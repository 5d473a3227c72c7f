"""The port's tracer (`repro_torch.obs.tracing`) and the spans the serving
stack records with it, on the CPU.

The tracer: ids, parents and roots on nested spans and across threads,
sampling, the ring bound, the disabled tracer's shared no-op span (no
clock read, no profiler range), the profiler mirror of a recorded span on
the anchor's clock.  The serving stack: one `TwinServer` tick and one
`ShardedTwinServer` tick with the tracer on record exactly the span tree
of the tracer's docstring, with its args, and a served what-if query its
own; tick reports, served models and query answers are identical with the
tracer on and off.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.merinda import MerindaConfig
from repro_torch.obs import NULL_SPAN, Tracer, tracing
from repro_torch.systems.lotka_volterra import LotkaVolterra
from repro_torch.systems.simulate import simulate_batch
from repro_torch.twin.monitor import GuardConfig
from repro_torch.twin.server import TwinServer, TwinServerConfig
from repro_torch.twin.sharded import ShardedTwinConfig, ShardedTwinServer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spans(tracer):
    return [e for e in tracer.to_chrome_trace()["traceEvents"]
            if e["ph"] == "X"]


def _children(events):
    """parent id -> its children's events, in order of start."""
    out: dict[int, list] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        out.setdefault(e["args"]["parent"], []).append(e)
    return out


# --------------------------------------------------------------------- #
# the tracer
# --------------------------------------------------------------------- #
def test_nested_spans_carry_id_parent_and_root():
    tr = Tracer()
    with tr.span("tick", tick=1):
        with tr.span("refit"):
            with tr.span("refit.step", step=0):
                pass
        with tr.span("guard"):
            pass
    with tr.span("scenario"):
        pass
    ev = {e["name"]: e["args"] for e in _spans(tr)}
    tick, refit, step = ev["tick"], ev["refit"], ev["refit.step"]
    assert tick["parent"] == 0 and tick["root"] == tick["id"]
    assert refit["parent"] == tick["id"] and refit["root"] == tick["id"]
    assert step["parent"] == refit["id"] and step["root"] == tick["id"]
    assert ev["guard"]["parent"] == tick["id"]
    assert ev["scenario"]["parent"] == 0
    assert ev["scenario"]["root"] == ev["scenario"]["id"]
    ids = [a["id"] for a in ev.values()]
    assert len(set(ids)) == len(ids) and min(ids) >= 1
    assert tick["tick"] == 1 and step["step"] == 0


def test_ids_stay_with_their_thread():
    tr = Tracer()
    start = threading.Barrier(4)

    def work(k):
        start.wait(timeout=10)
        for i in range(50):
            with tr.span("root", worker=k, i=i):
                with tr.span("child", worker=k):
                    with tr.span("leaf", worker=k):
                        pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    events = _spans(tr)
    assert len(events) == 4 * 50 * 3
    by_id = {e["args"]["id"]: e for e in events}
    assert len(by_id) == len(events)
    for e in events:
        a = e["args"]
        if e["name"] == "root":
            assert a["parent"] == 0 and a["root"] == a["id"]
            continue
        parent, root = by_id[a["parent"]], by_id[a["root"]]
        assert parent["name"] == {"child": "root", "leaf": "child"}[e["name"]]
        assert root["name"] == "root"
        assert parent["args"]["worker"] == root["args"]["worker"] == \
            a["worker"]
        assert parent["tid"] == root["tid"] == e["tid"]


def test_sampling_keeps_subtrees_whole():
    tr = Tracer(sample_every=3)
    for i in range(9):
        with tr.span("root", i=i):
            with tr.span("child"):
                with tr.span("leaf"):
                    pass
    events = _spans(tr)
    names = [e["name"] for e in events]
    # roots 0, 3, 6 sampled, each with its whole subtree
    assert names.count("root") == names.count("child") == \
        names.count("leaf") == 3
    roots = {e["args"]["id"]: e["args"]["i"] for e in events
             if e["name"] == "root"}
    assert sorted(roots.values()) == [0, 3, 6]
    assert all(e["args"]["root"] in roots for e in events)


def test_ring_bound_and_drop_count():
    tr = Tracer(capacity=4)
    for i in range(10):
        with tr.span("s", i=i):
            pass
    assert len(tr) == 4 and tr.dropped_events == 6
    assert [e["args"]["i"] for e in _spans(tr)] == [6, 7, 8, 9]
    assert tr.to_chrome_trace()["otherData"]["dropped_events"] == 6
    tr.clear()
    assert len(tr) == 0 and tr.dropped_events == 0


def test_disabled_tracer_returns_the_null_span_and_opens_no_range(
        monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    clock = []
    real_ns = tracing.time.perf_counter_ns

    def counted_ns():
        clock.append(1)
        return real_ns()

    tr = Tracer(enabled=False)
    # a profiler that always reads as recording, and a counted clock
    monkeypatch.setattr(tracing, "_profiler", (lambda: True, Range))
    monkeypatch.setattr(tracing.time, "perf_counter_ns", counted_ns)
    sp = tr.span("tick", tick=1)
    assert sp is NULL_SPAN
    with sp as inner:
        inner.note(promoted=1)
        with tr.span("refit"):
            pass
    assert len(tr) == 0 and opened == [] and clock == []
    # enabled at run time, as the benchmark does with a server's tracer
    tr.enabled = True
    with tr.span("tick"):
        with tr.span("refit"):
            pass
    assert opened == ["twin.tick", "twin.refit"]
    assert [e["name"] for e in _spans(tr)] == ["refit", "tick"]


def test_no_profiler_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(tracing, "_profiler",
                        (lambda: False, lambda name: opened.append(name)))
    tr = Tracer()
    with tr.span("tick"):
        pass
    assert len(tr) == 1 and opened == []


def test_recorded_span_lands_in_the_profiler_on_the_anchor_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("tick"):
            with tr.span("refit"):
                torch.ones(64).sum()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.name().startswith(tracing.PROFILER_PREFIX)}
    assert set(ranges) == {"twin.tick", "twin.refit"}
    doc = tr.to_chrome_trace()
    clock = doc["otherData"]["clock"]
    assert set(clock) == {"perf_counter_ns", "time_ns"}
    for e in _spans(tr):
        at = clock["time_ns"] + round(1e3 * e["ts"])
        assert abs(ranges["twin." + e["name"]].start_ns() - at) < 5e6
    tick, refit = ranges["twin.tick"], ranges["twin.refit"]
    assert tick.start_ns() <= refit.start_ns()
    assert (refit.start_ns() + refit.duration_ns()
            <= tick.start_ns() + tick.duration_ns())


# --------------------------------------------------------------------- #
# the serving stack's spans
# --------------------------------------------------------------------- #
SYSTEM = LotkaVolterra()
TWINS, CHUNK = 32, 10


@pytest.fixture(scope="module")
def telemetry():
    tr = simulate_batch(SYSTEM, torch.Generator().manual_seed(1),
                        batch=TWINS, horizon=120, noise_std=0.002,
                        device="cpu")
    return tr.ys_noisy.numpy(), tr.us.numpy()


def _server_cfg(**kw):
    base = dict(
        merinda=MerindaConfig(n=2, m=0, order=2, hidden=8, head_hidden=8,
                              n_active=4, dt=SYSTEM.spec.dt),
        max_twins=TWINS, refit_slots=2, capacity=128, window=16, stride=8,
        windows_per_twin=4, steps_per_tick=2, deploy_after=2,
        min_residency=2, max_residency=6, guard=GuardConfig(window=16),
        seed=0)
    base.update(kw)
    return TwinServerConfig(**base)


def _theta(srv):
    lib = srv.fleet.model.lib if hasattr(srv, "fleet") else \
        srv.shards[0].fleet.model.lib
    return np.asarray(SYSTEM.true_theta(lib), np.float32)


def _fed(t):
    """Samples a twin has streamed once tick t (from 0) has ingested: the
    first tick's chunk is five times as long, so the guard scores and the
    scheduler admits from the first tick on."""
    return (t + 5) * CHUNK


def _drive(srv, ys, us, ticks, queries=True):
    """Deploy the true model, then ingest and tick `ticks` times, with a
    what-if query after each tick; returns (reports, answers)."""
    srv.deploy_many(list(range(TWINS)), _theta(srv))
    reports, answers = [], []
    for t in range(ticks):
        lo = _fed(t - 1) if t else 0
        srv.ingest_many([(i, ys[i, lo:_fed(t)]) for i in range(TWINS)])
        reports.append(srv.tick())
        if queries:
            res = srv.scenario(t % TWINS, 6, np.zeros((3, 6, 0), np.float32))
            answers.append((res.ys, res.lo, res.hi, res.confidence))
    return reports, answers


TICK = ["flush", "guard", "schedule", "refit"]
TREE = {"flush": ["pump_flush", "flush.apply"],
        "guard": ["guard.score", "guard.wait", "guard.judge"],
        "schedule": ["schedule.plan", "schedule.apply"],
        "refit.step": ["refit.forward", "refit.backward", "refit.update"],
        "promote": ["promote.recover", "promote.score", "promote.wait",
                    "promote.deploy"]}
LEAVES = {"pump_flush", "flush.apply", "guard.score", "guard.wait",
          "guard.judge", "schedule.plan", "schedule.apply", "refit.windows",
          "refit.forward", "refit.backward", "refit.update", "refit.wait",
          "promote.recover", "promote.score", "promote.wait",
          "promote.deploy", "tick.wait", "scenario.rollout",
          "scenario.wait"}


def _check_tick(tick, kids, steps, shard=None):
    """The subtree under one `tick` event is the documented one; returns
    whether its refit promoted."""
    assert [e["name"] for e in kids[tick["args"]["id"]]] == TICK
    if shard is not None:
        assert tick["args"]["shard"] == shard
    promoted = False
    for stage in kids[tick["args"]["id"]]:
        got = [e["name"] for e in kids.get(stage["args"]["id"], [])]
        if stage["name"] == "refit":
            has_promote = "promote" in got
            assert got == (["refit.windows"] + ["refit.step"] * steps
                           + ["refit.wait"]
                           + ["promote"] * has_promote + ["tick.wait"])
            for e in kids[stage["args"]["id"]]:
                sub = [c["name"] for c in kids.get(e["args"]["id"], [])]
                assert sub == TREE.get(e["name"], []), e["name"]
            steps_seen = [e["args"]["step"]
                          for e in kids[stage["args"]["id"]]
                          if e["name"] == "refit.step"]
            assert steps_seen == list(range(steps))
            if has_promote:
                pr = next(e for e in kids[stage["args"]["id"]]
                          if e["name"] == "promote")
                assert pr["args"]["candidates"] >= 1
                assert 0 <= pr["args"]["promoted"] <= pr["args"]["candidates"]
                promoted = True
        else:
            assert got == TREE[stage["name"]], stage["name"]
            for e in kids[stage["args"]["id"]]:
                assert e["args"]["id"] not in kids      # leaves
        for e in kids.get(stage["args"]["id"], []):
            assert e["args"]["root"] == tick["args"]["root"]
    return promoted


def _args_of(events, name):
    return [e["args"] for e in events if e["name"] == name]


def test_server_tick_records_the_span_tree(telemetry):
    ys, us = telemetry
    tracer = Tracer()
    srv = TwinServer(_server_cfg(), device="cpu", tracer=tracer)
    _drive(srv, ys, us, 4)
    events = _spans(tracer)
    kids = _children(events)
    ticks = [e for e in events if e["name"] == "tick"]
    assert len(ticks) == 4
    assert all(e["args"]["parent"] == 0 for e in ticks)
    promoted = [_check_tick(t, kids, 2) for t in ticks]
    assert promoted[-1]                 # slots past deploy_after by tick 2
    assert {e["name"] for e in events} == (
        set(TICK) | set(LEAVES) | {"tick", "refit.step", "promote",
                                   "scenario", "ingest_many"})
    flushes = _args_of(events, "pump_flush")
    assert [a["samples"] for a in flushes] == \
        [TWINS * 5 * CHUNK] + [TWINS * CHUNK] * 3
    for a in flushes:
        assert a["rows"] == TWINS and a["padded_rows"] >= TWINS
        assert a["padded_samples"] >= a["samples"] and a["dropped"] == 0
    for a in _args_of(events, "guard.score"):
        assert a["scored"] == TWINS and a["width"] == TWINS
    plan = [(a["admitted"], a["evicted"])
            for a in _args_of(events, "schedule.apply")]
    assert plan[0] == (2, 0)
    ingests = _args_of(events, "ingest_many")
    assert [(a["chunks"], a["samples"], a["parent"]) for a in ingests] == \
        [(TWINS, TWINS * 5 * CHUNK, 0)] + [(TWINS, TWINS * CHUNK, 0)] * 3
    # a query: its own root with the rollout and the wait under it
    for q in [e for e in events if e["name"] == "scenario"]:
        assert q["args"]["parent"] == 0
        assert q["args"]["k"] == q["args"]["effective_k"] == 3
        assert [c["name"] for c in kids[q["args"]["id"]]] == \
            ["scenario.rollout", "scenario.wait"]
    # every span a tick opens lies inside it
    by_id = {e["args"]["id"]: e for e in events}
    for e in events:
        root = by_id[e["args"]["root"]]
        assert root["ts"] <= e["ts"] + 1e-3
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-3


def test_sharded_tick_records_the_span_tree(telemetry):
    ys, us = telemetry
    tracer = Tracer()
    srv = ShardedTwinServer(ShardedTwinConfig.uniform(
        _server_cfg(max_twins=TWINS // 2, guard_budget=8, steps_per_tick=1),
        2, rebalance_every=3), device="cpu", tracer=tracer)
    _drive(srv, ys, us, 3)
    events = _spans(tracer)
    kids = _children(events)
    roots = [e for e in events if e["args"]["parent"] == 0]
    assert [e["name"] for e in roots if e["name"] != "scenario"] == \
        ["ingest_many", "sharded_tick"] * 3
    assert all(a["chunks"] == TWINS for a in _args_of(events, "ingest_many"))
    for st in [e for e in roots if e["name"] == "sharded_tick"]:
        got = [e["name"] for e in kids[st["args"]["id"]]]
        assert got[:2] == ["tick", "tick"]
        assert got[2:] == (["rebalance"] if st["args"]["tick"] == 3 else [])
        for shard, tick in enumerate(kids[st["args"]["id"]][:2]):
            assert tick["args"]["root"] == st["args"]["id"]
            _check_tick(tick, kids, 1, shard=str(shard))
    for a in _args_of(events, "guard.score"):
        # the rotation's width: its budget and a quarter of it for carry
        assert a["width"] == 10 and 1 <= a["scored"] <= 10


@pytest.mark.parametrize("sharded", [False, True], ids=["server", "sharded"])
def test_tracing_on_and_off_serve_identically(telemetry, sharded):
    """The tracer only measures: tick reports, the served models and every
    what-if answer are identical, bit for bit, with it on and off."""
    ys, us = telemetry

    def run(tracer):
        torch.manual_seed(0)
        if sharded:
            srv = ShardedTwinServer(ShardedTwinConfig.uniform(
                _server_cfg(max_twins=TWINS // 2, guard_budget=8), 2,
                rebalance_every=2), device="cpu", tracer=tracer)
            shards = srv.shards
        else:
            srv = TwinServer(_server_cfg(), device="cpu", tracer=tracer)
            shards = [srv]
        reports, answers = _drive(srv, ys, us, 6)
        reports = reports if not sharded else [r for rep in reports
                                               for r in rep.reports]
        thetas = [(s._theta.clone(), s._theta_hist.clone()) for s in shards]
        return reports, answers, thetas

    off = run(Tracer(enabled=False))
    tracer = Tracer()
    on = run(tracer)
    assert len(tracer) > 0
    for a, b in zip(off[0], on[0]):
        assert (a.tick, a.admitted, a.evicted, a.released, a.n_active,
                a.n_twins, a.n_guarded, a.loss) == \
            (b.tick, b.admitted, b.evicted, b.released, b.n_active,
             b.n_twins, b.n_guarded, b.loss)
        assert [(e.kind, e.twin_id) for e in a.events] == \
            [(e.kind, e.twin_id) for e in b.events]
    assert any(r.loss is not None for r in off[0])
    for a, b in zip(off[1], on[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for (ta, ha), (tb, hb) in zip(off[2], on[2]):
        assert torch.equal(ta, tb) and torch.equal(ha, hb)
