"""The readers of the program's spans (spans.py): self times and per-tick
sums over shards from the tracer's events, kernels and idle gaps placed
under the innermost program range, and the two segments on a small cell on
the CPU, which leave every existing metric as it was."""
from __future__ import annotations

import copy
from types import SimpleNamespace

import pytest

from port_bench import run, spans, work
from port_bench.tests.conftest import args, small_cell

SEED = 3_000_000_231


class Events:
    """Chrome trace events with the tracer's ids, built by nesting."""

    def __init__(self):
        self.events, self.stack, self.next_id = [], [], 1

    def span(self, name, ts, dur, **kw):
        sid = self.next_id
        self.next_id += 1
        parent = self.stack[-1] if self.stack else 0
        root = self.stack[0] if self.stack else sid
        ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
              "args": {**kw, "id": sid, "parent": parent, "root": root}}
        self.events.append(ev)
        return _Open(self, sid)


class _Open:
    def __init__(self, ev, sid):
        self.ev, self.sid = ev, sid

    def __enter__(self):
        self.ev.stack.append(self.sid)

    def __exit__(self, *exc):
        self.ev.stack.pop()


def _fleet_events():
    """Two sharded ticks of two shards (durations in us), an ingest and a
    query each."""
    ev = Events()
    for k in range(2):
        t0 = 10_000 * k
        ev.span("ingest_many", t0, 500)
        with ev.span("sharded_tick", t0 + 1000, 8000):
            for shard in range(2):
                s0 = t0 + 1000 + 4000 * shard
                with ev.span("tick", s0, 3900, shard=str(shard)):
                    ev.span("flush", s0, 400)
                    with ev.span("refit", s0 + 400, 3400):
                        with ev.span("refit.step", s0 + 400, 3000, step=0):
                            ev.span("refit.forward", s0 + 400, 1000)
                            ev.span("refit.backward", s0 + 1400, 1500)
                        ev.span("tick.wait", s0 + 3400, 300)
        with ev.span("scenario", t0 + 9100, 600):
            ev.span("scenario.rollout", t0 + 9100, 100)
            ev.span("scenario.wait", t0 + 9200, 450)
    return ev.events


def test_host_table_sums_each_span_per_tick_over_shards():
    table = spans.host_table(_fleet_events())
    tick = table["tick"]
    # per tick: two shards' spans summed; ms from us
    assert tick["refit.forward"] == {"ms": 2.0, "self_ms": 2.0, "calls": 2}
    assert tick["refit.step"]["ms"] == 6.0
    assert tick["refit.step"]["self_ms"] == pytest.approx(2 * 0.5)
    assert tick["refit"]["self_ms"] == pytest.approx(2 * 0.1)
    assert tick["tick"]["self_ms"] == pytest.approx(2 * 0.1)
    assert tick["sharded_tick"]["ms"] == 8.0
    assert tick["sharded_tick"]["self_ms"] == pytest.approx(0.2)
    assert tick["tick.wait"]["calls"] == 2
    assert table["ingest_many"]["ingest_many"]["ms"] == 0.5
    assert table["scenario"]["scenario.wait"] == {"ms": 0.45,
                                                  "self_ms": 0.45,
                                                  "calls": 1}
    assert spans.children_share(_fleet_events()) == \
        pytest.approx(3300 / 3400)
    assert spans.root_ms(_fleet_events()) == [8.0, 8.0]


def test_events_without_ids_or_root_are_left_out():
    events = _fleet_events()
    kept = [e for e in events if e["name"] != "sharded_tick"]   # ring drop
    kept.append({"name": "tick", "ph": "X", "ts": 0.0, "dur": 9.0})
    table = spans.host_table(kept)
    assert "tick" not in table
    assert set(table) == {"ingest_many", "scenario"}


def test_span_metrics_read_the_table():
    info = SimpleNamespace(spans={"host_ms": spans.host_table(
        _fleet_events()), "kernels_per_tick": {"refit.forward": 7.0}})
    read = {n: run.metric_reader(n)(info) for n in spans.METRICS}
    assert read["ingest_span_ms"] == 0.5
    assert read["refit_forward_ms"] == 2.0
    assert read["refit_backward_ms"] == 3.0
    assert read["device_wait_ms"] == pytest.approx(0.6)
    assert read["promote_ms"] == 0.0 and read["refit_update_ms"] == 0.0
    assert read["scenario_wait_ms"] == 0.45
    assert read["forward_kernels_per_tick"] == 7.0
    assert read["update_kernels_per_tick"] == 0.0
    for n in spans.METRICS:
        assert run.metric_reader(n)(SimpleNamespace()) is None
        assert run.metric_reader(n)(SimpleNamespace(spans=None)) is None


def test_kernels_and_gaps_go_under_the_innermost_range():
    # ns: a tick holding guard (guard.score, guard.wait) and refit
    # (refit.forward); a query outside the tick
    ranges = [(0, 1000, "tick"), (0, 300, "guard"), (0, 100, "guard.score"),
              (100, 300, "guard.wait"), (300, 1000, "refit"),
              (300, 600, "refit.forward"), (1200, 1500, "scenario")]
    launches = {1: 50, 2: 400, 3: 450, 4: 700, 5: 1250, 6: 1100}
    kernels = [(60, 20, "k", 1), (410, 50, "k", 2), (470, 50, "k", 3),
               (710, 10, "k", 4), (1260, 20, "k", 5), (1110, 10, "k", 6),
               (2000, 5, "k", 99)]
    device = [(s, d, n) for s, d, n, _ in kernels]
    got = spans.attribute(ranges, launches, kernels, device, ticks=1)
    assert got["kernels_per_tick"] == {
        "guard.score": 1, "refit.forward": 2, "refit": 1, "scenario": 1,
        spans.OUTSIDE: 1}
    assert got["unplaced_kernels"] == 1
    # gaps: 80-410 (mid 245, guard.wait), 460-470 (refit.forward),
    # 520-710 (mid 615, refit), 720-1110 (mid 915, refit), 1120-1260
    # (mid 1190, outside), 1280-2000 (mid 1640, outside)
    idle = dict(got["idle_top_ms"])
    assert idle == {"guard.wait": 330e-6, "refit.forward": 10e-6,
                    "refit": 580e-6, spans.OUTSIDE: 860e-6}
    assert got["idle_in_tick_ms"] == pytest.approx(920e-6)
    assert got["idle_below_stage_share"] == pytest.approx(340 / 920)


def test_backward_kernels_and_gaps_go_under_their_autograd_node():
    ranges = [(0, 1000, "tick"), (0, 1000, "refit"),
              (100, 900, "refit.backward")]
    # the engine's ranges: a replayed kernel backward holding the nodes of
    # its replay, then a plain node
    nodes = [(150, 500, "_GRUScanKernelBackward"), (200, 300, "MulBackward0"),
             (600, 800, "AddBackward0")]
    launches = {1: 250, 2: 400, 3: 700, 4: 850, 5: 50}
    kernels = [(260, 10, "k", 1), (410, 10, "k", 2), (710, 10, "k", 3),
               (860, 10, "k", 4), (60, 10, "k", 5)]
    device = [(s, d, n) for s, d, n, _ in kernels]
    got = spans.attribute(ranges, launches, kernels, device, 1, nodes)
    assert got["kernels_per_tick"] == {"refit.backward": 4, "refit": 1}
    assert dict(got["backward_kernels_by_node"]) == {
        "_GRUScanKernelBackward": 2, "AddBackward0": 1, spans.NO_NODE: 1}
    # gaps: 70-260 (mid 165), 270-410 (mid 340), 420-710 (mid 565),
    # 720-860 (mid 790): all under refit.backward
    assert dict(got["backward_idle_ms_by_node"]) == pytest.approx({
        "_GRUScanKernelBackward": 330e-6, spans.NO_NODE: 290e-6,
        "AddBackward0": 140e-6})


class _Event:
    def __init__(self, name, kind=None):
        self._name = name
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name


def test_runtime_calls_are_told_from_operations():
    # named activities, as torch 2.13 gives them
    assert spans._is_runtime(_Event("cudaLaunchKernel", "cuda_runtime"))
    assert spans._is_runtime(_Event("cuLaunchKernel", "cuda_driver"))
    assert not spans._is_runtime(_Event("aten::add", "cpu_op"))
    # by name alone, as torch 2.11 gives them
    assert spans._is_runtime(_Event("cudaLaunchKernel"))
    assert spans._is_runtime(_Event("cuLaunchKernelEx"))
    for name in ("aten::add", "Activity Buffer Request", "cublasSgemm",
                 "Runtime Triggered Module Loading", "twin.refit"):
        assert not spans._is_runtime(_Event(name))


def test_innermost_follows_nesting_across_siblings():
    r = spans.Ranges([(0, 100, "a"), (10, 20, "b"), (30, 90, "c"),
                      (40, 50, "d"), (20, 30, "e")])
    names = {t: r.name(r.innermost(t)) for t in (5, 15, 25, 35, 45, 60, 95,
                                                 150)}
    assert names == {5: "a", 15: "b", 25: "e", 35: "c", 45: "d", 60: "c",
                     95: "a", 150: spans.OUTSIDE}
    assert r.under(r.innermost(45), {"a"})
    assert not r.under(r.innermost(150), {"a"})


@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.whatif"])
def test_segments_on_the_cpu_leave_the_existing_metrics_alone(name, cpu,
                                                              monkeypatch):
    cell = small_cell(name)
    seen = {}
    traced, span_segment = run.traced_segment, spans.span_segment

    def before_spans(loop, ticks):
        seen["window"] = copy.deepcopy((loop.ticks, loop.queries,
                                        loop.failed))
        return span_segment(loop, ticks)

    def keep(loop, ticks):
        seen["spanned"] = copy.deepcopy((loop.ticks, loop.queries,
                                         loop.failed))
        trace = traced(loop, ticks)
        seen["before"] = copy.deepcopy((loop.ticks, loop.queries,
                                        loop.failed, trace))
        seen["after"] = (loop, trace)
        seen["tracer"] = loop.srv.tracer
        return trace

    monkeypatch.setattr(spans, "span_segment", before_spans)
    monkeypatch.setattr(run, "traced_segment", keep)
    result, _ = spans.execute(cell, args(SEED, 2.0, trace=1), cpu)
    assert run.traced_segment is keep
    assert seen["window"] == seen["spanned"]
    assert result["correct"], result["checks"]
    s = result["spans"]
    host = ["ingest_span_ms", "flush_prepare_ms", "refit_forward_ms",
            "refit_backward_ms", "refit_update_ms", "promote_ms",
            "device_wait_ms"]
    if cell.traffic.get("queries"):
        host.append("scenario_wait_ms")
    for m in host:
        assert result["metrics"][m]["value"] is not None, m
        assert result["metrics"][m]["value"] >= 0.0
    # no device on the CPU: no kernels to place
    assert not s["kernels_per_tick"]
    assert "forward_kernels_per_tick" not in result["metrics"]
    assert s["segment_ticks"] == cell.traffic["trace_ticks"]
    assert min(s["tick_p50_ms"].values()) > 0
    assert min(s["ingest_p50_ms"].values()) > 0
    assert s["span_cost_us"]["on"] > s["span_cost_us"]["off"] > 0
    assert 0.5 < s["refit_children_share"] <= 1.0
    assert {"tick", "ingest_many"} <= set(s["host_ms"])
    # what the existing readers read is as the traced segment left it
    loop, trace = seen["after"]
    ticks, queries, failed, trace0 = seen["before"]
    assert (loop.ticks, loop.queries, loop.failed) == (ticks, queries, failed)
    assert (trace.device, trace.host, trace.ranges, trace.ticks,
            trace.window_s, trace.shapes) == \
        (trace0.device, trace0.host, trace0.ranges, trace0.ticks,
         trace0.window_s, trace0.shapes)
    assert not seen["tracer"].enabled and len(seen["tracer"]) == 0
    for m in cell.layer:
        info = dict(cfg=cell.cfg, traffic=cell.traffic, window_s=1.0,
                    work=work, power=None, flops=1.0)
        before = run.metric_reader(m["name"])(SimpleNamespace(
            **info, ticks=ticks, queries=queries, trace=trace0))
        after = run.metric_reader(m["name"])(SimpleNamespace(
            **info, ticks=loop.ticks, queries=loop.queries, trace=trace))
        assert before == after, m["name"]
