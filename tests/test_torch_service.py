"""TwinService conformance on the port: one scenario, three servers, one
truth -- and the JAX package's truth.

Ports tests/test_service_conformance.py onto the port's `TwinServer`,
`ShardedTwinServer` (2 shards) and `FederatedTwinServer` (2 worker
processes), all on the plain path (device="cpu"): ingest healthy
telemetry, inflict mid-stream model damage, watch the guard escalate to
ALERT, repair, watch it de-escalate.  Guard-only serving (deploy_after
never reached) makes the event stream a pure function of the deployed
thetas and the telemetry, so the three event streams must be IDENTICAL:
(tick, twin, kind) exactly and scores within 1e-6 relative, as in the JAX
suite.  They must also equal the JAX package's single `TwinServer` on the
same traces: (tick, twin, kind) exactly, scores within 1e-5 relative (the
guard tolerance of tests/test_torch_twin.py: f32 rollouts summed in
another order).  JAX's own suite holds its three servers equal, so no JAX
worker is spawned here.

The workers and this process run torch with one intra-op thread (set
before the workers start), so both sides sum in the same order.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.systems.lotka_volterra import LotkaVolterra
from repro.systems.simulate import simulate_batch
from repro.twin.monitor import GuardConfig as JaxGuardConfig
from repro.twin.server import TwinServer as JaxServer
from repro.twin.server import TwinServerConfig as JaxServerConfig
from repro_torch.core.merinda import MerindaConfig
from repro_torch.twin import (DegradationConfig, FederatedTwinConfig,
                              FederatedTwinServer, FederationConfig,
                              GuardConfig, ScenarioRefused, ShardedTwinConfig,
                              ShardedTwinServer, TwinServer, TwinServerConfig,
                              TwinService, conforms)

N_TWINS = 8
DAMAGED = {2, 5}
PER_TICK = 10
HEALTHY_TICKS = 4      # all models correct
DAMAGED_TICKS = 6      # twins in DAMAGED serve a negated theta
RECOVER_TICKS = 6      # repaired; guard must de-escalate
IMPLS = ("single", "sharded", "federated")
_MODEL = dict(n=2, m=0, order=2, hidden=8, head_hidden=8, n_active=4)
_SERVER = dict(max_twins=N_TWINS, refit_slots=2, capacity=128, window=16,
               stride=8, windows_per_twin=4, steps_per_tick=1,
               deploy_after=10 ** 6, min_residency=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread here and in every spawned worker."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def lv_world():
    sys_ = LotkaVolterra()
    tr = simulate_batch(sys_, jax.random.PRNGKey(0), batch=N_TWINS,
                        horizon=400, noise_std=0.002)
    true = np.asarray(sys_.true_theta(sys_.library()), np.float32)
    return sys_.spec.dt, np.asarray(tr.ys_noisy), true


def _base_cfg(dt):
    """Guard-only serving: deploy_after is unreachable, so guard events are
    a deterministic function of (deployed theta, telemetry)."""
    return TwinServerConfig(merinda=MerindaConfig(**_MODEL, dt=dt),
                            guard=GuardConfig(window=16), **_SERVER)


def _make(impl, cfg):
    if impl == "single":
        return TwinServer(cfg, device="cpu")
    if impl == "sharded":
        return ShardedTwinServer(ShardedTwinConfig.uniform(cfg, 2),
                                 device="cpu")
    return FederatedTwinServer(FederatedTwinConfig.uniform(cfg, 2),
                               device="cpu")


def _run_scenario(srv, ys, true):
    """ingest -> damage -> ALERT -> recover; returns the full event log."""
    for tid in range(N_TWINS):
        srv.register(tid)
    srv.deploy_many(list(range(N_TWINS)), np.stack([true] * N_TWINS))
    events = []
    tick = 0

    def serve(n_ticks):
        nonlocal tick
        for _ in range(n_ticks):
            staged = srv.ingest_many(
                [(tid, ys[tid, tick * PER_TICK:(tick + 1) * PER_TICK])
                 for tid in range(N_TWINS)])
            assert staged == N_TWINS * PER_TICK
            rep = srv.tick()
            events.extend(rep.events)
            tick += 1

    serve(HEALTHY_TICKS)
    damaged = sorted(DAMAGED)
    srv.deploy_many(damaged, np.stack([-true] * len(damaged)))   # damage
    serve(DAMAGED_TICKS)
    srv.deploy_many(damaged, np.stack([true] * len(damaged)))    # repair
    serve(RECOVER_TICKS)
    srv.drain()
    return events


@pytest.fixture(scope="module")
def scenario_events(lv_world):
    """Event log per implementation (one federated boot for the module),
    and the JAX package's single server's on the same traces."""
    dt, ys, true = lv_world
    cfg = _base_cfg(dt)
    out = {}
    for impl in IMPLS:
        srv = _make(impl, cfg)
        try:
            assert conforms(srv) == []
            assert isinstance(srv, TwinService)
            out[impl] = _run_scenario(srv, ys, true)
        finally:
            srv.close()
    jsrv = JaxServer(JaxServerConfig(merinda=JaxMerindaConfig(**_MODEL, dt=dt),
                                     guard=JaxGuardConfig(window=16),
                                     **_SERVER))
    try:
        out["jax"] = _run_scenario(jsrv, ys, true)
    finally:
        jsrv.close()
    return out


def _keyed(events):
    """Canonical order: multi-shard servers report per shard, the single
    server in ring order -- same transitions, different within-tick order."""
    return sorted((e.tick, e.twin_id, e.kind, e.score) for e in events)


def test_scenario_emits_the_mission_sequence(scenario_events):
    """Damage drives exactly the damaged twins to ALERT (a negated theta is
    severe enough to skip the REFIT rung), repair de-escalates."""
    ev = scenario_events["single"]
    assert ev, "scenario produced no guard events at all"
    alerted = {e.twin_id for e in ev if e.kind == "ALERT"}
    assert alerted == DAMAGED
    assert {e.twin_id for e in ev} == DAMAGED     # healthy twins stay silent
    for tid in DAMAGED:
        kinds = [e.kind for e in ev if e.twin_id == tid]
        first_alert = kinds.index("ALERT")
        assert "REFIT" in kinds[first_alert:], \
            f"twin {tid} never came down from ALERT"
        assert all(e.tick > HEALTHY_TICKS for e in ev if e.twin_id == tid)


@pytest.mark.parametrize("impl", [i for i in IMPLS if i != "single"])
def test_guard_events_identical_across_implementations(scenario_events, impl):
    """The exact (tick, twin, kind) transition set -- and the scores --
    survive sharding and the process/wire boundary."""
    ref = _keyed(scenario_events["single"])
    got = _keyed(scenario_events[impl])
    assert [(t, i, k) for t, i, k, _ in got] \
        == [(t, i, k) for t, i, k, _ in ref]
    np.testing.assert_allclose([s for *_, s in got], [s for *_, s in ref],
                               rtol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_guard_events_equal_the_jax_server(scenario_events, impl):
    """Each of the port's servers gives the JAX package's event stream."""
    ref = _keyed(scenario_events["jax"])
    got = _keyed(scenario_events[impl])
    assert ref, "the JAX server produced no events"
    assert [(t, i, k) for t, i, k, _ in got] \
        == [(t, i, k) for t, i, k, _ in ref]
    np.testing.assert_allclose([s for *_, s in got], [s for *_, s in ref],
                               rtol=1e-5)


def test_sample_accounting_identical(lv_world):
    """`ingest_many` returns the same staged-sample count on every
    implementation, including the force path (protocol contract)."""
    dt, ys, _ = lv_world
    cfg = _base_cfg(dt)
    batch = [(tid, ys[tid, :PER_TICK]) for tid in range(N_TWINS)]
    for impl in ("single", "sharded"):
        srv = _make(impl, cfg)
        try:
            assert srv.ingest_many(batch) == N_TWINS * PER_TICK
            assert srv.ingest_many(batch, force=True) == N_TWINS * PER_TICK
            srv.drain()
        finally:
            srv.close()


# --------------------------------------------------------------------- #
# scenario conformance: the what-if answer is part of the protocol
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def scenario_answers(lv_world):
    """Identical deploy history + telemetry on each implementation, then
    the same what-if query -- the answers (center, envelope, confidence)
    must match to f32 tolerance across the process/wire boundary."""
    dt, ys, true = lv_world
    cfg = _base_cfg(dt)
    out = {}
    for impl in IMPLS:
        srv = _make(impl, cfg)
        try:
            for tid in range(N_TWINS):
                srv.register(tid)
            srv.deploy_many(list(range(N_TWINS)),
                            np.stack([true] * N_TWINS))
            for t in range(3):
                srv.ingest_many(
                    [(tid, ys[tid, t * PER_TICK:(t + 1) * PER_TICK])
                     for tid in range(N_TWINS)])
                srv.tick()
            # a second deploy widens the confidence ensemble identically
            srv.deploy_many(list(range(N_TWINS)),
                            np.stack([true * 1.05] * N_TWINS))
            srv.drain()
            out[impl] = {tid: srv.scenario(tid, 12, k=3)
                         for tid in (0, 1, 5)}
        finally:
            srv.close()
    return out


@pytest.mark.parametrize("impl", [i for i in IMPLS if i != "single"])
def test_scenario_results_identical_across_implementations(scenario_answers,
                                                           impl):
    for tid, ref in scenario_answers["single"].items():
        got = scenario_answers[impl][tid]
        assert (got.twin_id, got.horizon, got.requested_k, got.k,
                got.degraded_level) == (ref.twin_id, ref.horizon,
                                        ref.requested_k, ref.k,
                                        ref.degraded_level)
        for f in ("ys", "lo", "hi", "confidence"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{impl} twin {tid} {f}")


def test_scenario_envelope_sane(scenario_answers):
    """The two-deploy history must produce a REAL envelope (not the
    degenerate single-theta band), on every implementation."""
    for impl, answers in scenario_answers.items():
        res = answers[0]
        assert (res.hi - res.lo).max() > 0, f"{impl}: degenerate envelope"
        assert (res.confidence < 1.0).all(), f"{impl}: confidence stuck at 1"
        assert (res.lo <= res.ys + 1e-6).all()
        assert (res.ys <= res.hi + 1e-6).all()


def _ladder_cfgs(dt):
    """Shard 0 under an impossible deadline with fast escalation -- its
    OWN ladder must shrink/refuse scenarios; shard 1 stays healthy."""
    base = _base_cfg(dt)
    degraded = dataclasses.replace(
        base, deadline_s=1e-4,
        degradation=DegradationConfig(enabled=True, hold_ticks=1))
    return (degraded, base)


@pytest.mark.parametrize("impl", ["sharded", "federated"])
def test_scenario_degraded_ladder_is_per_shard(lv_world, impl):
    """Deadline pressure on ONE shard refuses ITS twins' scenarios while
    the other shard answers at full K -- including across the federation
    wire, where `ScenarioRefused` must survive the ErrorMsg round trip."""
    dt, ys, true = lv_world
    cfgs = _ladder_cfgs(dt)
    srv = (ShardedTwinServer(ShardedTwinConfig(servers=cfgs), device="cpu")
           if impl == "sharded"
           else FederatedTwinServer(FederatedTwinConfig(servers=cfgs),
                                    device="cpu"))
    try:
        for tid in range(N_TWINS):
            srv.register(tid)
        srv.deploy_many(list(range(N_TWINS)), np.stack([true] * N_TWINS))
        for t in range(8):                 # every tick misses 0.1 ms: the
            srv.ingest_many(               # ladder climbs one level per tick
                [(tid, ys[tid, t * PER_TICK:(t + 1) * PER_TICK])
                 for tid in range(N_TWINS)])
            srv.tick()
        srv.drain()
        with pytest.raises(ScenarioRefused):
            srv.scenario(0, 10, k=4)       # twin 0 -> shard 0 (degraded)
        res = srv.scenario(1, 10, k=4)     # twin 1 -> shard 1 (healthy)
        assert res.k == res.requested_k == 4 and res.degraded_level == 0
    finally:
        srv.close()


def test_scenario_shrink_is_deterministic_across_shards(lv_world):
    """At shrink_level the SAME query gets the SAME reduced K on any
    shard (deterministic shrink, not sampling)."""
    dt, ys, true = lv_world
    srv = ShardedTwinServer(ShardedTwinConfig.uniform(_base_cfg(dt), 2),
                            device="cpu")
    try:
        for tid in range(N_TWINS):
            srv.register(tid)
        srv.deploy_many(list(range(N_TWINS)), np.stack([true] * N_TWINS))
        srv.ingest_many([(tid, ys[tid, :PER_TICK])
                         for tid in range(N_TWINS)])
        srv.tick()
        srv.drain()
        for shard in srv.shards:
            shard._degradation.level = 2
        ks = {srv.scenario(tid, 10, k=8).k for tid in range(N_TWINS)}
        assert ks == {2}                   # 8 // degraded_shrink(4), always
    finally:
        srv.close()


def test_federation_config_deprecated_kwargs():
    """The older `FederationConfig` kwargs keep working, warning, and route
    to the new field names; mixing old and new spellings is an error."""
    with pytest.warns(DeprecationWarning, match="min_slots"):
        cfg = FederationConfig(8, min_slots=2)
    assert cfg.min_shard_slots == 2
    with pytest.warns(DeprecationWarning):
        assert cfg.min_slots == 2          # deprecated read-alias
    with pytest.warns(DeprecationWarning, match="smooth"):
        cfg = FederationConfig(8, smooth=0.25)
    assert cfg.pressure_smooth == 0.25
    with pytest.raises(TypeError):
        FederationConfig(8, min_shard_slots=1, min_slots=1)


def test_conforms_reports_missing_surface():
    class Half:
        def ingest(self):
            pass

    missing = conforms(Half())
    assert "tick" in missing and "ingest_many" in missing
    assert "scenario" in missing          # the what-if surface is protocol
    assert "ingest" not in missing


def test_topology_maps_onto_the_federation(lv_world):
    """`make_federation` is the one mapping from fleet-topology names onto
    `FederationConfig`'s: the default budget is the sum of the pools."""
    dt, _, _ = lv_world
    cfg = ShardedTwinConfig.uniform(_base_cfg(dt), 3, min_shard_slots=2,
                                    pressure_smooth=0.25)
    fed = cfg.make_federation([2, 4, 8])
    assert (fed.total_slots, fed.min_shard_slots, fed.pressure_smooth) == \
        (14, 2, 0.25)
    assert dataclasses.replace(cfg, total_slots=5).make_federation(
        [2, 4, 8]).total_slots == 5
    assert FederatedTwinConfig.uniform(_base_cfg(dt), 3).make_federation(
        [2, 4, 8]) == ShardedTwinConfig.uniform(
            _base_cfg(dt), 3).make_federation([2, 4, 8])
