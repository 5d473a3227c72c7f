"""Serving-path parity: ring, guard, scheduler and the whole TwinServer.

The same seeded numpy inputs go through the JAX package and the port (on CPU
tensors, i.e. the kernels' plain versions).  Tolerances: ring gathers are
exact (bitwise); guard scores 1e-5 relative (fp32 rollouts summed in another
order); scheduler candidates and plans exact; the 64-twin server run holds
per-tick losses to rtol 1e-3 / atol 1e-4 and the final theta store,
divergences, predictions and scenario answers to the tolerances of the JAX
package's own reference-vs-Pallas server test (test_hotpath_parity.py).
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.library import make_library as jax_make_library
from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.systems.f8_crusader import F8Crusader as JaxF8
from repro.systems.simulate import simulate_batch
from repro.twin.monitor import DivergenceGuard as JaxGuard
from repro.twin.monitor import GuardConfig as JaxGuardConfig
from repro.twin.packed import PackedFleet as JaxPacked
from repro.twin.packed import fleet_scores as jax_fleet_scores
from repro.twin.recovery import DegradationConfig as JaxDegradationConfig
from repro.twin.scenario import ScenarioRefused as JaxRefused
from repro.twin.scheduler import PackedRefitScheduler as JaxPlanner
from repro.twin.scheduler import SchedulerConfig as JaxSchedCfg
from repro.twin.scheduler import TwinRecord as JaxRecord
from repro.twin.server import TwinServer as JaxServer
from repro.twin.server import TwinServerConfig as JaxServerConfig
from repro.twin.stream import RingConfig as JaxRingConfig
from repro.twin.stream import StagingOverflow as JaxStagingOverflow
from repro.twin.stream import TelemetryRing as JaxRing
from repro_torch.convert import fleet_state_from_jax, merinda_params_from_jax
from repro_torch.core.library import make_library
from repro_torch.core.merinda import MerindaConfig
from repro_torch.twin.monitor import DivergenceGuard, GuardConfig
from repro_torch.twin.packed import PackedFleet, fleet_scores
from repro_torch.twin.recovery import DegradationConfig
from repro_torch.twin.scenario import ScenarioRefused
from repro_torch.twin.scheduler import PackedRefitScheduler, SchedulerConfig
from repro_torch.twin.server import TwinServer, TwinServerConfig
from repro_torch.twin.stream import (RingConfig, StagingOverflow,
                                     TelemetryRing)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------- #
# ring: scatter and gathers, bitwise
# --------------------------------------------------------------------------- #
def test_ring_ingest_latest_windows_bitwise():
    cfg = dict(slots=5, capacity=40, n=3, m=1)
    jring, tring = JaxRing(JaxRingConfig(**cfg)), TelemetryRing(
        RingConfig(**cfg), device="cpu")
    js, ts = jring.init(), tring.init()
    rng = np.random.default_rng(0)
    for _ in range(9):                       # laps the 40-sample ring
        # distinct real rows plus scratch padding rows (row 4, count 0)
        slots = np.asarray([0, 2, 3, 4, 4], np.int32)
        counts = np.asarray([8, rng.integers(1, 9), 8, 0, 0], np.int32)
        ys = rng.normal(size=(5, 8, 3)).astype(np.float32)
        us = rng.normal(size=(5, 8, 1)).astype(np.float32)
        js = jring.ingest(js, *map(jnp.asarray, (slots, ys, us, counts)))
        tring.ingest(ts, *map(torch.from_numpy, (slots, ys, us, counts)))
    for key in ("y", "u", "count"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    rows = np.asarray([3, 0, 2], np.int32)
    jy, ju = jring.latest(js, jnp.asarray(rows), 32)
    ty, tu = tring.latest(ts, torch.from_numpy(rows), 32)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    span = JaxRing.span(8, 4, 6)
    jyw, juw = jring.windows(js, jnp.asarray(rows), window=8, stride=4,
                             length=span)
    tyw, tuw = tring.windows(ts, torch.from_numpy(rows), window=8, stride=4,
                             length=span)
    assert tyw.shape == (3, 6, 9, 3) and tuw.shape == (3, 6, 8, 1)
    np.testing.assert_array_equal(tyw.numpy(), np.asarray(jyw))
    np.testing.assert_array_equal(tuw.numpy(), np.asarray(juw))
    tring.clear(ts, 2)
    assert int(ts["count"][2]) == 0


# --------------------------------------------------------------------------- #
# guard: rollout scores (with a blow-up) and the float64 host fold
# --------------------------------------------------------------------------- #
def test_guard_scores_and_fold_match_jax():
    n, m, order, k = 3, 1, 3, 16
    jlib, lib = jax_make_library(n, m, order), make_library(n, m, order)
    rng = np.random.default_rng(1)
    theta = (0.3 * rng.normal(size=(6, n, lib.size))).astype(np.float32)
    theta[4, 0, lib.names.index("y0*y0*y0")] = 1e3      # diverges -> 1e6
    ys = (0.5 + 0.3 * rng.normal(size=(6, k + 1, n))).astype(np.float32)
    us = (0.1 * rng.normal(size=(6, k, m))).astype(np.float32)
    jg = JaxGuard(jlib, 0.01, JaxGuardConfig(window=k))
    tg = DivergenceGuard(lib, 0.01, GuardConfig(window=k))
    js = np.asarray(jg.score(*map(jnp.asarray, (theta, ys, us))))
    ts = tg.score(*map(torch.from_numpy, (theta, ys, us))).numpy()
    assert ts.dtype == np.float32 and js[4] == ts[4] == 1e6
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    div_j = np.linspace(0.0, 2.0, 8)
    div_t = div_j.copy()
    rows = np.asarray([5, 1, 3, 0, 6, 2])
    out_j = jg.fold_into(div_j, rows, js)
    out_t = tg.fold_into(div_t, rows, js)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(div_t, div_j)


# --------------------------------------------------------------------------- #
# scheduler: device ranking with ties, and whole plans
# --------------------------------------------------------------------------- #
def _random_case(rng):
    """A (cfg kwargs, records, max_active) planning problem whose priorities
    are exact in float32 and float64, with many exact ties."""
    slots = rng.randint(1, 6)
    cfg = dict(slots=slots, min_samples=rng.choice((1, 2, 4, 8)),
               staleness_weight=rng.choice((0.5, 1.0, 2.0)),
               divergence_weight=rng.choice((1.0, 4.0)),
               evict_margin=rng.choice((0.0, 0.5)),
               min_residency=rng.choice((0, 1, 2)),
               max_residency=rng.choice((2, 4)),
               release_divergence=rng.choice((0.05, 1.0)))
    free = list(range(slots))
    rng.shuffle(free)
    twins = {}
    for tid in range(rng.randint(0, 40)):
        resident = bool(free) and rng.random() < 0.3
        rec = JaxRecord(twin_id=tid, ring_slot=tid,
                        refit_slot=free.pop() if resident else None,
                        samples=rng.randint(0, 12),
                        deployed=rng.random() < 0.5,
                        residency=rng.randint(0, 8) if resident else 0,
                        divergence=rng.randint(0, 3) / 4)
        rec.samples_at_deploy = rng.randint(0, rec.samples)
        twins[tid] = rec
    return cfg, twins, rng.choice([None, rng.randint(0, slots)])


def _port_packed(jp: JaxPacked) -> PackedFleet:
    tp = PackedFleet(jp.capacity)
    for col in PackedFleet.__slots__[1:]:
        getattr(tp, col)[:] = getattr(jp, col)
    return tp


def test_fleet_scores_break_ties_like_lax_top_k():
    jp = JaxPacked(64)
    for row in range(40):
        jp.register(row, 1000 + row)
    jp.samples[:40] = 16            # every row ready, identical priority...
    jp.deployed[:40] = True
    jp.set_divergence(np.arange(10, 20), 0.25)   # ...except a tied block
    jp.resident[[11, 13]] = True
    kw = dict(min_samples=8, sw=1.0, dw=4.0, k=8)
    rows_j, prio_j, nw_j, pr_j = jax_fleet_scores(jp, **kw)
    rows_t, prio_t, nw_t, pr_t = fleet_scores(_port_packed(jp), **kw,
                                              device="cpu")
    np.testing.assert_array_equal(rows_t, np.asarray(rows_j))
    np.testing.assert_array_equal(prio_t, np.asarray(prio_j))
    assert rows_t.tolist() == [10, 12, 14, 15, 16, 17, 18, 19]
    assert (nw_t, pr_t) == (nw_j, pr_j)


def test_packed_planner_matches_jax_on_random_fleets():
    rng = random.Random(7)
    for _ in range(150):
        cfg, twins, max_active = _random_case(rng)
        jp = JaxPacked.from_records(twins)
        slot_rows = jp.slot_rows_from_records(twins, cfg["slots"])
        want = JaxPlanner(JaxSchedCfg(**cfg)).plan(jp, slot_rows,
                                                   max_active=max_active)
        got = PackedRefitScheduler(SchedulerConfig(**cfg), device="cpu").plan(
            _port_packed(jp), slot_rows, max_active=max_active)
        assert (got.admit, got.evict, got.release) == \
            (want.admit, want.evict, want.release)


# --------------------------------------------------------------------------- #
# the whole serving loop: JAX TwinServer vs the port's, from the same draws
# --------------------------------------------------------------------------- #
_SERVER = dict(max_twins=64, refit_slots=8, capacity=128, window=16,
               stride=8, windows_per_twin=4, steps_per_tick=2, deploy_after=4,
               min_residency=2, max_residency=8, seed=7)


class _JaxDraws:
    """The JAX server's random stream (`TwinServer._split` order: one key for
    `fleet.init`, then one per admission for `model.init`), converted."""

    def __init__(self, jfleet, seed):
        self.jfleet, self.key = jfleet, jax.random.PRNGKey(seed)

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def fleet_init(self):
        return fleet_state_from_jax(_np(self.jfleet.init(self._split())))

    def slot_init(self):
        return merinda_params_from_jax(
            _np(self.jfleet.model.init(self._split())))


# warm: every twin starts deployed (half with a near-zero theta that tracks
# the slow F-8 telemetry, half with a diverging one), so the guard scores from
# the first ticks.  degrade: a deadline no tick can meet climbs the shed ladder
# one level every `hold_ticks` (2) ticks: shed guard, defer refit, skip
# promote; scenario K shrinks at level 2 and queries are refused at 3.
_CASES = {
    "full": dict(ticks=10),
    "guard_budget": dict(ticks=7, warm=True, guard_budget=16),
    "degraded_scan": dict(ticks=7, warm=True, degrade=True),
    "degraded_budget": dict(ticks=7, warm=True, degrade=True,
                            guard_budget=16),
}


def _scenario_pair(jsrv, tsrv, tid, what_if):
    """Both servers' answer to one what-if query: the effective K, or None
    when both refused it."""
    try:
        sj = jsrv.scenario(tid, what_if.shape[1], what_if)
    except JaxRefused:
        with pytest.raises(ScenarioRefused):
            tsrv.scenario(tid, what_if.shape[1], what_if)
        return None
    st = tsrv.scenario(tid, what_if.shape[1], what_if)
    assert (st.k, st.requested_k, st.degraded_level) == \
        (sj.k, sj.requested_k, sj.degraded_level)
    for field in ("ys", "lo", "hi", "confidence"):
        np.testing.assert_allclose(getattr(st, field), getattr(sj, field),
                                   rtol=1e-3, atol=1e-4, err_msg=field)
    return st.k


@pytest.mark.parametrize("case", sorted(_CASES))
def test_server_64twin_parity_with_jax(case):
    opts = _CASES[case]
    system = JaxF8()
    n, m, dt = system.spec.n, system.spec.m, system.spec.dt
    n_twins, chunk, ticks = 64, 8, opts["ticks"]
    trace = simulate_batch(system, jax.random.PRNGKey(3), batch=n_twins,
                           horizon=chunk * ticks + 1, noise_std=0.002)
    ys, us = np.asarray(trace.ys_noisy), np.asarray(trace.us)
    model = dict(n=n, m=m, order=2, dt=dt, hidden=16, head_hidden=16,
                 n_active=12)
    extra = dict(guard_budget=opts.get("guard_budget"))
    jextra, textra = dict(extra), dict(extra)
    if opts.get("degrade"):
        jextra.update(deadline_s=1e-9,
                      degradation=JaxDegradationConfig(enabled=True))
        textra.update(deadline_s=1e-9,
                      degradation=DegradationConfig(enabled=True))
    jsrv = JaxServer(JaxServerConfig(merinda=JaxMerindaConfig(**model),
                                     guard=JaxGuardConfig(window=16),
                                     **_SERVER, **jextra))
    tsrv = TwinServer(TwinServerConfig(merinda=MerindaConfig(**model),
                                       guard=GuardConfig(window=16),
                                       **_SERVER, **textra),
                      device="cpu", init_source=_JaxDraws(jsrv.fleet, 7))
    rng = np.random.default_rng(4)
    what_if = (0.02 * rng.normal(size=(4, 12, m))).astype(np.float32)
    if opts.get("warm"):
        L = jsrv.fleet.model.lib.size
        thetas = (0.01 * rng.normal(size=(n_twins, n, L))).astype(np.float32)
        thetas[1::2] *= 100.0
        jsrv.deploy_many(range(n_twins), jnp.asarray(thetas))
        tsrv.deploy_many(range(n_twins), thetas)
    ks, n_events = [], 0
    for t in range(ticks):
        lo = t * chunk
        for srv in (jsrv, tsrv):
            srv.ingest_many((i, ys[i, lo:lo + chunk], us[i, lo:lo + chunk])
                            for i in range(n_twins))
        rj, rt = jsrv.tick(), tsrv.tick()
        assert (rt.n_active, rt.admitted, rt.evicted, rt.released) == \
            (rj.n_active, rj.admitted, rj.evicted, rj.released), t
        assert (rt.n_guarded, rt.degraded_level) == \
            (rj.n_guarded, rj.degraded_level), t
        assert [(e.from_level, e.to_level) for e in rt.degradation_events] \
            == [(e.from_level, e.to_level) for e in rj.degradation_events]
        assert [(e.twin_id, e.kind) for e in rt.events] == \
            [(e.twin_id, e.kind) for e in rj.events]
        n_events += len(rt.events)
        if rj.loss is None:
            assert rt.loss is None
        else:
            np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-3,
                                       atol=1e-4, err_msg=f"tick {t}")
        if opts.get("warm"):
            ks.append(_scenario_pair(jsrv, tsrv, 0, what_if))
    if opts.get("warm"):
        assert n_events > 0
    if opts.get("degrade"):
        # each rung was reached: full K, K shrunk 4 -> 1, refused
        assert ks[:5] == [4, 4, 1, 1, None] and set(ks[5:]) == {None}
        for action in ("guard", "refit", "promote"):
            assert tsrv._m_shed[action].value == jsrv._m_shed[action].value > 0
        assert (tsrv._m_scn_shrunk.value, tsrv._m_scn_refused.value) == \
            (jsrv._m_scn_shrunk.value, jsrv._m_scn_refused.value)
    elif opts.get("warm"):
        assert set(ks) == {4}
    deployed = sorted(t for t, r in jsrv.twins.items() if r.deployed)
    assert deployed and deployed == sorted(
        t for t, r in tsrv.twins.items() if r.deployed)
    # the last row is the scratch row: JAX parks losing candidates there,
    # the port writes only winners; no twin ever reads it
    np.testing.assert_allclose(tsrv._theta[:-1].numpy(),
                               np.asarray(jsrv._theta[:-1]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        [tsrv.twins[t].divergence for t in sorted(tsrv.twins)],
        [jsrv.twins[t].divergence for t in sorted(jsrv.twins)],
        rtol=1e-3, atol=1e-5)
    tsrv.packed.check_mirrors()
    tid = deployed[0]
    np.testing.assert_allclose(tsrv.predict(tid, 12).numpy(),
                               np.asarray(jsrv.predict(tid, 12)),
                               rtol=1e-3, atol=1e-4)
    k = _scenario_pair(jsrv, tsrv, tid, what_if[:3])
    assert k == (None if opts.get("degrade") else 3)
    assert tsrv.latency_summary()["ticks"] == ticks
    assert set(tsrv.stage_summary()) == set(jsrv.stage_summary())


# --------------------------------------------------------------------------- #
# staging backpressure: bounded buffer, retries, strict raise or drop-oldest
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("strict", [False, True])
def test_staging_overflow_matches_jax(strict):
    model = dict(n=2, m=1, hidden=8, head_hidden=8)
    server = dict(max_twins=4, capacity=64, window=8, stride=4,
                  windows_per_twin=2, staging_capacity=20,
                  ingest_strict=strict, ingest_retries=1,
                  ingest_backoff_s=0.0)
    jsrv = JaxServer(JaxServerConfig(merinda=JaxMerindaConfig(**model),
                                     guard=JaxGuardConfig(window=8),
                                     **server))
    tsrv = TwinServer(TwinServerConfig(merinda=MerindaConfig(**model),
                                       guard=GuardConfig(window=8),
                                       **server), device="cpu")
    rng = np.random.default_rng(9)
    raised = []
    for rnd in range(3):
        for tid in range(4):
            c = int(rng.integers(3, 10))
            y = rng.normal(size=(c, 2)).astype(np.float32)
            u = rng.normal(size=(c, 1)).astype(np.float32)
            outcome = []
            for srv, overflow in ((jsrv, JaxStagingOverflow),
                                  (tsrv, StagingOverflow)):
                try:
                    srv.ingest(tid, y, u)
                    outcome.append(False)
                except overflow:
                    outcome.append(True)
            assert outcome[0] == outcome[1], (rnd, tid)
            raised.append(outcome[0])
            assert tsrv._staging.pending_samples() == \
                jsrv._staging.pending_samples() <= 20
        jsrv.tick(), tsrv.tick()
    assert any(raised) == strict
    for a, b in ((tsrv._m_ingest_retries, jsrv._m_ingest_retries),
                 (tsrv._m_ingest_dropped, jsrv._m_ingest_dropped)):
        assert a.value == b.value
    assert (tsrv._m_ingest_dropped.value > 0) != strict
    assert [r.samples for r in tsrv.twins.values()] == \
        [r.samples for r in jsrv.twins.values()]
    for key in ("y", "u", "count"):
        np.testing.assert_array_equal(tsrv._rstate[key].numpy(),
                                      np.asarray(jsrv._rstate[key]))

