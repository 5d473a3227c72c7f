"""Crash-safe single-server serving in the port, held to the JAX package.

Mirrors the single-server cases of tests/test_twin_recovery.py (journal,
checkpointer, chaos schedule, ingest backpressure, snapshot/restore round
trip, mismatched shapes) and tests/test_twin_sharded.py's async-ingest
cases, on the port's plain path (device="cpu").  Beyond those:

  * the snapshot tree is the JAX server's, leaf for leaf (paths, shapes,
    dtypes), so checkpoints cross between the packages: a JAX snapshot
    written by JAX's `checkpoint.save` restores into a port server, a port
    snapshot into a JAX server, and the next ticks agree — guard events and
    plans identical, refit losses within rtol 1e-3 / atol 1e-4 (the
    backend-parity tolerance of tests/test_torch_twin.py);
  * a kill at tick 8 with journal replay (`ingest(force=True)`) flags the
    same twins and ends with the same sample counts as the uninterrupted
    run, and a torn newest commit falls back to the one before;
  * `scheduler="reference"` plans what the packed planner plans, tick by
    tick, and what the JAX reference server plans.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.distributed import fault_tolerance as jax_ft
from repro.systems.lotka_volterra import LotkaVolterra
from repro.systems.simulate import simulate_batch
from repro.train import checkpoint as jax_ckpt
from repro.twin.monitor import GuardConfig as JaxGuardConfig
from repro.twin.recovery import TelemetryJournal as JaxJournal
from repro.twin.server import TwinServer as JaxServer
from repro.twin.server import TwinServerConfig as JaxServerConfig
from repro_torch.convert import fleet_state_from_jax, merinda_params_from_jax
from repro_torch.core.merinda import MerindaConfig
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.train import checkpoint
from repro_torch.twin.monitor import GuardConfig
from repro_torch.twin.recovery import (ChaosConfig, ChaosInjector,
                                       RecoveryConfig, ShardFailure,
                                       TelemetryJournal, TwinCheckpointer)
from repro_torch.twin.server import TwinServer, TwinServerConfig
from repro_torch.twin.stream import StagingOverflow


# --------------------------------------------------------------------- #
# telemetry journal: the replay source
# --------------------------------------------------------------------- #
def _chunk(rng, c, n=2, m=1):
    return (rng.normal(size=(c, n)).astype(np.float32),
            rng.normal(size=(c, m)).astype(np.float32))


def test_journal_replays_exact_suffix():
    rng = np.random.default_rng(0)
    j, jj = TelemetryJournal(horizon=100), JaxJournal(horizon=100)
    sent_y, sent_u = [], []
    for c in (3, 5, 4):
        y, u = _chunk(rng, c)
        j.append(7, y, u)
        jj.append(7, y, u)
        sent_y.append(y)
        sent_u.append(u)
    all_y = np.concatenate(sent_y)
    all_u = np.concatenate(sent_u)
    # seen=4 falls INSIDE the second chunk: the first replayed chunk must be
    # trimmed, and the concatenation must equal the true suffix exactly
    chunks, lost = j.replay_since(7, seen=4)
    assert lost == 0
    got_y = np.concatenate([y for y, _ in chunks])
    got_u = np.concatenate([u for _, u in chunks])
    np.testing.assert_array_equal(got_y, all_y[4:])
    np.testing.assert_array_equal(got_u, all_u[4:])
    want, _ = jj.replay_since(7, seen=4)
    assert [len(y) for y, _ in chunks] == [len(y) for y, _ in want]
    # fully caught up -> nothing to replay
    assert j.replay_since(7, seen=12) == ([], 0)
    assert j.total(7) == 12 and j.twin_ids() == [7]


def test_journal_horizon_eviction_counts_lost():
    rng = np.random.default_rng(1)
    j, jj = TelemetryJournal(horizon=6), JaxJournal(horizon=6)
    for _ in range(5):                      # 20 samples, horizon keeps <= ~8
        chunk = _chunk(rng, 4)
        j.append(1, *chunk)
        jj.append(1, *chunk)
    chunks, lost = j.replay_since(1, seen=0)
    got = sum(len(y) for y, _ in chunks)
    assert lost > 0 and lost + got == 20    # every sample accounted for
    assert got >= 6                         # horizon worth is recoverable
    assert lost == jj.replay_since(1, seen=0)[1]
    # the tail inside the horizon is never lost
    _, lost_tail = j.replay_since(1, seen=20 - 6)
    assert lost_tail == 0


def test_journal_concurrent_appends_keep_per_twin_order():
    j = TelemetryJournal(horizon=10_000)

    def pump(tid):
        for i in range(50):
            j.append(tid, np.full((2, 2), i, np.float32))

    threads = [threading.Thread(target=pump, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tid in range(4):
        chunks, lost = j.replay_since(tid, seen=0)
        assert lost == 0
        vals = np.concatenate([y for y, _ in chunks])[:, 0]
        assert list(vals) == sorted(vals)   # chronological per twin


# --------------------------------------------------------------------- #
# checkpointer: atomic commits, GC, torn-write fallback
# --------------------------------------------------------------------- #
def _snap(v):
    """A snapshot with a device tensor (copied by the checkpointer) and a
    host array."""
    return lambda: {"w": torch.full((4, 3), float(v)),
                    "step": np.asarray([v], np.int64)}


def test_checkpointer_roundtrip_and_gc(tmp_path):
    ck = TwinCheckpointer(RecoveryConfig(ckpt_dir=str(tmp_path),
                                         ckpt_every=4, keep=2))
    assert not ck.maybe_save(0, 3, _snap(3))        # off cadence
    for tick in (4, 8, 12):
        assert ck.maybe_save(0, tick, _snap(tick))
    ck.wait()
    assert ck.latest(0) == 12
    tick, state = ck.restore_latest(0, _snap(0)())
    assert tick == 12
    assert isinstance(state["w"], np.ndarray)      # numpy leaves
    np.testing.assert_array_equal(state["w"], np.full((4, 3), 12,
                                                      np.float32))
    kept = sorted(p.name for p in ck.shard_dir(0).glob("step_*"))
    assert len(kept) <= 2                           # GC keeps the last `keep`
    assert ck._m_saves.value == 3 and ck._m_snapshot.count == 3
    assert ck._m_write.count == 3


def test_checkpointer_torn_commit_falls_back(tmp_path):
    ck = TwinCheckpointer(RecoveryConfig(ckpt_dir=str(tmp_path),
                                         ckpt_every=1, keep=2))
    ck.maybe_save(0, 1, _snap(1))
    ck.maybe_save(0, 2, _snap(2))
    assert ck.tear_latest(0) == 2                   # crash mid-write of #2
    tick, state = ck.restore_latest(0, _snap(0)())
    assert tick == 1                                # fell back, didn't corrupt
    np.testing.assert_array_equal(np.asarray(state["step"]), [1])


def test_checkpointer_keep_must_cover_torn_fallback(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        RecoveryConfig(ckpt_dir=str(tmp_path), keep=1)
    with pytest.raises(ValueError, match="ckpt_every"):
        RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=0)


def test_checkpointer_restore_nothing_committed(tmp_path):
    ck = TwinCheckpointer(RecoveryConfig(ckpt_dir=str(tmp_path)))
    assert ck.restore_latest(3, _snap(0)()) == (None, None)


# --------------------------------------------------------------------- #
# chaos injector and the fault-tolerance primitives under it
# --------------------------------------------------------------------- #
def test_chaos_kill_fires_once_even_past_the_tick():
    inj = ChaosInjector(ChaosConfig(kill_shard=1, kill_at_tick=5))
    assert not inj.should_kill(0, 5)                # wrong shard
    assert not inj.should_kill(1, 4)
    assert inj.should_kill(1, 7)                    # >= semantics, skipped 5/6
    assert not inj.should_kill(1, 8)                # one-shot
    err = ShardFailure(1, 7)
    assert isinstance(err, ft.SimulatedPreemption)
    assert (err.shard, err.tick) == (1, 7)


def test_chaos_windows():
    inj = ChaosInjector(ChaosConfig(slow_shard=0, slow_s=0.5,
                                    slow_from_tick=3, slow_until_tick=5,
                                    storm_shard=1, storm_factor=3,
                                    storm_from_tick=2, storm_until_tick=4,
                                    torn_checkpoint=True))
    assert inj.slow_delay(0, 2) == 0.0
    assert inj.slow_delay(0, 4) == 0.5
    assert inj.slow_delay(1, 4) == 0.0
    assert inj.storm_extra(1, 3) == 2
    assert inj.storm_extra(1, 4) == 0
    assert inj.should_tear() and not inj.should_tear()   # one-shot


def test_fault_tolerance_primitives_match_jax():
    for n in (1, 4, 8, 16, 40, 256, 512):
        assert ft.elastic_plan(n) == jax_ft.elastic_plan(n)
        assert ft.elastic_plan(n, model_axis=4) == \
            jax_ft.elastic_plan(n, model_axis=4)
    inj = ft.FailureInjector(fail_at_step=3)
    inj.maybe_fail(2)
    with pytest.raises(ft.SimulatedPreemption):
        inj.maybe_fail(5)
    inj.maybe_fail(6)                               # fires once
    hb = ft.Heartbeat(timeout_s=0.0)
    hb.beat(4)
    assert hb.step == 4
    assert ft.Heartbeat(timeout_s=3600.0).stalled() is False


# --------------------------------------------------------------------- #
# servers: the Lotka-Volterra world of the JAX tests
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lv_world():
    sys_ = LotkaVolterra()
    tr = simulate_batch(sys_, jax.random.PRNGKey(0), batch=8, horizon=400,
                        noise_std=0.002)
    true = np.asarray(sys_.true_theta(sys_.library()), np.float32)
    return sys_.spec.dt, np.asarray(tr.ys_noisy), np.asarray(tr.us), true


_MODEL = dict(n=2, m=0, order=2, hidden=8, head_hidden=8, n_active=4)
_SERVER = dict(max_twins=6, refit_slots=2, capacity=128, window=16,
               stride=8, windows_per_twin=4, steps_per_tick=1,
               deploy_after=2, min_residency=1, max_residency=4)


def _server_cfg(dt, **kw):
    return TwinServerConfig(merinda=MerindaConfig(**_MODEL, dt=dt),
                            guard=GuardConfig(window=16),
                            **{**_SERVER, **kw})


def _jax_cfg(dt, **kw):
    return JaxServerConfig(merinda=JaxMerindaConfig(**_MODEL, dt=dt),
                           guard=JaxGuardConfig(window=16),
                           **{**_SERVER, **kw})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _JaxDraws:
    """The JAX server's random stream (`TwinServer._split` order: one key
    for `fleet.init`, then one per admission), converted; its init-source
    state is the JAX key itself."""

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

    def state(self):
        return np.asarray(self.key, np.uint32)

    def load(self, state):
        self.key = jnp.asarray(np.asarray(state, np.uint32))


def _feed(srv, ys, t, twins=4, chunk=20):
    for i in range(twins):
        srv.ingest(i, ys[i, t * chunk:(t + 1) * chunk])


def _warm(srv, ys, true, ticks=6):
    """Six ticks of telemetry with twin 0 deployed with the true model and
    twin 1 with a wrong one at tick 2: guard events and refits."""
    reports = []
    for t in range(ticks):
        _feed(srv, ys, t)
        if t == 1:
            srv.deploy(0, true)
            srv.deploy(1, -true)
        reports.append(srv.tick())
    return reports


def test_torch_init_source_resumes_from_its_state(lv_world):
    """The default init source's uint32[2] state (seed, draws) resumes its
    admission stream exactly: a fresh source loaded with another's state
    draws what that one draws next."""
    dt, _, _, _ = lv_world
    srv = TwinServer(_server_cfg(dt, seed=11), device="cpu")
    a = srv._init
    for _ in range(3):
        a.slot_init()
    state = a.state()
    assert state.dtype == np.uint32 and state.tolist() == [11, 3]
    b = TwinServer(_server_cfg(dt), device="cpu")._init
    b.load(state)
    pa, pb = a.slot_init(), b.slot_init()
    for x, y in zip(checkpoint.tree_flatten(pa)[0],
                    checkpoint.tree_flatten(pb)[0]):
        assert torch.equal(x, y)


def test_server_ingest_backpressure_sheds_oldest(lv_world):
    """Non-strict bounded staging: overload drops the OLDEST staged samples
    (counted) and keeps serving; strict mode raises to the producer, and
    `force=True` (the replay path) bypasses the bound."""
    dt, ys, us, _ = lv_world
    srv = TwinServer(_server_cfg(dt, staging_capacity=16,
                                 ingest_strict=False, ingest_retries=1,
                                 ingest_backoff_s=1e-4), device="cpu")
    try:
        for k in range(5):                          # 40 > 16 staged samples
            srv.ingest(k % 2, ys[0, k * 8:(k + 1) * 8])
        assert int(srv._m_ingest_dropped.value) > 0
        assert int(srv._m_ingest_retries.value) > 0
        srv.tick()                                  # still serves
        assert srv.twins[0].samples + srv.twins[1].samples <= 16
    finally:
        srv.close()
    strict = TwinServer(_server_cfg(dt, staging_capacity=8,
                                    ingest_retries=0), device="cpu")
    try:
        strict.ingest(0, ys[0, :8])
        with pytest.raises(StagingOverflow):
            strict.ingest(1, ys[1, :8])
        strict.ingest(1, ys[1, :8], force=True)     # replay path bypasses
        assert strict.ingest_many([(2, ys[2, :8])], force=True) == 8
        assert strict._staging.pending_samples() == 24
    finally:
        strict.close()


def test_server_snapshot_restore_roundtrip(lv_world, tmp_path):
    """A fresh server restored from a checkpointed snapshot serves
    indistinguishably: same registry, thetas, predictions, guard and
    scheduler state, and the same next tick, bit for bit on the CPU."""
    dt, ys, _, true = lv_world
    cfg = _server_cfg(dt)
    srv = TwinServer(cfg, device="cpu")
    _warm(srv, ys, true)
    checkpoint.save(tmp_path, srv.tick_count, srv.snapshot_state())
    twin = TwinServer(cfg, share_modules_from=srv)
    assert twin.fleet is srv.fleet and twin.device == srv.device
    twin.restore_state(checkpoint.restore(tmp_path, srv.tick_count,
                                          twin.snapshot_state()))
    assert twin.tick_count == srv.tick_count
    assert sorted(twin.twins) == sorted(srv.twins)
    for tid, rec in srv.twins.items():
        assert dataclasses.asdict(twin.twins[tid]) == dataclasses.asdict(rec)
    assert twin._guard_state == srv._guard_state
    assert twin._slot_twin == srv._slot_twin
    assert sorted(twin._guard_live) == sorted(srv._guard_live)
    assert twin._div is twin.packed.divergence      # aliasing kept
    assert torch.equal(twin._theta, srv._theta)
    assert torch.equal(twin.predict(0, 10), srv.predict(0, 10))
    np.testing.assert_array_equal(twin._init.state(), srv._init.state())
    for t in (6, 7, 8):                 # both continue identically
        _feed(srv, ys, t)
        _feed(twin, ys, t)
        r1, r2 = srv.tick(), twin.tick()
        assert (r1.n_guarded, r1.admitted, r1.evicted, r1.released) == \
            (r2.n_guarded, r2.admitted, r2.evicted, r2.released)
        assert [(e.twin_id, e.kind) for e in r1.events] == \
            [(e.twin_id, e.kind) for e in r2.events]
        assert r1.loss == r2.loss
    assert torch.equal(twin._theta, srv._theta)


def test_restore_rejects_mismatched_shapes(lv_world, tmp_path):
    dt, _, _, _ = lv_world
    srv = TwinServer(_server_cfg(dt), device="cpu")
    other = TwinServer(_server_cfg(dt, max_twins=8), device="cpu")
    snap = checkpoint.to_host(srv.snapshot_state())
    with pytest.raises((ValueError, KeyError)):
        other.packed.load(snap["packed"])
    checkpoint.save(tmp_path, 1, srv.snapshot_state())
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(tmp_path, 1, other.snapshot_state())
    with pytest.raises(ValueError, match="share_modules_from"):
        TwinServer(_server_cfg(dt, max_twins=8), share_modules_from=srv)


# --------------------------------------------------------------------- #
# async ingest (tests/test_twin_sharded.py's single-server cases)
# --------------------------------------------------------------------- #
def test_async_ingest_no_drops_no_duplicates(lv_world):
    """Concurrent ingest threads + serving ticks: after drain, per-twin
    sample accounting and ring write heads both match exactly what was sent
    (no drops, no duplicates)."""
    dt, ys, us, _ = lv_world
    srv = TwinServer(_server_cfg(dt, max_twins=4, async_ingest=True),
                     device="cpu")
    try:
        n_tw, chunks, chunk = 4, 24, 5
        sent = {i: 0 for i in range(n_tw)}

        def pump(i):
            for c in range(chunks):
                lo = (c * chunk) % 300
                srv.ingest(i, ys[i, lo:lo + chunk], us[i, lo:lo + chunk])
                sent[i] += chunk

        threads = [threading.Thread(target=pump, args=(i,))
                   for i in range(n_tw)]
        for t in threads:
            t.start()
        for _ in range(6):
            srv.tick()
        for t in threads:
            t.join()
        srv.drain()
        for i in range(n_tw):
            rec = srv.twins[i]
            assert rec.samples == sent[i] == chunks * chunk
            assert int(srv._rstate["count"][rec.ring_slot]) == sent[i]
        assert srv._m_queue.value == 0
        assert srv._m_prepare.count > 0
    finally:
        srv.close()


def test_async_ingest_preserves_chronology(lv_world):
    """Samples land in the ring in ingest order even when flushes are
    prepared on the background thread across several ticks; the ring
    equals the synchronous server's, bit for bit."""
    dt, ys, us, _ = lv_world
    srv = TwinServer(_server_cfg(dt, max_twins=2, async_ingest=True),
                     device="cpu")
    sync = TwinServer(_server_cfg(dt, max_twins=2), device="cpu")
    try:
        for c in range(10):
            for s in (srv, sync):
                s.ingest(0, ys[0, c * 10:(c + 1) * 10])
            if c % 3 == 0:
                srv.tick()
                sync.tick()
        srv.drain()
        sync.drain()
        yl, _ = srv.ring.latest(srv._rstate, torch.tensor([0]), 20)
        np.testing.assert_allclose(yl[0].numpy(), ys[0, 79:100], rtol=1e-6)
        for k in ("y", "u", "count"):
            assert torch.equal(srv._rstate[k], sync._rstate[k])
    finally:
        srv.close()


# --------------------------------------------------------------------- #
# the reference planner inside the server
# --------------------------------------------------------------------- #
def test_reference_scheduler_serves_like_packed_and_jax(lv_world):
    """`scheduler="reference"` admits, evicts and releases exactly as the
    packed planner does, tick by tick, and as the JAX reference server;
    with the same draws, the losses agree too."""
    dt, ys, _, true = lv_world
    jsrv = JaxServer(_jax_cfg(dt, scheduler="reference", seed=3))
    ref = TwinServer(_server_cfg(dt, scheduler="reference"), device="cpu",
                     init_source=_JaxDraws(jsrv.fleet, 3))
    packed = TwinServer(_server_cfg(dt), device="cpu",
                        init_source=_JaxDraws(jsrv.fleet, 3))
    turnover = 0
    for t in range(12):
        for s in (jsrv, ref, packed):
            _feed(s, ys, t % 18, twins=6)
            if t == 1:
                s.deploy(0, true)
        rj, rr, rp = jsrv.tick(), ref.tick(), packed.tick()
        for r in (rr, rp):
            assert (r.admitted, r.evicted, r.released) == \
                (rj.admitted, rj.evicted, rj.released), t
            assert [(e.twin_id, e.kind) for e in r.events] == \
                [(e.twin_id, e.kind) for e in rj.events], t
        assert rr.loss == rp.loss
        if rj.loss is not None:
            np.testing.assert_allclose(rr.loss, rj.loss, rtol=1e-3,
                                       atol=1e-4)
        turnover += len(rj.admitted) + len(rj.evicted) + len(rj.released)
    assert turnover > 4


# --------------------------------------------------------------------- #
# checkpoints across the two packages
# --------------------------------------------------------------------- #
def test_snapshot_tree_matches_jax_leaf_for_leaf(lv_world):
    dt, _, _, _ = lv_world
    jsnap = _np(jax.device_get(JaxServer(_jax_cfg(dt)).snapshot_state()))
    tsnap = TwinServer(_server_cfg(dt), device="cpu").snapshot_state()
    leaves, paths = checkpoint.tree_flatten(checkpoint.to_host(tsnap))
    assert paths == jax_ckpt._tree_paths(jsnap)
    for p, a, b in zip(paths, leaves, jax.tree.leaves(jsnap)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), p


def _next_ticks_agree(a, b, ys, ticks=(6, 7, 8)):
    """Both servers take the same telemetry; plans and guard events equal,
    losses within the backend-parity tolerance.  Returns the admissions."""
    admitted = 0
    for t in ticks:
        _feed(a, ys, t)
        _feed(b, ys, t)
        ra, rb = a.tick(), b.tick()
        assert ra.tick == rb.tick
        assert (ra.n_guarded, ra.admitted, ra.evicted, ra.released) == \
            (rb.n_guarded, rb.admitted, rb.evicted, rb.released), t
        assert [(e.twin_id, e.kind) for e in ra.events] == \
            [(e.twin_id, e.kind) for e in rb.events], t
        assert (ra.loss is None) == (rb.loss is None)
        if ra.loss is not None:
            np.testing.assert_allclose(ra.loss, rb.loss, rtol=1e-3,
                                       atol=1e-4, err_msg=f"tick {t}")
        admitted += len(ra.admitted)
    return admitted


# a residency of 2 ticks: the slots turn over within the compared ticks, so
# admissions draw from the restored key
_CHURN = dict(max_residency=2)


def test_jax_checkpoint_restores_into_a_port_server(lv_world, tmp_path):
    dt, ys, _, true = lv_world
    jsrv = JaxServer(_jax_cfg(dt, **_CHURN))
    _warm(jsrv, ys, true)
    jax_ckpt.save(tmp_path, jsrv.tick_count, jsrv.snapshot_state())
    tsrv = TwinServer(_server_cfg(dt, **_CHURN), device="cpu",
                      init_source=_JaxDraws(jsrv.fleet, 99))
    tsrv.restore_state(checkpoint.restore(tmp_path, jsrv.tick_count,
                                          tsrv.snapshot_state()))
    np.testing.assert_array_equal(tsrv._init.state(), np.asarray(jsrv._key))
    assert tsrv._guard_state == jsrv._guard_state
    assert tsrv._slot_twin == jsrv._slot_twin
    # the restored port server draws JAX's next keys at its admissions
    assert _next_ticks_agree(jsrv, tsrv, ys) > 0


def test_port_checkpoint_restores_into_a_jax_server(lv_world, tmp_path):
    dt, ys, _, true = lv_world
    jfleet = JaxServer(_jax_cfg(dt, **_CHURN)).fleet
    tsrv = TwinServer(_server_cfg(dt, **_CHURN), device="cpu",
                      init_source=_JaxDraws(jfleet, 5))
    _warm(tsrv, ys, true)
    checkpoint.save(tmp_path, tsrv.tick_count, tsrv.snapshot_state())
    jsrv = JaxServer(_jax_cfg(dt, **_CHURN))
    like = _np(jax.device_get(jsrv.snapshot_state()))
    jsrv.restore_state(jax_ckpt.restore(tmp_path, tsrv.tick_count, like))
    np.testing.assert_array_equal(np.asarray(jsrv._key), tsrv._init.state())
    assert jsrv._guard_state == tsrv._guard_state
    assert _next_ticks_agree(tsrv, jsrv, ys) > 0


# --------------------------------------------------------------------- #
# kill, restore the newest commit, replay the journal
# --------------------------------------------------------------------- #
def _serve_with_journal(cfg, ys, true, ticks, ck=None, journal=None,
                        srv=None, start=0):
    srv = TwinServer(cfg, device="cpu") if srv is None else srv
    for t in range(start, ticks):
        for i in range(4):
            chunk = ys[i, t * 20:(t + 1) * 20]
            if journal is not None:
                journal.append(i, chunk)
            srv.ingest(i, chunk)
        if t == 1:
            srv.deploy(0, true)
            srv.deploy(1, -true)
        srv.tick()
        if ck is not None:
            ck.maybe_save(0, srv.tick_count, srv.snapshot_state)
    return srv


@pytest.mark.parametrize("torn", [False, True])
def test_kill_restore_and_replay_matches_uninterrupted(lv_world, tmp_path,
                                                       torn):
    """A server dropped at tick 8 (checkpoints every 3 ticks) is rebuilt
    from the newest commit — or, with that commit torn, the one before —
    and the journal suffix is replayed with `force=True`.  It ends at tick
    14 with the uninterrupted run's sample counts (0 lost) and guard
    state."""
    dt, ys, _, true = lv_world
    cfg = _server_cfg(dt)
    base = _serve_with_journal(cfg, ys, true, 14)
    journal = TelemetryJournal(horizon=cfg.capacity)
    ck = TwinCheckpointer(RecoveryConfig(ckpt_dir=str(tmp_path),
                                         ckpt_every=3, keep=2))
    dead = _serve_with_journal(cfg, ys, true, 8, ck=ck, journal=journal)
    del dead
    if torn:
        assert ck.tear_latest(0) == 6
    fresh = TwinServer(cfg, device="cpu")
    tick, state = ck.restore_latest(0, fresh.snapshot_state())
    assert tick == (3 if torn else 6)
    fresh.restore_state(state)
    lost = 0
    for tid in journal.twin_ids():
        chunks, n_lost = journal.replay_since(tid, fresh.twins[tid].samples)
        lost += n_lost
        fresh.ingest_many([(tid, y) for y, _ in chunks], force=True)
    assert lost == 0
    # a restart serves from the checkpoint's tick on: replayed telemetry
    # is flushed by the next tick, then new telemetry continues
    srv = _serve_with_journal(cfg, ys, true, 14, journal=journal, srv=fresh,
                              start=8)
    assert {t: r.samples for t, r in srv.twins.items()} == \
        {t: r.samples for t, r in base.twins.items()}
    flagged = lambda s: {t for t, k in s._guard_state.items() if k != "OK"}
    assert flagged(srv) == flagged(base) and 1 in flagged(base)
    assert ck._m_restores.value == 1
