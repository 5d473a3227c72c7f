"""The port's sharded serving: slot federation, the in-process
`ShardedTwinServer`, its supervisor, and parity with the JAX package.

Ports tests/test_twin_sharded.py (guard rotation, staging and flush
preparation, the federation grant cap in the planner, federation rebalance,
the sharded server end to end, shared modules; its async-ingest cases live
in tests/test_torch_recovery_serving.py) and tests/test_twin_recovery.py's
federation-on-dead-shards and chaos-lane cases (kill one of 4 shards at
1,024 twins, torn checkpoint, degradation, slow shard, ingest storm), at
the JAX tests' sizes, on the port's plain path (device="cpu").

Beyond those: a 2-shard Lotka-Volterra fleet started from the JAX
package's own draws (`init_sources`) serves 12 ticks with refits beside
JAX's `ShardedTwinServer` on the same telemetry -- grants, admissions and
guard events equal tick by tick, losses within rtol 1e-3 / atol 1e-4 (the
backend-parity tolerance of tests/test_torch_twin.py).
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.systems.lotka_volterra import LotkaVolterra
from repro.systems.simulate import simulate_batch
from repro.twin.monitor import GuardConfig as JaxGuardConfig
from repro.twin.scheduler import FederationConfig as JaxFederationConfig
from repro.twin.scheduler import SlotFederation as JaxSlotFederation
from repro.twin.server import TwinServerConfig as JaxServerConfig
from repro.twin.sharded import ShardedTwinConfig as JaxShardedConfig
from repro.twin.sharded import ShardedTwinServer as JaxSharded
from repro_torch.convert import fleet_state_from_jax, merinda_params_from_jax
from repro_torch.core.merinda import MerindaConfig
from repro_torch.twin.monitor import GuardConfig, GuardRotation
from repro_torch.twin.recovery import (ChaosConfig, DegradationConfig,
                                       RecoveryConfig)
from repro_torch.twin.scheduler import (FederationConfig, RefitScheduler,
                                        SchedulerConfig, SlotFederation,
                                        TwinRecord)
from repro_torch.twin.server import TwinServer, TwinServerConfig
from repro_torch.twin.sharded import ShardedTwinConfig, ShardedTwinServer
from repro_torch.twin.stream import StagingBuffer, prepare_flush


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread: the tiny shapes here run fastest on one,
    and the timed chaos cases must not share the cores with a thread pool
    per test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# guard rotation (pure host logic)
# --------------------------------------------------------------------- #
def test_rotation_covers_every_twin_within_bound():
    """Round-robin freshness floor: every eligible twin is scored within
    ceil(twins / budget) ticks, regardless of the divergence pattern."""
    n, budget = 23, 5
    rot = GuardRotation(budget=budget, carry=2)
    rows = np.arange(n)
    div = np.zeros(n)
    div[[4, 17]] = 3.0                                  # permanently flagged
    bound = -(-n // budget)                              # ceil(23/5) = 5
    last_scored = {row: 0 for row in range(n)}
    for tick in range(1, 4 * bound + 1):
        for row in rot.select(rows, div, threshold=0.1):
            last_scored[int(row)] = tick
        gaps = [tick - t for t in last_scored.values()]
        assert max(gaps) <= bound, f"tick {tick}: twin starved {max(gaps)}"


def test_rotation_carry_rescores_flagged_every_tick():
    rot = GuardRotation(budget=2, carry=2)
    rows = np.arange(10)
    div = np.zeros(10)
    div[7] = 5.0                                        # flagged
    hits = sum(7 in rot.select(rows, div, threshold=0.1) for _ in range(5))
    assert hits == 5                                    # carry-over every tick


def test_rotation_fixed_fused_width():
    rot = GuardRotation(budget=3, carry=1)
    assert rot.size == 4
    pick = rot.select(np.arange(3), np.asarray([0.0, 9.0, 9.0]),
                      threshold=0.1)
    assert len(pick) <= 4 and len(set(pick.tolist())) == len(pick)


# --------------------------------------------------------------------- #
# staging buffer + flush preparation (thread-safety, overflow)
# --------------------------------------------------------------------- #
def test_staging_swap_is_atomic_handoff():
    buf = StagingBuffer()
    buf.append(0, np.ones((4, 2), np.float32), np.zeros((4, 1), np.float32))
    taken = buf.swap()
    assert list(taken) == [0] and buf.empty()
    assert buf.staged_samples == 4 and buf.swapped_samples == 4
    assert buf.swap() == {}


def test_staging_concurrent_appends_lose_nothing():
    buf = StagingBuffer()
    per_thread, n_threads = 200, 8

    def pump(row):
        for _ in range(per_thread):
            buf.append(row, np.ones((1, 2), np.float32),
                       np.zeros((1, 1), np.float32))

    threads = [threading.Thread(target=pump, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    taken = buf.swap()
    total = sum(len(c[0]) for chunks in taken.values() for c in chunks)
    assert total == per_thread * n_threads


def test_prepare_flush_overflow_raises_not_wraps():
    """A chunk the padded buffer cannot hold must raise, not silently lap."""
    staged = {0: [(np.ones((12, 2), np.float32),
                   np.zeros((12, 1), np.float32))]}
    with pytest.raises(RuntimeError, match="lap"):
        prepare_flush(staged, capacity=8, pad=4, scratch=3, n=2, m=1)


def test_prepare_flush_accounts_raw_received():
    staged = {1: [(np.ones((30, 2), np.float32),
                   np.zeros((30, 1), np.float32)),
                  (2 * np.ones((10, 2), np.float32),
                   np.zeros((10, 1), np.float32))]}
    batch = prepare_flush(staged, capacity=32, pad=8, scratch=5, n=2, m=1)
    assert batch.received == {1: 40}            # raw, pre-truncation
    assert int(batch.counts[0]) == 32           # newest capacity-worth kept
    np.testing.assert_allclose(batch.ys[0, -10:], 2.0)


# --------------------------------------------------------------------- #
# scheduler: federation grant cap
# --------------------------------------------------------------------- #
def _sched(**kw):
    d = dict(slots=4, min_samples=10, min_residency=2, max_residency=8,
             evict_margin=0.5)
    d.update(kw)
    return RefitScheduler(SchedulerConfig(**d))


def _resident(tid, slot, **kw):
    d = dict(twin_id=tid, ring_slot=tid, refit_slot=slot, samples=50,
             deployed=True, samples_at_deploy=50, residency=4)
    d.update(kw)
    return TwinRecord(**d)


def test_plan_respects_grant_cap_on_admission():
    s = _sched()
    twins = {i: TwinRecord(twin_id=i, ring_slot=i, samples=20)
             for i in range(6)}
    plan = s.plan(twins, max_active=2)
    assert len(plan.admit) == 2                 # 4 physical, grant only 2


def test_plan_sheds_lowest_priority_when_grant_shrinks():
    s = _sched()
    twins = {i: _resident(i, i) for i in range(4)}
    twins[2].divergence = 9.0                   # highest priority: keep
    plan = s.plan(twins, max_active=1)
    assert len(plan.release) == 3 and 2 not in plan.release


def test_federation_moves_slots_toward_pressure():
    fed = SlotFederation(FederationConfig(total_slots=6, min_shard_slots=1,
                                          pressure_smooth=1.0), [4, 4])
    assert fed.rebalance([1.0, 1.0]) == [3, 3]          # symmetric demand
    grants = fed.rebalance([0.1, 10.0])
    assert grants[1] > grants[0] and sum(grants) == 6
    assert grants == [2, 4]                             # clamped at physical


def test_federation_floor_keeps_idle_shard_alive():
    fed = SlotFederation(FederationConfig(total_slots=4, min_shard_slots=1,
                                          pressure_smooth=1.0), [4, 4])
    assert fed.rebalance([0.0, 50.0]) == [1, 3]


def test_federation_grants_match_jax_on_random_pressures():
    """The port's rebalance is the JAX package's, grant for grant, over a
    seeded stream of pressures with deaths and restarts."""
    rng = np.random.default_rng(3)
    pools = [4, 8, 2, 6]
    port = SlotFederation(FederationConfig(13, 1, 0.5), pools)
    ref = JaxSlotFederation(JaxFederationConfig(13, 1, 0.5), pools)
    for _ in range(200):
        p = (rng.exponential(size=4) * (rng.random(4) < 0.8)).tolist()
        alive = (rng.random(4) < 0.85).tolist()
        assert port.rebalance(p, alive) == ref.rebalance(p, alive)
        assert port.pressures == ref.pressures


# --------------------------------------------------------------------- #
# federation: dead shards give their slots to the survivors
# --------------------------------------------------------------------- #
def test_federation_dead_shard_grant_flows_to_survivors():
    fed = SlotFederation(FederationConfig(total_slots=8, min_shard_slots=1,
                                          pressure_smooth=1.0), [4, 4, 4])
    base = fed.rebalance([1.0, 1.0, 1.0])
    assert sum(base) == 8 and all(g >= 1 for g in base)
    dead = fed.rebalance([1.0, 0.0, 1.0], alive=[True, False, True])
    assert dead[1] == 0                             # no floor for the dead
    assert sum(dead) <= 8 and dead[0] + dead[2] == sum(dead)
    assert dead[0] >= base[0] and dead[2] >= base[2]
    back = fed.rebalance([1.0, 1.0, 1.0], alive=[True, True, True])
    assert back[1] >= 1                             # restart rejoins the floor


def test_federation_all_dead_parks_the_budget():
    fed = SlotFederation(FederationConfig(total_slots=6, min_shard_slots=1,
                                          pressure_smooth=1.0), [3, 3])
    assert fed.rebalance([1.0, 1.0], alive=[False, False]) == [0, 0]


# --------------------------------------------------------------------- #
# sharded server end to end (tiny model)
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lv_world():
    sys_ = LotkaVolterra()
    tr = simulate_batch(sys_, jax.random.PRNGKey(0), batch=8, horizon=400,
                        noise_std=0.002)
    true = np.asarray(sys_.true_theta(sys_.library()), np.float32)
    return sys_.spec.dt, np.asarray(tr.ys_noisy), np.asarray(tr.us), true


_MODEL = dict(n=2, m=0, order=2, hidden=8, head_hidden=8, n_active=4)
_SERVER = dict(max_twins=6, refit_slots=2, capacity=128, window=16, stride=8,
               windows_per_twin=4, steps_per_tick=1, deploy_after=2,
               min_residency=1, max_residency=4)


def _server_cfg(dt, **kw):
    return TwinServerConfig(merinda=MerindaConfig(**_MODEL, dt=dt),
                            guard=GuardConfig(window=16),
                            **{**_SERVER, **kw})


def _sharded(cfg, **kw):
    return ShardedTwinServer(cfg, device="cpu", **kw)


def test_sharded_routes_and_serves(lv_world):
    dt, ys, us, _ = lv_world
    srv = _sharded(ShardedTwinConfig.uniform(_server_cfg(dt), 2,
                                             total_slots=3))
    try:
        for t in range(8):
            for i in range(6):
                srv.ingest(i, ys[i, t * 10:(t + 1) * 10],
                           us[i, t * 10:(t + 1) * 10])
            rep = srv.tick()
        assert rep.n_twins == 6
        assert rep.n_active <= 3                 # global grant respected
        assert sum(srv.grants) == 3
        # placement is modulo and sticky
        assert srv.shard_of(4) == 0 and srv.shard_of(5) == 1
        assert sorted(srv.shards[0].twins) == [0, 2, 4]
        assert len(srv.latencies) == 8
        # per-shard instruments share one registry under a shard label
        text = srv.metrics.expose()
        assert 'shard="0"' in text and 'shard="1"' in text
    finally:
        srv.close()


def test_sharded_grants_follow_divergence_pressure(lv_world):
    """Slots migrate toward the shard whose twins diverged: deploy WRONG
    physics on shard 1's twins, right physics on shard 0's."""
    dt, ys, us, true = lv_world
    srv = _sharded(ShardedTwinConfig.uniform(
        _server_cfg(dt, deploy_after=10 ** 6), 2,
        total_slots=3, rebalance_every=2, pressure_smooth=1.0))
    try:
        srv.deploy_many([0, 2, 4], true)         # shard 0: healthy models
        srv.deploy_many([1, 3, 5], -true)        # shard 1: wrong physics
        for t in range(8):
            for i in range(6):
                srv.ingest(i, ys[i, t * 10:(t + 1) * 10],
                           us[i, t * 10:(t + 1) * 10])
            srv.tick()
        assert srv.grants[1] > srv.grants[0]     # slots followed the pressure
        assert any(e.twin_id % 2 == 1 for e in
                   [e for s in srv.shards for e in s.events])
    finally:
        srv.close()


def test_guard_rotation_budget_bounds_fused_width(lv_world):
    """With guard_budget set, every tick scores at most budget+carry twins,
    and all deployed twins are still scored within the rotation bound."""
    dt, ys, us, true = lv_world
    budget = 2
    srv = TwinServer(_server_cfg(dt, deploy_after=10 ** 6,
                                 guard_budget=budget, guard_carry=1),
                     device="cpu")
    n_tw = 6
    for t in range(5):                  # enough samples for the guard window
        for i in range(n_tw):
            srv.ingest(i, ys[i, t * 10:(t + 1) * 10],
                       us[i, t * 10:(t + 1) * 10])
        srv.tick()
    for i in range(n_tw):
        srv.deploy(i, true)
    bound = -(-n_tw // budget)          # ceil(6/2) = 3 ticks
    scored_ticks = {i: None for i in range(n_tw)}
    for t in range(5, 5 + bound):
        for i in range(n_tw):
            srv.ingest(i, ys[i, t * 10:(t + 1) * 10],
                       us[i, t * 10:(t + 1) * 10])
        rep = srv.tick()
        assert rep.n_guarded <= budget + 1
        for i in range(n_tw):
            if scored_ticks[i] is None and srv.twins[i].divergence != 0.0:
                scored_ticks[i] = rep.tick
    assert all(v is not None for v in scored_ticks.values())


def test_shared_modules_require_identical_shapes(lv_world):
    dt, _, _, _ = lv_world
    a = TwinServer(_server_cfg(dt), device="cpu")
    with pytest.raises(ValueError, match="identical"):
        TwinServer(_server_cfg(dt, refit_slots=4), share_modules_from=a)
    b = TwinServer(_server_cfg(dt), share_modules_from=a)
    assert b.ring is a.ring and b.fleet is a.fleet and b.guard is a.guard


def test_sharded_shares_modules_and_seeds_shards_apart(lv_world):
    """Identical shard configs share one set of modules; each shard draws
    its own parameters (seed + i), and `init_sources` must name one source
    per shard."""
    dt, _, _, _ = lv_world
    cfg = ShardedTwinConfig.uniform(_server_cfg(dt), 3)
    srv = _sharded(cfg)
    try:
        s0, s1, s2 = srv.shards
        assert s0.fleet is s1.fleet is s2.fleet
        w0, w1 = (s._fstate["params"]["gru"]["wh"] for s in (s0, s1))
        assert not torch.equal(w0, w1)
        assert [int(s._init.seed) for s in srv.shards] == [0, 1, 2]
    finally:
        srv.close()
    with pytest.raises(ValueError, match="init sources"):
        _sharded(cfg, init_sources=[None, None])


def test_sharded_raises_without_a_card(monkeypatch, lv_world):
    dt, _, _, _ = lv_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedTwinServer(ShardedTwinConfig.uniform(_server_cfg(dt), 2))


# --------------------------------------------------------------------- #
# parity: the port's sharded fleet beside the JAX package's
# --------------------------------------------------------------------- #
class _JaxDraws:
    """The JAX server's random stream (`TwinServer._split` order: one key
    for `fleet.init`, then one per admission), converted."""

    def __init__(self, jfleet, seed):
        self.jfleet, self.key = jfleet, jax.random.PRNGKey(seed)

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def fleet_init(self):
        return fleet_state_from_jax(jax.tree.map(
            np.asarray, self.jfleet.init(self._split())))

    def slot_init(self):
        return merinda_params_from_jax(jax.tree.map(
            np.asarray, self.jfleet.model.init(self._split())))

    def state(self):
        return np.asarray(self.key, np.uint32)

    def load(self, state):
        self.key = jax.numpy.asarray(np.asarray(state, np.uint32))


def test_sharded_parity_with_jax(lv_world):
    """2 shards, a global budget of 3 slots rebalanced every 2 ticks, half
    the twins warm-started with wrong physics: 12 ticks with refits and
    promotions on both packages, from the JAX shards' own draws."""
    dt, ys, us, true = lv_world
    kw = dict(total_slots=3, rebalance_every=2, pressure_smooth=0.5)
    jcfg = JaxShardedConfig.uniform(JaxServerConfig(
        merinda=JaxMerindaConfig(**_MODEL, dt=dt),
        guard=JaxGuardConfig(window=16), **_SERVER), 2, **kw)
    jsrv = JaxSharded(jcfg)
    tsrv = _sharded(ShardedTwinConfig.uniform(_server_cfg(dt), 2, **kw),
                    init_sources=[_JaxDraws(s.fleet, s.cfg.seed + i)
                                  for i, s in enumerate(jsrv.shards)])
    try:
        thetas = np.stack([true if i % 3 else -true for i in range(6)])
        jsrv.deploy_many(list(range(6)), thetas)
        tsrv.deploy_many(list(range(6)), thetas)
        n_events = n_admitted = n_losses = 0
        for t in range(12):
            batch = [(i, ys[i, t * 10:(t + 1) * 10], us[i, t * 10:(t + 1) * 10])
                     for i in range(6)]
            jsrv.ingest_many(batch)
            tsrv.ingest_many(batch)
            rj, rt = jsrv.tick(), tsrv.tick()
            assert rt.grants == rj.grants, t
            assert (rt.n_active, rt.n_twins, rt.n_guarded) == \
                (rj.n_active, rj.n_twins, rj.n_guarded), t
            assert [(e.tick, e.twin_id, e.kind) for e in rt.events] == \
                [(e.tick, e.twin_id, e.kind) for e in rj.events], t
            n_events += len(rt.events)
            for a, b in zip(rt.reports, rj.reports):
                assert (a.admitted, a.evicted, a.released) == \
                    (b.admitted, b.evicted, b.released), t
                n_admitted += len(a.admitted)
                if b.loss is None:
                    assert a.loss is None
                else:
                    n_losses += 1
                    np.testing.assert_allclose(a.loss, b.loss, rtol=1e-3,
                                               atol=1e-4, err_msg=f"tick {t}")
        np.testing.assert_allclose(tsrv.federation.pressures,
                                   jsrv.federation.pressures, rtol=1e-3,
                                   atol=1e-4)
        promoted = [tid for s in tsrv.shards for tid, r in s.twins.items()
                    if r.deploy_tick > 0]
        # the run exercised what it claims to: events, refits, promotions
        assert n_events and n_admitted and n_losses >= 8 and promoted
    finally:
        jsrv.close()
        tsrv.close()


# --------------------------------------------------------------------- #
# chaos lane: fault-injected sharded serving
# --------------------------------------------------------------------- #
def _fleet_cfg(dt, shards, twins_per_shard, **kw):
    scfg = TwinServerConfig(
        merinda=MerindaConfig(**_MODEL, dt=dt),
        max_twins=twins_per_shard, refit_slots=4, capacity=64,
        window=16, stride=8, windows_per_twin=4, steps_per_tick=1,
        deploy_after=10 ** 6,                  # guard-only serving: samples
        min_residency=1,                       # stay under the refit span so
        guard=GuardConfig(window=16))          # no slot ever trains
    return ShardedTwinConfig.uniform(scfg, shards, **kw)


def _alert_sets(fleet):
    state = {tid for s in fleet.shards if s is not None
             for tid, k in s._guard_state.items() if k == "ALERT"}
    events = {e.twin_id for s in fleet.shards if s is not None
              for e in s.events if e.kind == "ALERT"}
    return state, events


def _run_fleet(fleet, ys, true, n_twins, damaged, ticks, per_tick=2):
    for tid in range(n_twins):
        fleet.register(tid)
    fleet.deploy_many(list(range(n_twins)),
                      np.stack([-true if tid in damaged else true
                                for tid in range(n_twins)]))
    reports = []
    for t in range(ticks):
        for tid in range(n_twins):
            s = t * per_tick
            fleet.ingest(tid, ys[tid % ys.shape[0], s:s + per_tick])
        reports.append(fleet.tick())
    fleet.drain()
    return reports


@pytest.mark.chaos
def test_kill_shard_at_1k_twins_recovers_all_alerts(lv_world, tmp_path):
    """Kill 1 of 4 shards mid-serving at 1024 twins; the supervisor restores
    the last committed checkpoint + replays the journal, and the re-derived
    guard ALERT set EQUALS an uninterrupted run's within a bounded number
    of recovery ticks."""
    dt, ys, _, true = lv_world
    n_twins, shards, ticks = 1024, 4, 16
    damaged = {tid for tid in range(n_twins) if tid % 7 == 3}

    control = _sharded(_fleet_cfg(dt, shards, n_twins // shards))
    try:
        _run_fleet(control, ys, true, n_twins, damaged, ticks)
        control_state, control_events = _alert_sets(control)
        control_samples = {tid: s.twins[tid].samples
                           for s in control.shards for tid in s.twins}
    finally:
        control.close()
    assert control_state == damaged                 # the guard works at all

    chaos = _sharded(_fleet_cfg(
        dt, shards, n_twins // shards,
        recovery=RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                                restart_delay_ticks=1),
        chaos=ChaosConfig(kill_shard=2, kill_at_tick=12)))
    try:
        reports = _run_fleet(chaos, ys, true, n_twins, damaged, ticks)
        died = [r for r in reports if r.dead_shards > 0]
        restarts = [rec for r in reports for rec in r.restarted]
        assert died and restarts, "chaos schedule never fired"
        rec = restarts[0]
        assert rec["shard"] == 2
        assert rec["ckpt_tick"] is not None         # restored, not rebuilt
        assert rec["lost"] == 0                     # inside the ring horizon
        assert rec["replayed"] > 0
        assert rec["down_ticks"] <= 2
        assert int(chaos._m_replay_lost.value) == 0

        chaos_state, chaos_events = _alert_sets(chaos)
        assert chaos_state == control_state         # same final ALERT set
        assert chaos_events == control_events       # same twins ever alerted
        chaos_samples = {tid: s.twins[tid].samples
                         for s in chaos.shards for tid in s.twins}
        assert chaos_samples == control_samples
        assert reports[-1].dead_shards == 0
    finally:
        chaos.close()


@pytest.mark.chaos
def test_torn_checkpoint_falls_back_to_previous_commit(lv_world, tmp_path):
    """A crash mid-checkpoint-write (COMMIT torn off) must not poison
    recovery: restore falls back to the previous committed tick and the
    journal covers the longer gap."""
    dt, ys, _, true = lv_world
    n_twins = 32
    damaged = {3, 10, 17}
    fleet = _sharded(_fleet_cfg(
        dt, 2, n_twins // 2,
        recovery=RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                                restart_delay_ticks=1),
        chaos=ChaosConfig(kill_shard=1, kill_at_tick=8,
                          torn_checkpoint=True)))
    try:
        reports = _run_fleet(fleet, ys, true, n_twins, damaged, 14)
        rec = [r for rep in reports for r in rep.restarted][0]
        # newest commit before the kill was tick 6; chaos tore it -> tick 3
        assert rec["ckpt_tick"] == 3
        assert rec["lost"] == 0 and rec["replayed"] > 0
        assert int(fleet.checkpointer._m_torn.value) == 1
        state, _ = _alert_sets(fleet)
        assert state == damaged                     # served through it all
    finally:
        fleet.close()


@pytest.mark.chaos
def test_degradation_sheds_before_deadline_breaks(lv_world):
    """Injected straggler drives pressure ABOVE high_water while staying
    UNDER the deadline: the ladder climbs through guard->refit->promote
    shedding with ZERO deadline violations, then returns to level 0.

    The JAX test stalls 0.45 s under a 0.5 s deadline; the port's eager CPU
    tick here takes 30-150 ms (JAX's jitted one a few), which alone pushes
    a stalled tick past 0.5 s, and past 1 s on a loaded test machine.  So
    this copy stalls 3.4 s under a 4.0 s deadline: 0.85 of it, as
    benchmarks/online_scale.py's degrade row (1.7 s under 2.0 s), above
    high_water 0.8, leaving 600 ms for the organic tick."""
    dt, ys, _, _ = lv_world
    srv = TwinServer(_server_cfg(
        dt, deadline_s=4.0,
        degradation=DegradationConfig(enabled=True, high_water=0.8,
                                      low_water=0.5, alpha=0.9,
                                      hold_ticks=1)), device="cpu")
    try:
        for t in range(4):                          # warm up
            for i in range(4):
                srv.ingest(i, ys[i, t * 20:(t + 1) * 20])
            srv.tick()
        srv.reset_latency_stats()
        assert srv.degraded_level == 0
        ups0 = int(srv._m_deg_trans["up"].value)
        downs0 = int(srv._m_deg_trans["down"].value)
        srv.inject_delay_s = 3.4                    # 85% of deadline
        seen_levels = []
        for t in range(5):
            rep = srv.tick()
            seen_levels.append(rep.degraded_level)
        assert max(seen_levels) == 3                # full ladder engaged
        assert seen_levels == sorted(seen_levels)   # one level at a time
        assert int(srv._m_shed["guard"].value) > 0
        assert int(srv._m_shed["refit"].value) > 0
        assert int(srv._m_shed["promote"].value) > 0
        assert int(srv._m_violations.value) == 0    # shed BEFORE breaking
        srv.inject_delay_s = 0.0                    # pressure clears
        for t in range(30):
            rep = srv.tick()
            if rep.degraded_level == 0:
                break
        assert rep.degraded_level == 0              # restored, full service
        assert srv._degradation.pressure < 0.5
        assert int(srv._m_violations.value) == 0
        ups = int(srv._m_deg_trans["up"].value) - ups0
        downs = int(srv._m_deg_trans["down"].value) - downs0
        assert ups == downs == 3                    # clean round trip
    finally:
        srv.close()


@pytest.mark.chaos
def test_chaos_slow_shard_degrades_only_that_shard(lv_world):
    """The sharded slow-shard knob lands INSIDE the victim's timed tick:
    its own ladder climbs while the healthy shard keeps full service.
    Deadline 4.0 s and stall 3.4 s, as in the degradation test above (the
    JAX test's 0.45 s under 0.5 s leaves the port's eager CPU tick no
    room)."""
    dt, ys, _, _ = lv_world
    base = _server_cfg(
        dt, deadline_s=4.0,
        degradation=DegradationConfig(enabled=True, high_water=0.8,
                                      low_water=0.5, alpha=0.9,
                                      hold_ticks=1))
    fleet = _sharded(ShardedTwinConfig(
        servers=(base, base),
        chaos=ChaosConfig(slow_shard=1, slow_s=3.4,
                          slow_from_tick=3, slow_until_tick=7)))
    try:
        levels = []
        for t in range(8):
            for i in range(6):
                fleet.ingest(i, ys[i, t * 10:(t + 1) * 10])
            rep = fleet.tick()
            levels.append(rep.degraded_level)
        assert max(levels) >= 1                     # victim shed
        assert fleet.shards[0].degraded_level == 0  # healthy shard untouched
        assert int(fleet._m_slow_inj.value) == 4    # ticks 3..6
    finally:
        fleet.close()


@pytest.mark.chaos
def test_storm_duplicates_journal_and_shard_alike(lv_world, tmp_path):
    """An ingest storm (x3 duplication) must hit the journal and the shard
    identically, or replay after a later crash would diverge from what the
    shard actually saw."""
    dt, ys, _, _ = lv_world
    fleet = _sharded(_fleet_cfg(
        dt, 2, 8,
        recovery=RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
        chaos=ChaosConfig(storm_shard=0, storm_factor=3,
                          storm_from_tick=2, storm_until_tick=4)))
    try:
        for t in range(5):
            for tid in (0, 1):                      # shard 0 and shard 1
                fleet.ingest(tid, ys[tid, t * 4:(t + 1) * 4])
            fleet.tick()
        fleet.drain()
        assert fleet.journals[0].total(0) == fleet.shards[0].twins[0].samples
        assert fleet.journals[1].total(1) == fleet.shards[1].twins[1].samples
        assert fleet.journals[0].total(0) > fleet.journals[1].total(1)
    finally:
        fleet.close()
