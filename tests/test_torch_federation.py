"""The port's federation: coordinator serving over worker processes, the
front door, kill + restart, and agreement with the in-process fleet.

Ports tests/test_federation.py's server tests onto the port's
`FederatedTwinServer` with 2 worker processes on the plain path
(device="cpu"): routed batched ingest, tick fan-out, predict across the pipe
(and the worker surviving a refused request), the TCP front door, fleet
snapshots, conflicting pins, and the crash contract (SIGKILL a worker:
0 lost samples after journal-tail replay, its grant flows to the survivor
while it is down and back after the restart).  Its codec tests are in
tests/test_torch_wire.py.

Beyond those: a federated run with refits equals the port's in-process
`ShardedTwinServer` on the same telemetry BIT FOR BIT (losses and guard
events), since each worker builds the same shard from the same seed and
both sides run torch with one intra-op thread; a worker's boot failure
raises in the caller with the worker's traceback; and the device rules --
`device=None` raises without a card before any worker starts, and
`start_method="fork"` with a CUDA device raises.
"""
import dataclasses
import multiprocessing as mp
import os

import jax
import numpy as np
import pytest
import torch

from repro.systems.lotka_volterra import LotkaVolterra
from repro.systems.simulate import simulate_batch
from repro_torch.core.merinda import MerindaConfig
from repro_torch.twin import (FederatedTwinConfig, FederatedTwinServer,
                              FrontDoorClient, GuardConfig, RecoveryConfig,
                              ShardedTwinConfig, ShardedTwinServer,
                              TwinServerConfig, conforms)
from repro_torch.twin import wire as W

N_TWINS = 8
WORKERS = 2
PER_TICK = 8


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
                        horizon=300, noise_std=0.002)
    true = np.asarray(sys_.true_theta(sys_.library()), np.float32)
    return sys_.spec.dt, np.asarray(tr.ys_noisy), true


def _worker_cfg(dt, **kw):
    kw.setdefault("refit_slots", 4)
    return TwinServerConfig(
        merinda=MerindaConfig(n=2, m=0, order=2, hidden=8, head_hidden=8,
                              n_active=4, dt=dt),
        max_twins=N_TWINS // WORKERS + 1, capacity=128, window=16, stride=8,
        windows_per_twin=4, steps_per_tick=1, deploy_after=2,
        min_residency=1, max_residency=4, guard=GuardConfig(window=16), **kw)


def _feed(srv, ys, tick, per_tick=PER_TICK):
    lo = tick * per_tick
    return srv.ingest_many([(tid, ys[tid, lo:lo + per_tick])
                            for tid in range(N_TWINS)])


@pytest.fixture(scope="module")
def fed_srv(lv_world):
    dt, _, _ = lv_world
    srv = FederatedTwinServer(FederatedTwinConfig.uniform(
        _worker_cfg(dt), WORKERS, rebalance_every=2, front_door=True),
        device="cpu")
    yield srv
    srv.close()
    srv.close()                            # idempotent


def test_federated_serves_through_the_protocol(fed_srv, lv_world):
    _, ys, _ = lv_world
    assert conforms(fed_srv) == []
    assert fed_srv.register(3) == 3 % WORKERS
    assert _feed(fed_srv, ys, 0) == N_TWINS * PER_TICK
    fed_srv.drain()
    for t in range(4):
        rep = fed_srv.tick()
    assert rep.n_twins == N_TWINS
    assert len(rep.grants) == WORKERS and sum(rep.grants) > 0
    assert rep.dead_shards == 0
    s = fed_srv.latency_summary()
    assert s["ticks"] >= 4 and s["dropped_samples"] == 0
    assert set(fed_srv.snapshot_state()) == {"shard0", "shard1"}


def test_snapshot_leaves_are_host_arrays(fed_srv):
    """A worker packs its snapshot as a host tree: nothing in it is a
    device tensor (the coordinator never touches the device)."""
    from repro_torch.train import checkpoint
    snap = fed_srv.snapshot_state()
    leaves, _ = checkpoint.tree_flatten(snap["shard0"])
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)


def test_worker_processes_report_their_device(fed_srv):
    info = fed_srv.worker_processes()
    assert [int(i["pid"]) for i in info] == \
        [w.proc.pid for w in fed_srv.workers]
    assert all(i["device"] == "cpu" for i in info)
    assert len({int(i["pid"]) for i in info} | {os.getpid()}) == WORKERS + 1


def test_predict_refusal_leaves_worker_alive(fed_srv, lv_world):
    _, ys, _ = lv_world
    with pytest.raises(RuntimeError):
        fed_srv.predict(999, horizon=4)    # unknown twin: logical refusal
    _feed(fed_srv, ys, 5)
    rep = fed_srv.tick()                   # ...but the worker still serves
    assert rep.dead_shards == 0


def test_predict_roundtrip_after_deploy(fed_srv, lv_world):
    _, ys, true = lv_world
    fed_srv.deploy_many(list(range(N_TWINS)), torch.as_tensor(true))
    _feed(fed_srv, ys, 0)                  # predict rolls from newest samples
    fed_srv.drain()
    ys_hat = fed_srv.predict(1, horizon=5)
    assert np.asarray(ys_hat).shape[0] == 6    # horizon+1, row 0 = observed
    assert np.all(np.isfinite(ys_hat))


def test_front_door_feeds_the_fleet(fed_srv, lv_world):
    _, ys, _ = lv_world
    client = FrontDoorClient(fed_srv.front_address)
    try:
        staged = client.ingest_many(
            [(tid, ys[tid, 48:56]) for tid in range(N_TWINS)])
        assert staged == N_TWINS * 8
        assert client.ingest(0, ys[0, 56:60]) == 4
    finally:
        client.close()
    fed_srv.drain()
    assert fed_srv.tick().n_twins == N_TWINS


def test_register_rejects_conflicting_pin(fed_srv):
    with pytest.raises(ValueError):
        fed_srv.register(3, shard=(3 % WORKERS) + 1)


@pytest.mark.chaos
def test_kill_restart_replays_journal_and_migrates_grants(lv_world,
                                                          tmp_path):
    """SIGKILL a worker mid-serve -> the survivor inherits its slot grant
    under scarcity, the supervised restart replays the journal tail with 0
    lost samples, and the grant shape recovers."""
    dt, ys, _ = lv_world
    victim, total_slots = 1, 4             # scarcity: half the pool sum
    srv = FederatedTwinServer(FederatedTwinConfig.uniform(
        _worker_cfg(dt, refit_slots=4), WORKERS,
        rebalance_every=1, total_slots=total_slots,
        recovery=RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                restart_delay_ticks=2)), device="cpu")
    try:
        for tid in range(N_TWINS):
            srv.register(tid)
        for t in range(4):                 # build state + checkpoints
            _feed(srv, ys, t)
            srv.drain()
            pre = srv.tick()
        assert pre.grants[victim] > 0

        srv.kill_worker(victim)
        _feed(srv, ys, 4)                  # journal-only for the dead half
        down = srv.tick()
        assert down.dead_shards == 1
        assert down.grants[victim] == 0
        assert sum(down.grants) == total_slots          # migrated, not lost
        assert down.grants[1 - victim] > pre.grants[1 - victim]

        _feed(srv, ys, 5)
        back = srv.tick()                  # restart_delay_ticks=2 elapsed
        assert len(back.restarted) == 1
        rec = back.restarted[0]
        assert rec["shard"] == victim
        assert rec["lost"] == 0
        assert rec["replayed"] > 0
        assert back.dead_shards == 0
        assert back.grants[victim] > 0     # share flowed back

        _feed(srv, ys, 6)                  # the fleet keeps serving
        assert srv.tick().n_twins == N_TWINS
    finally:
        srv.close()


def test_federated_equals_in_process_sharded(lv_world):
    """The same fleet in worker processes and in one process: 10 ticks with
    refits and promotions under a scarce global budget, half the twins
    warm-started with wrong physics -- grants, admissions, losses and guard
    events bit for bit."""
    dt, ys, true = lv_world
    cfg = _worker_cfg(dt, refit_slots=2)
    kw = dict(total_slots=3, rebalance_every=2)
    thetas = np.stack([true if i % 3 else -true for i in range(N_TWINS)])
    runs = {}
    for name in ("sharded", "federated"):
        srv = (ShardedTwinServer(ShardedTwinConfig.uniform(cfg, WORKERS,
                                                           **kw),
                                 device="cpu")
               if name == "sharded" else
               FederatedTwinServer(FederatedTwinConfig.uniform(cfg, WORKERS,
                                                               **kw),
                                   device="cpu"))
        try:
            srv.deploy_many(list(range(N_TWINS)), thetas)
            ticks = []
            for t in range(10):
                _feed(srv, ys, t, per_tick=10)
                rep = srv.tick()
                ticks.append((rep.grants, rep.n_active, rep.n_guarded,
                              [r.loss for r in rep.reports],
                              [(e.tick, e.twin_id, e.kind, e.score,
                                e.confidence) for e in rep.events]))
            runs[name] = ticks
        finally:
            srv.close()
    assert runs["federated"] == runs["sharded"]
    losses = [x for t in runs["sharded"] for x in t[3] if x is not None]
    events = [e for t in runs["sharded"] for e in t[4]]
    assert len(losses) >= 8 and events    # refits ran, the guard fired


def test_worker_boot_failure_raises_in_the_caller(lv_world):
    """A worker whose server cannot be built answers its boot with the
    error, which the coordinator raises (and no worker is left running)."""
    dt, _, _ = lv_world
    bad = dataclasses.replace(_worker_cfg(dt), capacity=8)   # < refit span
    before = set(mp.active_children())
    with pytest.raises(W.WireError, match="ring capacity"):
        FederatedTwinServer(FederatedTwinConfig.uniform(bad, WORKERS),
                            device="cpu")
    assert set(mp.active_children()) == before


def test_no_card_raises_before_spawning(monkeypatch, lv_world):
    dt, _, _ = lv_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(mp.active_children())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTwinServer(FederatedTwinConfig.uniform(_worker_cfg(dt),
                                                        WORKERS))
    assert set(mp.active_children()) == before


def test_fork_with_a_cuda_device_raises(lv_world):
    dt, _, _ = lv_world
    cfg = FederatedTwinConfig.uniform(_worker_cfg(dt), WORKERS,
                                      start_method="fork")
    before = set(mp.active_children())
    for device in ("cuda", "cuda:0", None):
        with pytest.raises(ValueError, match="fork"):
            FederatedTwinServer(cfg, device=device)
    assert set(mp.active_children()) == before
