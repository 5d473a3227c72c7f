"""Multi-process federation: the fleet served as a real service.

`ShardedTwinServer` (twin/sharded.py) proved the architecture — N shards,
a global slot budget following pressure, a supervisor that restarts dead
shards from checkpoint + journal replay — but every shard shares one
Python process, one GIL, one CUDA context.  This module runs the SAME
architecture across real process boundaries, each worker with its own CUDA
context on the card:

    telemetry producers                      FederationCoordinator
    (FrontDoorClient) ──IngestBatch──▶ IngestFrontDoor ─▶ journal ─▶ route
                                               │ per-worker pipes (wire.py)
                          ┌────────────────────┼────────────────────┐
                    TickCmd/grants       TickCmd/grants       TickCmd/grants
                    TickDone/pressure    TickDone/pressure    TickDone/pressure
                          │                    │                    │
                     ShardWorker          ShardWorker          ShardWorker
                     (subprocess:         (subprocess:         (subprocess:
                      TwinServer +         TwinServer +         TwinServer +
                      TwinCheckpointer)    TwinCheckpointer)    TwinCheckpointer)

Division of state, dictated by what must survive a worker death:

  * WORKER-side: the serving state (rings, fleet slots, theta store) and
    its `TwinCheckpointer` — checkpoints are the worker's durable truth,
    written to the shared `RecoveryConfig.ckpt_dir`.
  * COORDINATOR-side: the `TelemetryJournal` (one per worker — a sample is
    journaled BEFORE it is routed, so the coordinator can replay the
    suffix a dead worker never checkpointed), the `SlotFederation`, the
    chaos schedule, and twin placement.

Failure protocol (mirrors the in-process supervisor tick for tick):
a worker that times out, EOFs, or replies `ErrorMsg` is killed and marked
dead; its grant flows to survivors at the immediate rebalance; ingest for
its twins is journal-only until restart.  After `restart_delay_ticks`
supervisor ticks, a fresh process boots, restores the newest COMMITTED
checkpoint, and reports per-twin sample counts in `Hello`; the
coordinator replays exactly the journal suffix past those counts
(`force=True` ingest — replay must not be shed), drains, and the worker
rejoins the federation with its pre-crash pressure EMA intact.

The coordinator only ever speaks `twin/wire.py` messages — it never
reaches into worker internals — which is what lets workers and
coordinator restart independently (the wire version is the compatibility
gate) and is why the whole thing fits behind the `TwinService` protocol:
`FederatedTwinServer` here, `ShardedTwinServer`, and `TwinServer` are
interchangeable to every caller in this repo (benchmarks, examples, the
conformance suite).

Devices: `device=None` serves on the CUDA card and raises in the caller,
before any worker starts, when there is none; "cpu" runs the plain PyTorch
path.  Workers start with "spawn" (CUDA cannot be used in a forked child,
so "fork" with a CUDA device raises), and the coordinator builds the kernel
library once before starting them, so the workers load it instead of each
running `nvcc`.  Tensors never cross the pipe: a worker converts its answers
and its snapshot to host arrays at its edge, so the coordinator never
touches the device.

Worker boot is NOT cheap (a fresh torch import + CUDA context, seconds,
plus `restart_delay_ticks`); size `RecoveryConfig.journal_horizon` to
cover the boot window at your ingest rate or replay will report lost
samples.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.gru.ops import gru_scan
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.obs import MetricRegistry, Tracer
from repro_torch.train import checkpoint
from repro_torch.twin import wire as W
from repro_torch.twin.monitor import GuardEvent
from repro_torch.twin.recovery import (ChaosInjector, TelemetryJournal,
                                       TwinCheckpointer)
from repro_torch.twin.scenario import ScenarioRefused, ScenarioResult
from repro_torch.twin.scheduler import SlotFederation
from repro_torch.twin.server import _HISTORY, TwinServer, TwinServerConfig
from repro_torch.twin.service import FleetTopologyConfig
from repro_torch.twin.sharded import ShardedTickReport

__all__ = ["FederatedTwinConfig", "ShardWorker", "FederationCoordinator",
           "FederatedTwinServer"]


@dataclass(frozen=True)
class FederatedTwinConfig(FleetTopologyConfig):
    """Multi-process fleet: same topology surface as `ShardedTwinConfig`
    (one `FleetTopologyConfig` base — the configs cannot drift), plus the
    process-boundary knobs."""
    servers: tuple[TwinServerConfig, ...] = ()   # one per worker process
    tick_timeout_s: float = 60.0      # reply deadline before a worker is
                                      # declared dead (generous: a first
                                      # tick sets up the worker's device)
    boot_timeout_s: float = 300.0     # spawn -> Hello deadline
    front_door: bool = False          # open the TCP ingestion door
    front_host: str = "127.0.0.1"
    front_port: int = 0               # 0: ephemeral (read .front_address)
    start_method: str = "spawn"       # fork cannot use CUDA in the child

    @staticmethod
    def uniform(server: TwinServerConfig, workers: int,
                **kw) -> "FederatedTwinConfig":
        """N identical worker processes."""
        return FederatedTwinConfig(servers=(server,) * workers, **kw)


# --------------------------------------------------------------------------- #
# worker process entry (module-level: spawn must import it by name)
# --------------------------------------------------------------------------- #
def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _process_stats(srv: TwinServer) -> dict:
    """What this worker process holds: its pid, device, device memory and
    the kernel wrappers' launch counts since it started (the counters are
    per process, so only the worker can read them)."""
    dev = srv.device
    cuda = dev.type == "cuda"
    return {"pid": os.getpid(), "device": str(dev),
            "memory_allocated":
                torch.cuda.memory_allocated(dev) if cuda else 0,
            "max_memory_allocated":
                torch.cuda.max_memory_allocated(dev) if cuda else 0,
            "gru_scan_launches": gru_scan.launches,
            "rk4_poly_launches": rk4_poly_solve.launches}


def _worker_main(conn, scfg: TwinServerConfig, shard: int, recovery,
                 device: str) -> None:
    """One `ShardWorker` subprocess: TwinServer + its checkpointer behind a
    wire-message loop.  Boot: build, restore the newest committed
    checkpoint, announce holdings in `Hello`.  A boot failure, or any
    command that raises, sends `ErrorMsg` and exits -- the coordinator
    treats that as a death (at boot it raises it) and runs the restart
    protocol.  Arrays from the pipe are read-only views of the frame; they
    are copied (`np.array`) before they become tensors."""
    srv = ckpt = None
    try:
        srv = TwinServer(scfg, device=device, seed=scfg.seed + shard)
        ckpt = (TwinCheckpointer(recovery, metrics=srv.metrics)
                if recovery is not None else None)
        ckpt_tick = None
        if ckpt is not None:
            ckpt_tick, state = ckpt.restore_latest(shard,
                                                   srv.snapshot_state())
            if state is not None:
                srv.restore_state(state)
        samples = {int(tid): int(rec.samples)
                   for tid, rec in srv.twin_snapshot().items()}
        conn.send_bytes(W.encode(W.Hello(
            shard=shard, tick=int(srv.tick_count), ckpt_tick=ckpt_tick,
            samples=samples)))
        last_saved = ckpt_tick
        while True:
            try:
                msg = W.decode(conn.recv_bytes())
            except EOFError:
                break                       # coordinator went away
            if isinstance(msg, W.Shutdown):
                break
            if isinstance(msg, W.IngestBatch):        # fire-and-forget
                srv.ingest_many(msg.chunks(), force=msg.force)
            elif isinstance(msg, W.Deploy):           # fire-and-forget
                srv.deploy_many([int(t) for t in msg.twin_ids],
                                np.array(msg.thetas, np.float32))
            elif isinstance(msg, W.TickCmd):
                if msg.grant >= 0:
                    srv.set_active_slots(msg.grant)
                srv.inject_delay_s = msg.inject_delay_s
                rep = srv.tick()
                if ckpt is not None and ckpt.maybe_save(
                        shard, srv.tick_count, srv.snapshot_state):
                    last_saved = srv.tick_count
                conn.send_bytes(W.encode(W.TickDone(
                    tick=int(srv.tick_count),
                    latency_s=float(rep.latency_s),
                    deadline_met=bool(rep.deadline_met),
                    n_active=int(rep.n_active),
                    n_twins=int(rep.n_twins),
                    n_guarded=int(rep.n_guarded),
                    degraded_level=int(rep.degraded_level),
                    pressure=float(srv.refit_pressure()),
                    loss=None if rep.loss is None else float(rep.loss),
                    ckpt_tick=last_saved,
                    events=[[int(e.twin_id), e.kind, float(e.score),
                             int(e.tick), float(e.confidence)]
                            for e in rep.events])))
            elif isinstance(msg, W.DrainCmd):
                srv.drain()
                conn.send_bytes(W.encode(W.Ack()))
            elif isinstance(msg, W.PredictCmd):
                # a bad request (unknown twin, nothing deployed) is the
                # CALLER's error -- reply it, don't take the worker down
                try:
                    ys = srv.predict(msg.twin_id, msg.horizon,
                                     None if msg.us is None
                                     else np.array(msg.us, np.float32))
                except (KeyError, ValueError, RuntimeError) as e:
                    conn.send_bytes(W.encode(W.ErrorMsg(
                        where="predict", error=str(e))))
                else:
                    conn.send_bytes(W.encode(W.PredictResult(ys=_host(ys))))
            elif isinstance(msg, W.Scenario):
                # ScenarioRefused is a RuntimeError: a refusal under
                # deadline pressure rides the same error reply, and the
                # coordinator re-raises the precise type from its message
                try:
                    res = srv.scenario(msg.twin_id, msg.horizon,
                                       None if msg.us is None
                                       else np.array(msg.us, np.float32),
                                       k=msg.k)
                except (KeyError, ValueError, RuntimeError) as e:
                    conn.send_bytes(W.encode(W.ErrorMsg(
                        where="scenario", error=str(e))))
                else:
                    conn.send_bytes(W.encode(W.ScenarioResult(
                        twin_id=int(res.twin_id), horizon=int(res.horizon),
                        requested_k=int(res.requested_k), k=int(res.k),
                        degraded_level=int(res.degraded_level),
                        ys=_host(res.ys), lo=_host(res.lo),
                        hi=_host(res.hi), confidence=_host(res.confidence))))
            elif isinstance(msg, W.StatsCmd):
                if msg.kind == "reset":
                    srv.reset_latency_stats()
                    conn.send_bytes(W.encode(W.Ack()))
                else:
                    data = (srv.latency_summary() if msg.kind == "latency"
                            else _process_stats(srv) if msg.kind == "process"
                            else srv.stage_summary())
                    conn.send_bytes(W.encode(W.Stats(
                        data={k: (None if v is None else
                                  float(v) if isinstance(v, (int, float))
                                  else v)
                              for k, v in data.items()})))
            elif isinstance(msg, W.SnapshotCmd):
                conn.send_bytes(W.encode(W.SnapshotBlob.pack(
                    checkpoint.to_host(srv.snapshot_state()))))
            else:
                raise W.WireError(
                    f"worker cannot handle {type(msg).TYPE!r}")
    except Exception:                       # noqa: BLE001 -- report, then die
        try:
            conn.send_bytes(W.encode(W.ErrorMsg(
                where=f"shard{shard}", error=traceback.format_exc())))
        except OSError:
            pass
    finally:
        try:
            if ckpt is not None:
                ckpt.wait()
            if srv is not None:
                srv.close()
        finally:
            conn.close()


# --------------------------------------------------------------------------- #
# coordinator-side worker handle
# --------------------------------------------------------------------------- #
class ShardWorker:
    """Coordinator-side proxy for one worker subprocess: the process, its
    pipe, and the last federation-relevant facts it reported.  All sends
    hold `_send_lock` (front-door threads ingest concurrently with the
    serving thread); only the serving thread ever receives."""

    def __init__(self, ctx, scfg: TwinServerConfig, shard: int, recovery,
                 device: str):
        self.shard = shard
        self.conn, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(
            target=_worker_main, args=(child, scfg, shard, recovery, device),
            name=f"twin-worker-{shard}", daemon=True)
        self.proc.start()
        child.close()                       # the worker owns its end now
        self._send_lock = threading.Lock()
        self.alive = True
        self.pressure = 0.0                 # last reported refit pressure
        self.n_twins = 0
        self.hello: W.Hello | None = None

    def wait_hello(self, timeout: float) -> W.Hello:
        msg = self.request_raw(timeout)
        if not isinstance(msg, W.Hello):
            raise W.WireError(f"worker {self.shard}: expected hello, got "
                              f"{type(msg).TYPE!r}")
        self.hello = msg
        return msg

    def send(self, msg) -> bool:
        """Fire-and-forget; False (and dead-marking is the caller's job)
        when the pipe is already broken."""
        if not self.alive:
            return False
        payload = W.encode(msg)
        try:
            with self._send_lock:
                self.conn.send_bytes(payload)
            return True
        except (BrokenPipeError, OSError):
            return False

    def request_raw(self, timeout: float):
        """One reply off the pipe (serving thread only).  Raises
        `TimeoutError`/`EOFError`/`WireError` — callers translate any of
        those into a death."""
        if not self.conn.poll(timeout):
            raise TimeoutError(f"worker {self.shard}: no reply in "
                               f"{timeout:.1f}s")
        msg = W.decode(self.conn.recv_bytes())
        if isinstance(msg, W.ErrorMsg):
            raise W.WireError(
                f"worker {self.shard} failed in {msg.where}:\n{msg.error}")
        return msg

    def request(self, msg, want: type, timeout: float):
        if not self.send(msg):
            raise EOFError(f"worker {self.shard}: pipe closed")
        reply = self.request_raw(timeout)
        if not isinstance(reply, want):
            raise W.WireError(f"worker {self.shard}: expected "
                              f"{want.TYPE!r}, got {type(reply).TYPE!r}")
        return reply

    def kill(self) -> None:
        self.alive = False
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5.0)
        self.conn.close()


# --------------------------------------------------------------------------- #
# the coordinator / federated server
# --------------------------------------------------------------------------- #
class FederationCoordinator:
    """Owns N `ShardWorker` subprocesses; implements the `TwinService`
    surface by routing over the wire.  See the module docstring for the
    state split and failure protocol.  Threading: `ingest`/`ingest_many`
    are safe from many producer threads (per-worker send locks + a
    journal lock); `tick`, `drain`, `deploy*`, `predict`,
    `snapshot_state` belong to ONE serving thread, exactly like the
    in-process servers."""

    def __init__(self, cfg: FederatedTwinConfig, *, device=None,
                 metrics: MetricRegistry | None = None,
                 tracer: Tracer | None = None):
        """`device=None` serves on the CUDA card and raises here, before
        any worker starts, without one; "cpu" runs the plain path."""
        if not cfg.servers:
            raise ValueError("need at least one worker")
        if cfg.start_method == "fork" and (
                device is None or torch.device(device).type == "cuda"):
            raise ValueError("start_method='fork' cannot serve on a CUDA "
                             "device (CUDA cannot be used in a forked "
                             "child); use 'spawn'")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            backend.build_library()      # once, before the workers load it
        self.cfg = cfg
        self.metrics = MetricRegistry() if metrics is None else metrics
        self.tracer = Tracer(enabled=False) if tracer is None else tracer
        self._ctx = mp.get_context(cfg.start_method)

        self.journals = ([TelemetryJournal(cfg.recovery.journal_horizon
                                           or s.capacity)
                          for s in cfg.servers]
                         if cfg.recovery is not None else None)
        self.chaos = (ChaosInjector(cfg.chaos)
                      if cfg.chaos is not None else None)
        # coordinator-side checkpointer handle: NEVER saves (workers own
        # that); exists so chaos can tear a dead worker's newest commit
        self._ckpt_view = (TwinCheckpointer(cfg.recovery,
                                            metrics=self.metrics)
                           if cfg.recovery is not None else None)

        self._instruments()
        t0 = time.perf_counter()
        self.workers: list[ShardWorker] = [
            ShardWorker(self._ctx, scfg, i, cfg.recovery, str(self.device))
            for i, scfg in enumerate(cfg.servers)]
        try:
            for w in self.workers:
                w.wait_hello(cfg.boot_timeout_s)
                self._m_boot.observe(time.perf_counter() - t0)
        except BaseException:
            for w in self.workers:
                w.kill()
            raise

        pools = [s.refit_slots for s in cfg.servers]
        self.federation = SlotFederation(cfg.make_federation(pools), pools)
        self.grants = self.federation.rebalance([0.0] * len(pools))
        for g, gauge in zip(self.grants, self._m_grants):
            gauge.set(g)

        self._placement: dict[int, int] = {}
        self._dead: dict[int, int] = {}       # shard -> tick it died on
        self.tick_count = 0
        self.latencies: deque = deque(maxlen=_HISTORY)
        self.refresh_counts: deque = deque(maxlen=_HISTORY)
        self.deadline_s = (cfg.deadline_s if cfg.deadline_s is not None
                           else min(s.deadline_s for s in cfg.servers))

    def _instruments(self) -> None:
        """Same families the in-process supervisor exports (dashboards work
        unchanged) + the process-boundary extras."""
        M, n = self.metrics, len(self.cfg.servers)
        self._m_tick = M.histogram(
            "twin_fleet_tick_latency_seconds",
            help="full federated serving-tick wall latency (all workers)",
            unit="seconds")
        self._m_violations = M.counter(
            "twin_fleet_deadline_violations_total",
            help="federated ticks exceeding the fleet deadline")
        self._m_refreshes = M.counter(
            "twin_fleet_slot_refreshes_total",
            help="refit-slot train advances across all workers")
        self._m_grants = [
            M.gauge("twin_shard_slot_grant",
                    help="active refit-slot grant from the federation",
                    labels={"shard": str(i)}) for i in range(n)]
        self._m_deaths = M.counter(
            "twin_shard_deaths_total",
            help="worker-process deaths the coordinator handled")
        self._m_restarts = M.counter(
            "twin_shard_restarts_total",
            help="supervised worker restarts (checkpoint + journal replay)")
        self._m_dead = M.gauge(
            "twin_dead_shards", help="worker processes currently down")
        self._m_recovery = M.histogram(
            "twin_recovery_ticks",
            help="coordinator ticks a worker spent down before its restart "
                 "completed", unit="ticks")
        self._m_replayed = M.counter(
            "twin_replay_samples_total",
            help="journal samples replayed into restarted workers")
        self._m_replay_lost = M.counter(
            "twin_replay_lost_samples_total",
            help="samples past the journal horizon at restart")
        self._m_slow_inj = M.counter(
            "twin_chaos_slow_injections_total",
            help="injected straggler sleeps forwarded to worker ticks")
        self._m_boot = M.histogram(
            "twin_worker_boot_seconds",
            help="spawn -> Hello latency of a worker process (includes "
                 "the torch import, the device context and checkpoint "
                 "restore)", unit="seconds")
        self._m_ingest_sent = M.counter(
            "twin_coord_ingest_batches_total",
            help="ingest batches routed to workers over the wire")

    # -- placement + TwinService surface -------------------------------- #
    @property
    def n_workers(self) -> int:
        return len(self.workers)

    def shard_of(self, twin_id: int) -> int:
        s = self._placement.get(twin_id)
        if s is None:
            s = twin_id % self.n_workers
            self._placement[twin_id] = s
        return s

    def register(self, twin_id: int, shard: int | None = None) -> int:
        """Pin placement (workers register lazily on first ingest);
        returns the worker index.  Conflicting re-pins raise, matching
        `ShardedTwinServer.register`."""
        if shard is not None:
            prev = self._placement.setdefault(twin_id, shard)
            if prev != shard:
                raise ValueError(f"twin {twin_id} already placed on worker "
                                 f"{prev}, cannot move to {shard}")
        return self.shard_of(twin_id)

    def _live_worker(self, i: int) -> ShardWorker:
        w = self.workers[i]
        if not w.alive:
            raise RuntimeError(f"worker {i} is down (died at tick "
                               f"{self._dead.get(i)}; restart pending)")
        return w

    def ingest(self, twin_id: int, y, u=None, *, force: bool = False):
        """Journal-first routed ingest; dead-worker samples are journal-only
        until replay (producers never block on a crash)."""
        self.ingest_many([(twin_id, y, u)], force=force)

    def ingest_many(self, batch, *, force: bool = False) -> int:
        """One wire batch per worker — this is the front door's sink, so a
        producer flush of any size costs at most `n_workers` pipe writes."""
        staged = 0
        by_worker: dict[int, list] = {}
        for chunk in batch:
            tid, y = chunk[0], chunk[1]
            u = chunk[2] if len(chunk) > 2 else None
            s = self.shard_of(tid)
            copies = 1 + (self.chaos.storm_extra(s, self.tick_count)
                          if self.chaos is not None else 0)
            for _ in range(copies):
                if self.journals is not None:
                    self.journals[s].append(tid, y, u)
                by_worker.setdefault(s, []).append((tid, y, u))
            staged += np.atleast_2d(np.asarray(y)).shape[0]
        for s, chunks in by_worker.items():
            w = self.workers[s]
            if w.alive:
                w.send(W.IngestBatch.from_chunks(chunks, force=force))
                self._m_ingest_sent.inc()
        return staged

    def deploy(self, twin_id: int, theta) -> None:
        self.deploy_many([twin_id], _host(theta)[None])

    def deploy_many(self, twin_ids, thetas) -> None:
        """Warm-start across workers: one Deploy frame per worker.  Raises
        on a dead target — a warm start cannot be journaled (thetas are not
        telemetry), so refusing beats silently dropping."""
        thetas = _host(thetas)
        twin_ids = list(twin_ids)
        by_worker: dict[int, list[int]] = {}
        for k, tid in enumerate(twin_ids):
            by_worker.setdefault(self.shard_of(tid), []).append(k)
        for s, ks in by_worker.items():
            ids = np.asarray([int(twin_ids[k]) for k in ks], np.int64)
            block = thetas if thetas.ndim == 2 else thetas[ks]
            if not self._live_worker(s).send(W.Deploy(twin_ids=ids,
                                                      thetas=block)):
                raise RuntimeError(f"worker {s} died mid-deploy")

    def predict(self, twin_id: int, horizon: int, us=None):
        w = self._live_worker(self.shard_of(twin_id))
        try:
            return w.request(
                W.PredictCmd(twin_id=int(twin_id), horizon=int(horizon),
                             us=None if us is None else _host(us)),
                W.PredictResult, self.cfg.tick_timeout_s).ys
        except W.WireError as e:
            # logical refusal (unknown twin, nothing deployed): the worker
            # is fine — surface the same error shape TwinServer raises
            raise RuntimeError(str(e)) from e
        except (TimeoutError, EOFError):
            self._mark_dead(w.shard)
            raise

    def scenario(self, twin_id: int, horizon: int, us=None,
                 k: int | None = None):
        """What-if fan-out across the process boundary: the owning worker
        answers from its live theta store at its OWN degradation level."""
        w = self._live_worker(self.shard_of(twin_id))
        try:
            r = w.request(
                W.Scenario(twin_id=int(twin_id), horizon=int(horizon),
                           k=None if k is None else int(k),
                           us=None if us is None
                           else _host(us).astype(np.float32)),
                W.ScenarioResult, self.cfg.tick_timeout_s)
        except W.WireError as e:
            msg = str(e)
            if "scenario refused" in msg:
                raise ScenarioRefused(msg) from e
            raise RuntimeError(msg) from e
        except (TimeoutError, EOFError):
            self._mark_dead(w.shard)
            raise
        return ScenarioResult(twin_id=int(r.twin_id), horizon=int(r.horizon),
                              requested_k=int(r.requested_k), k=int(r.k),
                              degraded_level=int(r.degraded_level),
                              ys=r.ys, lo=r.lo, hi=r.hi,
                              confidence=r.confidence)

    # -- the supervisor tick -------------------------------------------- #
    def _alive(self) -> list[bool]:
        return [w.alive for w in self.workers]

    def _rebalance(self) -> None:
        """Re-divide the global budget from the last REPORTED pressures —
        the post-tick values, exactly what the in-process supervisor reads
        live (no train work happens between a tick and its rebalance)."""
        pressures = [w.pressure if w.alive else 0.0 for w in self.workers]
        self.grants = self.federation.rebalance(pressures,
                                                alive=self._alive())
        for g, gauge in zip(self.grants, self._m_grants):
            gauge.set(g)

    def _mark_dead(self, i: int) -> None:
        w = self.workers[i]
        if not w.alive:
            return
        w.kill()
        self._dead[i] = self.tick_count
        self._m_deaths.inc()
        self._m_dead.set(len(self._dead))
        if (self.chaos is not None and self._ckpt_view is not None
                and self.chaos.should_tear()):
            self._ckpt_view.tear_latest(i)
        self._rebalance()

    def kill_worker(self, i: int) -> None:
        """Operational/chaos hook: SIGKILL worker `i` now.  The journal
        already holds everything it was sent; the supervised restart
        replays the un-checkpointed suffix."""
        self._mark_dead(i)

    def tick(self) -> ShardedTickReport:
        """One federated cycle, same shape as the in-process supervisor:
        restart due workers, fan `TickCmd` out to every live worker, then
        collect every `TickDone` — send-all-then-collect, so workers tick
        CONCURRENTLY (this is the multi-core speedup the process split
        exists for).  A worker death never fails the supervisor tick."""
        with self.tracer.span("federated_tick", tick=self.tick_count + 1,
                              workers=self.n_workers):
            t0 = time.perf_counter()
            self.tick_count += 1
            restarted: list[dict] = []
            if self._dead and self.cfg.recovery is not None:
                for i, died_at in sorted(self._dead.items()):
                    if (self.tick_count - died_at
                            >= self.cfg.recovery.restart_delay_ticks):
                        with self.tracer.span("restart_worker", shard=i):
                            restarted.append(self._restart_worker(i))
            ticked: list[int] = []
            for i, w in enumerate(self.workers):
                if not w.alive:
                    continue
                if self.chaos is not None:
                    if self.chaos.should_kill(i, self.tick_count):
                        self._mark_dead(i)
                        continue
                    delay = self.chaos.slow_delay(i, self.tick_count)
                    if delay > 0:
                        self._m_slow_inj.inc()
                else:
                    delay = 0.0
                if w.send(W.TickCmd(tick=self.tick_count,
                                    grant=self.grants[i],
                                    inject_delay_s=delay)):
                    ticked.append(i)
                else:
                    self._mark_dead(i)
            reports: list = [None] * self.n_workers
            deadline = time.monotonic() + self.cfg.tick_timeout_s
            for i in ticked:
                w = self.workers[i]
                try:
                    done = w.request_raw(
                        max(0.05, deadline - time.monotonic()))
                    if not isinstance(done, W.TickDone):
                        raise W.WireError(
                            f"worker {i}: expected tick_done, got "
                            f"{type(done).TYPE!r}")
                except (TimeoutError, EOFError, OSError, W.WireError):
                    self._mark_dead(i)
                    continue
                w.pressure = done.pressure
                w.n_twins = done.n_twins
                reports[i] = done
            if restarted or self.tick_count % self.cfg.rebalance_every == 0:
                with self.tracer.span("rebalance"):
                    self._rebalance()
            latency = time.perf_counter() - t0
        self.latencies.append(latency)
        self._m_tick.observe(latency)
        if latency > self.deadline_s:
            self._m_violations.inc()
        live = [r for r in reports if r is not None]
        n_active = sum(r.n_active for r in live)
        self.refresh_counts.append(n_active)
        if n_active:
            self._m_refreshes.inc(n_active)
        self._m_dead.set(len(self._dead))
        return ShardedTickReport(
            tick=self.tick_count, latency_s=latency,
            deadline_met=latency <= self.deadline_s,
            reports=reports, grants=list(self.grants),
            events=[GuardEvent(twin_id=e[0], kind=e[1], score=e[2],
                               tick=e[3],
                               # tolerate 4-tuple events from pre-confidence
                               # workers (rolling upgrade across versions)
                               confidence=e[4] if len(e) > 4 else 1.0)
                    for r in live for e in r.events],
            n_active=n_active,
            n_twins=sum(r.n_twins for r in live),
            n_guarded=sum(r.n_guarded for r in live),
            degraded_level=max((r.degraded_level for r in live), default=0),
            dead_shards=len(self._dead),
            restarted=restarted,
            replayed_samples=sum(r["replayed"] for r in restarted))

    def _restart_worker(self, i: int) -> dict:
        """Supervised restart across the process boundary: spawn, let the
        worker restore its own newest committed checkpoint, read its
        `Hello` sample counts, replay exactly the journal suffix past
        them, drain.  Returns the restart record for the tick report."""
        t0 = time.perf_counter()
        w = ShardWorker(self._ctx, self.cfg.servers[i], i,
                        self.cfg.recovery, str(self.device))
        hello = w.wait_hello(self.cfg.boot_timeout_s)
        self._m_boot.observe(time.perf_counter() - t0)
        self.workers[i] = w
        died_at = self._dead.pop(i)
        replayed = lost = 0
        if self.journals is not None:
            journal = self.journals[i]
            seen = {int(k): int(v) for k, v in hello.samples.items()}
            chunks: list = []
            for tid in journal.twin_ids():
                tail, lost_t = journal.replay_since(tid, seen.get(tid, 0))
                lost += lost_t
                for y, u in tail:
                    chunks.append((tid, y, u))
                    replayed += len(y)
            if chunks:
                # force: replay must not be shed by staging backpressure
                w.send(W.IngestBatch.from_chunks(chunks, force=True))
            w.request(W.DrainCmd(), W.Ack, self.cfg.tick_timeout_s)
        down = self.tick_count - died_at
        self._m_restarts.inc()
        self._m_recovery.observe(down)
        self._m_replayed.inc(replayed)
        if lost:
            self._m_replay_lost.inc(lost)
        self._m_dead.set(len(self._dead))
        return {"shard": i, "ckpt_tick": hello.ckpt_tick,
                "replayed": replayed, "lost": lost, "down_ticks": down}

    # -- barriers, stats, shutdown -------------------------------------- #
    def drain(self) -> None:
        """Barrier: every routed sample reaches its worker's ring."""
        for w in self.workers:
            if not w.alive:
                continue
            try:
                w.request(W.DrainCmd(), W.Ack, self.cfg.tick_timeout_s)
            except (TimeoutError, EOFError, W.WireError):
                self._mark_dead(w.shard)

    def snapshot_state(self) -> dict:
        """Host tree: one worker `snapshot_state` sub-tree (numpy
        leaves) per LIVE worker, keyed `"shard<i>"` — the `ShardedTwinServer` shape, so
        fleet snapshots are interchangeable across deployments."""
        out = {}
        for i, w in enumerate(self.workers):
            if not w.alive:
                continue
            blob = w.request(W.SnapshotCmd(), W.SnapshotBlob,
                             self.cfg.tick_timeout_s)
            out[f"shard{i}"] = blob.unpack()
        return out

    def _worker_stats(self, kind: str) -> list[dict]:
        out = []
        for w in self.workers:
            if not w.alive:
                continue
            out.append(w.request(W.StatsCmd(kind=kind), W.Stats,
                                 self.cfg.tick_timeout_s).data)
        return out

    def worker_processes(self) -> list[dict]:
        """Per live worker: its pid, device, device memory and the kernel
        launches it has made since it started (`_process_stats`)."""
        return self._worker_stats("process")

    def latency_summary(self) -> dict:
        """p50/p99 of the WHOLE federated tick + aggregate throughput
        (the `ShardedTwinServer.latency_summary` shape)."""
        h = self._m_tick
        ticks = h.count
        if ticks == 0:
            return {"ticks": 0}
        worker = self._worker_stats("latency")
        return {
            "ticks": ticks,
            "p50_ms": h.quantile(0.5) * 1e3,
            "p99_ms": h.quantile(0.99) * 1e3,
            "max_ms": h.max * 1e3,
            "deadline_s": self.deadline_s,
            "violations": int(self._m_violations.value),
            "twin_refreshes_per_s":
                self._m_refreshes.value / max(h.sum, 1e-9),
            "dropped_samples": sum(int(s.get("dropped_samples", 0))
                                   for s in worker),
            "flush_overflows": sum(int(s.get("flush_overflows", 0))
                                   for s in worker),
        }

    def stage_summary(self) -> dict:
        """Aggregate per-tick stage cost across workers (ms)."""
        out: dict[str, float] = {}
        for data in self._worker_stats("stage"):
            for k, v in data.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def reset_latency_stats(self) -> None:
        self.latencies.clear()
        self.refresh_counts.clear()
        self._m_tick.reset()
        self._m_violations.reset()
        self._m_refreshes.reset()
        for w in self.workers:
            if not w.alive:
                continue
            try:
                w.request(W.StatsCmd(kind="reset"), W.Ack,
                          self.cfg.tick_timeout_s)
            except (TimeoutError, EOFError, W.WireError):
                self._mark_dead(w.shard)

    def close(self) -> None:
        """Shut every worker down (idempotent); stragglers are killed."""
        for w in self.workers:
            if w.alive:
                w.send(W.Shutdown())
        for w in self.workers:
            if w.alive:
                w.proc.join(timeout=10.0)
                w.alive = False
                if w.proc.is_alive():
                    w.proc.kill()
                    w.proc.join(timeout=5.0)
                w.conn.close()


class FederatedTwinServer(FederationCoordinator):
    """`FederationCoordinator` + the network ingestion front door: the
    third `TwinService` implementation (see twin/service.py).  With
    `cfg.front_door=True`, telemetry producers connect a
    `FrontDoorClient` to `.front_address` and their batches land in the
    coordinator journal (durability first) before being routed — the
    full production shape of the paper's online-twinning loop."""

    def __init__(self, cfg: FederatedTwinConfig, *, device=None,
                 metrics: MetricRegistry | None = None,
                 tracer: Tracer | None = None):
        super().__init__(cfg, device=device, metrics=metrics, tracer=tracer)
        self.front_door = (W.IngestFrontDoor(self.ingest_many,
                                             host=cfg.front_host,
                                             port=cfg.front_port)
                           if cfg.front_door else None)

    @property
    def front_address(self):
        """(host, port) producers dial, or None without a front door."""
        return None if self.front_door is None else self.front_door.address

    def close(self) -> None:
        if self.front_door is not None:
            self.front_door.close()
            self.front_door = None
        super().close()
