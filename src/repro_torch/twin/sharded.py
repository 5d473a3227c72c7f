"""ShardedTwinServer: the 10k-tracked-object serving architecture.

One `TwinServer` saturates at a few hundred twins: its guard scan, staging
flush, and single refit-slot pool all serialize on one tick loop.  This
module partitions the tracked fleet across N SHARDS — each shard owns its own
`TelemetryRing`, `FleetMerinda` refit-slot pool, theta store, and
`RefitScheduler` — with two cross-shard mechanisms on top:

  * **Slot federation** (`SlotFederation`, twin/scheduler.py): a GLOBAL
    active-refit budget is divided across shards in proportion to their
    aggregate staleness+divergence pressure (each shard's
    `refit_pressure()` -- one reduction over its packed fleet arrays, not
    an O(twins) host scan), re-evaluated every `rebalance_every` ticks.  A
    shard whose twins diverge (dynamics changed, models stale) is granted
    slots that quiet shards give back — refit compute follows the
    emergency.  Physical pools never change shape, so
    no tensor is reallocated; only each scheduler's fill cap moves.

  * **Shared modules**: shards with identical configs share the stateless
    ring/fleet/guard/scenario module objects (`share_modules_from`).

Every shard runs on one device (`device=`: None means the CUDA card and
raises without one, "cpu" the plain PyTorch path), so each shard's tick
launches the GRU-scan and RK4 kernels (csrc/) on the card.  `init_sources`
gives each shard its source of random parameters (default: a
`TorchInitSource` seeded `cfg.seed + i`), the hook that lets a test start
the shards from the JAX package's own draws.

Shards may also be HETEROGENEOUS (different MerindaConfig per shard) — the
mixed-fleet deployment where F-8 airframes, Van der Pol oscillators, and
Lotka-Volterra populations are tracked by one server
(examples/sharded_fleet.py); federation grants still flow between them.

Placement is sticky: a twin's first `register`/`ingest` pins it to a shard
(`twin_id % shards` by default, or an explicit `shard=` for family-routed
fleets).  Combined with per-shard `async_ingest` (background staging flush)
and `guard_budget` (O(budget) rotating guard), one process tracks 10k+
objects — `benchmarks/online_scale.py` is the scaling evidence.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.obs import MetricRegistry, Tracer
from repro_torch.twin.monitor import GuardEvent
from repro_torch.twin.recovery import (ChaosInjector, ShardFailure,
                                       TelemetryJournal, TwinCheckpointer)
from repro_torch.twin.scheduler import SlotFederation
from repro_torch.twin.server import (_HISTORY, TickReport, TwinServer,
                                     TwinServerConfig)
from repro_torch.twin.service import FleetTopologyConfig

__all__ = ["ShardedTwinConfig", "ShardedTickReport", "ShardedTwinServer"]


@dataclass(frozen=True)
class ShardedTwinConfig(FleetTopologyConfig):
    """In-process fleet: the topology knobs (slot budget, grant floor,
    rebalance cadence, smoothing, recovery, chaos) live in
    `FleetTopologyConfig` — shared verbatim with `FederatedTwinConfig`
    (twin/federation.py), the multi-process deployment of the same shape."""
    servers: tuple[TwinServerConfig, ...] = ()   # one per shard (may differ)

    @staticmethod
    def uniform(server: TwinServerConfig, shards: int,
                **kw) -> "ShardedTwinConfig":
        """N identical shards (they will share modules)."""
        return ShardedTwinConfig(servers=(server,) * shards, **kw)


@dataclass
class ShardedTickReport:
    tick: int
    latency_s: float
    deadline_met: bool
    reports: list[TickReport | None]      # per shard, in shard order
                                          # (None: shard was dead this tick)
    grants: list[int]                     # active-slot grant per shard
    events: list[GuardEvent] = field(default_factory=list)
    n_active: int = 0
    n_twins: int = 0
    n_guarded: int = 0
    degraded_level: int = 0               # max shed-ladder level across shards
    dead_shards: int = 0                  # shards down at the end of the tick
    restarted: list = field(default_factory=list)
                                          # restart records this tick:
                                          # {shard, ckpt_tick, replayed, lost,
                                          #  down_ticks}
    replayed_samples: int = 0             # journal samples replayed this tick


class ShardedTwinServer:
    """N `TwinServer` shards + slot federation; see module docstring.

    API mirrors `TwinServer` (register/ingest/deploy/deploy_many/predict/
    tick/drain/close + latency/stage summaries) with twin_ids routed to
    their pinned shard.  Units: `ShardedTickReport.latency_s` is SECONDS
    for the WHOLE sharded tick (all shards, serial); `deadline_s` is the
    tightest per-shard deadline.  Threading matches `TwinServer`: `ingest`
    is safe from many sensor threads (each shard's staging buffer
    synchronizes its own producers), everything that touches device state —
    `tick`, `drain`, `deploy*`, `predict` — belongs to one serving thread.
    Guard cost per tick is O(sum of per-shard budgets), independent of the
    tracked-twin count (the 1k->10k scale benchmark checks <= 2x drift).
    """

    def __init__(self, cfg: ShardedTwinConfig, *, device=None,
                 init_sources=None,
                 metrics: MetricRegistry | None = None,
                 tracer: Tracer | None = None):
        """`device=None` serves on the CUDA card and raises without one.
        `init_sources[i]` (default None: `TorchInitSource(fleet, seed + i)`)
        is shard i's init source, see `TorchInitSource`; a restarted shard
        gets its own again, and a restored checkpoint loads its state.

        One `MetricRegistry` + `Tracer` is shared by the whole fleet: every
        shard resolves its instruments with a `shard="<i>"` label, so one
        `metrics.expose()` scrape carries per-shard stage histograms next to
        the fleet-level aggregates, and every shard's spans land in one
        trace (nested under the `sharded_tick` root)."""
        if not cfg.servers:
            raise ValueError("need at least one shard")
        if init_sources is not None and len(init_sources) != len(cfg.servers):
            raise ValueError(f"{len(init_sources)} init sources for "
                             f"{len(cfg.servers)} shards")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._init_sources = (list(init_sources) if init_sources is not None
                              else [None] * len(cfg.servers))
        self.metrics = MetricRegistry() if metrics is None else metrics
        self.tracer = Tracer(enabled=False) if tracer is None else tracer
        self.shards: list[TwinServer | None] = []
        first_with_cfg: dict[TwinServerConfig, TwinServer] = {}
        for i, scfg in enumerate(cfg.servers):
            srv = self._new_shard(i, first_with_cfg.get(scfg))
            first_with_cfg.setdefault(scfg, srv)
            self.shards.append(srv)

        pools = [s.cfg.refit_slots for s in self.shards]
        self.federation = SlotFederation(cfg.make_federation(pools), pools)
        self.grants = self.federation.rebalance([0.0] * len(pools))
        for srv, g in zip(self.shards, self.grants):
            srv.set_active_slots(g)

        self._placement: dict[int, int] = {}      # twin_id -> shard index
        self.tick_count = 0
        self.latencies: deque = deque(maxlen=_HISTORY)
        self.refresh_counts: deque = deque(maxlen=_HISTORY)
        self.deadline_s = (cfg.deadline_s if cfg.deadline_s is not None
                           else min(s.cfg.deadline_s for s in self.shards))

        # fault-tolerance layer (twin/recovery.py): checkpointer + journals
        # live with the SUPERVISOR so they survive any shard's death
        self.checkpointer = (TwinCheckpointer(cfg.recovery,
                                              metrics=self.metrics)
                             if cfg.recovery is not None else None)
        self.journals = ([TelemetryJournal(cfg.recovery.journal_horizon
                                           or s.capacity)
                          for s in cfg.servers]
                         if cfg.recovery is not None else None)
        self.chaos = (ChaosInjector(cfg.chaos)
                      if cfg.chaos is not None else None)
        self._dead: dict[int, int] = {}           # shard -> supervisor tick
                                                  # it died on

        # fleet-level instruments: the whole sharded tick (all shards,
        # serial) — per-shard detail lives in each shard's labeled children
        M = self.metrics
        self._m_tick = M.histogram(
            "twin_fleet_tick_latency_seconds",
            help="full sharded serving-tick wall latency (all shards)",
            unit="seconds")
        self._m_violations = M.counter(
            "twin_fleet_deadline_violations_total",
            help="sharded ticks exceeding the tightest shard deadline")
        self._m_refreshes = M.counter(
            "twin_fleet_slot_refreshes_total",
            help="refit-slot train advances across all shards")
        self._m_grants = [
            M.gauge("twin_shard_slot_grant",
                    help="active refit-slot grant from the federation",
                    labels={"shard": str(i)})
            for i in range(len(self.shards))]
        for g, n in zip(self._m_grants, self.grants):
            g.set(n)
        self._m_deaths = M.counter(
            "twin_shard_deaths_total",
            help="shard failures (injected or organic) the supervisor "
                 "handled")
        self._m_restarts = M.counter(
            "twin_shard_restarts_total",
            help="supervised shard restarts (checkpoint restore + journal "
                 "replay)")
        self._m_dead = M.gauge(
            "twin_dead_shards", help="shards currently down")
        self._m_recovery = M.histogram(
            "twin_recovery_ticks",
            help="supervisor ticks a shard spent down before its restart "
                 "completed", unit="ticks")
        self._m_replayed = M.counter(
            "twin_replay_samples_total",
            help="journal samples replayed into restarted shards")
        self._m_replay_lost = M.counter(
            "twin_replay_lost_samples_total",
            help="samples past the journal horizon at restart "
                 "(unrecoverable by design; ring would have dropped them)")
        self._m_slow_inj = M.counter(
            "twin_chaos_slow_injections_total",
            help="injected straggler sleeps before shard ticks")

    # ------------------------------------------------------------------ #
    def _new_shard(self, i: int, donor: TwinServer | None) -> TwinServer:
        """Shard i's server, sharing `donor`'s modules when given."""
        scfg = self.cfg.servers[i]
        return TwinServer(scfg, device=self.device, share_modules_from=donor,
                          init_source=self._init_sources[i],
                          seed=scfg.seed + i, metrics=self.metrics,
                          tracer=self.tracer, shard=i)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_of(self, twin_id: int) -> int:
        """The twin's pinned shard (pins it modulo-N if unplaced)."""
        s = self._placement.get(twin_id)
        if s is None:
            s = twin_id % self.n_shards
            self._placement[twin_id] = s
        return s

    def _shard_srv(self, i: int) -> TwinServer:
        srv = self.shards[i]
        if srv is None:
            raise RuntimeError(f"shard {i} is down (died at supervisor tick "
                               f"{self._dead.get(i)}; restart pending)")
        return srv

    def register(self, twin_id: int, shard: int | None = None):
        """Start tracking; `shard` pins placement explicitly (family routing
        for heterogeneous fleets) — conflicting re-pins raise."""
        if shard is not None:
            prev = self._placement.setdefault(twin_id, shard)
            if prev != shard:
                raise ValueError(f"twin {twin_id} already placed on shard "
                                 f"{prev}, cannot move to {shard}")
        return self._shard_srv(self.shard_of(twin_id)).register(twin_id)

    # ------------------------------------------------------------------ #
    def ingest(self, twin_id: int, y, u=None, *, force: bool = False):
        """Route telemetry to the twin's shard, journaling first (recovery
        enabled): the journal must already hold a sample when the shard that
        received it dies.  Ingest into a DEAD shard is journal-only — the
        sample is replayed at restart, so producers never block on a crash.
        A chaos storm duplicates the chunk (journal and shard alike), so
        replay stays consistent with what the shard actually saw.
        `force=True` bypasses shard staging backpressure (crash-recovery
        replay) — same contract as `TwinServer.ingest`."""
        s = self.shard_of(twin_id)
        copies = 1 + (self.chaos.storm_extra(s, self.tick_count)
                      if self.chaos is not None else 0)
        srv = self.shards[s]
        for _ in range(copies):
            if self.journals is not None:
                self.journals[s].append(twin_id, y, u)
            if srv is not None:
                srv.ingest(twin_id, y, u, force=force)

    def ingest_many(self, batch, *, force: bool = False) -> int:
        """Batched `ingest` over (twin_id, y[, u]) chunks; returns the
        number of SAMPLES staged (journal-only samples for dead shards
        count — they WILL be served after replay)."""
        staged = chunks = 0
        with self.tracer.span("ingest_many", cat="ingest") as sp:
            for chunk in batch:
                tid, y = chunk[0], chunk[1]
                u = chunk[2] if len(chunk) > 2 else None
                self.ingest(tid, y, u, force=force)
                staged += np.atleast_2d(np.asarray(y)).shape[0]
                chunks += 1
            sp.note(chunks=chunks, samples=staged)
        return staged

    def deploy(self, twin_id: int, theta) -> None:
        self._shard_srv(self.shard_of(twin_id)).deploy(twin_id, theta)

    def deploy_many(self, twin_ids, thetas) -> None:
        """Warm-start across shards: one scatter per shard.  thetas [B, n,
        L] (a tensor or an array) or one [n, L] broadcast to every twin."""
        if not isinstance(thetas, torch.Tensor):
            thetas = torch.as_tensor(np.asarray(thetas, np.float32))
        twin_ids = list(twin_ids)
        by_shard: dict[int, list[int]] = {}
        for k, tid in enumerate(twin_ids):
            by_shard.setdefault(self.shard_of(tid), []).append(k)
        for s, ks in by_shard.items():
            ids = [twin_ids[k] for k in ks]
            self._shard_srv(s).deploy_many(
                ids, thetas if thetas.ndim == 2 else thetas[ks])

    def predict(self, twin_id: int, horizon: int, us=None):
        return self._shard_srv(self.shard_of(twin_id)).predict(twin_id,
                                                               horizon, us)

    def scenario(self, twin_id: int, horizon: int, us=None,
                 k: int | None = None):
        """What-if fan-out: route to the owning shard; degradation shrink /
        refuse happens at THAT shard's ladder level (a straggling shard
        sheds its own scenario load without dimming the healthy shards)."""
        return self._shard_srv(self.shard_of(twin_id)).scenario(
            twin_id, horizon, us, k=k)

    # ------------------------------------------------------------------ #
    def _alive(self) -> list[bool]:
        return [srv is not None for srv in self.shards]

    def _rebalance(self) -> None:
        """Re-divide the global slot budget; dead shards pressure 0 / no
        floor (their share flows to survivors until restart)."""
        pressures = [srv.refit_pressure() if srv is not None else 0.0
                     for srv in self.shards]
        self.grants = self.federation.rebalance(pressures,
                                                alive=self._alive())
        for srv, g, gauge in zip(self.shards, self.grants, self._m_grants):
            if srv is not None:
                srv.set_active_slots(g)
            gauge.set(g)

    def tick(self) -> ShardedTickReport:
        """One serving cycle: restart any dead shard whose delay elapsed,
        tick every live shard (applying the chaos schedule: straggler
        sleeps, kills), checkpoint shards on their cadence, then
        (periodically) rebalance the global slot budget by shard pressure.

        A shard death never fails the supervisor tick: the dead shard's
        report slot is None, its grant flows to the survivors, and ingest
        for its twins is journaled until the restart replays it."""
        with self.tracer.span("sharded_tick", tick=self.tick_count + 1,
                              shards=len(self.shards)):
            t0 = time.perf_counter()
            self.tick_count += 1
            restarted: list[dict] = []
            if self._dead and self.cfg.recovery is not None:
                for i, died_at in sorted(self._dead.items()):
                    if (self.tick_count - died_at
                            >= self.cfg.recovery.restart_delay_ticks):
                        with self.tracer.span("restart_shard", shard=i):
                            restarted.append(self._restart_shard(i))
            reports: list[TickReport | None] = []
            for i, srv in enumerate(self.shards):
                if srv is None:
                    reports.append(None)
                    continue
                if self.chaos is not None:
                    if self.chaos.should_kill(i, self.tick_count):
                        try:
                            raise ShardFailure(i, self.tick_count)
                        except ShardFailure:
                            self._kill_shard(i)
                        reports.append(None)
                        continue
                    delay = self.chaos.slow_delay(i, self.tick_count)
                    if delay > 0:
                        self._m_slow_inj.inc()
                    srv.inject_delay_s = delay
                reports.append(srv.tick())
                if self.checkpointer is not None:
                    self.checkpointer.maybe_save(i, srv.tick_count,
                                                 srv.snapshot_state)
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
            events=[e for r in live for e in r.events],
            n_active=n_active,
            n_twins=sum(r.n_twins for r in live),
            n_guarded=sum(r.n_guarded for r in live),
            degraded_level=max((r.degraded_level for r in live), default=0),
            dead_shards=len(self._dead),
            restarted=restarted,
            replayed_samples=sum(r["replayed"] for r in restarted))

    # -- failover: kill (chaos/organic) + supervised restart ------------ #
    def _kill_shard(self, i: int) -> None:
        """Take shard `i` down: stop its pump, drop the server object, hand
        its slot grant to the survivors.  Its rings and thetas die with it
        (nothing else holds its tensors: the registry's children are plain
        numbers); recovery is checkpoint + journal replay at restart."""
        srv = self.shards[i]
        if srv is not None:
            srv.close()
        self.shards[i] = None
        self._dead[i] = self.tick_count
        self._m_deaths.inc()
        self._m_dead.set(len(self._dead))
        if (self.chaos is not None and self.checkpointer is not None
                and self.chaos.should_tear()):
            self.checkpointer.tear_latest(i)
        self._rebalance()

    def _restart_shard(self, i: int) -> dict:
        """Supervised restart: fresh server (sharing a surviving donor's
        modules when configs match), restore from the last COMMITTED
        checkpoint, replay the journal suffix, rejoin the federation.
        Returns the restart record for the tick report."""
        scfg = self.cfg.servers[i]
        donor = next((s for s in self.shards
                      if s is not None and s.cfg == scfg), None)
        srv = self._new_shard(i, donor)
        ckpt_tick = None
        if self.checkpointer is not None:
            ckpt_tick, state = self.checkpointer.restore_latest(
                i, srv.snapshot_state())
            if state is not None:
                srv.restore_state(state)
        self.shards[i] = srv
        died_at = self._dead.pop(i)
        replayed = lost = 0
        if self.journals is not None:
            journal = self.journals[i]
            for tid in journal.twin_ids():
                rec = srv.twins.get(tid)
                seen = rec.samples if rec is not None else 0
                chunks, lost_t = journal.replay_since(tid, seen)
                lost += lost_t
                for y, u in chunks:
                    # force: replay must not be shed by ingest backpressure
                    srv.ingest(tid, y, u, force=True)
                    replayed += len(y)
            srv.drain()      # every replayed sample reaches the ring NOW
        srv.set_active_slots(self.grants[i])
        down = self.tick_count - died_at
        self._m_restarts.inc()
        self._m_recovery.observe(down)
        self._m_replayed.inc(replayed)
        if lost:
            self._m_replay_lost.inc(lost)
        self._m_dead.set(len(self._dead))
        return {"shard": i, "ckpt_tick": ckpt_tick, "replayed": replayed,
                "lost": lost, "down_ticks": down}

    # ------------------------------------------------------------------ #
    def snapshot_state(self) -> dict:
        """The whole fleet's state: one `TwinServer.snapshot_state` sub-tree
        per LIVE shard, keyed `"shard<i>"` (dead shards omitted -- their
        truth is the checkpoint + journal).  Device leaves are the shards'
        live tensors: `checkpoint.to_host` before ticking again."""
        return {f"shard{i}": srv.snapshot_state()
                for i, srv in enumerate(self.shards) if srv is not None}

    def drain(self) -> None:
        """Barrier: every ingested sample reaches its shard's ring."""
        for srv in self.shards:
            if srv is not None:
                srv.drain()

    def close(self) -> None:
        if self.checkpointer is not None:
            self.checkpointer.wait()
        for srv in self.shards:
            if srv is not None:
                srv.close()

    # ------------------------------------------------------------------ #
    def reset_latency_stats(self) -> None:
        self.latencies.clear()
        self.refresh_counts.clear()
        self._m_tick.reset()
        self._m_violations.reset()
        self._m_refreshes.reset()
        for srv in self.shards:
            if srv is not None:
                srv.reset_latency_stats()

    def latency_summary(self) -> dict:
        """p50/p99 of the WHOLE sharded tick + aggregate twin throughput.

        Registry-backed like `TwinServer.latency_summary` (same histograms
        `metrics.expose()` scrapes); dropped/overflow totals aggregate the
        per-shard counters."""
        h = self._m_tick
        ticks = h.count
        if ticks == 0:
            return {"ticks": 0}
        return {
            "ticks": ticks,
            "p50_ms": h.quantile(0.5) * 1e3,
            "p99_ms": h.quantile(0.99) * 1e3,
            "max_ms": h.max * 1e3,
            "deadline_s": self.deadline_s,
            "violations": int(self._m_violations.value),
            "twin_refreshes_per_s":
                self._m_refreshes.value / max(h.sum, 1e-9),
            "dropped_samples": sum(int(s._m_dropped.value)
                                   for s in self.shards if s is not None),
            "flush_overflows": sum(int(s._m_overflow.value)
                                   for s in self.shards if s is not None),
        }

    def stage_summary(self) -> dict:
        """Aggregate per-tick stage cost across shards (ms): the guard
        column is the scale benchmark's O(budget) evidence."""
        out: dict[str, float] = {}
        for srv in self.shards:
            if srv is None:
                continue
            for k, v in srv.stage_summary().items():
                out[k] = out.get(k, 0.0) + v
        return out
