"""TwinServer: the online serving loop — ingest, refit, deploy, guard.

One `tick()` is a full serving cycle over the whole tracked fleet:

    1. FLUSH    staged telemetry into the device ring (one scatter for every
                twin that produced samples this tick).  With `async_ingest`
                the host-side merge/pad work runs on a background
                `BackgroundPump` thread (data/pipeline.py); the tick only
                copies prepared batches to the device and scatters them,
    2. GUARD    RK4-roll deployed thetas over their newest window (the RK4
                kernel) and EMA-fold the normalized rollout error into each
                twin's divergence score; REFIT/ALERT events on transitions,
    3. SCHEDULE admit/evict/release twins over the bounded refit-slot pool
                (`PackedRefitScheduler`, one device pass over packed arrays;
                or the reference `RefitScheduler`, which sorts the record
                dict on the host),
    4. REFIT    `steps_per_tick` FleetMerinda train steps over all slots at
                once (GRU-scan kernel + RK4 kernel per step),
    5. PROMOTE  recover_all on slots past `deploy_after`, shadow-evaluate
                against the incumbent, scatter winners into the theta store.

The tick ends with a device synchronize, so tick latency counts the device
work.  Unassigned refit slots park on a scratch ring row (`max_twins`).
The ring and the theta store are updated IN PLACE.

`predict(twin_id, horizon)` rolls the deployed model forward from the
twin's newest telemetry; `scenario(...)` answers a batched what-if query.

Crash safety (twin/recovery.py): `snapshot_state` gives the whole serving
state as a tree of fixed shapes, which a `TwinCheckpointer` writes in the
JAX package's checkpoint layout; `restore_state` rebuilds a fresh server
from it (from a JAX server's snapshot too), and `ingest(..., force=True)`
replays a `TelemetryJournal` suffix past a bounded staging buffer.
`share_modules_from` lets a restarted server reuse a running one's ring,
fleet, guard and scenario modules.

Fleet hooks (twin/sharded.py, twin/federation.py): `shard=` puts a
`{"shard": "<i>"}` label on every instrument, so many shards share one
registry; `set_active_slots` caps the refit slots the scheduler may fill
(the federation's grant); `refit_pressure` is the demand the federation
divides the global budget by; `inject_delay_s` is a chaos straggler's sleep
inside the timed tick.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.fleet import FleetConfig, FleetMerinda
from repro_torch.core.merinda import MerindaConfig
from repro_torch.data.pipeline import BackgroundPump
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.obs import MetricRegistry, Tracer
from repro_torch.train import checkpoint
from repro_torch.twin.monitor import (DivergenceGuard, GuardConfig,
                                      GuardEvent, GuardInstruments,
                                      GuardRotation)
from repro_torch.twin.packed import PackedFleet
from repro_torch.twin.recovery import DegradationConfig, DegradationPolicy
from repro_torch.twin.scenario import (ScenarioConfig, ScenarioRefused,
                                       ScenarioResult, ScenarioRunner,
                                       effective_k)
from repro_torch.twin.scheduler import (PackedRefitScheduler, RefitScheduler,
                                        SchedulerConfig, SchedulePlan,
                                        SchedulerMetrics, TwinRecord)
from repro_torch.twin.service import DeadlineConfig
from repro_torch.twin.stream import (FlushBatch, RingConfig, StagingBuffer,
                                     StagingOverflow, TelemetryRing,
                                     prepare_flush)

__all__ = ["TwinServerConfig", "TickReport", "TwinServer", "TorchInitSource"]

_STAGES = ("flush", "guard", "schedule", "refit")
_HISTORY = 4096       # recent-tick raw numbers kept for inspection


@dataclass(frozen=True)
class TwinServerConfig(DeadlineConfig):
    """Single-server knobs; `deadline_s` (1.0 s default) comes from
    `DeadlineConfig`."""
    merinda: MerindaConfig
    max_twins: int                    # tracked-object capacity
    refit_slots: int = 8              # concurrent refits (compute budget)
    capacity: int = 512               # ring samples per twin
    window: int = 24                  # refit window k
    stride: int = 8
    windows_per_twin: int = 16        # S_B per slot per train step
    steps_per_tick: int = 2           # incremental train steps per tick
    lr: float = 3e-3
    sparsify_after: int = 60          # per-slot warmup (FleetConfig)
    deploy_after: int = 24            # train steps before a slot's theta ships
    promote_margin: float = 0.7       # candidate must score < margin * incumbent
    guard: GuardConfig = GuardConfig()
    guard_budget: int | None = None   # None: score the whole store per tick;
                                      # int: rotating subset of this size
    guard_carry: int | None = None    # extra per-tick re-scores of flagged
                                      # twins (default: guard_budget // 4)
    async_ingest: bool = False        # background staging flush thread
    ingest_depth: int = 2             # prepared-batch queue depth (double buf)
    staleness_weight: float = 1.0
    divergence_weight: float = 4.0
    evict_margin: float = 0.5
    min_residency: int = 8
    max_residency: int = 64
    release_divergence: float = 0.05
    scheduler: str = "bucketed"       # "bucketed": PackedRefitScheduler
                                      # (one device scoring pass);
                                      # "reference": the O(n log n)
                                      # dict-sorting oracle
    flush_pad: int = 8                # chunk-length quantum
    degradation: DegradationConfig = DegradationConfig()
                                      # deadline-aware shed ladder
                                      # (twin/recovery.py; disabled default)
    scenario: ScenarioConfig = ScenarioConfig()
                                      # what-if engine knobs
                                      # (twin/scenario.py)
    staging_capacity: int | None = None
                                      # staging-buffer sample bound (None:
                                      # unbounded)
    ingest_strict: bool = True        # overflow after retries: raise (True)
                                      # or shed oldest staged samples
    ingest_retries: int = 3           # bounded backoff attempts on overflow
    ingest_backoff_s: float = 2e-3    # first retry sleep (doubles per try)
    seed: int = 0


@dataclass
class TickReport:
    tick: int
    latency_s: float
    deadline_met: bool
    loss: float | None                # mean refit loss (None: no active slot)
    events: list[GuardEvent] = field(default_factory=list)
    admitted: list = field(default_factory=list)   # [(slot, twin_id)]
    evicted: list = field(default_factory=list)
    released: list = field(default_factory=list)
    n_active: int = 0                 # twins resident in refit slots
    n_twins: int = 0                  # twins tracked
    n_guarded: int = 0                # twins scored by the guard this tick
    degraded_level: int = 0           # shed ladder after this tick (0 = full)
    degradation_events: list = field(default_factory=list)


class TorchInitSource:
    """The server's default source of random model parameters.

    The init-source protocol: `fleet_init()` is called once at
    construction, `slot_init()` once per admission, in admission order;
    `state()` returns a uint32[2] array and `load(state)` resumes from one.
    The server checkpoints `state()` as its snapshot's "key" leaf, the
    place (and shape) of the JAX server's PRNG key, so a checkpoint of
    either package passes the other's shape check.  A test hands the server
    another object with the same four methods (for instance one that
    replays the JAX server's draws through repro_torch.convert, whose state
    is the JAX key itself).

    Here the state is (seed, draws so far): `fleet_init` draws from a CPU
    `torch.Generator` seeded with `seed`, and admission k (counting from 0)
    from one seeded with seed * 2^32 + k + 1, so `load` resumes in O(1)
    with no replay.  A JAX key loaded here is taken the same way: its two
    words become (seed, draws), which names a reproducible stream of
    admissions but not the JAX server's own draws.
    """

    def __init__(self, fleet: FleetMerinda, seed: int):
        self.fleet = fleet
        self.seed = int(seed) & 0xFFFFFFFF
        self.draws = 0

    def fleet_init(self):
        return self.fleet.init(torch.Generator().manual_seed(self.seed))

    def slot_init(self):
        self.draws += 1
        gen = torch.Generator().manual_seed((self.seed << 32) + self.draws)
        return self.fleet.model.init(gen, device="cpu")

    def state(self) -> np.ndarray:
        return np.asarray([self.seed, self.draws], np.uint32)

    def load(self, state) -> None:
        self.seed, self.draws = (int(v) for v in np.asarray(state,
                                                            np.uint32))


class TwinServer:
    def __init__(self, cfg: TwinServerConfig, *, device=None,
                 share_modules_from: "TwinServer | None" = None,
                 init_source=None, seed: int | None = None,
                 metrics: MetricRegistry | None = None,
                 tracer: Tracer | None = None,
                 shard: int | str | None = None):
        """`device=None` runs on the CUDA card and raises without one;
        `device="cpu"` runs the plain PyTorch path.  `share_modules_from`
        reuses another server's ring, fleet, guard and scenario modules
        (they hold no serving state; the configs must agree on their
        shapes, and the device is the other server's).  `init_source`
        supplies random parameters (default: `TorchInitSource(fleet,
        seed)`, `seed` defaulting to `cfg.seed`; see its docstring for the
        protocol).  `metrics`/`tracer` attach shared observability: a
        sharded server passes one registry and tracer to every shard, each
        with its own `shard` label."""
        if cfg.scheduler not in ("bucketed", "reference"):
            raise ValueError(f"unknown scheduler {cfg.scheduler!r} "
                             "(expected 'bucketed' or 'reference')")
        m = cfg.merinda
        self.cfg = cfg
        src = share_modules_from
        self.device = resolve_device(device) if src is None else src.device
        self.metrics = MetricRegistry() if metrics is None else metrics
        self.tracer = Tracer(enabled=False) if tracer is None else tracer
        self._labels = {} if shard is None else {"shard": str(shard)}
        self.span = TelemetryRing.span(cfg.window, cfg.stride,
                                       cfg.windows_per_twin)
        self.min_samples = self.span + 1
        if cfg.capacity < max(self.min_samples, cfg.guard.window + 1):
            raise ValueError("ring capacity smaller than the refit/guard span")

        self._scratch = cfg.max_twins     # scratch ring row + theta row
        if src is not None:
            if src.cfg.merinda != m or src.cfg.max_twins != cfg.max_twins \
                    or src.cfg.refit_slots != cfg.refit_slots \
                    or src.cfg.capacity != cfg.capacity \
                    or src.cfg.windows_per_twin != cfg.windows_per_twin \
                    or src.cfg.lr != cfg.lr \
                    or src.cfg.sparsify_after != cfg.sparsify_after \
                    or src.cfg.guard != cfg.guard \
                    or src.cfg.scenario != cfg.scenario \
                    or (device is not None
                        and resolve_device(device) != src.device):
                raise ValueError("share_modules_from requires identical "
                                 "module shapes, guard/scenario config and "
                                 "device (merinda/ring/fleet cfg)")
            # the ring, fleet, guard and scenario runner hold no serving
            # state (it is passed to them explicitly)
            self.ring, self.fleet, self.guard = src.ring, src.fleet, src.guard
            self.scenario_runner = src.scenario_runner
        else:
            self.ring = TelemetryRing(RingConfig(
                slots=cfg.max_twins + 1, capacity=cfg.capacity, n=m.n,
                m=m.m), device=self.device)
            self.fleet = FleetMerinda(FleetConfig(
                merinda=m, fleet=cfg.refit_slots,
                windows_per_twin=cfg.windows_per_twin, lr=cfg.lr,
                sparsify_after=cfg.sparsify_after), device=self.device,
                tracer=self.tracer)
            self.guard = DivergenceGuard(self.fleet.model.lib, m.dt,
                                         cfg.guard)
            self.scenario_runner = ScenarioRunner(self.fleet.model.lib, m.dt,
                                                  cfg.scenario,
                                                  tracer=self.tracer)
        self._rstate = self.ring.init()
        self._init = (TorchInitSource(self.fleet,
                                      cfg.seed if seed is None else seed)
                      if init_source is None else init_source)
        self._fstate = self._to_device(self._init.fleet_init())

        sched_cfg = SchedulerConfig(
            slots=cfg.refit_slots, min_samples=self.min_samples,
            staleness_weight=cfg.staleness_weight,
            divergence_weight=cfg.divergence_weight,
            evict_margin=cfg.evict_margin, min_residency=cfg.min_residency,
            max_residency=cfg.max_residency,
            release_divergence=cfg.release_divergence)
        sched_metrics = SchedulerMetrics.create(self.metrics, self._labels)
        if cfg.scheduler == "bucketed":
            self.scheduler = PackedRefitScheduler(
                sched_cfg, metrics=sched_metrics, device=self.device)
        else:
            self.scheduler = RefitScheduler(sched_cfg, metrics=sched_metrics)
        # packed arrays are the scheduler's truth: every mutation point
        # below writes BOTH the record and its packed row; the record dict
        # is the metadata mirror the reference planner reads
        self.packed = PackedFleet(cfg.max_twins)
        self._max_active: int | None = None   # slot cap (None: all slots)
        self.inject_delay_s = 0.0     # chaos straggler: sleep inside the
                                      # timed tick (twin/recovery.py)

        self._rotation = (None if cfg.guard_budget is None else
                          GuardRotation(cfg.guard_budget,
                                        cfg.guard_budget // 4
                                        if cfg.guard_carry is None
                                        else cfg.guard_carry))

        self.twins: dict[int, TwinRecord] = {}
        self._row2rec: dict[int, TwinRecord] = {}     # ring row -> record
        # guard-eligible set (deployed + enough samples), kept incrementally;
        # _div IS the packed fleet's divergence column (same array object)
        self._guard_live: dict[int, TwinRecord] = {}
        self._guard_min = cfg.guard.window + 1
        self._div = self.packed.divergence
        self._live_rows = np.empty((0,), np.int64)
        self._live_dirty = False
        self._reg_lock = threading.Lock()
        self._guard_state: dict[int, str] = {}        # twin_id -> last kind
        self._slot_ring = np.full((cfg.refit_slots,), self._scratch,
                                  dtype=np.int32)     # refit slot -> ring row
        self._slot_twin: dict[int, int] = {}          # refit slot -> twin_id
        L = self.fleet.model.lib.size
        self._theta = torch.zeros((cfg.max_twins + 1, m.n, L),
                                  device=self.device)
        # per-twin ring of recently served thetas (scenario ensemble)
        self._theta_hist = torch.zeros(
            (cfg.max_twins + 1, cfg.scenario.ensemble, m.n, L),
            device=self.device)
        self._hist_count = np.zeros((cfg.max_twins + 1,), np.int64)
        self._staging = StagingBuffer(capacity=cfg.staging_capacity)
        self._degradation = DegradationPolicy(cfg.degradation, cfg.deadline_s)
        # the pump thread does host work only (merge and pad staged
        # samples); every device copy and scatter stays in _apply, on the
        # serving thread
        self._pump = (BackgroundPump(self._prepare_timed,
                                     depth=cfg.ingest_depth)
                      if cfg.async_ingest else None)
        self.tick_count = 0
        self._n_deployed = 0
        self.latencies: deque[float] = deque(maxlen=_HISTORY)
        self.stage_times: dict[str, deque] = {s: deque(maxlen=_HISTORY)
                                              for s in _STAGES}
        self.refresh_counts: deque[int] = deque(maxlen=_HISTORY)
        self.events: list[GuardEvent] = []
        self._init_instruments()

    def _to_device(self, tree):
        if isinstance(tree, dict):
            return {k: self._to_device(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(self._to_device(v) for v in tree))
        return tree.to(self.device)

    def _init_instruments(self) -> None:
        """Resolve this server's metric children (per-shard labels)."""
        M, lab = self.metrics, self._labels
        self._m_tick = M.histogram(
            "twin_tick_latency_seconds",
            help="full serving-tick wall latency", unit="seconds",
            labels=lab)
        self._m_stage = {
            s: M.histogram("twin_stage_latency_seconds",
                           help="per-stage serving-tick wall latency",
                           unit="seconds", labels={**lab, "stage": s})
            for s in _STAGES}
        self._m_violations = M.counter(
            "twin_deadline_violations_total",
            help="ticks whose wall latency exceeded deadline_s",
            labels=lab)
        self._m_refreshes = M.counter(
            "twin_slot_refreshes_total",
            help="refit-slot train advances (active slots summed per tick)",
            labels=lab)
        self._m_dropped = M.counter(
            "twin_dropped_samples_total",
            help="telemetry samples truncated by flush backlog",
            labels=lab)
        self._m_overflow = M.counter(
            "twin_flush_overflows_total",
            help="flush batches that truncated a backlog",
            labels=lab)
        self._m_prepare = M.histogram(
            "twin_flush_prepare_seconds",
            help="host-side staging merge/pad latency", unit="seconds",
            labels=lab)
        self._m_tracked = M.gauge(
            "twin_tracked_twins", help="registered tracked objects",
            labels=lab)
        self._m_deployed = M.gauge(
            "twin_deployed_twins", help="twins with a serving theta",
            labels=lab)
        self._m_active = M.gauge(
            "twin_active_slots", help="refit slots currently assigned",
            labels=lab)
        self._m_staging = M.gauge(
            "twin_staging_pending_samples",
            help="samples staged but not yet flushed",
            labels=lab)
        self._m_queue = M.gauge(
            "twin_pump_queue_depth",
            help="prepared flush batches awaiting the serving tick",
            labels=lab)
        self._m_degraded = M.gauge(
            "twin_degraded_level",
            help="deadline-degradation ladder level (0 = full service)",
            labels=lab)
        self._m_deg_trans = {
            d: M.counter("twin_degraded_transitions_total",
                         help="degradation ladder moves by direction",
                         labels={**lab, "direction": d})
            for d in ("up", "down")}
        self._m_shed = {
            a: M.counter("twin_degraded_shed_total",
                         help="ticks that shed a stage under degradation",
                         labels={**lab, "action": a})
            for a in ("guard", "refit", "promote")}
        self._m_ingest_retries = M.counter(
            "twin_ingest_retries_total",
            help="ingest backoff retries after a staging overflow",
            labels=lab)
        self._m_ingest_dropped = M.counter(
            "twin_ingest_dropped_total",
            help="staged samples shed (drop-oldest) by non-strict ingest "
                 "backpressure",
            labels=lab)
        self._guard_obs = GuardInstruments.create(M, lab)
        self._m_scn_latency = M.histogram(
            "twin_scenario_latency_seconds",
            help="what-if query wall latency (ensemble x K fused rollout)",
            unit="seconds",
            labels=lab)
        self._m_scn_requests = M.counter(
            "twin_scenario_requests_total",
            help="scenario queries answered",
            labels=lab)
        self._m_scn_rollouts = M.counter(
            "twin_scenario_rollouts_total",
            help="individual trajectories integrated for scenario queries "
                 "(effective K x ensemble)",
            labels=lab)
        self._m_scn_shrunk = M.counter(
            "twin_scenario_shrunk_total",
            help="scenario queries served with K shrunk by the degradation "
                 "ladder",
            labels=lab)
        self._m_scn_refused = M.counter(
            "twin_scenario_refused_total",
            help="scenario queries refused under deadline pressure",
            labels=lab)
        self._m_scn_confidence = M.histogram(
            "twin_scenario_confidence",
            help="per-scenario ensemble confidence (1 = recent thetas "
                 "agree)", bounds=(0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0),
            labels=lab)

    # ------------------------------------------------------------------ #
    def register(self, twin_id: int) -> TwinRecord:
        """Start tracking an object; assigns its telemetry ring row."""
        rec = self.twins.get(twin_id)
        if rec is not None:
            return rec
        with self._reg_lock:
            rec = self.twins.get(twin_id)
            if rec is not None:
                return rec
            row = len(self.twins)
            if row >= self.cfg.max_twins:
                raise RuntimeError(f"server full ({self.cfg.max_twins} twins)")
            rec = TwinRecord(twin_id=twin_id, ring_slot=row)
            self.twins[twin_id] = rec
            self._row2rec[row] = rec
            self._guard_state[twin_id] = "OK"
            self.packed.register(row, twin_id)
            return rec

    def twin_snapshot(self) -> dict[int, TwinRecord]:
        """Registry copy safe to iterate while ingest threads register."""
        with self._reg_lock:
            return dict(self.twins)

    def _guard_add(self, rec: TwinRecord) -> None:
        """Admit a record to the guard-eligible set (idempotent)."""
        if rec.ring_slot not in self._guard_live:
            self._guard_live[rec.ring_slot] = rec
            self.packed.set_divergence(rec.ring_slot, rec.divergence)
            self._live_dirty = True

    # ------------------------------------------------------------------ #
    def ingest(self, twin_id: int, y, u=None, *, force: bool = False):
        """Stage telemetry for `twin_id`: y [n] or [C, n], u [m] or [C, m].

        Host-side staging only — the device scatter happens once per tick.
        Thread-safe: with `async_ingest` many sensor threads may call this
        concurrently with `tick()` (the staging buffer is the synchronized
        handoff).  A bounded staging buffer (`cfg.staging_capacity`)
        retries with doubling backoff on overflow (kicking the pump each
        try), then raises (`ingest_strict`) or sheds the oldest staged
        samples.  `force=True` bypasses the bound entirely (crash-recovery
        replay, twin/recovery.py).
        """
        rec = self.register(twin_id)
        y = np.atleast_2d(np.asarray(y, np.float32))
        C = y.shape[0]
        m = self.cfg.merinda.m
        u = (np.zeros((C, m), np.float32) if u is None
             else np.asarray(u, np.float32).reshape(C, m))
        if C > self.cfg.capacity:
            raise ValueError("chunk larger than ring capacity")
        try:
            self._staging.append(rec.ring_slot, y, u, force=force)
        except StagingOverflow:
            self._ingest_backpressure(rec.ring_slot, y, u)
        if self._pump is not None:
            self._pump.kick()

    def ingest_many(self, batch, *, force: bool = False) -> int:
        """Batched `ingest`: `batch` iterates (twin_id, y) or (twin_id, y,
        u) chunks.  Returns the number of SAMPLES staged.  Same
        thread-safety and backpressure contract as `ingest`."""
        staged = chunks = 0
        with self.tracer.span("ingest_many", cat="ingest",
                              **self._labels) as sp:
            for chunk in batch:
                tid, y = chunk[0], chunk[1]
                u = chunk[2] if len(chunk) > 2 else None
                self.ingest(tid, y, u, force=force)
                staged += np.atleast_2d(np.asarray(y)).shape[0]
                chunks += 1
            sp.note(chunks=chunks, samples=staged)
        return staged

    def _ingest_backpressure(self, row: int, y, u) -> None:
        """Bounded retry-with-backoff, then strict-raise or drop-oldest."""
        delay = self.cfg.ingest_backoff_s
        for _ in range(max(0, self.cfg.ingest_retries)):
            self._m_ingest_retries.inc()
            if self._pump is not None:
                self._pump.kick()      # give the flusher a chance to drain
            time.sleep(delay)
            delay *= 2
            try:
                self._staging.append(row, y, u)
                return
            except StagingOverflow:
                continue
        if self.cfg.ingest_strict:
            raise StagingOverflow(
                f"staging buffer still full after "
                f"{self.cfg.ingest_retries} retries "
                f"(capacity {self.cfg.staging_capacity} samples)")
        dropped = self._staging.drop_oldest(len(y))
        self._m_ingest_dropped.inc(dropped)
        self._staging.append(row, y, u, force=True)

    # -- staging flush: prepare (host, maybe background) + apply (device) - #
    def _prepare_timed(self) -> FlushBatch | None:
        """Swap the staging buffer and merge/pad it (numpy only), under a
        span and a latency histogram.  With async ingest this runs on the
        pump thread, so the span lands on the pump's own trace track."""
        m = self.cfg.merinda
        with self.tracer.span("pump_flush", cat="ingest",
                              **self._labels) as sp:
            t0 = time.perf_counter()
            batch = prepare_flush(self._staging.swap(),
                                  capacity=self.cfg.capacity,
                                  pad=self.cfg.flush_pad,
                                  scratch=self._scratch, n=m.n, m=m.m)
            self._m_prepare.observe(time.perf_counter() - t0)
            if batch is not None:
                B, C = batch.ys.shape[:2]
                sp.note(rows=len(batch.received), padded_rows=B,
                        samples=int(batch.counts.sum()),
                        padded_samples=B * C, dropped=batch.dropped)
        return batch

    @property
    def dropped_samples(self) -> int:
        """Backlog samples truncated by the flush (counter-backed)."""
        return int(self._m_dropped.value)

    def _apply(self, batch: FlushBatch) -> int:
        if batch.dropped:
            self._m_dropped.inc(batch.dropped)
            self._m_overflow.inc()
        for row, raw in batch.received.items():
            rec = self._row2rec[row]
            rec.samples += raw
            self.packed.samples[row] = rec.samples
            if rec.deployed and rec.samples >= self._guard_min:
                self._guard_add(rec)
        dev = lambda a: torch.from_numpy(a).to(self.device)
        self.ring.ingest(self._rstate, dev(batch.slots), dev(batch.ys),
                         dev(batch.us), dev(batch.counts))
        return sum(batch.received.values())

    def _flush(self) -> int:
        if self._pump is not None:
            with self.tracer.span("flush.apply"):
                return sum(self._apply(b) for b in self._pump.drain())
        batch = self._prepare_timed()
        if batch is None:
            return 0
        with self.tracer.span("flush.apply"):
            return self._apply(batch)

    def drain(self) -> None:
        """Barrier: every sample ingested before this call reaches the ring.

        With async ingest, waits for the pump to go idle, applies every
        prepared batch, then flushes anything still staged inline.  Must be
        called from the serving (tick) thread — device state is
        single-threaded by design.

        Guarantee: on return, all samples whose `ingest()` call returned
        BEFORE `drain()` started are in the ring.  Samples ingested
        concurrently with the drain may or may not be included (they are
        never lost — at worst they wait for the next flush).  Busy-waits in
        0.1 ms sleeps while the pump finishes its in-flight batch; does not
        block producers.
        """
        if self._pump is not None:
            while not self._pump.idle():
                for b in self._pump.drain():
                    self._apply(b)
                time.sleep(1e-4)
            for b in self._pump.drain():
                self._apply(b)
        batch = self._prepare_timed()
        if batch is not None:
            self._apply(batch)

    def close(self) -> None:
        """Stop the async flush worker (no-op for synchronous servers)."""
        if self._pump is not None:
            self._pump.close()

    # ------------------------------------------------------------------ #
    def set_active_slots(self, n: int | None) -> None:
        """Cap the refit slots the scheduler may fill (the federation's
        grant).  None restores the full physical pool."""
        self._max_active = n

    @property
    def active_slot_cap(self) -> int:
        return (self.cfg.refit_slots if self._max_active is None
                else max(0, min(self.cfg.refit_slots, self._max_active)))

    def refit_pressure(self) -> float:
        """Aggregate staleness + divergence refit demand, the federation's
        rebalance signal: one device reduction over the packed arrays
        (bucketed scheduler), or the host scan over a registry snapshot
        (reference scheduler)."""
        if isinstance(self.scheduler, PackedRefitScheduler):
            return self.scheduler.pressure(self.packed)
        return self.scheduler.pressure(self.twin_snapshot())

    # ------------------------------------------------------------------ #
    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def _hist_push(self, rows: np.ndarray, thetas) -> None:
        """Append served thetas [B, n, L] to the per-twin history rings (one
        in-place scatter): the scenario ensemble holds the `ensemble` most
        recently SERVED models per twin."""
        pos = self._hist_count[rows] % self.cfg.scenario.ensemble
        self._theta_hist[self._rows(rows), self._rows(pos)] = thetas
        self._hist_count[rows] += 1

    def deploy(self, twin_id: int, theta) -> None:
        """Install a theta for `twin_id` directly (warm start from an
        offline recovery)."""
        self.deploy_many([twin_id], torch.as_tensor(theta)[None])

    def deploy_many(self, twin_ids, thetas) -> None:
        """Warm-start many twins in one scatter: thetas [B, n, L] (or one
        [n, L] broadcast to every twin).  Serving-thread only."""
        recs = [self.register(t) for t in twin_ids]
        rows = np.asarray([r.ring_slot for r in recs], np.int64)
        # explicit float32: a float64 host array would otherwise stay float64
        thetas = torch.as_tensor(thetas).to(self.device, torch.float32)
        if thetas.ndim == 2:
            thetas = thetas.expand((len(recs),) + tuple(thetas.shape))
        self._theta[self._rows(rows)] = thetas
        self._hist_push(rows, thetas)
        for rec in recs:
            self._mark_deployed(rec)
            rec.samples_at_deploy = rec.samples
            self.packed.samples_at_deploy[rec.ring_slot] = rec.samples
            rec.deploy_tick = self.tick_count
            if rec.samples >= self._guard_min:
                self._guard_add(rec)

    def _mark_deployed(self, rec: TwinRecord) -> None:
        if not rec.deployed:
            rec.deployed = True
            self.packed.deployed[rec.ring_slot] = True
            self._n_deployed += 1

    # ------------------------------------------------------------------ #
    def _update_divergence(self, shed: bool = False
                           ) -> tuple[list[GuardEvent], int]:
        gw = self.cfg.guard.window
        live = self._guard_live
        if not live:
            return [], 0
        # full scan, degraded: score every other tick
        if self._rotation is None and shed and self.tick_count % 2 == 0:
            return [], 0
        span = self.tracer.span
        with span("guard.score") as sp:
            if self._rotation is None:
                # full scan: one rollout over the whole store
                width = self.cfg.max_twins
                rows = torch.arange(width, device=self.device)
                ys, us = self.ring.latest(self._rstate, rows, gw)
                scores = self.guard.score(self._theta[:-1], ys, us)
                recs = list(live.values())
                srows = np.fromiter((r.ring_slot for r in recs), np.int64,
                                    count=len(recs))
            else:
                # budgeted rotation: fixed-width rollout.  Degraded: a
                # smaller width, no carry
                if self._live_dirty:
                    self._live_rows = np.fromiter(sorted(live), np.int64,
                                                  count=len(live))
                    self._live_dirty = False
                if shed:
                    width = max(1, self._rotation.budget
                                // max(1, self.cfg.degradation.guard_shrink))
                    pick = self._rotation.select(
                        self._live_rows, self._div,
                        self.cfg.guard.refit_threshold, budget=width,
                        carry=0)
                else:
                    width = self._rotation.size
                    pick = self._rotation.select(
                        self._live_rows, self._div,
                        self.cfg.guard.refit_threshold)
                rows_np = np.full((width,), self._scratch, np.int64)
                rows_np[:len(pick)] = pick
                rows = self._rows(rows_np)
                ys, us = self.ring.latest(self._rstate, rows, gw)
                scores = self.guard.score(self._theta[rows], ys, us)
                recs = [live[int(row)] for row in pick]
                srows = np.asarray(pick, np.int64)
            sp.note(scored=len(recs), width=width)
        with span("guard.wait"):
            scores = scores.cpu().numpy()
        with span("guard.judge"):
            raw = (scores[srows] if self._rotation is None
                   else scores[:len(recs)])
            # one vectorized EMA fold publishes the smoothed scores into the
            # packed divergence column; the record fields mirror them
            smoothed = self.guard.fold_into(self._div, srows, raw)
            self.packed.div32[srows] = smoothed
            events: list[GuardEvent] = []
            score_hist = self._guard_obs.score
            for rec, score, div in zip(recs, raw, smoothed):
                score_hist.observe(float(score))
                rec.divergence = float(div)
                ev = self.guard.judge(rec.twin_id, rec.divergence,
                                      self.tick_count)
                kind = ev.kind if ev else "OK"
                if kind != self._guard_state[rec.twin_id]:
                    self._guard_state[rec.twin_id] = kind
                    if ev:
                        events.append(ev)
                        self._guard_obs.events[ev.kind].inc()
            self.events.extend(events)
            self._guard_obs.scored.inc(len(recs))
        return events, len(recs)

    # ------------------------------------------------------------------ #
    def _slot_windows(self):
        return self.ring.windows(self._rstate, self._rows(self._slot_ring),
                                 window=self.cfg.window,
                                 stride=self.cfg.stride, length=self.span)

    def _apply_plan(self, plan: SchedulePlan) -> None:
        packed = self.packed
        for tid in plan.evict + plan.release:
            rec = self.twins[tid]
            self._slot_ring[rec.refit_slot] = self._scratch
            self._slot_twin.pop(rec.refit_slot, None)
            rec.refit_slot = None
            rec.residency = rec.steps_in_slot = 0
            packed.resident[rec.ring_slot] = False
            packed.residency[rec.ring_slot] = 0
        for slot, tid in plan.admit:
            rec = self.twins[tid]
            y_w, u_w = self.ring.windows(
                self._rstate, self._rows([rec.ring_slot]),
                window=self.cfg.window, stride=self.cfg.stride,
                length=self.span)
            self.fleet.reset_slot(self._fstate, slot, self._init.slot_init(),
                                  y_w[0], u_w[0])
            rec.refit_slot = slot
            rec.admitted_tick = self.tick_count
            rec.residency = rec.steps_in_slot = 0
            packed.resident[rec.ring_slot] = True
            packed.residency[rec.ring_slot] = 0
            self._slot_ring[slot] = rec.ring_slot
            self._slot_twin[slot] = tid

    def _refit(self, defer: bool = False, skip_promote: bool = False
               ) -> float | None:
        if not self._slot_twin:
            return None
        span = self.tracer.span
        if defer:
            # degraded (level >= 2): slots hold; converged candidates may
            # still ship (level < 3)
            if not skip_promote:
                deployable = [
                    slot for slot, tid in self._slot_twin.items()
                    if self.twins[tid].steps_in_slot >= self.cfg.deploy_after]
                if deployable:
                    with span("refit.windows"):
                        y_win, u_win = self._slot_windows()
                    self._promote(deployable, y_win, u_win)
            return None
        with span("refit.windows"):
            y_win, u_win = self._slot_windows()
        loss_vec = None
        for k in range(self.cfg.steps_per_tick):
            with span("refit.step", step=k):
                self._fstate, loss_vec, _ = self.fleet.train_step_per_slot(
                    self._fstate, y_win, u_win)
        # report loss over ASSIGNED slots only — scratch-parked slots train
        # on zero windows and would dilute the mean toward zero
        with span("refit.wait"):
            losses = loss_vec.cpu().numpy()
        loss = float(np.mean(losses[sorted(self._slot_twin)]))
        deployable = []
        for slot, tid in self._slot_twin.items():
            rec = self.twins[tid]
            rec.steps_in_slot += self.cfg.steps_per_tick
            rec.residency += 1
            self.packed.residency[rec.ring_slot] = rec.residency
            if rec.steps_in_slot >= self.cfg.deploy_after:
                deployable.append(slot)
        if deployable and not skip_promote:
            self._promote(deployable, y_win, u_win)
        return loss

    def _promote(self, deployable, y_win, u_win) -> None:
        """Shadow-evaluate slot recoveries and deploy only improvements.

        Candidate and incumbent are rolled over the same newest telemetry.
        Against a HEALTHY incumbent (score < refit_threshold) the candidate
        must beat it by `promote_margin`; against a missing/diverged one it
        ships if it is outright good or a margin improvement.
        """
        thresh = self.cfg.guard.refit_threshold
        span = self.tracer.span
        with span("promote", candidates=len(deployable)) as sp:
            with span("promote.recover"):
                thetas = self.fleet.recover_all(self._fstate, y_win, u_win)
            with span("promote.score"):
                rows = self._rows(self._slot_ring)
                ys_g, us_g = self.ring.latest(self._rstate, rows,
                                              self.cfg.guard.window)
                cand = self.guard.score(thetas, ys_g, us_g)
                inc = self.guard.score(self._theta[rows], ys_g, us_g)
            with span("promote.wait"):
                cand, inc = cand.cpu().numpy(), inc.cpu().numpy()
            with span("promote.deploy"):
                promoted = self._deploy_winners(deployable, thetas, cand,
                                                inc, thresh)
            sp.note(promoted=len(promoted))

    def _deploy_winners(self, deployable, thetas, cand, inc, thresh) -> set:
        """The promote's decision and deploy: returns the promoted slots."""
        promoted = set()
        for slot in deployable:
            rec = self.twins[self._slot_twin[slot]]
            healthy_inc = rec.deployed and inc[slot] < thresh
            better = cand[slot] < self.cfg.promote_margin * inc[slot]
            if better or (not healthy_inc and cand[slot] < thresh):
                promoted.add(slot)
            elif healthy_inc:
                # candidate lost but the serving model is healthy: count a
                # completed review so the twin's staleness resets
                rec.samples_at_deploy = rec.samples
                self.packed.samples_at_deploy[rec.ring_slot] = rec.samples
        if promoted:
            slots = sorted(promoted)
            prows = np.asarray(
                [self.twins[self._slot_twin[s]].ring_slot for s in slots],
                np.int64)
            winners = thetas[self._rows(slots)]
            self._theta[self._rows(prows)] = winners      # in place
            self._hist_push(prows, winners)
        for slot in promoted:
            rec = self.twins[self._slot_twin[slot]]
            self._mark_deployed(rec)
            rec.samples_at_deploy = rec.samples
            self.packed.samples_at_deploy[rec.ring_slot] = rec.samples
            rec.deploy_tick = self.tick_count
            rec.divergence = float(min(cand[slot], 1e6))
            self.packed.set_divergence(rec.ring_slot, rec.divergence)
            if rec.samples >= self._guard_min:
                self._guard_add(rec)
        return promoted

    # ------------------------------------------------------------------ #
    def tick(self) -> TickReport:
        """One full serving cycle; see the module docstring for the stages.

        `TickReport.latency_s` and `cfg.deadline_s` are SECONDS.  The tick
        ends with a device synchronize, so its latency includes the device
        work.  Serving thread only; `ingest()` may run concurrently.
        """
        span = self.tracer.span
        deg = self._degradation
        shed_guard, defer_refit = deg.shed_guard, deg.defer_refit
        skip_promote = deg.skip_promote
        with span("tick", tick=self.tick_count + 1, **self._labels):
            t0 = time.perf_counter()
            self.tick_count += 1
            if self.inject_delay_s > 0.0:
                time.sleep(self.inject_delay_s)
            with span("flush"):
                self._flush()
            t1 = time.perf_counter()
            with span("guard"):
                if shed_guard:
                    self._m_shed["guard"].inc()
                events, n_guarded = self._update_divergence(shed=shed_guard)
            t2 = time.perf_counter()
            # bucketed: plan straight off the packed arrays (a twin
            # registered mid-plan is visible only once `registered` flips,
            # and with 0 samples it cannot be ready).  reference: plan on a
            # registry snapshot, since async ingest threads may register
            # twins mid-tick
            with span("schedule"):
                with span("schedule.plan"):
                    if isinstance(self.scheduler, PackedRefitScheduler):
                        plan = self.scheduler.plan(
                            self.packed, self._slot_ring,
                            max_active=self._max_active)
                    else:
                        plan = self.scheduler.plan(
                            self.twin_snapshot(),
                            max_active=self._max_active)
                with span("schedule.apply", admitted=len(plan.admit),
                          evicted=len(plan.evict)):
                    self._apply_plan(plan)
            t3 = time.perf_counter()
            with span("refit"):
                if defer_refit:
                    self._m_shed["refit"].inc()
                if skip_promote:
                    self._m_shed["promote"].inc()
                loss = self._refit(defer=defer_refit,
                                   skip_promote=skip_promote)
                with span("tick.wait"):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            t4 = time.perf_counter()
        latency = t4 - t0
        self.latencies.append(latency)
        self._m_tick.observe(latency)
        for stage, dt in zip(_STAGES, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            self.stage_times[stage].append(dt)
            self._m_stage[stage].observe(dt)
        if latency > self.cfg.deadline_s:
            self._m_violations.inc()
        deg_ev = deg.observe(self.tick_count, latency)
        self._m_degraded.set(deg.level)
        if deg_ev is not None:
            self._m_deg_trans[
                "up" if deg_ev.to_level > deg_ev.from_level else "down"].inc()
        n_active = len(self._slot_twin)
        self.refresh_counts.append(n_active)
        if n_active:
            self._m_refreshes.inc(n_active)
        self._m_tracked.set(len(self.twins))
        self._m_deployed.set(self._n_deployed)
        self._m_active.set(n_active)
        self._m_staging.set(self._staging.pending_samples())
        if self._pump is not None:
            self._m_queue.set(self._pump.queue_depth())
        self._guard_obs.live.set(len(self._guard_live))
        return TickReport(
            tick=self.tick_count, latency_s=latency,
            deadline_met=latency <= self.cfg.deadline_s, loss=loss,
            events=events, admitted=plan.admit, evicted=plan.evict,
            released=plan.release, n_active=n_active,
            n_twins=len(self.twins), n_guarded=n_guarded,
            degraded_level=deg.level,
            degradation_events=[deg_ev] if deg_ev is not None else [])

    # ------------------------------------------------------------------ #
    def _newest_state(self, rec: TwinRecord) -> torch.Tensor:
        ys, _ = self.ring.latest(self._rstate, self._rows([rec.ring_slot]), 0)
        return ys[:, -1, :]                                  # [1, n]

    @torch.no_grad()
    def predict(self, twin_id: int, horizon: int, us=None) -> torch.Tensor:
        """Roll the deployed model `horizon` steps from the newest
        telemetry.  Returns ys [horizon+1, n] on the server's device (row 0
        = the newest observed state)."""
        rec = self.twins[twin_id]
        if not rec.deployed:
            raise RuntimeError(f"twin {twin_id} has no deployed model")
        if rec.samples < 1:
            # the ring is still all zeros: a rollout would start from the
            # origin instead of the twin's actual state
            raise RuntimeError(f"twin {twin_id} has no telemetry to "
                               "predict from")
        m = self.cfg.merinda.m
        us = (torch.zeros((1, horizon, m), device=self.device) if us is None
              else torch.as_tensor(np.asarray(us, np.float32),
                                   device=self.device).reshape(1, horizon, m))
        out = rk4_poly_solve(self._theta[rec.ring_slot][None],
                             self._newest_state(rec), us,
                             dt=self.cfg.merinda.dt,
                             library=self.fleet.model.lib)
        return out[0]

    def scenario(self, twin_id: int, horizon: int, us=None,
                 k: int | None = None) -> ScenarioResult:
        """Answer a batched what-if query for one twin (twin/scenario.py).

        `us` is [K, horizon, m] counterfactual input sequences (or
        [horizon, m] for K=1; None = zero inputs, K from `k`).  Center
        trajectories come from the LIVE theta, lo/hi/confidence from the
        recent-theta ensemble.  Under deadline pressure K shrinks or the
        query raises `ScenarioRefused` before any device work.
        """
        rec = self.twins[twin_id]
        if not rec.deployed:
            raise RuntimeError(f"twin {twin_id} has no deployed model")
        if rec.samples < 1:
            raise RuntimeError(f"twin {twin_id} has no telemetry to "
                               "roll scenarios from")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        scfg = self.cfg.scenario
        m = self.cfg.merinda.m
        if us is not None:
            us = np.asarray(us, np.float32)
            if us.ndim == 2:
                us = us[None]
            if us.ndim != 3 or us.shape[1] != horizon or us.shape[2] != m:
                raise ValueError(f"us must be [K, {horizon}, {m}], "
                                 f"got {us.shape}")
            requested = us.shape[0] if k is None else int(k)
            if requested > us.shape[0]:
                raise ValueError(f"k {requested} exceeds provided "
                                 f"sequences {us.shape[0]}")
        else:
            requested = 1 if k is None else int(k)
        level = self._degradation.level
        with self.tracer.span("scenario", twin=int(twin_id), k=requested,
                              horizon=int(horizon), level=level) as sp:
            t0 = time.perf_counter()
            try:
                eff = effective_k(requested, level, scfg)
            except ScenarioRefused:
                self._m_scn_refused.inc()
                raise
            sp.note(effective_k=eff)
            if eff < requested:
                self._m_scn_shrunk.inc()
            us_eff = (np.zeros((eff, horizon, m), np.float32)
                      if us is None else np.ascontiguousarray(us[:eff]))
            center, lo, hi, conf = self.scenario_runner.rollout(
                self._theta_hist[rec.ring_slot],
                int(self._hist_count[rec.ring_slot]),
                self._newest_state(rec)[0], us_eff)
            self._m_scn_requests.inc()
            self._m_scn_rollouts.inc(eff * scfg.ensemble)
            for c in conf:
                self._m_scn_confidence.observe(float(c))
            self._m_scn_latency.observe(time.perf_counter() - t0)
        return ScenarioResult(twin_id=int(twin_id), horizon=int(horizon),
                              requested_k=requested, k=eff,
                              degraded_level=level, ys=center, lo=lo, hi=hi,
                              confidence=conf)

    # ------------------------------------------------------------------ #
    def reset_latency_stats(self) -> None:
        """Reset the measured-window stats (call after warm-up ticks).
        Lifetime counters (dropped samples, guard events) are left alone."""
        self.latencies.clear()
        self.refresh_counts.clear()
        for times in self.stage_times.values():
            times.clear()
        self._m_tick.reset()
        for h in self._m_stage.values():
            h.reset()
        self._m_violations.reset()
        self._m_refreshes.reset()
        self._degradation.reset()
        self._m_degraded.set(0)

    def latency_summary(self) -> dict:
        """p50/p99 tick latency vs the deadline + serving throughput, from
        the registry histograms (p50/p99 are log-bucket estimates, < 4%
        relative quantization; max/violations are exact)."""
        h = self._m_tick
        ticks = h.count
        if ticks == 0:
            return {"ticks": 0}
        return {
            "ticks": ticks,
            "p50_ms": h.quantile(0.5) * 1e3,
            "p99_ms": h.quantile(0.99) * 1e3,
            "max_ms": h.max * 1e3,
            "deadline_s": self.cfg.deadline_s,
            "violations": int(self._m_violations.value),
            "twin_refreshes_per_s":
                self._m_refreshes.value / max(h.sum, 1e-9),
            "dropped_samples": int(self._m_dropped.value),
            "flush_overflows": int(self._m_overflow.value),
        }

    def stage_summary(self) -> dict:
        """Mean per-tick cost of each serving stage (ms)."""
        out = {}
        for stage, hist in self._m_stage.items():
            n = hist.count
            out[f"{stage}_ms"] = (hist.sum / n * 1e3) if n else 0.0
        return out

    # -- crash-safe serving state (twin/recovery.py checkpoints) -------- #
    @property
    def degraded_level(self) -> int:
        """Current deadline-degradation ladder level (0 = full service)."""
        return self._degradation.level

    _GUARD_KINDS = ("OK", "REFIT", "ALERT")

    def snapshot_state(self) -> dict:
        """Full serving state as a tree of fixed shapes — what a
        `TwinCheckpointer` writes and `restore_state` consumes.

        The tree is the JAX server's, leaf for leaf (names, shapes, dtypes,
        pytree order), so either package's checkpoint restores into the
        other; the "key" leaf is the init source's uint32[2] `state()` (see
        `TorchInitSource`).  Every leaf's shape is a function of the CONFIG
        alone, never of runtime occupancy — so a fresh server's snapshot is
        a valid restore `like` and `checkpoint.restore`'s shape checks
        catch config drift.  Host arrays are COPIES; device leaves are the
        server's live tensors, which it updates in place: copy them to the
        host (`checkpoint.to_host`, as the checkpointer does on this
        thread) before the server ticks again.

        Serving-thread only.  Excludes the staging buffer/pump (in-flight
        samples are the telemetry journal's job) and the bounded
        debug/metric windows.
        """
        cap = self.cfg.max_twins
        refit_slot = np.full((cap,), -1, np.int32)
        deploy_tick = np.full((cap,), -1, np.int64)
        admitted_tick = np.full((cap,), -1, np.int64)
        steps_in_slot = np.zeros((cap,), np.int64)
        guard_code = np.zeros((cap,), np.int8)
        guard_live = np.zeros((cap,), bool)
        kind_code = {k: i for i, k in enumerate(self._GUARD_KINDS)}
        for rec in self.twin_snapshot().values():
            row = rec.ring_slot
            refit_slot[row] = -1 if rec.refit_slot is None else rec.refit_slot
            deploy_tick[row] = rec.deploy_tick
            admitted_tick[row] = rec.admitted_tick
            steps_in_slot[row] = rec.steps_in_slot
            guard_code[row] = kind_code[
                self._guard_state.get(rec.twin_id, "OK")]
        for row in self._guard_live:
            guard_live[row] = True
        slot_twin_ids = np.full((self.cfg.refit_slots,), -1, np.int64)
        for slot, tid in self._slot_twin.items():
            slot_twin_ids[slot] = tid
        return {
            "theta": self._theta,
            "theta_hist": self._theta_hist,
            "hist_count": self._hist_count.copy(),
            "rstate": self._rstate,
            "fstate": self._fstate,
            "key": np.asarray(self._init.state(), np.uint32),
            "packed": self.packed.snapshot(),
            "rows": {"refit_slot": refit_slot, "deploy_tick": deploy_tick,
                     "admitted_tick": admitted_tick,
                     "steps_in_slot": steps_in_slot,
                     "guard_code": guard_code, "guard_live": guard_live},
            "slot_ring": self._slot_ring.copy(),
            "slot_twin_ids": slot_twin_ids,
            "scalars": np.asarray(
                [self.tick_count, self._n_deployed,
                 0 if self._rotation is None else self._rotation._cursor,
                 -1 if self._max_active is None else self._max_active],
                np.int64),
        }

    def _tensor(self, x) -> torch.Tensor:
        """A restored leaf (numpy array or tensor) on this server's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def restore_state(self, state: dict) -> None:
        """Rebuild this server's serving state from a `snapshot_state`
        tree — typically `checkpoint.restore`d (numpy leaves) into a fresh
        server's own snapshot as `like`, from either package.

        In place wherever something aliases the state: the theta store,
        its history and the ring are `copy_`d into the server's own
        tensors, and the packed columns are loaded with `[:]`, so `_div`
        keeps aliasing `packed.divergence`.  The registry (TwinRecord dict,
        row maps, guard-live set) is rebuilt from the packed columns and
        the per-row extras.  Serving-thread only; call before any
        post-restart ingest/tick."""
        self._theta.copy_(self._tensor(state["theta"]))
        self._theta_hist.copy_(self._tensor(state["theta_hist"]))
        self._hist_count[:] = np.asarray(state["hist_count"])
        for k, v in self._rstate.items():
            v.copy_(self._tensor(state["rstate"][k]))
        self._fstate = checkpoint.tree_unflatten(
            self._fstate, [self._tensor(x) for x in
                           checkpoint.tree_flatten(state["fstate"])[0]])
        self._init.load(np.asarray(state["key"]))
        self.packed.load(state["packed"])
        self._slot_ring[:] = np.asarray(state["slot_ring"], np.int32)
        scalars = np.asarray(state["scalars"])
        self.tick_count = int(scalars[0])
        self._n_deployed = int(scalars[1])
        if self._rotation is not None:
            self._rotation._cursor = int(scalars[2])
        ma = int(scalars[3])
        self._max_active = None if ma < 0 else ma
        rows = state["rows"]
        refit_slot = np.asarray(rows["refit_slot"])
        deploy_tick = np.asarray(rows["deploy_tick"])
        admitted_tick = np.asarray(rows["admitted_tick"])
        steps_in_slot = np.asarray(rows["steps_in_slot"])
        guard_code = np.asarray(rows["guard_code"])
        guard_live = np.asarray(rows["guard_live"])
        p = self.packed
        with self._reg_lock:
            self.twins.clear()
            self._row2rec.clear()
            self._guard_state.clear()
            self._guard_live.clear()
            self._slot_twin.clear()
            for row in np.flatnonzero(p.registered):
                row = int(row)
                rec = TwinRecord(
                    twin_id=int(p.twin_id[row]), ring_slot=row,
                    refit_slot=(None if refit_slot[row] < 0
                                else int(refit_slot[row])),
                    samples=int(p.samples[row]),
                    samples_at_deploy=int(p.samples_at_deploy[row]),
                    deployed=bool(p.deployed[row]),
                    deploy_tick=int(deploy_tick[row]),
                    admitted_tick=int(admitted_tick[row]),
                    residency=int(p.residency[row]),
                    steps_in_slot=int(steps_in_slot[row]),
                    divergence=float(p.divergence[row]))
                self.twins[rec.twin_id] = rec
                self._row2rec[row] = rec
                self._guard_state[rec.twin_id] = \
                    self._GUARD_KINDS[int(guard_code[row])]
                if guard_live[row]:
                    self._guard_live[row] = rec
            for slot, tid in enumerate(np.asarray(state["slot_twin_ids"])):
                if tid >= 0:
                    self._slot_twin[slot] = int(tid)
        self._live_dirty = True
