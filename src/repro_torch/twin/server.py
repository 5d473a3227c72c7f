"""TwinServer: the online serving loop — ingest, refit, deploy, guard.

One `tick()` is a full serving cycle over the whole tracked fleet:

    1. FLUSH    staged telemetry into the device ring (one scatter for every
                twin that produced samples this tick),
    2. GUARD    RK4-roll deployed thetas over their newest window (the RK4
                kernel) and EMA-fold the normalized rollout error into each
                twin's divergence score; REFIT/ALERT events on transitions,
    3. SCHEDULE admit/evict/release twins over the bounded refit-slot pool
                (`PackedRefitScheduler`, one device pass over packed arrays),
    4. REFIT    `steps_per_tick` FleetMerinda train steps over all slots at
                once (GRU-scan kernel + RK4 kernel per step),
    5. PROMOTE  recover_all on slots past `deploy_after`, shadow-evaluate
                against the incumbent, scatter winners into the theta store.

The tick ends with a device synchronize, so tick latency counts the device
work.  Unassigned refit slots park on a scratch ring row (`max_twins`).
The ring and the theta store are updated IN PLACE.

`predict(twin_id, horizon)` rolls the deployed model forward from the
twin's newest telemetry; `scenario(...)` answers a batched what-if query.

Not ported yet (they raise NotImplementedError): `async_ingest=True` (the
background flush pump), `scheduler="reference"`, and
`snapshot_state`/`restore_state`.  The hooks only the sharded and federated
servers call (`set_active_slots`, `refit_pressure`, `drain`, `close`,
`inject_delay_s`) come with those servers.
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
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.obs import MetricRegistry, Tracer
from repro_torch.twin.monitor import (DivergenceGuard, GuardConfig,
                                      GuardEvent, GuardInstruments,
                                      GuardRotation)
from repro_torch.twin.packed import PackedFleet
from repro_torch.twin.recovery import DegradationConfig, DegradationPolicy
from repro_torch.twin.scenario import (ScenarioConfig, ScenarioRefused,
                                       ScenarioResult, ScenarioRunner,
                                       effective_k)
from repro_torch.twin.scheduler import (PackedRefitScheduler, SchedulerConfig,
                                        SchedulePlan, SchedulerMetrics,
                                        TwinRecord)
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
    async_ingest: bool = False        # background flush pump (not ported)
    staleness_weight: float = 1.0
    divergence_weight: float = 4.0
    evict_margin: float = 0.5
    min_residency: int = 8
    max_residency: int = 64
    release_divergence: float = 0.05
    scheduler: str = "bucketed"       # "bucketed": PackedRefitScheduler
    flush_pad: int = 8                # chunk-length quantum
    degradation: DegradationConfig = DegradationConfig()
    scenario: ScenarioConfig = ScenarioConfig()
    staging_capacity: int | None = None
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
    """The server's default source of random model parameters: one CPU
    `torch.Generator` seeded with `seed`.  `fleet_init()` is called once at
    construction, `slot_init()` once per admission, in admission order.

    A test hands the server another object with the same two methods (for
    instance one that replays the JAX server's draws through
    repro_torch.convert)."""

    def __init__(self, fleet: FleetMerinda, seed: int):
        self.fleet = fleet
        self.generator = torch.Generator().manual_seed(seed)

    def fleet_init(self):
        return self.fleet.init(self.generator)

    def slot_init(self):
        return self.fleet.model.init(self.generator)


class TwinServer:
    def __init__(self, cfg: TwinServerConfig, *, device=None,
                 init_source=None,
                 metrics: MetricRegistry | None = None,
                 tracer: Tracer | None = None):
        """`device=None` runs on the CUDA card and raises without one;
        `device="cpu"` runs the plain PyTorch path.  `init_source` supplies
        random parameters (default: `TorchInitSource(fleet, cfg.seed)`)."""
        if cfg.async_ingest:
            raise NotImplementedError("async_ingest (BackgroundPump) is not "
                                      "ported yet")
        if cfg.scheduler == "reference":
            raise NotImplementedError("scheduler='reference' "
                                      "(RefitScheduler) is not ported yet")
        if cfg.scheduler != "bucketed":
            raise ValueError(f"unknown scheduler {cfg.scheduler!r} "
                             "(expected 'bucketed' or 'reference')")
        m = cfg.merinda
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = MetricRegistry() if metrics is None else metrics
        self.tracer = Tracer(enabled=False) if tracer is None else tracer
        self.span = TelemetryRing.span(cfg.window, cfg.stride,
                                       cfg.windows_per_twin)
        self.min_samples = self.span + 1
        if cfg.capacity < max(self.min_samples, cfg.guard.window + 1):
            raise ValueError("ring capacity smaller than the refit/guard span")

        self._scratch = cfg.max_twins     # scratch ring row + theta row
        self.ring = TelemetryRing(RingConfig(
            slots=cfg.max_twins + 1, capacity=cfg.capacity, n=m.n, m=m.m),
            device=self.device)
        self.fleet = FleetMerinda(FleetConfig(
            merinda=m, fleet=cfg.refit_slots,
            windows_per_twin=cfg.windows_per_twin, lr=cfg.lr,
            sparsify_after=cfg.sparsify_after), device=self.device)
        self.guard = DivergenceGuard(self.fleet.model.lib, m.dt, cfg.guard)
        self.scenario_runner = ScenarioRunner(self.fleet.model.lib, m.dt,
                                              cfg.scenario)
        self._rstate = self.ring.init()
        self._init = (TorchInitSource(self.fleet, cfg.seed)
                      if init_source is None else init_source)
        self._fstate = self._to_device(self._init.fleet_init())

        sched_cfg = SchedulerConfig(
            slots=cfg.refit_slots, min_samples=self.min_samples,
            staleness_weight=cfg.staleness_weight,
            divergence_weight=cfg.divergence_weight,
            evict_margin=cfg.evict_margin, min_residency=cfg.min_residency,
            max_residency=cfg.max_residency,
            release_divergence=cfg.release_divergence)
        self.scheduler = PackedRefitScheduler(
            sched_cfg, metrics=SchedulerMetrics.create(self.metrics),
            device=self.device)
        # packed arrays are the scheduler's truth: every mutation point
        # below writes BOTH the record and its packed row
        self.packed = PackedFleet(cfg.max_twins)

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
        """Resolve this server's metric children."""
        M = self.metrics
        self._m_tick = M.histogram(
            "twin_tick_latency_seconds",
            help="full serving-tick wall latency", unit="seconds")
        self._m_stage = {
            s: M.histogram("twin_stage_latency_seconds",
                           help="per-stage serving-tick wall latency",
                           unit="seconds", labels={"stage": s})
            for s in _STAGES}
        self._m_violations = M.counter(
            "twin_deadline_violations_total",
            help="ticks whose wall latency exceeded deadline_s")
        self._m_refreshes = M.counter(
            "twin_slot_refreshes_total",
            help="refit-slot train advances (active slots summed per tick)")
        self._m_dropped = M.counter(
            "twin_dropped_samples_total",
            help="telemetry samples truncated by flush backlog")
        self._m_overflow = M.counter(
            "twin_flush_overflows_total",
            help="flush batches that truncated a backlog")
        self._m_prepare = M.histogram(
            "twin_flush_prepare_seconds",
            help="host-side staging merge/pad latency", unit="seconds")
        self._m_tracked = M.gauge(
            "twin_tracked_twins", help="registered tracked objects")
        self._m_deployed = M.gauge(
            "twin_deployed_twins", help="twins with a serving theta")
        self._m_active = M.gauge(
            "twin_active_slots", help="refit slots currently assigned")
        self._m_staging = M.gauge(
            "twin_staging_pending_samples",
            help="samples staged but not yet flushed")
        self._m_degraded = M.gauge(
            "twin_degraded_level",
            help="deadline-degradation ladder level (0 = full service)")
        self._m_deg_trans = {
            d: M.counter("twin_degraded_transitions_total",
                         help="degradation ladder moves by direction",
                         labels={"direction": d})
            for d in ("up", "down")}
        self._m_shed = {
            a: M.counter("twin_degraded_shed_total",
                         help="ticks that shed a stage under degradation",
                         labels={"action": a})
            for a in ("guard", "refit", "promote")}
        self._m_ingest_retries = M.counter(
            "twin_ingest_retries_total",
            help="ingest backoff retries after a staging overflow")
        self._m_ingest_dropped = M.counter(
            "twin_ingest_dropped_total",
            help="staged samples shed (drop-oldest) by non-strict ingest "
                 "backpressure")
        self._guard_obs = GuardInstruments.create(M)
        self._m_scn_latency = M.histogram(
            "twin_scenario_latency_seconds",
            help="what-if query wall latency (ensemble x K fused rollout)",
            unit="seconds")
        self._m_scn_requests = M.counter(
            "twin_scenario_requests_total",
            help="scenario queries answered")
        self._m_scn_rollouts = M.counter(
            "twin_scenario_rollouts_total",
            help="individual trajectories integrated for scenario queries "
                 "(effective K x ensemble)")
        self._m_scn_shrunk = M.counter(
            "twin_scenario_shrunk_total",
            help="scenario queries served with K shrunk by the degradation "
                 "ladder")
        self._m_scn_refused = M.counter(
            "twin_scenario_refused_total",
            help="scenario queries refused under deadline pressure")
        self._m_scn_confidence = M.histogram(
            "twin_scenario_confidence",
            help="per-scenario ensemble confidence (1 = recent thetas "
                 "agree)", bounds=(0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0))

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

    def _guard_add(self, rec: TwinRecord) -> None:
        """Admit a record to the guard-eligible set (idempotent)."""
        if rec.ring_slot not in self._guard_live:
            self._guard_live[rec.ring_slot] = rec
            self.packed.set_divergence(rec.ring_slot, rec.divergence)
            self._live_dirty = True

    # ------------------------------------------------------------------ #
    def ingest(self, twin_id: int, y, u=None):
        """Stage telemetry for `twin_id`: y [n] or [C, n], u [m] or [C, m].

        Host-side staging only — the device scatter happens once per tick.
        Thread-safe.  A bounded staging buffer (`cfg.staging_capacity`)
        retries with doubling backoff on overflow, then raises
        (`ingest_strict`) or sheds the oldest staged samples.
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
            self._staging.append(rec.ring_slot, y, u)
        except StagingOverflow:
            self._ingest_backpressure(rec.ring_slot, y, u)

    def ingest_many(self, batch) -> int:
        """Batched `ingest`: `batch` iterates (twin_id, y) or (twin_id, y,
        u) chunks.  Returns the number of SAMPLES staged."""
        staged = 0
        for chunk in batch:
            tid, y = chunk[0], chunk[1]
            u = chunk[2] if len(chunk) > 2 else None
            self.ingest(tid, y, u)
            staged += np.atleast_2d(np.asarray(y)).shape[0]
        return staged

    def _ingest_backpressure(self, row: int, y, u) -> None:
        """Bounded retry-with-backoff, then strict-raise or drop-oldest."""
        delay = self.cfg.ingest_backoff_s
        for _ in range(max(0, self.cfg.ingest_retries)):
            self._m_ingest_retries.inc()
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

    # -- staging flush: prepare (host) + apply (device) ------------------ #
    def _prepare_timed(self) -> FlushBatch | None:
        m = self.cfg.merinda
        t0 = time.perf_counter()
        batch = prepare_flush(self._staging.swap(),
                              capacity=self.cfg.capacity,
                              pad=self.cfg.flush_pad, scratch=self._scratch,
                              n=m.n, m=m.m)
        self._m_prepare.observe(time.perf_counter() - t0)
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
        batch = self._prepare_timed()
        return self._apply(batch) if batch is not None else 0

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
        if self._rotation is None:
            # full scan: one rollout over the whole store.  Degraded: score
            # every other tick
            if shed and self.tick_count % 2 == 0:
                return [], 0
            rows = torch.arange(self.cfg.max_twins, device=self.device)
            ys, us = self.ring.latest(self._rstate, rows, gw)
            scores = self.guard.score(self._theta[:-1], ys, us).cpu().numpy()
            recs = list(live.values())
            srows = np.fromiter((r.ring_slot for r in recs), np.int64,
                                count=len(recs))
            raw = scores[srows]
        else:
            # budgeted rotation: fixed-width rollout.  Degraded: a smaller
            # width, no carry
            if self._live_dirty:
                self._live_rows = np.fromiter(sorted(live), np.int64,
                                              count=len(live))
                self._live_dirty = False
            if shed:
                width = max(1, self._rotation.budget
                            // max(1, self.cfg.degradation.guard_shrink))
                pick = self._rotation.select(self._live_rows, self._div,
                                             self.cfg.guard.refit_threshold,
                                             budget=width, carry=0)
            else:
                width = self._rotation.size
                pick = self._rotation.select(self._live_rows, self._div,
                                             self.cfg.guard.refit_threshold)
            rows_np = np.full((width,), self._scratch, np.int64)
            rows_np[:len(pick)] = pick
            rows = self._rows(rows_np)
            ys, us = self.ring.latest(self._rstate, rows, gw)
            scores = self.guard.score(self._theta[rows], ys,
                                      us).cpu().numpy()
            recs = [live[int(row)] for row in pick]
            srows = np.asarray(pick, np.int64)
            raw = scores[:len(recs)]
        # one vectorized EMA fold publishes the smoothed scores into the
        # packed divergence column; the record fields mirror them
        smoothed = self.guard.fold_into(self._div, srows, raw)
        self.packed.div32[srows] = smoothed
        events: list[GuardEvent] = []
        score_hist = self._guard_obs.score
        for rec, score, div in zip(recs, raw, smoothed):
            score_hist.observe(float(score))
            rec.divergence = float(div)
            ev = self.guard.judge(rec.twin_id, rec.divergence, self.tick_count)
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
        if defer:
            # degraded (level >= 2): slots hold; converged candidates may
            # still ship (level < 3)
            if not skip_promote:
                deployable = [
                    slot for slot, tid in self._slot_twin.items()
                    if self.twins[tid].steps_in_slot >= self.cfg.deploy_after]
                if deployable:
                    y_win, u_win = self._slot_windows()
                    self._promote(deployable, y_win, u_win)
            return None
        y_win, u_win = self._slot_windows()
        loss_vec = None
        for _ in range(self.cfg.steps_per_tick):
            self._fstate, loss_vec, _ = self.fleet.train_step_per_slot(
                self._fstate, y_win, u_win)
        # report loss over ASSIGNED slots only — scratch-parked slots train
        # on zero windows and would dilute the mean toward zero
        loss = float(np.mean(loss_vec.cpu().numpy()[sorted(self._slot_twin)]))
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
        rows = self._rows(self._slot_ring)
        thetas = self.fleet.recover_all(self._fstate, y_win, u_win)
        ys_g, us_g = self.ring.latest(self._rstate, rows,
                                      self.cfg.guard.window)
        cand = self.guard.score(thetas, ys_g, us_g).cpu().numpy()
        inc = self.guard.score(self._theta[rows], ys_g, us_g).cpu().numpy()
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
        with span("tick", tick=self.tick_count + 1):
            t0 = time.perf_counter()
            self.tick_count += 1
            with span("flush"):
                self._flush()
            t1 = time.perf_counter()
            with span("guard"):
                if shed_guard:
                    self._m_shed["guard"].inc()
                events, n_guarded = self._update_divergence(shed=shed_guard)
            t2 = time.perf_counter()
            with span("schedule"):
                plan = self.scheduler.plan(self.packed, self._slot_ring)
                self._apply_plan(plan)
            t3 = time.perf_counter()
            with span("refit"):
                if defer_refit:
                    self._m_shed["refit"].inc()
                if skip_promote:
                    self._m_shed["promote"].inc()
                loss = self._refit(defer=defer_refit,
                                   skip_promote=skip_promote)
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
                              horizon=int(horizon), level=level):
            t0 = time.perf_counter()
            try:
                eff = effective_k(requested, level, scfg)
            except ScenarioRefused:
                self._m_scn_refused.inc()
                raise
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

    @property
    def degraded_level(self) -> int:
        """Current deadline-degradation ladder level (0 = full service)."""
        return self._degradation.level

    def snapshot_state(self) -> dict:
        raise NotImplementedError("snapshot_state is not ported yet")

    def restore_state(self, state: dict) -> None:
        raise NotImplementedError("restore_state is not ported yet")
