"""Fault tolerance for the twin server: checkpoint, replay, degrade.

The paper's setting is MISSION CRITICAL — collision-avoidance twins that must
keep answering inside a hard deadline.  Three failure classes are covered
here, each with its own mechanism and its own metric family:

  * **Crash** (the serving process dies): `TwinCheckpointer` snapshots the
    server's full serving state — theta store, telemetry ring, fleet train
    state, packed scheduler columns, guard state — on a configurable
    cadence, in `train/checkpoint.py`'s atomic COMMIT directory layout (a
    torn write is invisible to `latest_step`).  The snapshot is copied to
    the host on the tick thread; the `.npy` writes run on a background
    thread, off the serving deadline (`twin_ckpt_*`).  A restarted server
    restores the last committed checkpoint and REPLAYS the suffix of a
    `TelemetryJournal` (`TwinServer.ingest(..., force=True)`), so every
    sample ingested inside the journal horizon survives the crash.

  * **Overload** (ticks approaching the deadline): `DegradationPolicy`
    watches tick wall time (EWMA via `StragglerDetector` + the instantaneous
    tick) and sheds work through a fixed ladder — level 1 shrinks the guard,
    level 2 defers refit train steps, level 3 skips shadow-eval promotion —
    restoring level by level once pressure clears (`twin_degraded_*`).
    Ingest backpressure is the same story at the producer boundary: a
    bounded `StagingBuffer` raises `StagingOverflow`, and
    `TwinServer.ingest` retries with backoff, then (non-strict mode) sheds
    the OLDEST staged samples.

  * **Injected chaos** (tests, chip_smoke.py): `ChaosConfig` extends
    `FailureInjector`/`SimulatedPreemption` into a deterministic schedule —
    kill-at-tick, slow-shard straggler windows, torn checkpoint, and
    staging-overflow storms.

Nothing here imports twin/server.py — the server imports THIS module and
hands it callables/state, so the dependency points one way.
"""
from __future__ import annotations

import shutil
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     SimulatedPreemption,
                                                     StragglerDetector)
from repro_torch.obs import MetricRegistry
from repro_torch.train import checkpoint

__all__ = ["RecoveryConfig", "TwinCheckpointer", "TelemetryJournal",
           "ChaosConfig", "ChaosInjector", "ShardFailure",
           "DegradationConfig", "DegradationPolicy", "DegradationEvent"]


# --------------------------------------------------------------------------- #
# per-shard checkpointing
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class RecoveryConfig:
    """Checkpoint + failover knobs.

    `ckpt_every` is in SHARD ticks (each shard checkpoints on its own tick
    counter, so a restarted shard resumes its own cadence; a single server
    is shard 0).  `keep` commits are retained per shard — at least 2, so a
    torn newest write always has a committed predecessor to fall back to.
    `journal_horizon` bounds the telemetry journal per twin (None: the
    ring capacity — the ring horizon IS the replay guarantee boundary).
    """
    ckpt_dir: str
    ckpt_every: int = 16
    keep: int = 2
    async_write: bool = True
    restart_delay_ticks: int = 1      # supervisor ticks a shard stays down
    journal_horizon: int | None = None

    def __post_init__(self):
        if self.ckpt_every < 1:
            raise ValueError("ckpt_every must be >= 1")
        if self.keep < 2:
            raise ValueError("keep must be >= 2 (torn-write fallback needs "
                             "a committed predecessor)")


class TwinCheckpointer:
    """Atomic per-shard serving-state checkpoints, written off the tick loop.

    Layout: `ckpt_dir/shard_<i>/step_<tick>/{manifest.json, leaf_*.npy,
    COMMIT}` — `train/checkpoint.py`'s format verbatim (the JAX package's
    too), so atomicity (`latest_step` ignores torn dirs) and the bit-exact
    round trip are the properties that module's tests already pin.

    `maybe_save` takes the snapshot SYNCHRONOUSLY on the caller's thread
    (the serving tick): `snapshot_fn()` returns host copies of the host
    arrays, and every device tensor in it is copied to the host
    (`.detach().cpu()`) before the background writer starts, so the writer
    never races the serving thread's in-place mutations.  One writer per
    shard at a time; a new save joins the previous one first (the
    discipline of `CheckpointManager`).
    """

    def __init__(self, cfg: RecoveryConfig,
                 metrics: MetricRegistry | None = None):
        self.cfg = cfg
        self.dir = Path(cfg.ckpt_dir)
        self.metrics = MetricRegistry() if metrics is None else metrics
        self._pending: dict[int, threading.Thread] = {}
        M = self.metrics
        self._m_saves = M.counter(
            "twin_ckpt_saves_total",
            help="shard serving-state checkpoints committed (or handed to "
                 "the background writer)")
        self._m_snapshot = M.histogram(
            "twin_ckpt_snapshot_seconds",
            help="on-tick host snapshot latency (the serving-path cost of a "
                 "checkpoint; the .npy write is off-path)", unit="seconds")
        self._m_write = M.histogram(
            "twin_ckpt_write_seconds",
            help="background checkpoint write+GC latency", unit="seconds")
        self._m_restores = M.counter(
            "twin_ckpt_restores_total",
            help="shard restores from a committed checkpoint")
        self._m_torn = M.counter(
            "twin_ckpt_torn_total",
            help="checkpoints torn by chaos injection (COMMIT removed)")
        self._m_last: dict[int, object] = {}       # shard -> Gauge

    def shard_dir(self, shard: int) -> Path:
        return self.dir / f"shard_{shard:03d}"

    def _last_gauge(self, shard: int):
        g = self._m_last.get(shard)
        if g is None:
            g = self.metrics.gauge(
                "twin_ckpt_last_tick",
                help="shard tick of the newest checkpoint handed to the "
                     "writer", labels={"shard": str(shard)})
            self._m_last[shard] = g
        return g

    # ------------------------------------------------------------------ #
    def maybe_save(self, shard: int, tick: int, snapshot_fn,
                   force: bool = False) -> bool:
        """Checkpoint shard `shard` if its tick hits the cadence.

        `snapshot_fn()` returns the serving state (`TwinServer.
        snapshot_state`): host arrays that are copies, and device tensors,
        which are copied to the host here, on the caller's thread."""
        if not force and (tick % self.cfg.ckpt_every != 0 or tick == 0):
            return False
        prev = self._pending.get(shard)
        if prev is not None:
            prev.join()
        t0 = time.perf_counter()
        host_tree = checkpoint.to_host(snapshot_fn())
        self._m_snapshot.observe(time.perf_counter() - t0)
        d = self.shard_dir(shard)

        def write_then_gc():
            t1 = time.perf_counter()
            checkpoint._write(d, tick, host_tree)
            self._gc(shard)
            self._m_write.observe(time.perf_counter() - t1)

        if self.cfg.async_write:
            t = threading.Thread(target=write_then_gc, daemon=True)
            t.start()
            self._pending[shard] = t
        else:
            write_then_gc()
        self._m_saves.inc()
        self._last_gauge(shard).set(tick)
        return True

    def _gc(self, shard: int) -> None:
        steps = sorted(p for p in self.shard_dir(shard).glob("step_*")
                       if (p / "COMMIT").exists())
        for p in steps[:-self.cfg.keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------ #
    def wait(self, shard: int | None = None) -> None:
        """Join outstanding writer threads (all shards when `shard` is
        None) — the flush barrier before reading `latest`/restoring."""
        items = (list(self._pending.items()) if shard is None
                 else [(shard, self._pending.get(shard))])
        for s, t in items:
            if t is not None:
                t.join()
                self._pending.pop(s, None)

    def latest(self, shard: int) -> int | None:
        """Newest COMMITTED shard tick (torn checkpoints invisible)."""
        self.wait(shard)
        return checkpoint.latest_step(self.shard_dir(shard))

    def restore_latest(self, shard: int, like):
        """(tick, state) from the newest committed checkpoint, or
        (None, None) when the shard has never committed one.  `like` is a
        fresh server's `snapshot_state()` — fixed shapes by config, so a
        mismatched restore raises `ValueError` instead of corrupting.  The
        state's leaves are numpy arrays; `TwinServer.restore_state` puts
        them on its device."""
        step = self.latest(shard)
        if step is None:
            return None, None
        state = checkpoint.restore(self.shard_dir(shard), step, like)
        self._m_restores.inc()
        return step, state

    def tear_latest(self, shard: int) -> int | None:
        """Chaos: remove the COMMIT marker from the newest checkpoint —
        simulates a crash mid-write.  `latest`/`restore_latest` must then
        fall back to the previous committed step.  Returns the torn tick."""
        step = self.latest(shard)
        if step is None:
            return None
        (self.shard_dir(shard) / f"step_{step:08d}" / "COMMIT").unlink()
        self._m_torn.inc()
        return step


# --------------------------------------------------------------------------- #
# telemetry journal (the replay source)
# --------------------------------------------------------------------------- #
class TelemetryJournal:
    """Bounded per-twin journal of ingested telemetry chunks.

    Lives OUTSIDE the server (with its supervisor or the sensor gateway):
    it must survive the server's death.  Every ingest is appended here
    before it reaches the server, so after a crash the journal holds the
    suffix of samples the restored checkpoint has not seen —
    `replay_since(twin, seen)` returns exactly those chunks (trimming the
    first chunk when `seen` falls inside it) plus a `lost` count for
    samples already evicted past the horizon.

    The horizon is per twin in SAMPLES (normally the ring capacity):
    anything older would have been overwritten in the ring anyway, so the
    journal's memory bound matches the recovery guarantee — no sample inside
    the ring horizon is lost to a crash.

    Thread-safe: sensor threads append concurrently; replay runs on the
    serving thread.
    """

    def __init__(self, horizon: int):
        if horizon < 1:
            raise ValueError("journal horizon must be >= 1 sample")
        self.horizon = horizon
        self._lock = threading.Lock()
        # twin_id -> deque of (start_index, y [C,n], u [C,m] | None)
        self._chunks: dict[int, deque] = {}
        self._total: dict[int, int] = {}
        self.appended_samples = 0

    def append(self, twin_id: int, y, u=None) -> int:
        """Journal one chunk (same y/u shapes `TwinServer.ingest` takes).
        Copies — the caller may reuse its buffers.  Returns the chunk
        length in samples."""
        y = np.atleast_2d(np.asarray(y, np.float32)).copy()
        u = None if u is None else np.asarray(u, np.float32).copy()
        C = len(y)
        with self._lock:
            total = self._total.get(twin_id, 0)
            dq = self._chunks.setdefault(twin_id, deque())
            dq.append((total, y, u))
            total += C
            self._total[twin_id] = total
            # evict whole chunks that fell entirely past the horizon
            while dq and dq[0][0] + len(dq[0][1]) <= total - self.horizon:
                dq.popleft()
            self.appended_samples += C
        return C

    def twin_ids(self) -> list[int]:
        with self._lock:
            return list(self._total)

    def total(self, twin_id: int) -> int:
        with self._lock:
            return self._total.get(twin_id, 0)

    def replay_since(self, twin_id: int, seen: int):
        """Chunks covering samples [seen, total) for `twin_id`.

        Returns (chunks, lost): `chunks` is a list of (y, u) in
        chronological order (u may be None), `lost` counts samples in
        [seen, total) already evicted past the horizon — those are
        unrecoverable and the caller must surface them."""
        out: list = []
        with self._lock:
            total = self._total.get(twin_id, 0)
            need = total - seen
            if need <= 0:
                return [], 0
            covered_from = None
            for start, y, u in self._chunks.get(twin_id, ()):
                if start + len(y) <= seen:
                    continue
                if covered_from is None:
                    covered_from = start
                skip = max(0, seen - start)
                out.append((y[skip:],
                            None if u is None else u[skip:]))
            if covered_from is None:
                return [], need
            lost = max(0, covered_from - seen)
        return out, lost


# --------------------------------------------------------------------------- #
# chaos injection (the deterministic failure schedule tests drive)
# --------------------------------------------------------------------------- #
class ShardFailure(SimulatedPreemption):
    """Injected death of one serving shard (supervisor catches + restarts)."""

    def __init__(self, shard: int, tick: int):
        super().__init__(f"injected shard {shard} failure at tick {tick}")
        self.shard = shard
        self.tick = tick


@dataclass(frozen=True)
class ChaosConfig:
    """Deterministic failure schedule.

    Knobs (all independent; combine with care — a storm before a kill makes
    the journal and the shard's sample counts diverge by design):

      * kill_shard/kill_at_tick — the shard dies instead of ticking once
        the tick reaches `kill_at_tick` (`>=` semantics via
        `FailureInjector`, so schedules survive skipped tick numbers).
      * torn_checkpoint — the killed shard's newest checkpoint loses its
        COMMIT marker (crash mid-write); restore must fall back.
      * slow_shard + slow_s over [slow_from_tick, slow_until_tick) — an
        injected straggler: the shard sleeps `slow_s` inside its timed
        tick, so its own degradation policy sees the stall.
      * storm_shard + storm_factor over [storm_from_tick, storm_until_tick)
        — every ingest routed to that shard is duplicated `storm_factor`x
        (journal and shard alike), a staging-overflow storm exercising the
        bounded-buffer retry/drop-oldest path.
    """
    kill_shard: int | None = None
    kill_at_tick: int = 1
    torn_checkpoint: bool = False
    slow_shard: int | None = None
    slow_s: float = 0.0
    slow_from_tick: int = 0
    slow_until_tick: int = 1 << 31
    storm_shard: int | None = None
    storm_factor: int = 1
    storm_from_tick: int = 0
    storm_until_tick: int = 1 << 31


class ChaosInjector:
    """Mutable state of a `ChaosConfig` schedule (one-shot kill/tear)."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._kill = FailureInjector(
            fail_at_step=(cfg.kill_at_tick if cfg.kill_shard is not None
                          else None))
        self._torn = False

    def should_kill(self, shard: int, tick: int) -> bool:
        """True exactly once, for the configured shard, at (or after —
        `FailureInjector`'s `>=` contract) the configured tick."""
        if self.cfg.kill_shard is None or shard != self.cfg.kill_shard:
            return False
        try:
            self._kill.maybe_fail(tick)
        except SimulatedPreemption:
            return True
        return False

    def should_tear(self) -> bool:
        """True once, at kill time, when torn_checkpoint is scheduled."""
        if not self.cfg.torn_checkpoint or self._torn:
            return False
        self._torn = True
        return True

    def slow_delay(self, shard: int, tick: int) -> float:
        c = self.cfg
        if (c.slow_shard == shard
                and c.slow_from_tick <= tick < c.slow_until_tick):
            return c.slow_s
        return 0.0

    def storm_extra(self, shard: int, tick: int) -> int:
        """Extra duplicate ingests for this shard at this tick (0 = none)."""
        c = self.cfg
        if (c.storm_shard == shard
                and c.storm_from_tick <= tick < c.storm_until_tick):
            return max(0, c.storm_factor - 1)
        return 0


# --------------------------------------------------------------------------- #
# deadline-aware graceful degradation
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DegradationConfig:
    """Shed-work ladder for ticks approaching the deadline.

    Pressure = max(EWMA tick time, last tick time) / deadline — the max with
    the instantaneous tick matters because `StragglerDetector` EXCLUDES
    flagged outliers from its EWMA (so one straggler doesn't mask the next),
    which means a sustained overload would never move the EWMA alone.

    The ladder (each level includes the ones below, restored in reverse):
      level 1: shrink the guard budget by `guard_shrink`x (rotation mode)
               or score only every other tick (full-scan mode),
      level 2: defer refit train steps (slots hold; already-converged
               candidates may still promote),
      level 3: skip shadow-eval promotion too — the tick is down to flush +
               reduced guard + scheduling bookkeeping.

    Escalation needs pressure > `high_water`, de-escalation pressure <
    `low_water`, each at most once per `hold_ticks` (hysteresis — the
    ladder must not flap on one noisy tick).
    """
    enabled: bool = False
    high_water: float = 0.8
    low_water: float = 0.5
    alpha: float = 0.3               # EWMA weight of the newest tick
    hold_ticks: int = 2
    guard_shrink: int = 4
    max_level: int = 3


@dataclass(frozen=True)
class DegradationEvent:
    tick: int
    from_level: int
    to_level: int
    pressure: float


class DegradationPolicy:
    """Per-server degradation state machine; see `DegradationConfig`.

    `observe(tick, dt_s)` AFTER each tick updates pressure and moves the
    ladder at most one level; the `shed_guard`/`defer_refit`/`skip_promote`
    properties are what the NEXT tick consults.  Wraps a
    `StragglerDetector` so injected/organic stragglers are also counted
    (`straggler_events`)."""

    def __init__(self, cfg: DegradationConfig, deadline_s: float):
        self.cfg = cfg
        self.deadline_s = deadline_s
        self.detector = StragglerDetector(alpha=cfg.alpha)
        self.level = 0
        self.pressure = 0.0
        self._last_change = -(1 << 30)

    def reset(self) -> None:
        """Forget pressure history and restore full service — benchmarks
        call this (via `reset_latency_stats`) after jit warmup so compile
        stalls don't count as overload."""
        self.detector = StragglerDetector(alpha=self.cfg.alpha)
        self.level = 0
        self.pressure = 0.0
        self._last_change = -(1 << 30)

    @property
    def shed_guard(self) -> bool:
        return self.level >= 1

    @property
    def defer_refit(self) -> bool:
        return self.level >= 2

    @property
    def skip_promote(self) -> bool:
        return self.level >= 3

    @property
    def straggler_events(self) -> int:
        return len(self.detector.events)

    def observe(self, tick: int, dt_s: float) -> DegradationEvent | None:
        """Fold one tick's wall time; returns the ladder transition (if
        any).  Call even when disabled — pressure stays observable."""
        self.detector.observe(tick, dt_s)
        ewma = self.detector.ewma_s if self.detector.ewma_s is not None \
            else dt_s
        self.pressure = max(ewma, dt_s) / max(self.deadline_s, 1e-9)
        cfg = self.cfg
        if not cfg.enabled or tick - self._last_change < cfg.hold_ticks:
            return None
        if self.pressure > cfg.high_water and self.level < cfg.max_level:
            ev = DegradationEvent(tick, self.level, self.level + 1,
                                  self.pressure)
        elif self.pressure < cfg.low_water and self.level > 0:
            ev = DegradationEvent(tick, self.level, self.level - 1,
                                  self.pressure)
        else:
            return None
        self.level = ev.to_level
        self._last_change = tick
        return ev
