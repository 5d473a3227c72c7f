"""Slot-based refit scheduling: thousands of twins, a bounded compute budget.

A FIXED number of refit slots (the FleetMerinda fleet axis — one train step
advances all of them), with twins admitted into and evicted from slots
dynamically.  Priority (higher = refit sooner):

    priority = staleness_weight * staleness + divergence_weight * divergence

  * staleness  — samples ingested since the twin's model was last deployed,
    over the refit span; a never-deployed twin gets a +1 bonus;
  * divergence — the guard's EMA score (twin/monitor.py).

Free slots are filled by the highest-priority READY twins; a resident may be
PREEMPTED by a waiting twin whose priority beats it by `evict_margin` after
`min_residency` ticks; a converged, quiet resident RELEASES its slot after
`max_residency` ticks.  `max_active` caps how many slots may be filled.

`PackedRefitScheduler` scores the whole fleet in one device pass over the
packed arrays (twin/packed.py), pops the O(slots) winners through a
`PriorityBuckets` queue, and re-scores them in float64 with the reference
arithmetic.  The dict-sorting reference planner (`RefitScheduler`) and the
slot federation are not ported yet.
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.twin.packed import PackedFleet, fleet_pressure, fleet_scores

__all__ = ["TwinRecord", "SchedulerConfig", "SchedulePlan", "SchedulerMetrics",
           "PriorityBuckets", "PackedRefitScheduler"]


@dataclass
class TwinRecord:
    """Host-side registry entry for one tracked object."""
    twin_id: int
    ring_slot: int                    # row in TelemetryRing
    refit_slot: int | None = None     # FleetMerinda slot, None if waiting
    samples: int = 0                  # total telemetry ingested
    samples_at_deploy: int = 0
    deployed: bool = False            # has a theta in the serving store
    deploy_tick: int = -1
    admitted_tick: int = -1
    residency: int = 0                # ticks spent in current slot
    steps_in_slot: int = 0            # train steps in current slot
    divergence: float = 0.0           # EMA guard score


@dataclass(frozen=True)
class SchedulerConfig:
    slots: int
    min_samples: int                  # readiness: samples for one window batch
    staleness_weight: float = 1.0
    divergence_weight: float = 4.0
    evict_margin: float = 0.5         # challenger must beat resident by this
    min_residency: int = 8            # ticks before preemption allowed
    max_residency: int = 64           # ticks before voluntary release allowed
    release_divergence: float = 0.05  # ...and only if the twin tracks reality


@dataclass
class SchedulePlan:
    admit: list = field(default_factory=list)    # [(slot, twin_id)]
    evict: list = field(default_factory=list)    # [twin_id] preempted
    release: list = field(default_factory=list)  # [twin_id] converged


@dataclass
class SchedulerMetrics:
    """Slot-turnover instruments (obs registry children).

    `admitted`/`evicted`/`released` count slot transitions cumulatively;
    `pressure` is the latest aggregate staleness+divergence demand — the
    same number the federation rebalances on, so a fleet dashboard shows
    WHY grants moved.  `plan_seconds` is the pure planning cost (scoring +
    winner pops, excluding the server's slot-reset applies) — the scale
    benchmark's flatness evidence; `waiting` gauges the ready-but-unslotted
    backlog the planner draws from; `queue_entries` the candidate entries
    retained in the bucketed queue after a plan.
    """
    admitted: object            # Counter-like: .inc(n)
    evicted: object
    released: object
    pressure: object            # Gauge-like: .set(v)
    plan_seconds: object        # Histogram-like: .observe(s)
    waiting: object             # Gauge: ready twins without a slot
    queue_entries: object       # Gauge: live bucket-queue entries

    @staticmethod
    def create(registry) -> "SchedulerMetrics":
        """Resolve the scheduler's instruments from a `MetricRegistry`."""
        return SchedulerMetrics(
            admitted=registry.counter(
                "twin_sched_admitted_total",
                help="twins admitted into refit slots"),
            evicted=registry.counter(
                "twin_sched_evicted_total",
                help="twins preempted out of refit slots"),
            released=registry.counter(
                "twin_sched_released_total",
                help="twins that released their refit slot (converged, "
                     "stuck, or federation revoke)"),
            pressure=registry.gauge(
                "twin_sched_pressure",
                help="aggregate staleness+divergence refit demand "
                     "(federation rebalance signal)"),
            plan_seconds=registry.histogram(
                "twin_sched_plan_seconds",
                help="schedule-planning wall latency per tick (scoring + "
                     "winner selection, excluding slot-reset application)",
                unit="seconds"),
            waiting=registry.gauge(
                "twin_sched_waiting",
                help="ready twins waiting for a refit slot (planner queue "
                     "depth)"),
            queue_entries=registry.gauge(
                "twin_sched_queue_entries",
                help="live candidate entries held by the bucketed priority "
                     "queue after planning"))


# --------------------------------------------------------------------------- #
# PriorityBuckets: quantized-priority queue with lazy deletion
# --------------------------------------------------------------------------- #
class PriorityBuckets:
    """Bucketed max-priority queue: O(1) push/discard, cheap ordered pops.

    Priorities are quantized to `quantum`-wide buckets (level =
    floor(priority / quantum)); a lazy max-heap tracks non-empty levels, and
    entries are lazily deleted — `discard`/re-`push` just version-bumps the
    key, and stale bucket entries are skipped (and pruned) when a pop
    reaches their bucket.  The same live-set discipline as
    `GuardRotation`'s eligible-row array: mutation points pay O(1) and the
    consumer pays for exactly what it touches.

    Ordering contract: pops come out in EXACT (-priority, key) order, not
    merely bucket order — quantization is monotone, so cross-bucket order is
    exact for free, and within the one bucket a pop touches, live entries
    are compared exactly.  Cost per pop is O(touched-bucket size +
    log #levels); with `quantum` sized so a bucket holds O(budget) entries,
    a planning pass of B pops costs O(B + log n) — the bound that replaces
    the reference planner's O(n log n) full sorts.
    """

    __slots__ = ("quantum", "_buckets", "_levels", "_live", "_version")

    def __init__(self, quantum: float = 0.25):
        if not quantum > 0:
            raise ValueError("bucket quantum must be > 0")
        self.quantum = quantum
        self._buckets: dict[int, list] = {}   # level -> [(key, prio, payload, ver)]
        self._levels: list[int] = []          # negated levels (max-heap)
        self._live: dict = {}                 # key -> (prio, level, ver)
        self._version = 0

    def _level(self, prio: float) -> int:
        if not math.isfinite(prio):
            raise ValueError(f"priority must be finite, got {prio}")
        return int(math.floor(prio / self.quantum))

    def __len__(self) -> int:
        return len(self._live)

    @property
    def stale_entries(self) -> int:
        """Lazily-deleted entries still occupying buckets (pruned on pop)."""
        return sum(len(b) for b in self._buckets.values()) - len(self._live)

    def clear(self) -> None:
        self._buckets.clear()
        self._levels.clear()
        self._live.clear()

    def push(self, key, prio: float, payload=None) -> None:
        """Insert or reprioritize `key` (old entry is lazily deleted)."""
        level = self._level(prio)
        self._version += 1
        self._live[key] = (prio, level, self._version)
        bucket = self._buckets.get(level)
        if bucket is None:
            bucket = self._buckets[level] = []
            heapq.heappush(self._levels, -level)
        bucket.append((key, prio, payload, self._version))

    def discard(self, key) -> None:
        """Lazily delete `key` (no-op if absent)."""
        self._live.pop(key, None)

    def _top_bucket(self):
        """Highest level with a live entry, with its bucket pruned to live
        entries only; None when empty."""
        while self._levels:
            level = -self._levels[0]
            bucket = self._buckets.get(level, ())
            live = [e for e in bucket
                    if self._live.get(e[0], (None, None, -1))[2] == e[3]]
            if live:
                self._buckets[level] = live
                return live
            heapq.heappop(self._levels)
            self._buckets.pop(level, None)
        return None

    def peek(self):
        """Best live (key, prio, payload) by (-prio, key), or None."""
        bucket = self._top_bucket()
        if bucket is None:
            return None
        key, prio, payload, _ = min(bucket, key=lambda e: (-e[1], e[0]))
        return key, prio, payload

    def pop(self):
        """Remove and return the best live (key, prio, payload), or None."""
        bucket = self._top_bucket()
        if bucket is None:
            return None
        best = min(bucket, key=lambda e: (-e[1], e[0]))
        bucket.remove(best)
        del self._live[best[0]]
        return best[0], best[1], best[2]


# --------------------------------------------------------------------------- #
# PackedRefitScheduler: device-fused scoring + O(budget + log n) host pops
# --------------------------------------------------------------------------- #
class PackedRefitScheduler:
    """The default planner (the reference dict-sorting planner of the JAX
    package has the same admission semantics and waits for a later slice).

    Per tick it makes ONE device pass over the `PackedFleet` arrays
    (`packed.fleet_scores`) which returns the top-`slots` waiting
    candidates, the waiting-queue depth, and the pressure reduction.  That
    top-k is sufficient for exact planning: a tick can consume at most
    `cap - len(kept)` waiting twins in the fill phase plus `len(kept)` in
    the eviction phase, and their sum is bounded by `cap <= slots`.  The
    host then re-scores the O(slots) candidates and residents in float64
    (see twin/packed.py's precision contract), orders candidates through a
    `PriorityBuckets` queue keyed by twin_id, and runs the admission
    algorithm: release, fill, preempt.  Host cost per tick:
    O(slots log slots + log n) plus the O(n) device pass.
    """

    def __init__(self, cfg: SchedulerConfig,
                 metrics: SchedulerMetrics | None = None, *,
                 quantum: float = 0.25, device="cpu"):
        self.cfg = cfg
        self.metrics = metrics
        self.device = device
        self.queue = PriorityBuckets(quantum)
        self.last_pressure = 0.0
        self.last_waiting = 0

    # ------------------------------------------------------------------ #
    def _priority_rows(self, fleet: PackedFleet, rows: np.ndarray
                       ) -> np.ndarray:
        """Exact float64 re-score of `rows` (the reference planner's IEEE
        operation order, so comparisons are bit-identical to it)."""
        cfg = self.cfg
        rows = np.asarray(rows, np.int64)
        stale = ((fleet.samples[rows] - fleet.samples_at_deploy[rows])
                 / max(cfg.min_samples, 1))
        stale = stale + np.where(fleet.deployed[rows], 0.0, 1.0)
        return (cfg.staleness_weight * stale
                + cfg.divergence_weight * fleet.divergence[rows])

    def pressure(self, fleet: PackedFleet) -> float:
        """Aggregate refit demand: summed priority over READY twins (waiting
        and resident), one device reduction."""
        cfg = self.cfg
        p = fleet_pressure(fleet, min_samples=cfg.min_samples,
                           sw=cfg.staleness_weight,
                           dw=cfg.divergence_weight, device=self.device)
        self.last_pressure = p
        if self.metrics is not None:
            self.metrics.pressure.set(p)
        return p

    # ------------------------------------------------------------------ #
    def plan(self, fleet: PackedFleet, slot_rows: np.ndarray,
             max_active: int | None = None) -> SchedulePlan:
        """Decide this tick's slot turnover from packed fleet state.

        `slot_rows[slot]` is the resident ring row, with values outside
        [0, fleet.capacity) marking an empty slot (the server's scratch-row
        convention).  Pure: mutates neither the fleet nor `slot_rows`; the
        server applies the plan.  `max_active` caps the slots that may be
        filled; when it drops below occupancy the lowest-priority residents
        are shed.
        """
        t0 = time.perf_counter()
        cfg = self.cfg
        cap = (cfg.slots if max_active is None
               else max(0, min(cfg.slots, max_active)))
        plan = SchedulePlan()

        slot_rows = np.asarray(slot_rows)
        occupied = ((slot_rows >= 0) & (slot_rows < fleet.capacity))

        # ONE device pass: top-k waiting candidates + queue depth + pressure
        cand_rows, cand_prio32, n_waiting, pressure = fleet_scores(
            fleet, min_samples=cfg.min_samples, sw=cfg.staleness_weight,
            dw=cfg.divergence_weight, k=cfg.slots, device=self.device)
        self.last_pressure = pressure
        self.last_waiting = n_waiting
        keep = np.isfinite(cand_prio32)
        cand_rows = cand_rows[keep]

        # exact float64 re-score of the O(slots) rows the plan can touch
        queue = self.queue
        queue.clear()
        if cand_rows.size:
            cand_prio = self._priority_rows(fleet, cand_rows)
            cand_ids = fleet.twin_id[cand_rows]
            for tid, prio in zip(cand_ids.tolist(), cand_prio.tolist()):
                queue.push(int(tid), prio)

        # residents as (twin_id, slot, priority, residency, healthy, stuck),
        # iterated in twin_id order like the reference
        residents = []
        res_rows = slot_rows[occupied]
        if res_rows.size:
            res_slots = np.nonzero(occupied)[0]
            res_prio = self._priority_rows(fleet, res_rows)
            res_ids = fleet.twin_id[res_rows]
            healthy = (fleet.deployed[res_rows]
                       & (fleet.divergence[res_rows]
                          < cfg.release_divergence))
            res_cnt = fleet.residency[res_rows]
            residents = sorted(
                zip(res_ids.tolist(), res_slots.tolist(), res_prio.tolist(),
                    res_cnt.tolist(), healthy.tolist()))

        # federation revoke: shed lowest-priority residents to fit the grant
        if len(residents) > cap:
            shed = sorted(residents, key=lambda r: (r[2], r[0]))
            shed_ids = {r[0] for r in shed[:len(residents) - cap]}
            plan.release.extend(sorted(shed_ids))
            residents = [r for r in residents if r[0] not in shed_ids]

        # voluntary release (converged+healthy, or stuck) — but only for
        # waiting twins the grant-usable free slots cannot absorb
        free = sorted(set(range(cfg.slots))
                      - {slot for _, slot, *_ in residents})
        kept = []
        usable_free = min(len(free), cap - len(residents))
        releasable = n_waiting - usable_free
        voluntary = 0
        for tid, slot, prio, residency, healthy in residents:
            stuck = residency >= 2 * cfg.max_residency
            if (voluntary < releasable
                    and ((residency >= cfg.max_residency and healthy)
                         or stuck)):
                plan.release.append(tid)
                voluntary += 1
                free.append(slot)
            else:
                kept.append((tid, slot, prio, residency))

        # fill free slots with the best waiting twins, up to the grant
        free.sort()
        budget = cap - len(kept)
        for slot in free:
            if budget <= 0 or not len(queue):
                break
            tid, _, _ = queue.pop()
            plan.admit.append((slot, tid))
            budget -= 1

        # preemption: strongest challengers vs weakest eligible residents
        evictable = sorted((r for r in kept
                            if r[3] >= cfg.min_residency),
                           key=lambda r: (r[2], r[0]))
        for tid, slot, prio, _ in evictable:
            top = queue.peek()
            if top is None:
                break
            if top[1] > prio + cfg.evict_margin:
                queue.pop()
                plan.evict.append(tid)
                plan.admit.append((slot, top[0]))
            else:
                break   # residents below this one are even harder to beat

        if self.metrics is not None:
            if plan.admit:
                self.metrics.admitted.inc(len(plan.admit))
            if plan.evict:
                self.metrics.evicted.inc(len(plan.evict))
            if plan.release:
                self.metrics.released.inc(len(plan.release))
            self.metrics.pressure.set(pressure)
            self.metrics.waiting.set(n_waiting)
            self.metrics.queue_entries.set(len(queue))
            self.metrics.plan_seconds.observe(time.perf_counter() - t0)
        return plan
