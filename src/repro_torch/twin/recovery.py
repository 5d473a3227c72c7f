"""Deadline-aware graceful degradation for the twin server.

`DegradationPolicy` watches tick wall time (EWMA via `StragglerDetector` +
the instantaneous tick) and sheds work through a fixed ladder — level 1
shrinks the guard, level 2 defers refit train steps, level 3 skips
shadow-eval promotion — restoring level by level once pressure clears.

Only the degradation ladder is ported so far; checkpointing, the telemetry
journal and chaos injection wait for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.distributed.fault_tolerance import StragglerDetector

__all__ = ["DegradationConfig", "DegradationPolicy", "DegradationEvent"]


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
