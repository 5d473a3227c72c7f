"""Host-side step-time monitoring.

`StragglerDetector` keeps an EWMA of step (tick) wall time and flags steps
slower than `threshold` x the EWMA; twin/recovery.py's degradation ladder
reads it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["StragglerDetector"]


@dataclass
class StragglerDetector:
    """EWMA step-time monitor; flags steps slower than threshold x EWMA.

    At scale the mitigation is re-dispatch + fence; in this repo the loop
    logs the event and (optionally) triggers an early checkpoint so a kill
    of the slow host loses no progress.
    """
    alpha: float = 0.1
    threshold: float = 3.0
    ewma_s: float | None = None
    events: list = field(default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        if self.ewma_s is None:
            self.ewma_s = dt_s
            return False
        slow = dt_s > self.threshold * self.ewma_s
        if slow:
            self.events.append({"step": step, "dt_s": dt_s,
                                "ewma_s": self.ewma_s})
        # EWMA excludes flagged outliers so one straggler doesn't mask the
        # next.
        if not slow:
            self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * dt_s
        return slow
