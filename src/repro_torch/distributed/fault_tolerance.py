"""Host-side fault tolerance: heartbeats, straggler detection, failure
injection, and the elastic re-sizing policy.

What runs where:
  * `Heartbeat` / `StragglerDetector` — host-side monitors around a train
    or serving loop (per-step wall-time EWMA; a step exceeding `threshold`
    x the EWMA is flagged); twin/recovery.py's degradation ladder reads the
    detector.
  * `FailureInjector` — deterministic chaos hook: raises a
    `SimulatedPreemption` at a chosen step; the loop must restart from the
    last committed checkpoint (train/checkpoint.py).  twin/recovery.py's
    `ShardFailure` and `ChaosInjector` build on both.
  * `elastic_plan` — given a surviving device count, picks the largest
    (data, model) layout; train/checkpoint.py stores leaves as host arrays,
    so `restore(device=...)` puts them on whatever devices remain.

All of it is pure host code, copied from the JAX package's module of the
same name.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["Heartbeat", "StragglerDetector", "SimulatedPreemption",
           "FailureInjector", "elastic_plan"]


@dataclass
class Heartbeat:
    """Step-progress monitor.  `beat()` each step; `stalled()` reports if no
    beat arrived within `timeout_s` (host hang / lost worker)."""
    timeout_s: float = 300.0
    last_beat: float = field(default_factory=time.monotonic)
    step: int = -1

    def beat(self, step: int):
        self.step = step
        self.last_beat = time.monotonic()

    def stalled(self) -> bool:
        return (time.monotonic() - self.last_beat) > self.timeout_s


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


class SimulatedPreemption(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise SimulatedPreemption once the loop reaches `fail_at_step`.

    Fires on `step >= fail_at_step` (once), not exact equality: loops that
    skip step numbers (resume from a checkpoint, stride by accumulation,
    tick counters that jump after a drain) must still hit the injected
    failure instead of silently sailing past it.
    """
    fail_at_step: int | None = None
    fired: bool = False

    def maybe_fail(self, step: int):
        if (self.fail_at_step is not None and not self.fired
                and step >= self.fail_at_step):
            self.fired = True
            raise SimulatedPreemption(f"injected failure at step {step}")


def elastic_plan(n_devices: int, *, model_axis: int = 16) -> dict:
    """Pick the largest (data, model) layout for the surviving device count.

    Keeps the model axis fixed (the tensor-parallel degree is a property of
    the program) and shrinks data parallelism; global batch is preserved by
    raising grad_accum, so restarts are loss-curve-identical regardless of
    node loss.
    """
    if n_devices < model_axis:
        # degenerate: shrink the model axis too (single-host debugging)
        model_axis = max(1, n_devices)
    data = max(1, n_devices // model_axis)
    return {"mesh_shape": (data, model_axis),
            "axes": ("data", "model"),
            "grad_accum_scale": 16 // min(data, 16) if data < 16 else 1,
            "dropped_devices": n_devices - data * model_axis}
