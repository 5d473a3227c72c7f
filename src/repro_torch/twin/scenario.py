"""Batched what-if rollouts with confidence bounds — the scenario engine.

A `ScenarioRunner` evaluates K counterfactual input sequences for one twin
over an ensemble of its E most recently served thetas in ONE `rk4_poly_solve`
call: the [E, K] grid folds into the kernel's batch axis.  The center
trajectory is the LIVE theta's rollout; lo/hi are the ensemble envelope and
confidence is 1 / (1 + normalized envelope width).  Under deadline pressure
the degradation ladder deterministically shrinks K (`effective_k`) or
refuses the query with `ScenarioRefused` before any device work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.obs import Tracer

__all__ = [
    "ScenarioConfig", "ScenarioRefused", "ScenarioResult", "ScenarioRunner",
    "effective_k",
]

_BLOWUP = 1e6          # matches the guard's non-finite clamp (monitor.py)


@dataclass(frozen=True)
class ScenarioConfig:
    """Scenario-engine knobs (part of `TwinServerConfig`).

    max_k            hard per-query cap on counterfactual sequences
    ensemble         theta-history ring size per twin (confidence ensemble);
                     1 disables the envelope (lo == hi, confidence == 1)
    shrink_level     degradation level at which K shrinks deterministically
    degraded_shrink  divisor applied to K at shrink_level (floor 1)
    refuse_level     degradation level at which queries are refused outright
    """
    max_k: int = 32
    ensemble: int = 4
    shrink_level: int = 2
    degraded_shrink: int = 4
    refuse_level: int = 3

    def __post_init__(self):
        if self.max_k < 1 or self.ensemble < 1:
            raise ValueError("max_k and ensemble must be >= 1")
        if self.degraded_shrink < 2:
            raise ValueError("degraded_shrink must be >= 2")
        if not (0 < self.shrink_level <= self.refuse_level):
            raise ValueError("need 0 < shrink_level <= refuse_level")


class ScenarioRefused(RuntimeError):
    """Scenario query refused under deadline pressure (degradation ladder).
    The message always starts with ``scenario refused``."""


def effective_k(requested: int, level: int, cfg: ScenarioConfig) -> int:
    """Deterministic K under the degradation ladder; raises when refused."""
    if requested < 1:
        raise ValueError(f"k must be >= 1, got {requested}")
    if requested > cfg.max_k:
        raise ValueError(f"k {requested} exceeds max_k {cfg.max_k}")
    if level >= cfg.refuse_level:
        raise ScenarioRefused(
            f"scenario refused: degradation level {level} >= "
            f"refuse_level {cfg.refuse_level}")
    if level >= cfg.shrink_level:
        return max(1, requested // cfg.degraded_shrink)
    return requested


@dataclass(frozen=True)
class ScenarioResult:
    """One twin's what-if answer: K trajectories plus an uncertainty band.

    ys          [K, H+1, n] center trajectories (LIVE theta rollout)
    lo, hi      [K, H+1, n] ensemble envelope (min/max over recent thetas)
    confidence  [K] in (0, 1]: 1 / (1 + normalized ensemble spread)
    k           effective K served (may be < requested_k when degraded)
    degraded_level   degradation-ladder level at serve time
    """
    twin_id: int
    horizon: int
    requested_k: int
    k: int
    degraded_level: int
    ys: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    confidence: np.ndarray


class ScenarioRunner:
    """Fused ensemble x K rollout engine over a PolyLibrary model family.
    Stateless after construction; `tracer` (the building server's) times
    the rollout and the wait for its copies."""

    def __init__(self, library, dt: float, cfg: ScenarioConfig, *,
                 tracer: Tracer | None = None):
        self.lib = library
        self.dt = float(dt)
        self.cfg = cfg
        self.tracer = Tracer(enabled=False) if tracer is None else tracer

    @torch.no_grad()
    def rollout(self, theta_hist, count: int, y0, us) -> tuple:
        """theta_hist [E, n, L] and y0 [n] on the device, count = deploys
        so far, us [K, H, m] -> numpy (center [K, H+1, n], lo, hi,
        confidence [K])."""
        E, n, L = theta_hist.shape
        span = self.tracer.span
        with span("scenario.rollout"):
            us = torch.as_tensor(np.asarray(us, np.float32),
                                 device=theta_hist.device)
            if us.ndim != 3:
                raise ValueError(
                    f"us must be [K, H, m], got {tuple(us.shape)}")
            K = us.shape[0]
            live_idx = max(count - 1, 0) % E
            live = theta_hist[live_idx]
            # unfilled ring slots fall back to the live theta: a twin with
            # one deploy still answers, with a zero-width envelope
            valid = torch.arange(E, device=theta_hist.device) < count
            ens = torch.where(valid[:, None, None], theta_hist, live[None])
            theta = ens[:, None].expand(E, K, n, L)
            y0b = y0.to(torch.float32)[None, None].expand(E, K, n)
            usb = us[None].expand((E,) + tuple(us.shape))
            ys = rk4_poly_solve(theta, y0b, usb, dt=self.dt,
                                library=self.lib)
            ys = torch.nan_to_num(ys, nan=_BLOWUP, posinf=_BLOWUP,
                                  neginf=-_BLOWUP).clamp(-_BLOWUP, _BLOWUP)
            center = ys[live_idx]
            lo = ys.amin(dim=0)
            hi = ys.amax(dim=0)
            # normalized mean envelope width per scenario, squashed to (0, 1]
            scale = torch.std(center, dim=(1, 2), correction=0) + 1e-6
            spread = torch.mean(hi - lo, dim=(1, 2)) / scale
            confidence = 1.0 / (1.0 + spread)
        with span("scenario.wait"):
            return tuple(t.cpu().numpy()
                         for t in (center, lo, hi, confidence))
