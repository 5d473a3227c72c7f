"""Divergence guard: does the deployed twin still match reality?

Every serving tick the guard RK4-rolls each deployed theta forward over the
newest telemetry window (the RK4 kernel, kernels/rk4) and scores the
normalized rollout error against what the sensors reported:

    score = mean((SOLVE(y_0, theta, U) - Y)^2) / (var(Y) + eps)

Non-finite errors (an unstable rollout) are clamped to 1e6 so the guard
fires instead of propagating NaNs.  Scores are EMA-smoothed on the host in
float64 (`fold_into`), and `judge` turns a smoothed score into REFIT/ALERT
events.  `GuardRotation` bounds guard cost at large fleets: a fixed-size
rotating subset per tick plus a carry-over quota for flagged twins.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.obs.registry import DEFAULT_SCORE_BUCKETS

__all__ = ["GuardConfig", "GuardEvent", "GuardInstruments", "DivergenceGuard",
           "GuardRotation", "score_confidence"]

_BLOWUP_SCORE = 1e6     # score assigned to non-finite (unstable) rollouts


@dataclass(frozen=True)
class GuardConfig:
    window: int = 32                 # telemetry steps rolled per check
    refit_threshold: float = 0.1
    alert_threshold: float = 1.0
    ema: float = 0.5                 # new-score weight in the EMA


def score_confidence(score: float) -> float:
    """Map a normalized divergence score to a confidence in (0, 1]:
    1 / (1 + score)."""
    return 1.0 / (1.0 + max(float(score), 0.0))


@dataclass(frozen=True)
class GuardEvent:
    twin_id: int
    kind: str        # "REFIT" | "ALERT"
    score: float
    tick: int
    confidence: float = 1.0    # score_confidence(score); 1.0 = full trust


@dataclass
class GuardInstruments:
    """Guard/rotation instruments (obs registry children), owned by the
    server: `events` counts REFIT/ALERT transitions, `score` the raw
    (pre-EMA) scores, `scored` guard evaluations, `live` the eligible set."""
    events: dict            # kind -> Counter
    score: object           # Histogram of raw divergence scores
    scored: object          # Counter: twins scored by the fused guard call
    live: object            # Gauge: guard-eligible (deployed + sampled) twins

    @staticmethod
    def create(registry) -> "GuardInstruments":
        return GuardInstruments(
            events={kind: registry.counter(
                        "twin_guard_events_total",
                        help="guard state transitions by kind",
                        labels={"kind": kind})
                    for kind in ("REFIT", "ALERT")},
            score=registry.histogram(
                "twin_divergence_score",
                help="raw guard divergence scores (normalized rollout "
                     "error; 1e6 = non-finite blowup)",
                bounds=DEFAULT_SCORE_BUCKETS),
            scored=registry.counter(
                "twin_guard_scored_total",
                help="twin scorings performed by the fused guard rollout"),
            live=registry.gauge(
                "twin_guard_live",
                help="guard-eligible twins (deployed with enough samples)"))


class DivergenceGuard:
    """Scores deployed thetas against reality; see module docstring.  The
    rollout runs where the tensors are (the RK4 kernel on the card)."""

    def __init__(self, library, dt: float, cfg: GuardConfig = GuardConfig()):
        self.lib = library
        self.dt = dt
        self.cfg = cfg

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def score(self, theta, ys, us):
        """Normalized rollout error per twin.

        theta [B, n, L]; ys [B, k+1, n] newest telemetry; us [B, k, m].
        Returns [B] float32 — finite even when the rollout diverges.
        """
        y_est = rk4_poly_solve(theta, ys[:, 0, :], us, dt=self.dt,
                               library=self.lib)
        num = torch.mean(torch.square(y_est - ys), dim=(1, 2))
        den = torch.mean(torch.square(ys - torch.mean(ys, dim=1,
                                                      keepdim=True)),
                         dim=(1, 2)) + 1e-6
        return torch.nan_to_num(num / den, nan=_BLOWUP_SCORE,
                                posinf=_BLOWUP_SCORE)

    # ------------------------------------------------------------------ #
    def smooth(self, prev: float, score: float) -> float:
        """EMA update of one record's score."""
        a = self.cfg.ema
        return a * min(float(score), _BLOWUP_SCORE) + (1.0 - a) * prev

    def fold_into(self, div_by_row: np.ndarray, rows: np.ndarray,
                  scores) -> np.ndarray:
        """Vectorized `smooth`: EMA-fold raw `scores` into the by-row
        float64 divergence array IN PLACE at `rows`; returns the updated
        values.  Same float64 arithmetic order as `smooth`."""
        a = self.cfg.ema
        rows = np.asarray(rows)
        clipped = np.minimum(np.asarray(scores, np.float64), _BLOWUP_SCORE)
        div_by_row[rows] = a * clipped + (1.0 - a) * div_by_row[rows]
        return div_by_row[rows]

    def judge(self, twin_id: int, score: float, tick: int) -> GuardEvent | None:
        """Threshold an (already smoothed) score into an event, or None."""
        if score > self.cfg.alert_threshold:
            return GuardEvent(twin_id, "ALERT", float(score), tick,
                              score_confidence(score))
        if score > self.cfg.refit_threshold:
            return GuardEvent(twin_id, "REFIT", float(score), tick,
                              score_confidence(score))
        return None


class GuardRotation:
    """Budgeted round-robin guard scheduling with divergence carry-over.

    Each tick `select()` picks `budget` rows along a cyclic cursor over the
    eligible set (every eligible twin is scored within ceil(eligible /
    budget) ticks) plus up to `carry` extra rows: the most-diverged twins
    above the refit threshold.  Pure numpy over a sorted eligible-row array
    and a by-row divergence array.
    """

    def __init__(self, budget: int, carry: int = 0):
        if budget < 1:
            raise ValueError("guard rotation budget must be >= 1")
        self.budget = budget
        self.carry = max(0, carry)
        self._cursor = 0       # next ring row served by the rotation (cyclic)

    @property
    def size(self) -> int:
        """Fixed fused-call width (rows beyond the pick are scratch-padded)."""
        return self.budget + self.carry

    def select(self, rows: np.ndarray, div_by_row: np.ndarray,
               threshold: float, *, budget: int | None = None,
               carry: int | None = None) -> np.ndarray:
        """Pick this tick's ring rows (at most `budget + carry`, distinct).
        `budget`/`carry` override the configured quotas for one call (the
        degradation path)."""
        eff_budget = self.budget if budget is None else max(1, budget)
        eff_carry = self.carry if carry is None else max(0, carry)
        rows = np.asarray(rows)
        if rows.size == 0:
            return rows
        i = int(np.searchsorted(rows, self._cursor))
        take = min(eff_budget, rows.size)
        pick = rows[(i + np.arange(take)) % rows.size]
        self._cursor = int(pick[-1]) + 1
        if eff_carry:
            flagged = rows[div_by_row[rows] > threshold]
            flagged = flagged[~np.isin(flagged, pick)]
            if flagged.size > eff_carry:
                part = np.argpartition(-div_by_row[flagged],
                                       eff_carry - 1)[:eff_carry]
                flagged = flagged[part]
            # deterministic order: most diverged first, row id breaks ties
            flagged = flagged[np.lexsort((flagged, -div_by_row[flagged]))]
            pick = np.concatenate([pick, flagged])
        return pick
