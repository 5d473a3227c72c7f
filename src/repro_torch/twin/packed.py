"""Packed fleet-state arrays: the scheduler's device-scored data layout.

Row-indexed numpy arrays are the truth for what the scheduler reads
(samples, deploy watermark, divergence, residency); the `TwinRecord` dict is
metadata.  `fleet_scores` scores the WHOLE fleet in one pass on the device
and returns only the top-`slots` waiting candidates, the waiting-queue depth
and the pressure sum, so per-tick host work is O(slots).

Precision contract: the device pass scores in float32 and only RANKS
candidates; ties break toward the lower row (a stable descending sort —
`torch.topk` gives no tie order on CUDA).  The host re-scores the returned
rows in float64 with the reference planner's arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PackedFleet", "fleet_scores", "fleet_pressure"]


class PackedFleet:
    """Row-indexed scheduler-state arrays for one server's tracked fleet.

    All arrays have length `capacity` (= the server's `max_twins`); a row is
    live once `registered[row]` is True (set last in `register`).
    `divergence` (float64) is the guard's exact truth for host re-scoring;
    `div32` its float32 shadow for the device pass, written at the same
    mutation points.
    """

    __slots__ = ("capacity", "twin_id", "registered", "samples",
                 "samples_at_deploy", "deployed", "divergence", "div32",
                 "resident", "residency")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.twin_id = np.full((capacity,), -1, np.int64)
        self.registered = np.zeros((capacity,), bool)
        self.samples = np.zeros((capacity,), np.int32)
        self.samples_at_deploy = np.zeros((capacity,), np.int32)
        self.deployed = np.zeros((capacity,), bool)
        self.divergence = np.zeros((capacity,), np.float64)
        self.div32 = np.zeros((capacity,), np.float32)
        self.resident = np.zeros((capacity,), bool)
        self.residency = np.zeros((capacity,), np.int64)

    def set_divergence(self, rows, values) -> None:
        """Write divergence truth + its float32 shadow together."""
        self.divergence[rows] = values
        self.div32[rows] = self.divergence[rows]

    def check_mirrors(self) -> None:
        """Assert the float32 shadow matches the float64 truth (tests)."""
        if not np.array_equal(self.div32,
                              self.divergence.astype(np.float32)):
            raise AssertionError("div32 shadow drifted from divergence")

    def register(self, row: int, twin_id: int) -> None:
        """Bind a row to a twin id; `registered` is set last."""
        self.twin_id[row] = twin_id
        self.registered[row] = True


def _priorities(fleet: PackedFleet, min_samples: int, sw: float, dw: float,
                device):
    """float32 priority of every row and the ready mask, on `device`."""
    col = lambda a: torch.from_numpy(a).to(device)
    samples = col(fleet.samples)
    stale = ((samples - col(fleet.samples_at_deploy)).to(torch.float32)
             / torch.tensor(float(max(min_samples, 1)), device=device))
    deployed = col(fleet.deployed)
    stale = stale + torch.where(deployed, 0.0, 1.0)
    prio = (torch.tensor(sw, dtype=torch.float32, device=device) * stale
            + torch.tensor(dw, dtype=torch.float32, device=device)
            * col(fleet.div32))
    ready = col(fleet.registered) & (samples >= min_samples)
    return prio, ready


def fleet_scores(fleet: PackedFleet, *, min_samples: int, sw: float,
                 dw: float, k: int, device="cpu"):
    """One pass over the fleet: (cand_rows [k], cand_prio [k] float32,
    n_waiting, pressure) as numpy/python values.  cand rows are the top-k
    READY, UNSLOTTED rows by priority, ties toward the lower row; rows whose
    cand_prio is -inf are padding (fewer than k waiting)."""
    k = max(1, min(k, fleet.capacity))
    prio, ready = _priorities(fleet, min_samples, sw, dw, device)
    pressure = torch.sum(torch.where(ready, prio, 0.0))
    waiting = ready & ~torch.from_numpy(fleet.resident).to(device)
    n_waiting = torch.sum(waiting)
    masked = torch.where(waiting, prio, -torch.inf)
    order = torch.sort(masked, descending=True, stable=True).indices[:k]
    # one device -> host copy; every value is exact in float64
    out = torch.cat([order.to(torch.float64), masked[order].to(torch.float64),
                     torch.stack([n_waiting.to(torch.float64),
                                  pressure.to(torch.float64)])]
                    ).cpu().numpy()
    return (out[:k].astype(np.int64), out[k:2 * k].astype(np.float32),
            int(out[2 * k]), float(out[2 * k + 1]))


def fleet_pressure(fleet: PackedFleet, *, min_samples: int, sw: float,
                   dw: float, device="cpu") -> float:
    """Aggregate refit demand: summed priority over ready rows."""
    prio, ready = _priorities(fleet, min_samples, sw, dw, device)
    return float(torch.sum(torch.where(ready, prio, 0.0)))
