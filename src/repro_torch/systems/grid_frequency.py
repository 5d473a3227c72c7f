"""Single-area grid frequency dynamics (swing equation + governor).

    M*df/dt   = p - D*f - u              (inertia, damping, load imbalance)
    tau*dp/dt = -p - f/R                 (governor droop response)
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class GridFrequency(DynamicalSystem):
    def __init__(self, M=8.0, D=1.0, R=0.08, tau=0.5):
        self.p = (M, D, R, tau)
        self.spec = SystemSpec(
            name="grid_frequency", n=2, m=1, order=2,
            dt=0.02, horizon=500,
            y0_low=(-0.5, -0.5), y0_high=(0.5, 0.5),
            input_kind="prbs", input_scale=0.3,
        )

    def rows(self):
        M, D, R, tau = self.p
        return [
            {"y1": 1.0 / M, "y0": -D / M, "u0": -1.0 / M},
            {"y1": -1.0 / tau, "y0": -1.0 / (R * tau)},
        ]
