"""Near-hover quadrotor roll axis with lateral drift.

    dphi/dt = p
    dp/dt   = tau*u - d1*p - d3*p^3      (actuation, drag, flapping)
    dvy/dt  = g*phi - c*vy               (tilt accelerates, drag bleeds)
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class Quadrotor(DynamicalSystem):
    def __init__(self, tau=8.0, d1=0.6, d3=0.4, g=9.81, c=0.35):
        self.p = (tau, d1, d3, g, c)
        self.spec = SystemSpec(
            name="quadrotor", n=3, m=1, order=3,
            dt=0.01, horizon=500,
            y0_low=(-0.3, -0.5, -0.5), y0_high=(0.3, 0.5, 0.5),
            input_kind="sum_of_sines", input_scale=0.4,
        )

    def rows(self):
        tau, d1, d3, g, c = self.p
        return [
            {"y1": 1.0},
            {"u0": tau, "y1": -d1, "y1*y1*y1": -d3},
            {"y0": g, "y2": -c},
        ]
