"""Lotka-Volterra predator-prey system (paper Table I, row 1).

dy0/dt =  a*y0 - b*y0*y1
dy1/dt = -c*y1 + d*y0*y1

Coefficients follow the SINDy-MPC benchmark suite (Kaiser, Kutz & Brunton).
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class LotkaVolterra(DynamicalSystem):
    def __init__(self, a=1.0, b=0.1, c=1.5, d=0.075):
        self.a, self.b, self.c, self.d = a, b, c, d
        self.spec = SystemSpec(
            name="lotka_volterra", n=2, m=0, order=2,
            dt=0.02, horizon=400,
            y0_low=(5.0, 2.0), y0_high=(20.0, 10.0),
            input_kind="none",
        )

    def rows(self):
        return [
            {"y0": self.a, "y0*y1": -self.b},
            {"y1": -self.c, "y0*y1": self.d},
        ]
