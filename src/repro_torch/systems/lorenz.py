"""Chaotic Lorenz system (paper Table I, row 2).

dy0/dt = sigma*(y1 - y0)
dy1/dt = y0*(rho - y2) - y1
dy2/dt = y0*y1 - beta*y2
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class Lorenz(DynamicalSystem):
    def __init__(self, sigma=10.0, rho=28.0, beta=8.0 / 3.0):
        self.sigma, self.rho, self.beta = sigma, rho, beta
        self.spec = SystemSpec(
            name="lorenz", n=3, m=0, order=2,
            dt=0.005, horizon=800,
            y0_low=(-10.0, -10.0, 15.0), y0_high=(10.0, 10.0, 35.0),
            input_kind="none",
        )

    def rows(self):
        return [
            {"y0": -self.sigma, "y1": self.sigma},
            {"y0": self.rho, "y0*y2": -1.0, "y1": -1.0},
            {"y0*y1": 1.0, "y2": -self.beta},
        ]
