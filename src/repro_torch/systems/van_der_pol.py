"""Forced Van der Pol oscillator (limit-cycle dynamics).

  dy0/dt = y1
  dy1/dt = mu*(1 - y0^2)*y1 - y0 + u = mu*y1 - mu*y0^2*y1 - y0 + u
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class VanDerPol(DynamicalSystem):
    def __init__(self, mu: float = 1.5):
        self.mu = mu
        self.spec = SystemSpec(
            name="van_der_pol", n=2, m=1, order=3,
            dt=0.02, horizon=600,
            y0_low=(-2.0, -2.0), y0_high=(2.0, 2.0),
            input_kind="sum_of_sines", input_scale=0.8,
        )

    def rows(self):
        return [
            {"y1": 1.0},
            {"y1": self.mu, "y0*y0*y1": -self.mu, "y0": -1.0, "u0": 1.0},
        ]
