"""Two-lump battery thermal model, temperatures as deviations from ambient.

    dTc/dt = q*u^2 - k1*(Tc - Ts)        (I^2*R heating, core -> surface)
    dTs/dt = k1*(Tc - Ts) - k2*Ts        (conduction in, convection out)
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class ThermalBattery(DynamicalSystem):
    def __init__(self, q=1.8, k1=0.9, k2=0.5):
        self.p = (q, k1, k2)
        self.spec = SystemSpec(
            name="thermal_battery", n=2, m=1, order=2,
            dt=0.05, horizon=500,
            y0_low=(0.0, 0.0), y0_high=(8.0, 4.0),
            input_kind="prbs", input_scale=1.0,
        )

    def rows(self):
        q, k1, k2 = self.p
        return [
            {"u0*u0": q, "y0": -k1, "y1": k1},
            {"y0": k1, "y1": -(k1 + k2)},
        ]
