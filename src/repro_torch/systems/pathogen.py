"""Pathogenic attack system (paper Table I, row 4).

The paper prints no equations; this is the JAX package's sparse
polynomial pathogen / immune-response model under treatment input u:

dP/dt = r*P - c*P*I - g*P*u     (growth, immune kill, drug kill)
dI/dt = a*P*I - d*I + s*u       (stimulation, natural death, treatment)
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec


class PathogenicAttack(DynamicalSystem):
    def __init__(self, r=1.2, c=0.45, g=0.6, a=0.25, d=0.35, s=0.4):
        self.p = (r, c, g, a, d, s)
        self.spec = SystemSpec(
            name="pathogenic_attack", n=2, m=1, order=2,
            dt=0.02, horizon=500,
            y0_low=(1.0, 0.5), y0_high=(6.0, 3.0),
            input_kind="prbs", input_scale=0.8,
        )

    def rows(self):
        r, c, g, a, d, s = self.p
        return [
            {"y0": r, "y0*y1": -c, "u0*y0": -g},
            {"y0*y1": a, "y1": -d, "u0": s},
        ]
