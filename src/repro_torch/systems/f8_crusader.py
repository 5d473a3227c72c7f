"""F8 Crusader longitudinal dynamics (the paper's primary benchmark).

The Garrard & Jordan polynomial model (order 3, n=3 states, m=1 input):
  y0 = angle of attack, y1 = pitch angle, y2 = pitch rate, u = elevator.

dy0/dt = -0.877 y0 + y2 - 0.088 y0*y2 + 0.47 y0^2 - 0.019 y1^2 - y0^2*y2
         + 3.846 y0^3 - 0.215 u + 0.28 y0^2*u + 0.47 y0*u^2 + 0.63 u^3
dy1/dt = y2
dy2/dt = -4.208 y0 - 0.396 y2 - 0.47 y0^2 - 3.564 y0^3
         - 20.967 u + 6.265 y0^2*u + 46 y0*u^2 + 61.4 u^3

`F8Crusader(n_aircraft=k)` stacks k independent airframes into one
3k-dimensional system driven by one shared elevator input: the paper's
model-dimension sweep (Fig. 4 / Table II).
"""
from __future__ import annotations

from repro_torch.systems.base import DynamicalSystem, SystemSpec

__all__ = ["F8Crusader", "f8_rows"]


def f8_rows(base: int = 0, u_name: str = "u0") -> list[dict[str, float]]:
    """Rows of one airframe whose states are y{base}..y{base+2}."""
    a, b, q = f"y{base}", f"y{base + 1}", f"y{base + 2}"
    u = u_name

    def nm(*parts):
        return "*".join(sorted(parts))

    row0 = {
        a: -0.877, q: 1.0, nm(a, q): -0.088, nm(a, a): 0.47,
        nm(b, b): -0.019, nm(a, a, q): -1.0, nm(a, a, a): 3.846,
        u: -0.215, nm(a, a, u): 0.28, nm(a, u, u): 0.47, nm(u, u, u): 0.63,
    }
    row1 = {q: 1.0}
    row2 = {
        a: -4.208, q: -0.396, nm(a, a): -0.47, nm(a, a, a): -3.564,
        u: -20.967, nm(a, a, u): 6.265, nm(a, u, u): 46.0, nm(u, u, u): 61.4,
    }
    return [row0, row1, row2]


class F8Crusader(DynamicalSystem):
    """F8 longitudinal dynamics; `n_aircraft` stacks independent airframes
    (n = 3 * n_aircraft, one shared elevator input)."""

    def __init__(self, n_aircraft: int = 1):
        self.n_aircraft = n_aircraft
        n = 3 * n_aircraft
        self.spec = SystemSpec(
            name=f"f8_crusader_{n}d" if n_aircraft > 1 else "f8_crusader",
            n=n, m=1, order=3,
            dt=0.01, horizon=600,
            # the open-loop cubic terms (3.846 y0^3) destabilize large
            # angle-of-attack excursions: a trim-neighbourhood range
            y0_low=tuple([-0.15, -0.05, -0.05] * n_aircraft),
            y0_high=tuple([0.30, 0.05, 0.05] * n_aircraft),
            input_kind="sum_of_sines", input_scale=0.05,
        )

    def rows(self):
        # inputs follow ALL states in the library, so the input is u0 for
        # every n_aircraft
        return [row for k in range(self.n_aircraft)
                for row in f8_rows(3 * k, "u0")]
