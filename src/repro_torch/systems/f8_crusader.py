"""F8 Crusader longitudinal dynamics (the paper's primary benchmark).

The Garrard & Jordan polynomial model (order 3, n=3 states, m=1 input):
  y0 = angle of attack, y1 = pitch angle, y2 = pitch rate, u = elevator.

dy0/dt = -0.877 y0 + y2 - 0.088 y0*y2 + 0.47 y0^2 - 0.019 y1^2 - y0^2*y2
         + 3.846 y0^3 - 0.215 u + 0.28 y0^2*u + 0.47 y0*u^2 + 0.63 u^3
dy1/dt = y2
dy2/dt = -4.208 y0 - 0.396 y2 - 0.47 y0^2 - 3.564 y0^3
         - 20.967 u + 6.265 y0^2*u + 46 y0*u^2 + 61.4 u^3

`F8Crusader(elevator_effectiveness=e)` scales every input-dependent
coefficient by e: partial elevator loss, the damage scenario of the online
serving example.  `simulate` makes telemetry with the port's own RK4.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.library import PolyLibrary, make_library
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.rk4.ops import rk4_poly_solve

__all__ = ["F8Crusader", "f8_rows", "simulate", "sum_of_sines"]


def f8_rows(u_name: str = "u0") -> list[dict[str, float]]:
    """Per-state {term_name: coeff} rows of one airframe (states y0..y2)."""
    a, b, q, u = "y0", "y1", "y2", u_name

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


@dataclass(frozen=True)
class F8Crusader:
    """One F-8 airframe: n=3, m=1, order 3, dt = 0.01 s.  `y0_low/high` and
    `input_scale` are the JAX package's trim-neighbourhood defaults."""
    elevator_effectiveness: float = 1.0
    n: int = 3
    m: int = 1
    order: int = 3
    dt: float = 0.01
    y0_low: tuple = (-0.15, -0.05, -0.05)
    y0_high: tuple = (0.30, 0.05, 0.05)
    input_scale: float = 0.05

    def library(self, order: int | None = None) -> PolyLibrary:
        return make_library(self.n, self.m,
                            self.order if order is None else order)

    def rows(self) -> list[dict[str, float]]:
        e = self.elevator_effectiveness
        return [{k: (v * e if "u0" in k else v) for k, v in row.items()}
                for row in f8_rows()]

    def true_theta(self, library: PolyLibrary | None = None) -> np.ndarray:
        """Ground-truth coefficients placed in `library` (float64 [n, L])."""
        return (library or self.library()).theta_from_terms(self.rows())


def sum_of_sines(generator: torch.Generator, batch: int, horizon: int,
                 m: int, dt: float, scale: float, n_tones: int = 4):
    """Excitation inputs [batch, horizon, m]: a sum of `n_tones` sines with
    random frequency (0.1-1.5 Hz), phase and amplitude per channel."""
    shape = (batch, 1, m, n_tones)
    freqs = 0.1 + 1.4 * torch.rand(shape, generator=generator,
                                   dtype=torch.float64)
    phases = 2 * math.pi * torch.rand(shape, generator=generator,
                                      dtype=torch.float64)
    amps = 0.2 + 0.8 * torch.rand(shape, generator=generator,
                                  dtype=torch.float64)
    t = (torch.arange(horizon, dtype=torch.float64) * dt)[None, :, None, None]
    return ((amps * torch.sin(2 * math.pi * freqs * t + phases)).sum(-1)
            * scale).to(torch.float32)


def simulate(system: F8Crusader, generator: torch.Generator, *, batch: int,
             horizon: int, substeps: int = 10, noise_std: float = 0.0,
             y0=None, us=None, device=None):
    """Ground-truth telemetry: (ys [batch, horizon+1, n] clean, ys_noisy,
    us [batch, horizon, m]), integrated with `substeps` RK4 sub-steps per
    sample (zero-order-hold inputs) through the port's rk4_poly_solve; the
    noise is Gaussian, scaled by each trace's per-channel std, as in the JAX
    package's `simulate_batch`.  `y0` and `us` default to draws from
    `generator` (on the CPU).  `device=None` integrates on the card and
    raises without one; pass "cpu" for the plain path."""
    device = resolve_device(device)
    lib = system.library()
    if y0 is None:
        lo = torch.tensor(system.y0_low)
        hi = torch.tensor(system.y0_high)
        y0 = lo + (hi - lo) * torch.rand((batch, system.n),
                                         generator=generator)
    if us is None:
        us = sum_of_sines(generator, batch, horizon, system.m, system.dt,
                          system.input_scale)
    y0 = torch.as_tensor(y0, dtype=torch.float32).to(device)
    us = torch.as_tensor(us, dtype=torch.float32).to(device)
    theta = torch.as_tensor(system.true_theta(lib), dtype=torch.float32,
                            device=device).expand(batch, system.n, lib.size)
    fine = rk4_poly_solve(theta, y0, us.repeat_interleave(substeps, dim=1),
                          dt=system.dt / substeps, library=lib)
    ys = fine[:, ::substeps]
    noise = torch.randn(ys.shape, generator=generator).to(device)
    ys_noisy = ys + noise_std * noise * ys.std(dim=1, keepdim=True,
                                               correction=0)
    return ys, ys_noisy, us
