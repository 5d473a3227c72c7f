"""Ground-truth trace generation for the model-recovery benchmarks.

Traces are integrated at `substeps` RK4 sub-intervals per sample (inputs
held over each sample), then optionally corrupted with Gaussian noise
scaled by each trace's per-channel std over time.  Every system's rhs is
Theta_true @ Phi(Y, U), so the integration is one `rk4_poly_solve` call
on the inputs repeated `substeps` times: the JAX package's generic
`integrate(system.rhs, ...)`, through the RK4 kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.systems.base import DynamicalSystem

__all__ = ["Trace", "simulate", "simulate_batch", "simulate_from",
           "register_systems", "REGISTRY"]


@dataclass
class Trace:
    """Sampled trajectories: ys [..., T+1, n] clean, ys_noisy likewise,
    us [..., T, m]."""
    ys: torch.Tensor
    ys_noisy: torch.Tensor
    us: torch.Tensor
    dt: float


def simulate_from(system: DynamicalSystem, y0, us, *, substeps: int = 10,
                  noise_std: float = 0.0,
                  generator: torch.Generator | None = None,
                  device=None) -> Trace:
    """Integrate `system` from y0 [B, n] under us [B, T, m] (held over
    each sample).  The noise (when `noise_std`) is drawn from `generator`
    on the CPU.  `device=None` integrates on the card and raises without
    one; pass "cpu" for the plain path."""
    device = resolve_device(device)
    lib = system.library()
    y0 = torch.as_tensor(y0, dtype=torch.float32).to(device)
    us = torch.as_tensor(us, dtype=torch.float32).to(device)
    theta = torch.as_tensor(system.true_theta(lib), dtype=torch.float32,
                            device=device).expand(y0.shape[0], lib.n,
                                                  lib.size)
    fine = rk4_poly_solve(theta, y0, us.repeat_interleave(substeps, dim=1),
                          dt=system.spec.dt / substeps, library=lib)
    ys = fine[:, ::substeps].contiguous()
    ys_noisy = ys
    if noise_std:
        noise = torch.randn(ys.shape, generator=generator).to(device)
        ys_noisy = ys + noise_std * noise * ys.std(dim=1, keepdim=True,
                                                   correction=0)
    return Trace(ys=ys, ys_noisy=ys_noisy, us=us, dt=system.spec.dt)


def simulate_batch(system: DynamicalSystem, generator: torch.Generator,
                   batch: int, horizon: int | None = None,
                   substeps: int = 10, noise_std: float = 0.0, *,
                   device=None) -> Trace:
    """`batch` independent traces: ys [batch, T+1, n], us [batch, T, m].
    Draws, in order: y0, the inputs, the noise."""
    horizon = horizon or system.spec.horizon
    y0 = system.sample_y0(generator, (batch,))
    us = system.sample_inputs(generator, horizon, (batch,)).movedim(0, 1)
    return simulate_from(system, y0, us, substeps=substeps,
                         noise_std=noise_std, generator=generator,
                         device=device)


def simulate(system: DynamicalSystem, generator: torch.Generator,
             horizon: int | None = None, substeps: int = 10,
             noise_std: float = 0.0, *, device=None) -> Trace:
    """One trace: ys [T+1, n], us [T, m]."""
    tr = simulate_batch(system, generator, 1, horizon, substeps, noise_std,
                        device=device)
    return Trace(ys=tr.ys[0], ys_noisy=tr.ys_noisy[0], us=tr.us[0],
                 dt=tr.dt)


REGISTRY = {}


def register_systems():
    """Populate the name -> constructor registry (import-cycle-free)."""
    from repro_torch.systems.f8_crusader import F8Crusader
    from repro_torch.systems.grid_frequency import GridFrequency
    from repro_torch.systems.lorenz import Lorenz
    from repro_torch.systems.lotka_volterra import LotkaVolterra
    from repro_torch.systems.pathogen import PathogenicAttack
    from repro_torch.systems.quadrotor import Quadrotor
    from repro_torch.systems.thermal_battery import ThermalBattery
    from repro_torch.systems.van_der_pol import VanDerPol

    REGISTRY.update({
        "lotka_volterra": LotkaVolterra,
        "lorenz": Lorenz,
        "f8_crusader": F8Crusader,
        "pathogenic_attack": PathogenicAttack,
        "van_der_pol": VanDerPol,
        "quadrotor": Quadrotor,
        "thermal_battery": ThermalBattery,
        "grid_frequency": GridFrequency,
    })
    return REGISTRY
