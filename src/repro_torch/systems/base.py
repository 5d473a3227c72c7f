"""Benchmark nonlinear dynamical systems: the common base.

Every system is a sparse polynomial ODE  dY/dt = Theta_true @ Phi(Y, U)  plus
what the data pipeline needs: initial-condition ranges, the input
excitation and the sampling step.  `true_theta(library)` places the
ground-truth coefficients into a library of any order, so recovered models
are scored both on reconstruction MSE (the paper's Table I metric) and on
coefficient error.  Specs and coefficients are those of the JAX package;
random draws come from an explicit `torch.Generator` on the CPU.
"""
from __future__ import annotations

import abc
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.library import PolyLibrary, make_library

__all__ = ["SystemSpec", "DynamicalSystem", "sum_of_sines", "prbs"]

PRBS_LEVELS = (0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)
PRBS_HOLD = 20          # samples each PRBS level is held


@dataclass(frozen=True)
class SystemSpec:
    name: str
    n: int              # state dimension
    m: int              # input dimension
    order: int          # polynomial order of the true dynamics
    dt: float           # sampling interval
    horizon: int        # default number of samples per trace
    y0_low: tuple
    y0_high: tuple
    input_kind: str     # "none" | "sum_of_sines" | "prbs"
    input_scale: float = 1.0


def sum_of_sines(generator: torch.Generator, horizon: int, batch: tuple,
                 m: int, dt: float, scale: float, n_tones: int = 4):
    """Inputs [horizon, *batch, m]: per channel a sum of `n_tones` sines of
    random frequency (0.1-1.5 Hz), phase and amplitude (0.2-1.0), drawn in
    that order and summed in float64."""
    shape = tuple(batch) + (m, n_tones)
    freqs = 0.1 + 1.4 * torch.rand(shape, generator=generator,
                                   dtype=torch.float64)
    phases = 2 * math.pi * torch.rand(shape, generator=generator,
                                      dtype=torch.float64)
    amps = 0.2 + 0.8 * torch.rand(shape, generator=generator,
                                  dtype=torch.float64)
    t = (torch.arange(horizon, dtype=torch.float64) * dt).reshape(
        (horizon,) + (1,) * (len(shape)))
    return ((amps * torch.sin(2 * math.pi * freqs * t + phases)).sum(-1)
            * scale).to(torch.float32)


def prbs(generator: torch.Generator, horizon: int, batch: tuple, m: int,
         scale: float):
    """Four-level PRBS [horizon, *batch, m]: levels {0, 1/3, 2/3, 1} held
    PRBS_HOLD samples.  Two levels would make u^2 collinear with {1, u} in
    the library; four keep every monomial of u independent."""
    n_seg = horizon // PRBS_HOLD + 1
    pick = torch.randint(len(PRBS_LEVELS), (n_seg,) + tuple(batch) + (m,),
                         generator=generator)
    levels = torch.tensor(PRBS_LEVELS, dtype=torch.float32)[pick]
    return levels.repeat_interleave(PRBS_HOLD, dim=0)[:horizon] * scale


class DynamicalSystem(abc.ABC):
    spec: SystemSpec

    @abc.abstractmethod
    def rows(self) -> list[dict[str, float]]:
        """Ground-truth coefficients as per-state {term_name: coeff} dicts."""

    # ------------------------------------------------------------------ #
    def library(self, order: int | None = None) -> PolyLibrary:
        return make_library(self.spec.n, self.spec.m,
                            order if order is not None else self.spec.order)

    def true_theta(self, library: PolyLibrary | None = None) -> np.ndarray:
        """Ground-truth coefficients placed in `library` (float64 [n, L])."""
        return (library or self.library()).theta_from_terms(self.rows())

    def rhs(self, y, u=None):
        """The polynomial rhs evaluated through the library."""
        lib = self.library()
        theta = torch.as_tensor(self.true_theta(lib), dtype=y.dtype,
                                device=y.device)
        return lib.eval(y, u if self.spec.m else None) @ theta.T

    # ------------------------------------------------------------------ #
    def sample_y0(self, generator: torch.Generator, batch: tuple = ()):
        """Initial states [*batch, n], uniform over the spec's range."""
        lo = torch.tensor(self.spec.y0_low)
        hi = torch.tensor(self.spec.y0_high)
        return lo + (hi - lo) * torch.rand(tuple(batch) + (self.spec.n,),
                                           generator=generator)

    def sample_inputs(self, generator: torch.Generator, horizon: int,
                      batch: tuple = ()):
        """Excitation inputs [horizon, *batch, m] (float32)."""
        spec = self.spec
        if spec.m and spec.input_kind == "sum_of_sines":
            return sum_of_sines(generator, horizon, batch, spec.m, spec.dt,
                                spec.input_scale)
        if spec.m and spec.input_kind == "prbs":
            return prbs(generator, horizon, batch, spec.m, spec.input_scale)
        return torch.zeros((horizon,) + tuple(batch) + (spec.m,))
