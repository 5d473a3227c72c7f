"""Fixed-step ODE integrators over a sampled input sequence.

  * rk4_step / euler_step   single-step updates
  * integrate               step any f(y, u) over the inputs, y0 prepended
  * poly_ode_integrate      integrate dY = Theta @ Phi(Y, U) (the contract
                            of kernels/rk4, written with `integrate`)

Inputs are held over each step (zero-order hold): u[t] is constant from t
to t+1.  `integrate` is a Python loop, generic in f: EMILY steps its MLP
rhs with `rk4_step`.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["euler_step", "rk4_step", "integrate", "poly_ode_integrate"]


def euler_step(f: Callable, y, u, dt):
    return y + dt * f(y, u)


def rk4_step(f: Callable, y, u, dt):
    """Classic RK4 with the input held over the step."""
    k1 = f(y, u)
    k2 = f(y + 0.5 * dt * k1, u)
    k3 = f(y + 0.5 * dt * k2, u)
    k4 = f(y + dt * k3, u)
    return y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"rk4": rk4_step, "euler": euler_step}


def integrate(f: Callable, y0, us, dt, method: str = "rk4",
              substeps: int = 1):
    """Integrate dy/dt = f(y, u): y0 [..., n], us [T, ..., m] ->
    ys [T+1, ..., n] with y0 at index 0; `substeps` steps per sample."""
    step = _STEPPERS[method]
    h = dt / substeps
    y, ys = y0, [y0]
    for u in us:
        for _ in range(substeps):
            y = step(f, y, u, h)
        ys.append(y)
    return torch.stack(ys)


def poly_ode_integrate(theta, y0, us, dt, *, library, method: str = "rk4",
                       substeps: int = 1):
    """Integrate dY = Theta @ Phi(Y, U): theta [..., n, L], y0 [..., n],
    us [T, ..., m] (m == 0: shape [T, ..., 0]) -> ys [T+1, ..., n]."""
    def rhs(y, u):
        phi = library.eval(y, u if library.m else None)
        return torch.einsum("...nl,...l->...n", theta, phi)

    return integrate(rhs, y0, us, dt, method=method, substeps=substeps)
