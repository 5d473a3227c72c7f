"""Shared model-recovery metrics (the paper's Table I)."""
from __future__ import annotations

import torch

from repro_torch.core.library import PolyLibrary
from repro_torch.kernels.rk4.ops import rk4_poly_solve

__all__ = ["reconstruction_mse", "coefficient_error"]


@torch.no_grad()
def reconstruction_mse(lib: PolyLibrary, theta, y_win, u_win,
                       dt: float) -> float:
    """Table I: re-integrate the recovered sparse model from each window's
    first sample and take the MSE against the measured window; the same
    protocol for MERINDA, EMILY and PINN+SR.

    A mis-recovered polynomial model can diverge under integration (cubic
    terms): diverged trajectories are clamped to 10x the data envelope, so
    a bad model scores a large but finite MSE instead of NaN."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=y_win.device)
    B = y_win.shape[0]
    y_est = rk4_poly_solve(theta.expand((B,) + theta.shape), y_win[:, 0, :],
                           u_win, dt=dt, library=lib)
    bound = float(10.0 * torch.max(torch.abs(y_win)))
    y_est = torch.clamp(torch.nan_to_num(y_est, nan=bound, posinf=bound,
                                         neginf=-bound), -bound, bound)
    return float(torch.mean(torch.square(y_est - y_win)))


def coefficient_error(theta, theta_true) -> float:
    """Relative L2 error on the stacked coefficient matrix."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    theta_true = torch.as_tensor(theta_true, dtype=torch.float32,
                                 device=theta.device)
    num = torch.linalg.norm(theta - theta_true)
    return float(num / (torch.linalg.norm(theta_true) + 1e-12))
