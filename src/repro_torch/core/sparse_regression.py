"""Sequentially thresholded least squares (STLSQ), the SINDy-style sparse
regression of the EMILY and PINN+SR baselines, and the masked ridge refit
that polishes MERINDA's coefficients on its own support.

Both solve each state's masked normal equations in float32, as the JAX
package does: (Phi_m^T Phi_m + ridge I) w = Phi_m^T dy_i with Phi_m the
library columns kept by row i's mask.  The rows are one batched
`torch.linalg.solve` (cuSOLVER on the card, LAPACK on the CPU).
"""
from __future__ import annotations

import torch

__all__ = ["stlsq", "masked_ridge"]


def masked_ridge(phi, dy, mask, ridge: float = 1e-6):
    """Least-squares refit of dy ~= phi @ theta.T restricted to `mask`.

    phi [..., N, L] library features at samples, dy [..., N, n] derivative
    targets, mask [..., n, L] -> theta [..., n, L] (zero off the mask).
    """
    L = phi.shape[-1]
    phi_m = phi.unsqueeze(-3) * mask.unsqueeze(-2)            # [..., n, N, L]
    A = phi_m.mT @ phi_m + ridge * torch.eye(L, dtype=phi.dtype,
                                             device=phi.device)
    b = phi_m.mT @ dy.mT.unsqueeze(-1)                        # [..., n, L, 1]
    return torch.linalg.solve(A, b).squeeze(-1) * mask


def stlsq(phi, dy, threshold: float = 0.05, ridge: float = 1e-6,
          n_iters: int = 10):
    """Solve dy ~= phi @ theta.T with sequential magnitude thresholding:
    `n_iters` rounds of a masked ridge solve, each dropping the terms whose
    |coefficient| is at or below `threshold`.

    phi [N, L], dy [N, n] -> theta [n, L].
    """
    mask = phi.new_ones((dy.shape[-1], phi.shape[-1]))
    theta = masked_ridge(phi, dy, mask, ridge)
    for i in range(n_iters):
        if i:             # the first round's solve is the one just made
            theta = masked_ridge(phi, dy, mask, ridge)
        mask = (torch.abs(theta) > threshold).to(phi.dtype)
        theta = theta * mask
    return theta
