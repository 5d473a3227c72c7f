"""Plain PyTorch version of the fused RK4 polynomial-ODE integrator.

Contract (shared with the CUDA kernel, csrc/rk4_poly.cu):
  rk4_poly_solve(theta [B, n, L], y0 [B, n], us [B, T, m], dt,
                 term_indices [L, O]) -> ys [B, T+1, n]

integrating  dY/dt = theta @ Phi(Y, u)  with zero-order-hold inputs, where
Phi_l = prod_o Xaug[term_indices[l, o]] and Xaug = [1, Y, U].
"""
from __future__ import annotations

import torch

__all__ = ["rk4_poly_solve_ref", "poly_features_ref"]


def poly_features_ref(y, u, term_indices):
    """y: [..., n], u: [..., m], term_indices: [L, O] -> Phi [..., L]."""
    aug = torch.cat([torch.ones_like(y[..., :1]), y, u], dim=-1)
    idx = torch.as_tensor(term_indices, dtype=torch.long, device=aug.device)
    gathered = aug[..., idx]                              # [..., L, O]
    phi = gathered[..., 0]
    for o in range(1, idx.shape[1]):                      # fixed factor order
        phi = phi * gathered[..., o]
    return phi


def rk4_poly_solve_ref(theta, y0, us, dt, term_indices):
    def rhs(y, u):
        phi = poly_features_ref(y, u, term_indices)       # [B, L]
        return torch.einsum("bnl,bl->bn", theta, phi)

    y = y0
    ys = [y0]
    for t in range(us.shape[1]):
        u = us[:, t]
        k1 = rhs(y, u)
        k2 = rhs(y + 0.5 * dt * k1, u)
        k3 = rhs(y + 0.5 * dt * k2, u)
        k4 = rhs(y + dt * k3, u)
        y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return torch.stack(ys, dim=1)
