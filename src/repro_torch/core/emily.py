"""EMILY baseline: model recovery through a neural-ODE layer (the paper's
comparator; Banerjee, Kaiser & Gupta, PMLR 2024).

  1. Fit dY/dt = MLP(Y, U) by RK4-integrating windows with the MLP as the
     rhs and minimizing trajectory MSE: the NODE forward pass MERINDA
     replaces (4 MLP evaluations per RK4 step per sample, inside the
     training graph).
  2. Extract the sparse model: evaluate the learned rhs on the data and
     STLSQ-regress it onto the polynomial library -> Theta.

The MLP is plain PyTorch: no kernel of the JAX package serves it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.library import make_library
from repro_torch.core.odeint import rk4_step
from repro_torch.core.sparse_regression import stlsq
from repro_torch.kernels.backend import resolve_device

__all__ = ["EmilyConfig", "Emily", "mlp_init"]


@dataclass(frozen=True)
class EmilyConfig:
    n: int
    m: int
    order: int = 2
    hidden: int = 64            # width of the NODE rhs MLP
    depth: int = 2
    dt: float = 0.01
    stlsq_threshold: float = 0.05

    @property
    def library(self):
        return make_library(self.n, self.m, self.order)


def mlp_init(generator, dims: list[int]) -> list[dict]:
    """Layers {w [a, b] uniform in +-1/sqrt(a), b zeros} on the CPU, drawn
    from `generator` layer by layer."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        s = 1.0 / math.sqrt(a)
        layers.append({"w": torch.empty((a, b)).uniform_(
            -s, s, generator=generator), "b": torch.zeros((b,))})
    return layers


class Emily:
    def __init__(self, cfg: EmilyConfig):
        self.cfg = cfg
        self.lib = cfg.library

    def init(self, generator: torch.Generator | None = None, *,
             device=None):
        """Fresh params {"mlp": [{w, b}, ...]}, drawn on the CPU and moved
        to `device` (None: the card, raising without one).  The output
        layer starts at zero, so integration starts on the data."""
        device = resolve_device(device)
        cfg = self.cfg
        layers = mlp_init(generator,
                          [cfg.n + cfg.m] + [cfg.hidden] * cfg.depth + [cfg.n])
        layers[-1]["w"].zero_()
        return {"mlp": [{k: v.to(device) for k, v in layer.items()}
                        for layer in layers]}

    # ------------------------------------------------------------------ #
    def rhs(self, params, y, u):
        x = torch.cat([y, u], dim=-1) if self.cfg.m else y
        for layer in params["mlp"][:-1]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        return x @ params["mlp"][-1]["w"] + params["mlp"][-1]["b"]

    def node_forward(self, params, y0, u_win):
        """The NODE cell: RK4 integration of the learned rhs.  y0 [B, n],
        u_win [B, T, m] -> [B, T+1, n]."""
        f = lambda y, u: self.rhs(params, y, u)
        y, ys = y0, [y0]
        for t in range(u_win.shape[1]):
            y = rk4_step(f, y, u_win[:, t], self.cfg.dt)
            ys.append(y)
        return torch.stack(ys, dim=1)

    def loss(self, params, batch, sparsify_enable=False):
        del sparsify_enable       # sparsity comes afterwards, from STLSQ
        y_win, u_win = batch
        y_est = self.node_forward(params, y_win[:, 0, :], u_win)
        mse = torch.mean(torch.square(y_est - y_win))
        return mse, {"ode_loss": mse}

    @torch.no_grad()
    def recover(self, params, y_win, u_win):
        """STLSQ of the learned rhs onto the polynomial library."""
        cfg = self.cfg
        y = y_win[:, :-1, :].reshape(-1, cfg.n)
        u = u_win.reshape(y.shape[0], cfg.m)
        dy = self.rhs(params, y, u)
        phi = self.lib.eval(y, u if cfg.m else None)
        return stlsq(phi, dy, threshold=cfg.stlsq_threshold)
