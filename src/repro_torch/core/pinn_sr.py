"""PINN+SR baseline: a physics-informed network with sparse regression
(the paper's second comparator).

A coordinate network N(t) -> Y_hat(t) fits one trace; the physics residual
ties its time derivative (exact, by forward-mode AD in t) to a jointly
learned sparse library model:

  loss = MSE(Y_hat(t_i), Y_i)
       + lam_phys * || dY_hat/dt(t_i) - Theta @ Phi(Y_hat(t_i), U(t_i)) ||^2
       + lam_l1 * |Theta|_1

with sequential thresholding rounds on Theta (the SR part).  As in the
JAX package every leaf of the params is trained, the Fourier frequencies
and the threshold mask included; the output statistics only scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.emily import mlp_init
from repro_torch.core.library import make_library
from repro_torch.core.merinda import _abs
from repro_torch.kernels.backend import resolve_device

__all__ = ["PinnSRConfig", "PinnSR"]


@dataclass(frozen=True)
class PinnSRConfig:
    n: int
    m: int
    order: int = 2
    hidden: int = 64
    depth: int = 3
    n_fourier: int = 16         # Fourier features on t
    dt: float = 0.01
    horizon: int = 400          # samples per trace the net is fit to
    lam_phys: float = 0.1
    lam_l1: float = 1e-3
    threshold: float = 0.05

    @property
    def library(self):
        return make_library(self.n, self.m, self.order)


class PinnSR:
    def __init__(self, cfg: PinnSRConfig):
        self.cfg = cfg
        self.lib = cfg.library

    def init(self, generator: torch.Generator | None = None, ys=None, *,
             device=None):
        """Fresh params, drawn on the CPU and moved to `device` (None: the
        card, raising without one).  ys: optional [T+1, n] trace whose
        mean and std standardize the net's output (coordinate nets fit
        O(1) targets far faster); theta stays in physical units."""
        device = resolve_device(device)
        cfg = self.cfg
        dims = [2 * cfg.n_fourier + 1] + [cfg.hidden] * cfg.depth + [cfg.n]
        layers = mlp_init(generator, dims)
        if ys is None:
            y_mu, y_sigma = torch.zeros((cfg.n,)), torch.ones((cfg.n,))
        else:
            ys = torch.as_tensor(ys, dtype=torch.float32)
            y_mu = ys.mean(dim=0)
            y_sigma = ys.std(dim=0, correction=0) + 1e-6
        params = {
            "mlp": layers,
            # harmonics of the trace period (bounded derivatives)
            "freqs": ((torch.arange(cfg.n_fourier, dtype=torch.float32)
                       + 1.0) / (cfg.horizon * cfg.dt)),
            "y_mu": y_mu, "y_sigma": y_sigma,
            "theta": torch.zeros((cfg.n, self.lib.size)),
            "mask": torch.ones((cfg.n, self.lib.size)),   # the SR mask
        }
        to = lambda t: t.to(device=device, dtype=torch.float32)
        return {k: ([{n: to(v) for n, v in layer.items()} for layer in p]
                    if k == "mlp" else to(p)) for k, p in params.items()}

    # ------------------------------------------------------------------ #
    def net(self, params, t):
        """t [...] (seconds) -> Y_hat [..., n]."""
        wt = 2 * math.pi * params["freqs"] * t[..., None]
        x = torch.cat([t[..., None], torch.sin(wt), torch.cos(wt)], dim=-1)
        for layer in params["mlp"][:-1]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        raw = x @ params["mlp"][-1]["w"] + params["mlp"][-1]["b"]
        return raw * params["y_sigma"].detach() + params["y_mu"].detach()

    def net_and_dot(self, params, t):
        """(Y_hat, dY_hat/dt) at every t, by forward-mode AD in t (each
        output row depends on its own t only)."""
        return torch.func.jvp(lambda tt: self.net(params, tt), (t,),
                              (torch.ones_like(t),))

    # ------------------------------------------------------------------ #
    def loss(self, params, batch, sparsify_enable=False):
        """batch: (ys [T+1, n], us [T, m]), one trace."""
        del sparsify_enable
        cfg = self.cfg
        ys, us = batch
        T = us.shape[0]
        ts = torch.arange(T, dtype=torch.float32, device=ys.device) * cfg.dt
        y_hat, y_dot = self.net_and_dot(params, ts)
        sigma = params["y_sigma"].detach()
        data = torch.mean(torch.square((y_hat - ys[:-1]) / sigma))
        theta = params["theta"] * params["mask"]
        phi = self.lib.eval(y_hat, us if cfg.m else None)
        phys = torch.mean(torch.square((y_dot - phi @ theta.T) / sigma))
        l1 = torch.mean(_abs(params["theta"]))
        loss = data + cfg.lam_phys * phys + cfg.lam_l1 * l1
        return loss, {"data": data, "phys": phys, "l1": l1,
                      "ode_loss": data}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def apply_threshold(self, params):
        """One SR round: zero and freeze the small coefficients."""
        theta = params["theta"] * params["mask"]
        mask = (torch.abs(theta) > self.cfg.threshold).to(theta.dtype)
        return {**params, "theta": theta * mask, "mask": mask}

    @torch.no_grad()
    def recover(self, params, y_win=None, u_win=None):
        del y_win, u_win
        return params["theta"] * params["mask"]
