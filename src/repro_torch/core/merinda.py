"""MERINDA: Model REcovery IN Dynamic Architectures, in PyTorch.

Architecture (paper Fig. 2): windows of (Y, U) -> GRU encoder -> pruned
dense head (ReLU MLP from the hidden states to C(M+n, n) library
coefficients, sparsified so only |Theta| stay active, plus q input-shift
values) -> RK4 solver SOLVE(Y(0), Theta_est, U) -> Y_est.

Params are a plain nested dict of tensors with the JAX package's keys
({"gru": {wx, wh, b}, "head": {w1, b1, w2, b2}, "norm": {mu, sigma,
phi_scale}}).  Every method also takes params and data with a LEADING FLEET
AXIS (params leaves [F, ...], y_win [F, B, k+1, n]) and then returns one
value per slot: the refit path (core/fleet.py) runs all slots in one call,
with the GRU scan launched over per-slot weights.  Both hot blocks go
through the kernel wrappers (kernels/gru, kernels/rk4), which choose the
CUDA kernel or the plain version by the device of the tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.library import PolyLibrary, make_library
from repro_torch.kernels.gru.ops import gru_scan
from repro_torch.kernels.gru.ref import init_gru_params
from repro_torch.kernels.rk4.ops import rk4_poly_solve

__all__ = ["MerindaConfig", "Merinda", "median_midpoint"]


@dataclass(frozen=True)
class MerindaConfig:
    n: int                      # state dim |Y|
    m: int                      # input dim
    order: int = 2              # library order M
    hidden: int = 64            # GRU width V
    head_hidden: int = 64       # dense-head hidden width
    n_active: int = 8           # |Theta|: surviving coefficients
    dt: float = 0.01
    l1: float = 1e-3            # sparsity penalty on dense coefficients
    theta_scale: float = 1.0    # output scale of the head
    collocation_weight: float = 1.0   # "network loss" (derivative residual)
    learn_shift: bool = True    # the paper's q input-shift outputs

    @property
    def library(self) -> PolyLibrary:
        return make_library(self.n, self.m, self.order)


def median_midpoint(x: torch.Tensor, dim: int, keepdim: bool = False):
    """`jnp.median`: the mean of the two middle values for an even count,
    computed as (lo + hi) * 0.5 like JAX.  `torch.median` returns the lower
    one, and `torch.quantile` interpolates in another order."""
    s = torch.sort(x, dim=dim).values
    N = x.shape[dim]
    lo = s.narrow(dim, (N - 1) // 2, 1)
    hi = s.narrow(dim, N // 2, 1)
    out = (lo + hi) * 0.5
    return out if keepdim else out.squeeze(dim)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient at zero (+1, where `torch.abs` gives 0).  The
    head's last layer starts at zero, so every coefficient sits at 0 on a
    fresh slot's first step and the L1 term's gradient depends on this."""
    return torch.where(x >= 0, x, -x)


def _expand_flag(flag, like: torch.Tensor, lead_ndim: int, extra: int):
    """A python bool or a per-slot bool tensor [lead] -> a tensor that
    broadcasts against `extra` trailing axes."""
    flag = torch.as_tensor(flag, device=like.device)
    return flag.reshape(tuple(flag.shape) + (1,) * extra) if lead_ndim else flag


class Merinda:
    """Functional model: params are a dict of tensors; methods are pure."""

    def __init__(self, cfg: MerindaConfig):
        self.cfg = cfg
        self.lib = cfg.library

    # ------------------------------------------------------------------ #
    def norm_stats(self, y_win, u_win):
        """Per-channel (mu, sigma) of the GRU input and per-column library
        scales (phi_scale), over windows and time.  y_win [..., N, k+1, n]."""
        xs = torch.cat([y_win[..., :-1, :], u_win], dim=-1)
        mu = xs.mean(dim=(-3, -2))
        sigma = xs.std(dim=(-3, -2), correction=0) + 1e-6   # jnp.std: ddof 0
        phi = self.lib.eval(y_win[..., :-1, :], u_win if self.cfg.m else None)
        phi_scale = torch.sqrt(torch.mean(torch.square(phi),
                                          dim=(-3, -2))) + 1e-6
        return {"mu": mu, "sigma": sigma, "phi_scale": phi_scale}

    def init(self, generator: torch.Generator | None = None, norm=None, *,
             device="cpu"):
        """Fresh params; random leaves come from `generator` on the CPU and
        are then moved to `device`.  `norm` defaults to the identity."""
        cfg = self.cfg
        L = self.lib.size
        d_in = cfg.n + cfg.m
        q = cfg.m if cfg.learn_shift else 0
        d_head = 2 * cfg.hidden    # [last hidden ; mean-pooled hidden]
        s1 = 1.0 / math.sqrt(d_head)
        gru = init_gru_params(generator, d_in, cfg.hidden)
        w1 = torch.empty((d_head, cfg.head_hidden)).uniform_(
            -s1, s1, generator=generator)
        if norm is None:
            norm = {"mu": torch.zeros((d_in,)), "sigma": torch.ones((d_in,)),
                    "phi_scale": torch.ones((L,))}
        params = {
            "gru": gru,
            "head": {
                "w1": w1,
                "b1": torch.zeros((cfg.head_hidden,)),
                # zero init: Theta_est starts at 0 -> stable integration
                "w2": torch.zeros((cfg.head_hidden, cfg.n * L + q)),
                "b2": torch.zeros((cfg.n * L + q,)),
            },
            "norm": norm,
        }
        return {g: {k: v.to(device=device, dtype=torch.float32)
                    for k, v in leaves.items()}
                for g, leaves in params.items()}

    # ------------------------------------------------------------------ #
    def encode(self, params, y_win, u_win):
        """GRU forward: windows -> dense coefficients + input shift.

        y_win: [..., B, k+1, n], u_win: [..., B, k, m].
        Returns (theta_dense [..., B, n, L], shift [..., B, m]).
        """
        cfg = self.cfg
        L = self.lib.size
        xs = torch.cat([y_win[..., :-1, :], u_win], dim=-1)    # [..., B, k, n+m]
        norm = {k: v.detach() for k, v in params["norm"].items()}
        xs = ((xs - norm["mu"][..., None, None, :])
              / norm["sigma"][..., None, None, :])
        h0 = xs.new_zeros(xs.shape[:-2] + (cfg.hidden,))
        g = params["gru"]
        hs, hT = gru_scan(xs, h0, g["wx"], g["wh"], g["b"])
        summary = torch.cat([hT, hs.mean(dim=-2)], dim=-1)
        hd = params["head"]
        h = torch.relu(summary @ hd["w1"] + hd["b1"].unsqueeze(-2))
        raw = (h @ hd["w2"] + hd["b2"].unsqueeze(-2)) * cfg.theta_scale
        # the head regresses unit-scale-library coefficients; rescale
        theta_dense = (raw[..., :cfg.n * L].unflatten(-1, (cfg.n, L))
                       / norm["phi_scale"][..., None, None, :])
        if cfg.learn_shift and cfg.m:
            shift = raw[..., cfg.n * L:]
        else:
            shift = raw.new_zeros(raw.shape[:-1] + (cfg.m,))
        return theta_dense, shift

    # ------------------------------------------------------------------ #
    def sparsify(self, theta_dense, enable, phi_scale=None):
        """Magnitude top-|Theta| mask with straight-through gradients.

        theta_dense [..., B, n, L]; `enable` is a python bool or a per-slot
        bool tensor over the leading axes.  Ties at the threshold are all
        kept (`>=` against the k-th largest), as in the JAX package.
        """
        cfg = self.cfg
        n, L = theta_dense.shape[-2:]
        lead_ndim = theta_dense.ndim - 3
        scale = (theta_dense.new_ones((L,)) if phi_scale is None
                 else phi_scale)
        flat = theta_dense.flatten(-2)                         # [..., B, nL]
        k = min(cfg.n_active, n * L)
        mag = torch.abs(flat * scale.tile((n,)).unsqueeze(-2)).detach()
        thresh = torch.sort(mag, dim=-1).values[..., -k:][..., :1]
        mask = (mag >= thresh).to(flat.dtype)
        sparse = (flat * mask).unflatten(-1, (n, L))
        return torch.where(_expand_flag(enable, flat, lead_ndim, 3),
                           sparse, theta_dense)

    # ------------------------------------------------------------------ #
    def decode(self, theta, y0, u_win):
        """SOLVE(Y(0), Theta, U): RK4-integrate the recovered model."""
        return rk4_poly_solve(theta, y0, u_win, dt=self.cfg.dt,
                              library=self.lib)

    def forward(self, params, y_win, u_win, sparsify_enable=False):
        theta_dense, shift = self.encode(params, y_win, u_win)
        theta = self.sparsify(theta_dense, sparsify_enable,
                              params["norm"]["phi_scale"])
        u_eff = u_win + shift.unsqueeze(-2) if self.cfg.m else u_win
        y_est = self.decode(theta, y_win[..., 0, :], u_eff)
        return y_est, theta, theta_dense

    # ------------------------------------------------------------------ #
    def loss(self, params, batch, sparsify_enable=False):
        """ODE loss MSE(Y, Y_est) + collocation loss + L1; one value per
        leading (fleet) index, a scalar for unbatched params."""
        cfg = self.cfg
        y_win, u_win = batch
        lead_ndim = y_win.ndim - 3
        dims = (-3, -2, -1)
        y_est, theta, theta_dense = self.forward(params, y_win, u_win,
                                                 sparsify_enable)
        ode_loss = torch.mean(torch.square(y_est - y_win), dim=dims)
        phi_scale = params["norm"]["phi_scale"].detach()
        l1 = torch.mean(_abs(theta_dense * phi_scale[..., None, None, :]),
                        dim=dims)
        # L1 relaxed 10x once the hard mask is active
        l1_w = torch.where(_expand_flag(sparsify_enable, l1, lead_ndim, 0),
                           0.1 * cfg.l1, cfg.l1)
        loss = ode_loss + l1_w * l1
        coll = torch.zeros_like(loss)
        if cfg.collocation_weight:
            dy_fd = (y_win[..., 2:, :] - y_win[..., :-2, :]) / (2.0 * cfg.dt)
            y_mid = y_win[..., 1:-1, :]
            u_mid = u_win[..., 1:, :]
            phi = self.lib.eval(y_mid, u_mid if cfg.m else None)
            pred = torch.einsum("...nl,...kl->...kn", theta, phi)
            coll = torch.mean(torch.square(pred - dy_fd), dim=dims)
            loss = loss + cfg.collocation_weight * coll
        return loss, {"ode_loss": ode_loss, "l1": l1, "coll": coll,
                      "theta_mean_abs": torch.mean(torch.abs(theta),
                                                   dim=dims)}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def recover(self, params, y_win, u_win, polish: bool = False):
        """One global sparse model from all windows: median-pooled
        coefficients, re-sparsified.  Returns theta [..., n, L]."""
        if polish:
            raise NotImplementedError("polish (masked ridge) is not ported "
                                      "yet; use polish=False")
        theta_dense, _ = self.encode(params, y_win, u_win)
        pooled = median_midpoint(theta_dense, dim=-3, keepdim=True)
        return self.sparsify(pooled, True,
                             params["norm"]["phi_scale"]).squeeze(-3)
