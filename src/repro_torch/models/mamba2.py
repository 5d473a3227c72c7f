"""Mamba-2 block (SSD, state-space duality) for the Zamba2 hybrid.

Sequences map the SSD recurrence
    S_t = a_t * S_{t-1} + dt_t * B_t (x) x_t ,   y_t = C_t . S_t + D * x_t
onto the chunked linear recurrence (kernels/linear_scan, mode "ssd": read
after the update), on the card the CUDA kernel csrc/linear_scan.cu:
    q_t = C_t, k_t = B_t (each broadcast over the heads), v_t = dt_t * x_t,
    w_t = log a_t = -exp(A_log) * dt_t (f32, broadcast over K).
Decode is the exact O(1)-state step with a rolling causal-conv window and
runs no kernel, as in the JAX package.  Parameters are a plain dict of
tensors under the JAX package's names.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models.layers import apply_norm, dense, dense_init, norm_init

__all__ = ["mamba2_init", "mamba2_apply", "mamba2_decode",
           "mamba2_state_init"]


def _dims(d_model: int, expand: int, head_dim: int, state: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * state
    return d_inner, n_heads, conv_dim


def mamba2_init(gen: torch.Generator, d_model: int, *, state: int = 64,
                head_dim: int = 64, expand: int = 2, conv_width: int = 4,
                dtype=torch.float32) -> dict:
    """Random parameters drawn on the generator's device (the JAX package's
    distributions; the draws themselves differ)."""
    d_inner, n_heads, conv_dim = _dims(d_model, expand, head_dim, state)
    dev = gen.device
    d_in_proj = 2 * d_inner + 2 * state + n_heads     # z, x, B, C, dt
    f32 = torch.float32
    conv_w = torch.randn((conv_width, conv_dim), dtype=f32, device=dev,
                         generator=gen) / math.sqrt(conv_width)
    u = torch.rand((n_heads,), dtype=f32, device=dev, generator=gen)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        "in_proj": dense_init(gen, d_model, d_in_proj, dtype),
        "conv": {"w": conv_w.to(dtype),            # depthwise, over (x, B, C)
                 "b": torch.zeros((conv_dim,), dtype=dtype, device=dev)},
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=f32,
                                          device=dev)).to(dtype),
        "D": torch.ones((n_heads,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))).to(dtype),
        "norm": norm_init(d_inner, "rmsnorm", dtype, dev),
        "out_proj": dense_init(gen, d_inner, d_model, dtype),
    }


def _causal_conv(w, b, x, init=None):
    """Depthwise causal conv: x [B, T, C], w [W, C].  init: [B, W-1, C] tail
    of the previous segment (zeros at sequence start).  Summed over the W
    taps in order, then + b, as the JAX package."""
    W = w.shape[0]
    B, T, C = x.shape
    if init is None:
        init = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([init, x], dim=1)
    out = xp[:, 0:T, :] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T, :] * w[i]
    # the new conv tail, a copy: a view would keep all of xp alive
    return F.silu(out + b), xp[:, T:, :].clone()


def _split_proj(zxbcdt, d_inner, state, n_heads):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * state]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt


def _skip(p, xs, head_dim: int):
    """The D skip term, in xs's dtype."""
    return xs * torch.repeat_interleave(p["D"], head_dim).to(xs.dtype)


def mamba2_apply(p, x, *, state: int = 64, head_dim: int = 64,
                 expand: int = 2, conv_width: int = 4, ssm_state=None,
                 conv_state=None, chunk: int = 64):
    """x: [B, T, d] -> (y, (new_conv_state, new_ssm_state))."""
    B, T, d = x.shape
    d_inner, n_heads, conv_dim = _dims(d, expand, head_dim, state)
    zxbcdt = dense(p["in_proj"], x)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, state, n_heads)

    xbc, new_conv = _causal_conv(p["conv"]["w"], p["conv"]["b"], xbc,
                                 conv_state)
    xs = xbc[..., :d_inner]
    Bt = xbc[..., d_inner:d_inner + state]
    Ct = xbc[..., d_inner + state:]

    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))         # [B, T, H]
    a_log = -torch.exp(p["A_log"].to(f32)) * dt                # log decay

    # the unified recurrence's operands, [B, H, T, K/V]
    q = Ct[:, None].expand(B, n_heads, T, state)
    k = Bt[:, None].expand(B, n_heads, T, state)
    v = (xs.reshape(B, T, n_heads, head_dim)
         * dt[..., None].to(xs.dtype)).transpose(1, 2)
    w = a_log.transpose(1, 2)[..., None].expand(B, n_heads, T, state)

    o, new_ssm = linear_scan(q, k, v, w, mode="ssd", chunk=chunk,
                             initial_state=ssm_state)
    y = o.transpose(1, 2).reshape(B, T, d_inner).to(x.dtype)
    y = y + _skip(p, xs, head_dim)
    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    return dense(p["out_proj"], y), (new_conv, new_ssm)


# --------------------------------------------------------------------------- #
# Decode (single token, exact recurrence; no kernel)
# --------------------------------------------------------------------------- #
def mamba2_state_init(batch: int, d_model: int, *, state: int = 64,
                      head_dim: int = 64, expand: int = 2,
                      conv_width: int = 4, dtype=torch.float32,
                      device=None) -> dict:
    d_inner, n_heads, conv_dim = _dims(d_model, expand, head_dim, state)
    return {
        "conv": torch.zeros((batch, conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, state, head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x1, mstate, *, state: int = 64, head_dim: int = 64,
                  expand: int = 2, conv_width: int = 4):
    """x1: [B, d] -> (y [B, d], new_state)."""
    B, d = x1.shape
    d_inner, n_heads, conv_dim = _dims(d, expand, head_dim, state)
    zxbcdt = dense(p["in_proj"], x1)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, state, n_heads)

    conv_in = torch.cat([mstate["conv"], xbc[:, None, :]], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", conv_in, p["conv"]["w"])
                 + p["conv"]["b"])
    new_conv = conv_in[:, 1:, :]

    f32 = torch.float32
    xs = xbc[..., :d_inner]
    Bt = xbc[..., d_inner:d_inner + state].to(f32)
    Ct = xbc[..., d_inner + state:].to(f32)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))           # [B, H]
    a = torch.exp(-torch.exp(p["A_log"].to(f32)) * dt)          # [B, H]

    xh = xs.reshape(B, n_heads, head_dim).to(f32)
    dBx = (dt[..., None, None] * Bt[:, None, :, None]
           * xh[:, :, None, :])                                  # [B,H,K,V]
    new_ssm = a[..., None, None] * mstate["ssm"] + dBx
    y = torch.einsum("bk,bhkv->bhv", Ct, new_ssm)
    y = y.reshape(B, d_inner).to(x1.dtype)
    y = y + _skip(p, xs, head_dim)
    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    return dense(p["out_proj"], y), {"conv": new_conv, "ssm": new_ssm}
