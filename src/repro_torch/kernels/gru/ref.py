"""Plain PyTorch version of the fused GRU sequence scan (the kernel's contract).

Gate layout in the fused weight matrices is [z | r | c] along the last axis:

    z_t = sigmoid(x_t Wx[:, :H]   + h Wh[:, :H]   + b[:H])
    r_t = sigmoid(x_t Wx[:, H:2H] + h Wh[:, H:2H] + b[H:2H])
    c_t = tanh   (x_t Wx[:, 2H:]  + (r_t * h) Wh[:, 2H:] + b[2H:])
    h_t = (1 - z_t) * h + z_t * c_t

Weights may carry a leading fleet axis of per-slot weights (wx [F, Din, 3H],
wh [F, H, 3H], b [F, 3H] with xs [F, B, T, Din], h0 [F, B, H]); shared 2-d
weights broadcast over any leading axes of xs/h0.  Used on CPU tensors, by
the tests, and as the backward of the CUDA kernel (kernels/gru/ops.py).
"""
from __future__ import annotations

import math

import torch

__all__ = ["gru_cell_ref", "gru_scan_ref", "init_gru_params"]


def init_gru_params(generator: torch.Generator | None, d_in: int, hidden: int,
                    *, dtype=torch.float32) -> dict:
    """Uniform(+-1/sqrt(fan)) weights, zero bias, drawn from `generator`
    (on the CPU; callers move the result to their device)."""
    sx = 1.0 / math.sqrt(d_in)
    sh = 1.0 / math.sqrt(hidden)
    return {
        "wx": torch.empty((d_in, 3 * hidden), dtype=dtype).uniform_(
            -sx, sx, generator=generator),
        "wh": torch.empty((hidden, 3 * hidden), dtype=dtype).uniform_(
            -sh, sh, generator=generator),
        "b": torch.zeros((3 * hidden,), dtype=dtype),
    }


def _gates(h, xp_t, wh):
    H = h.shape[-1]
    hp2 = h @ wh[..., :, :2 * H]                         # z/r hidden part
    z = torch.sigmoid(xp_t[..., :H] + hp2[..., :H])
    r = torch.sigmoid(xp_t[..., H:2 * H] + hp2[..., H:])
    c = torch.tanh(xp_t[..., 2 * H:] + (r * h) @ wh[..., :, 2 * H:])
    return (1.0 - z) * h + z * c


def gru_cell_ref(h, x, wx, wh, b):
    """One GRU step. h: [..., H], x: [..., Din] -> new h."""
    bias = b.unsqueeze(-2) if b.ndim > 1 else b
    return _gates(h, x @ wx + bias, wh)


def gru_scan_ref(xs, h0, wx, wh, b):
    """xs: [..., B, T, Din], h0: [..., B, H] -> (hs [..., B, T, H], hT)."""
    # hoisted input projection, as the TPU kernel does it (one product for
    # every timestep); unsqueeze(-3) lines a fleet axis of weights up with
    # xs's leading axis and is a no-op broadcast for shared weights
    xp = xs @ wx.unsqueeze(-3) + b.unsqueeze(-2).unsqueeze(-2)
    h = h0
    hs = []
    for t in range(xs.shape[-2]):
        h = _gates(h, xp[..., t, :], wh)
        hs.append(h)
    if not hs:
        return h0.new_zeros(h0.shape[:-1] + (0, h0.shape[-1])), h0
    return torch.stack(hs, dim=-2), h
