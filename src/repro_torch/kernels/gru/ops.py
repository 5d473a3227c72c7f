"""Public GRU-scan wrapper: shape checks, leading-axis folding, dispatch to
the CUDA kernel (csrc/gru_scan.cu) or, for CPU tensors, the plain version.

Two weight forms:

  * shared: wx [Din, 3H], wh [H, 3H], b [3H] with xs [..., B, T, Din] and
    h0 [..., B, H]; extra leading axes fold into the batch axis;
  * fleet: per-slot weights wx [F, Din, 3H], wh [F, H, 3H], b [F, 3H] with
    xs [F, B, T, Din], h0 [F, B, H] — one launch over a (slot, batch-tile)
    grid.  JAX got this from `pallas_call`'s vmap rule (the refit path runs
    the scan under `vmap` over slots); PyTorch has none, so the axis is
    explicit here.

On a CUDA tensor the forward launches the kernel (`_GRUScanKernel`) and the
backward replays the plain version under autograd — the JAX `custom_vjp`
does the same, and the JAX package has no backward kernel to port.  The
kernel masks its own ragged batch edge, so no padding happens here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.gru.ref import gru_scan_ref

__all__ = ["gru_scan", "gru_scan_kernel"]

_MAX_GRID_Y = 65535


def _block_b(H: int, B: int) -> int:
    """Sequences per block: about 128 threads, at least one sequence."""
    return max(1, min(B, 128 // H)) if B else 1


def gru_scan_kernel(xs, h0, wx, wh, b):
    """Launch the CUDA kernel on fleet-form operands (no autograd).

    xs [F, B, T, D], h0 [F, B, H], wx [F, D, 3H], wh [F, H, 3H], b [F, 3H],
    all fp32 contiguous on one CUDA device -> (hs [F, B, T, H], hT [F, B, H]).
    """
    F, B, T, D = xs.shape
    H = h0.shape[-1]
    dev = xs.device
    for name, t in (("xs", xs), ("h0", h0), ("wx", wx), ("wh", wh), ("b", b)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"gru_scan kernel: {name} on {t.device}, "
                             f"expected the CUDA device {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"gru_scan kernel: {name} is {t.dtype}, "
                            "expected float32")
        if not t.is_contiguous():
            raise ValueError(f"gru_scan kernel: {name} is not contiguous")
    if H > 1024:
        raise ValueError(f"gru_scan kernel: hidden {H} > 1024 threads")
    lib = backend.load_library()
    bt = _block_b(H, B)
    smem = lib.gru_scan_smem_bytes(D, H, bt)
    if smem > backend.MAX_SMEM:
        raise ValueError(f"gru_scan kernel: {smem} bytes of shared memory "
                         f"(D={D}, H={H}) exceeds {backend.MAX_SMEM}")
    if -(-B // bt) > _MAX_GRID_Y:
        raise ValueError(f"gru_scan kernel: batch {B} exceeds the grid")
    hs = torch.empty((F, B, T, H), dtype=torch.float32, device=dev)
    hT = torch.empty((F, B, H), dtype=torch.float32, device=dev)
    if F == 0 or B == 0:
        return hs, h0.clone()
    err = lib.gru_scan_launch(
        xs.data_ptr(), h0.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), hs.data_ptr(), hT.data_ptr(), F, B, T, D, H, bt,
        ctypes.c_void_p(backend.cuda_stream(dev)))
    backend.check_cuda(lib, err, "gru_scan")
    gru_scan.launches += 1
    return hs, hT


class _GRUScanKernel(torch.autograd.Function):
    """CUDA forward, plain-version backward (replayed under autograd)."""

    @staticmethod
    def forward(ctx, xs, h0, wx, wh, b):
        ctx.save_for_backward(xs, h0, wx, wh, b)
        return gru_scan_kernel(xs, h0, wx, wh, b)

    @staticmethod
    def backward(ctx, g_hs, g_hT):
        need = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t, n in zip(inputs, need) if n]
        if not wanted:
            return (None,) * 5
        with torch.enable_grad():
            hs, hT = gru_scan_ref(*inputs)
            grads = iter(torch.autograd.grad((hs, hT), wanted, (g_hs, g_hT),
                                             allow_unused=True))
        out = []
        for t, n in zip(inputs, need):
            g = next(grads) if n else None
            out.append(torch.zeros_like(t) if n and g is None else g)
        return tuple(out)


def gru_scan(xs, h0, wx, wh, b):
    """Fused GRU scan; see kernels/gru/ref.py for the math and the module
    docstring for the shared and fleet weight forms.

    Returns (hs [..., B, T, H], hT [..., B, H]).  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.
    """
    H = h0.shape[-1]
    fleet = wx.ndim == 3
    if (wx.shape[-1] != 3 * H or wh.shape[-2:] != (H, 3 * H)
            or b.shape[-1] != 3 * H or wx.ndim not in (2, 3)
            or wh.ndim != wx.ndim or b.ndim != wx.ndim - 1):
        raise ValueError(f"GRU weight shapes {tuple(wx.shape)}/"
                         f"{tuple(wh.shape)}/{tuple(b.shape)} inconsistent "
                         f"with hidden={H} (expect [*, 3H])")
    if xs.shape[:-2] != h0.shape[:-1] or xs.shape[-1] != wx.shape[-2]:
        raise ValueError(f"xs {tuple(xs.shape)} inconsistent with h0 "
                         f"{tuple(h0.shape)} / wx {tuple(wx.shape)}")
    if fleet and (xs.ndim != 4 or xs.shape[0] != wx.shape[0]
                  or wh.shape[0] != wx.shape[0] or b.shape[0] != wx.shape[0]):
        raise ValueError(f"fleet GRU weights {tuple(wx.shape)} need xs "
                         f"[F, B, T, Din] with the same F, got "
                         f"{tuple(xs.shape)}")
    if xs.device.type != "cuda":
        return gru_scan_ref(xs, h0, wx, wh, b)
    lead = xs.shape[:-2]
    T, d_in = xs.shape[-2:]
    if fleet:
        args = (xs, h0, wx, wh, b)
    else:                  # shared weights: the F = 1 case, leading axes folded
        Bf = math.prod(lead)
        args = (xs.reshape(1, Bf, T, d_in), h0.reshape(1, Bf, H),
                wx.unsqueeze(0), wh.unsqueeze(0), b.unsqueeze(0))
    args = tuple(a.contiguous() for a in args)
    hs, hT = _GRUScanKernel.apply(*args)
    if not fleet:
        hs, hT = hs.reshape(lead + (T, H)), hT.reshape(lead + (H,))
    return hs, hT


gru_scan.launches = 0     # kernel launches (counted where the kernel starts)
