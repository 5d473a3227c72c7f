"""Public RK4 wrapper: shape checks, leading-axis folding, dispatch to the
CUDA kernel (csrc/rk4_poly.cu) or, for CPU tensors, the plain version.

Extra leading axes on theta/y0/us (the fleet axis of the refit decode, the
[ensemble, K] grid of a scenario query) fold into the batch axis: the
coefficients are per-instance operands, so folding is exact.  On a CUDA
tensor the forward launches the kernel (`_RK4Kernel`) and the backward
replays the plain version under autograd, as the JAX `custom_vjp` does.
The kernel masks its own ragged batch edge and reads no input channel when
m == 0, so there is neither padding nor a dummy channel here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref

__all__ = ["rk4_poly_solve", "rk4_poly_kernel"]

_BLOCK = 32            # instances (threads) per block


def rk4_poly_kernel(theta, y0, us, term_idx, dt: float):
    """Launch the CUDA kernel (no autograd).  theta [B, n, L], y0 [B, n],
    us [B, T, m], term_idx [L, O] int32, all contiguous on one CUDA device
    -> ys [B, T+1, n]."""
    B, n, L = theta.shape
    T, m = us.shape[1], us.shape[2]
    O = term_idx.shape[1]
    dev = theta.device
    for name, t, dtype in (("theta", theta, torch.float32),
                           ("y0", y0, torch.float32),
                           ("us", us, torch.float32),
                           ("term_idx", term_idx, torch.int32)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"rk4 kernel: {name} on {t.device}, expected "
                             f"the CUDA device {dev}")
        if t.dtype != dtype:
            raise TypeError(f"rk4 kernel: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rk4 kernel: {name} is not contiguous")
    lib = backend.load_library()
    if n > lib.rk4_poly_max_n() or 1 + n + m > lib.rk4_poly_max_aug():
        raise ValueError(f"rk4 kernel: n={n}, m={m} exceed the kernel's "
                         f"limits (n <= {lib.rk4_poly_max_n()}, 1+n+m <= "
                         f"{lib.rk4_poly_max_aug()})")
    nb = _BLOCK
    while nb > 1 and lib.rk4_poly_smem_bytes(n, L, O, nb) > backend.MAX_SMEM:
        nb //= 2
    if lib.rk4_poly_smem_bytes(n, L, O, nb) > backend.MAX_SMEM:
        raise ValueError(f"rk4 kernel: theta rows of {n * L} floats do not "
                         "fit in shared memory")
    ys = torch.empty((B, T + 1, n), dtype=torch.float32, device=dev)
    if B == 0:
        return ys
    err = lib.rk4_poly_launch(
        theta.data_ptr(), y0.data_ptr(), us.data_ptr() if m else None,
        term_idx.data_ptr(), ys.data_ptr(), B, n, m, L, O, T, float(dt), nb,
        ctypes.c_void_p(backend.cuda_stream(dev)))
    backend.check_cuda(lib, err, "rk4_poly_solve")
    rk4_poly_solve.launches += 1
    return ys


class _RK4Kernel(torch.autograd.Function):
    """CUDA forward, plain-version backward (replayed under autograd)."""

    @staticmethod
    def forward(ctx, theta, y0, us, term_idx, dt):
        ctx.save_for_backward(theta, y0, us, term_idx)
        ctx.dt = dt
        return rk4_poly_kernel(theta, y0, us, term_idx, dt)

    @staticmethod
    def backward(ctx, g_ys):
        theta, y0, us, term_idx = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip((theta, y0, us), need)]
        wanted = [t for t, n in zip(inputs, need) if n]
        if not wanted:
            return (None,) * 5
        with torch.enable_grad():
            ys = rk4_poly_solve_ref(*inputs, ctx.dt, term_idx)
            grads = iter(torch.autograd.grad(ys, wanted, g_ys,
                                             allow_unused=True))
        out = []
        for t, n in zip(inputs, need):
            g = next(grads) if n else None
            out.append(torch.zeros_like(t) if n and g is None else g)
        return (*out, None, None)


def rk4_poly_solve(theta, y0, us, *, dt: float, library):
    """Integrate dY = theta @ Phi(Y, u) for T steps.

    theta: [..., B, n, L], y0: [..., B, n], us: [..., B, T, m]
    -> ys [..., B, T+1, n] (row 0 is y0).  `library` is a
    repro_torch.core.library.PolyLibrary.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.
    """
    n, L = theta.shape[-2:]
    if n != library.n or L != library.size:
        raise ValueError(f"theta {tuple(theta.shape)} inconsistent with "
                         f"library (n={library.n}, L={library.size})")
    if (y0.shape[-1] != n or us.shape[-1] != library.m
            or theta.shape[:-2] != y0.shape[:-1]
            or theta.shape[:-2] != us.shape[:-2]):
        raise ValueError(f"theta {tuple(theta.shape)} / y0 "
                         f"{tuple(y0.shape)} / us {tuple(us.shape)} batch or "
                         f"channel axes disagree (library n={library.n}, "
                         f"m={library.m})")
    lead = theta.shape[:-2]
    T = us.shape[-2]
    # explicit flat batch: reshape(-1) cannot infer it when m == 0 makes us
    # a zero-size tensor
    Bf = math.prod(lead)
    theta = theta.reshape(Bf, n, L)
    y0 = y0.reshape(Bf, n)
    us = us.reshape(Bf, T, library.m)
    term_idx = library.indices_on(theta.device)
    if theta.device.type != "cuda":
        ys = rk4_poly_solve_ref(theta, y0, us, dt, term_idx)
    else:
        ys = _RK4Kernel.apply(theta.contiguous(), y0.contiguous(),
                              us.contiguous(), term_idx, float(dt))
    return ys.reshape(lead + ys.shape[1:])


rk4_poly_solve.launches = 0   # kernel launches (counted where the kernel starts)
