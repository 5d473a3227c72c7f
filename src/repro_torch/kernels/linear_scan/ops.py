"""Public wrapper for the chunked linear recurrence (RWKV-6 / Mamba-2 SSD):
shape checks, then dispatch on the device of the inputs -- CPU tensors run
the plain chunked version (kernels/linear_scan/ref.py), CUDA tensors launch
the hand-written kernel (csrc/linear_scan.cu: three launches a call -- chunk
states, the scan across chunks, chunk outputs -- counted as one) or raise.

On a CUDA tensor the forward launches the kernel (`_LinearScanKernel`) and
the backward replays the plain chunked version on the saved inputs under
autograd, as the GRU and RK4 wrappers do: the JAX package trains through
its jnp chunked scan (its Pallas kernel has no VJP), so there is no
backward kernel to port.  Under recomputation (`LMConfig.remat`) the
forward runs, and launches, again in the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.linear_scan.ref import MODES, linear_scan_chunked
from repro_torch.kernels.work import scan_work

__all__ = ["linear_scan", "linear_scan_kernel"]

_MAX_DIM = 64          # C, K and V limits of the kernel's shared-memory tiles
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def linear_scan_kernel(q, k, v, w, u, s0, *, mode: str, chunk: int):
    """Launch the CUDA kernel (no autograd).

    q, k [BH, T, K] and v [BH, T, V] in one of float32 / bfloat16; w
    [BH, T, K] float32; u [H, K] float32 or None; s0 [BH, K, V] float32 or
    None; all contiguous on one CUDA device.  Returns (o [BH, T, V],
    final_state [BH, K, V]), float32.  On meta tensors nothing launches:
    the outputs are shaped and the work reported (backend.meta_kernel).
    """
    BH, T, K = q.shape
    V = v.shape[-1]
    C = min(chunk, T)
    dev = q.device
    named = [("q", q), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)]
    for name, t in named:
        if t is None:
            continue
        if t.device != dev or t.device.type not in ("cuda", "meta"):
            raise ValueError(f"linear_scan kernel: {name} on {t.device}, "
                             f"expected the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"linear_scan kernel: {name} is not contiguous")
        want = q.dtype if name in ("k", "v") else torch.float32
        if name != "q" and t.dtype != want:
            raise TypeError(f"linear_scan kernel: {name} is {t.dtype}, "
                            f"expected {want}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"linear_scan kernel: q/k/v are {q.dtype}, expected "
                        "float32 or bfloat16")
    if max(C, K, V) > _MAX_DIM:
        raise ValueError(f"linear_scan kernel: chunk {C}, K {K}, V {V}; each "
                         f"must be <= {_MAX_DIM}")
    H = 1 if u is None else u.shape[0]
    if u is not None and (BH % H or u.shape[1] != K):
        raise ValueError(f"linear_scan kernel: u {tuple(u.shape)} does not "
                         f"fit B*H={BH}, K={K}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    o = torch.empty((BH, T, V), dtype=torch.float32, device=dev)
    if T == 0 or BH == 0:
        sf = (s0.clone() if s0 is not None else
              torch.zeros((BH, K, V), dtype=torch.float32, device=dev))
        return o, sf
    sf = torch.empty((BH, K, V), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        f32, tf32 = scan_work(BH, 1, T, K, V, C, mode == "rwkv6",
                              q.dtype == torch.bfloat16)
        backend.meta_kernel("linear_scan", flops=f32, tf32_flops=tf32,
                            nbytes=sum(t.nbytes for _, t in named
                                       if t is not None) + o.nbytes
                            + sf.nbytes)
        return o, sf
    # scratch of the three launches: each chunk's state contribution,
    # overwritten by the state it reads, and its decay exp(cw_end)
    N = -(-T // C)
    d_state = torch.empty((BH, N, K, V), dtype=torch.float32, device=dev)
    a_end = torch.empty((BH, N, K), dtype=torch.float32, device=dev)
    lib = backend.load_library()
    smem = lib.linear_scan_smem_bytes(K, V, C)
    if smem > backend.MAX_SMEM:
        raise ValueError(f"linear_scan kernel: {smem} bytes of shared memory "
                         f"exceeds {backend.MAX_SMEM}")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.linear_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), ptr(u),
        ptr(s0), o.data_ptr(), sf.data_ptr(), d_state.data_ptr(),
        a_end.data_ptr(), BH, H, T, K, V, C,
        int(mode == "rwkv6"), int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(backend.cuda_stream(dev)))
    backend.check_cuda(lib, err, "linear_scan")
    linear_scan.launches += 1
    return o, sf


class _LinearScanKernel(torch.autograd.Function):
    """CUDA forward on [B, H, T, *] operands (w, u, s0 already float32),
    plain-version backward (linear_scan_chunked replayed under autograd on
    the saved inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, w, u, s0, mode, chunk):
        ctx.save_for_backward(q, k, v, w, u, s0)
        ctx.mode, ctx.chunk = mode, chunk
        ctx.set_materialize_grads(False)
        B, H, T, K = q.shape
        V = v.shape[-1]
        flat = lambda t, d: t.reshape(B * H, T, d).contiguous()
        o, sf = linear_scan_kernel(
            flat(q, K), flat(k, K), flat(v, V), flat(w, K),
            None if u is None else u.contiguous(),
            None if s0 is None else s0.reshape(B * H, K, V).contiguous(),
            mode=mode, chunk=chunk)
        return o.reshape(B, H, T, V), sf.reshape(B, H, K, V)

    @staticmethod
    def backward(ctx, g_o, g_sf):
        need = ctx.needs_input_grad[:6]
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t, n in zip(inputs, need) if n]
        # cotangents of the outputs that have one (o, the final state)
        cots = [(i, g) for i, g in enumerate((g_o, g_sf)) if g is not None]
        if not wanted or not cots:
            return (None,) * 8
        with torch.enable_grad():
            outs = linear_scan_chunked(*inputs[:5], mode=ctx.mode,
                                       chunk=ctx.chunk,
                                       initial_state=inputs[5])
            grads = iter(torch.autograd.grad(
                [outs[i] for i, _ in cots], wanted, [g for _, g in cots],
                allow_unused=True))
        out = []
        for t, n in zip(inputs, need):
            g = next(grads) if n else None
            out.append(torch.zeros_like(t) if n and g is None else g)
        return (*out, None, None)


def linear_scan(q, k, v, w, u=None, *, mode: str = "ssd", chunk: int = 64,
                initial_state=None):
    """q, k, w: [B, H, T, K]; v: [B, H, T, V]; u: [H, K] or None;
    initial_state: [B, H, K, V] or None.

    Returns (o [B, H, T, V] f32, final_state [B, H, K, V] f32); the math is
    kernels/linear_scan/ref.py's.  CPU tensors run the plain chunked
    version; CUDA tensors launch the kernel or raise; meta tensors take
    the CUDA route without a launch.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if q.ndim != 4 or k.shape != q.shape or w.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, w "
                         f"{tuple(w.shape)} must all be [B, H, T, K]")
    B, H, T, K = q.shape
    if v.ndim != 4 or v.shape[:3] != (B, H, T):
        raise ValueError(f"v {tuple(v.shape)} must be [B, H, T, V] with "
                         f"B, H, T = {B}, {H}, {T}")
    V = v.shape[-1]
    if u is not None and tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)} must be [H, K] = [{H}, {K}]")
    if initial_state is not None and tuple(initial_state.shape) != (B, H, K,
                                                                    V):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} must "
                         f"be [B, H, K, V] = [{B}, {H}, {K}, {V}]")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if q.device.type not in ("cuda", "meta"):
        return linear_scan_chunked(q, k, v, w, u, mode=mode, chunk=chunk,
                                   initial_state=initial_state)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    f32 = lambda t: None if t is None else t.to(torch.float32)
    return _LinearScanKernel.apply(q, k, v, f32(w), f32(u),
                                   f32(initial_state), mode, chunk)


linear_scan.launches = 0   # kernel launches (counted where the kernel starts)
