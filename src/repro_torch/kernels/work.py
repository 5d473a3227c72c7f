"""The work of each hand-written kernel: the operations it does on given
shapes, and the least time the card could take for them.

One copy for both users: `chip_smoke.py` sets each kernel's time against
its bound with these, and the dry-run's op counter (launch/opcount.py)
adds a kernel's operations and bytes where a meta trace reaches it.
Operations count 2 per multiply-add.  Bytes are each input read once and
each output written once (the callers sum their tensors' nbytes).
"""
from __future__ import annotations

from repro_torch.kernels.linear_scan.ref import SUBCHUNK
from repro_torch.launch.mesh import HW

__all__ = ["gru_flops", "rk4_flops", "rk4_adjoint_flops", "scan_work",
           "scan_work_pairwise", "bound_ms"]


def gru_flops(F: int, B: int, T: int, H: int, D: int) -> float:
    """Products only: x Wx, h Wh_zr and (r*h) Wh_c a step, F x B
    sequences."""
    return 2.0 * F * B * T * (D * 3 * H + 3 * H * H)


def rk4_flops(B: int, T: int, n: int, L: int, O: int) -> float:
    """Per right-hand side, (O-1) products a library term for Phi and n*L
    multiply-adds; four right-hand sides a step."""
    return 4.0 * B * T * (L * (O - 1) + 2 * n * L)


def rk4_adjoint_flops(B: int, T: int, n: int, L: int, O: int) -> float:
    """The adjoint's steps: three right-hand sides recomputed (as
    `rk4_flops`) and four vector-Jacobian products.  A product, per library
    term: (O-1) products for Phi, n multiply-adds each for g_theta and for
    c = Theta^T lam, and per factor (O-2) products for the other factors,
    one by c and one add into its channel's cotangent."""
    rhs = L * (O - 1) + 2 * n * L
    vjp = L * (O - 1 + 4 * n + O * O)
    return B * T * (3.0 * rhs + 4.0 * vjp)


def scan_work_pairwise(B, H, T, K, V, C, rwkv6: bool) -> float:
    """Operations of the chunked formulation with every decay in the
    pairwise form (the count of the earlier kernel), for the causal pairs
    this T has: per (t, s) pair and k, q*k*decay (3) plus the decay's
    subtraction and exponential (2); P v; q_read S; the state update; 2 per
    multiply-add."""
    ops = 0.0
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        strict = c * (c - 1) // 2
        diag = c                                    # s == t: bonus or 1
        pair_ops = (strict * K * 5 + diag * K * 3) if rwkv6 else \
            ((strict + diag) * K * 5)
        ops += (pair_ops + (strict + diag) * V * 2    # P v
                + c * K * (2 + 2 * V)                 # q*2^cw_read, @ S
                + c * K * (3 + 2 * V)                 # kd, kd^T v
                + K * (1 + 2 * V))                    # 2^cw_end S
    return B * H * ops


def scan_work(B, H, T, K, V, C, rwkv6: bool, exact_v: bool):
    """Operations of the subchunk form the kernel runs (csrc/linear_scan.cu,
    ref.py::linear_scan_subchunked), for the causal pairs this T has, as
    (f32, TF32).  Pairs inside one SUBCHUNK-row subchunk keep the pairwise
    count above; a pair of query subchunk I and earlier key subchunk J is
    one multiply-add per k on pre-scaled rows, plus one product per (row,
    J, k) for the factor 2^(p_I - c_J).  The scalings: qs and kj
    (subtraction, exponential, product), 2^(p_I - c_J) (2) and 2^p_I (1)
    per subchunk, q_read (1).  The four products -- the off-diagonal
    blocks of P, P v, q_read S, kd^T v -- run on the tensor cores in
    3xTF32 form: 3 TF32 multiply-adds for each, 2 where the other side is
    v and v is exact in TF32 (bf16).  The rest is f32 outside them."""
    nv = 2 if exact_v else 3
    f32 = tf32 = 0.0
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        sizes = [min(SUBCHUNK, c - r) for r in range(0, c, SUBCHUNK)]
        ns = len(sizes)
        inner = sum(b * (b - 1) // 2 for b in sizes)       # s < t, same sub
        outer = c * (c - 1) // 2 - inner                    # earlier sub
        diag = c
        pair_ops = (inner * K * 5 + diag * K * 3) if rwkv6 else \
            ((inner + diag) * K * 5)
        factor_rows = sum(b * i for i, b in enumerate(sizes))   # (t, J<I)
        f32 += (pair_ops + factor_rows * K
                + c * K * 3 * 2                              # qs, kj
                + ns * (ns - 1) // 2 * K * 2 + ns * K         # pivots
                + c * K                                      # q_read
                + c * K * 3                                  # kd
                + K * (1 + 2 * V))                           # 2^cw_end S
        tf32 += (3 * outer * K * 2                           # P, off-diag
                 + nv * (inner + outer + diag) * V * 2       # P v
                 + 3 * c * K * V * 2                         # q_read @ S
                 + nv * c * K * V * 2)                       # kd^T v
    return B * H * f32, B * H * tf32


def bound_ms(flops: float, nbytes: float, tf32_flops: float = 0.0):
    """The larger of the operations' time (f32 ones outside the tensor
    cores, TF32 ones on them) and the bytes' time, in ms, and which one it
    is: "operations" or "bytes"."""
    t_ops = flops / HW.PEAK_F32_FLOPS + tf32_flops / HW.PEAK_TF32_FLOPS
    t_bytes = nbytes / HW.HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
