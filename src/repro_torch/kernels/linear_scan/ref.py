"""Plain PyTorch versions of the data-dependent-decay linear recurrence (the
kernel's contract).

Unified recurrence (covers RWKV-6 time-mix and Mamba-2 SSD):

    S_t = diag(exp(w_t)) @ S_{t-1} + k_t^T v_t          S: [K, V]
    mode "ssd"  :  o_t = q_t @ S_t                       (read after update)
    mode "rwkv6":  o_t = q_t @ (S_{t-1} + diag(u) k_t^T v_t)
                                                         (read before update,
                                                          bonus u for current)

Shapes: q, k, w: [B, H, T, K]; v: [B, H, T, V]; u (bonus): [H, K] or None
(None weighs the current token by 1).  w is the LOG decay (<= 0).
initial_state: [B, H, K, V] or None (zeros).  Both functions compute in f32
and return (o [B, H, T, V] f32, final_state [B, H, K, V] f32).

  * linear_scan_seq     -- exact per-step loop (the oracle);
  * linear_scan_chunked -- the chunk-parallel formulation, the contract:
    intra-chunk masked pair products, inter-chunk state carry.  Every decay
    factor it keeps is exp of a non-positive difference, and the pairs it
    masks are masked before the exp, so neither the values nor their
    gradients overflow;
  * linear_scan_subchunked -- the same function in the form the CUDA kernel
    (csrc/linear_scan.cu) computes it: per-chunk state contributions, a
    scan across chunks, and outputs whose off-diagonal pair blocks are
    products of pivot-scaled rows.

Used on CPU tensors (kernels/linear_scan/ops.py dispatches here), by the
tests, and by chip_smoke.py to hold the kernel on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear_scan_seq", "linear_scan_chunked",
           "linear_scan_subchunked", "MODES"]

MODES = ("ssd", "rwkv6")
SUBCHUNK = 8        # subchunk rows of the kernel's formulation (kSub)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _state0(initial_state, B, H, K, V, device):
    if initial_state is None:
        return torch.zeros((B, H, K, V), dtype=torch.float32, device=device)
    return initial_state.to(torch.float32)


def linear_scan_seq(q, k, v, w, u=None, mode: str = "ssd",
                    initial_state=None):
    """Exact sequential oracle.  Returns (o [B,H,T,V], S_final [B,H,K,V])."""
    _check_mode(mode)
    B, H, T, K = q.shape
    V = v.shape[-1]
    q, k, v, w = (t.to(torch.float32) for t in (q, k, v, w))
    S = _state0(initial_state, B, H, K, V, q.device)
    uf = None if u is None else u.to(torch.float32)[None, :, :, None]
    outs = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]          # [B,H,K,V]
        decay = torch.exp(w[:, :, t])[..., None]
        if mode == "rwkv6":
            bonus = kv if uf is None else kv * uf
            o_t = torch.einsum("bhk,bhkv->bhv", q[:, :, t], S + bonus)
            S = decay * S + kv
        else:
            S = decay * S + kv
            o_t = torch.einsum("bhk,bhkv->bhv", q[:, :, t], S)
        outs.append(o_t)
    o = (torch.stack(outs, dim=2) if outs
         else torch.zeros((B, H, 0, V), dtype=torch.float32, device=q.device))
    return o, S


def linear_scan_chunked(q, k, v, w, u=None, mode: str = "ssd",
                        chunk: int = 64, initial_state=None):
    """Chunk-parallel formulation; matches linear_scan_seq to f32 tolerance
    for any chunk size.  A ragged T is zero-padded to a multiple of
    C = min(chunk, T): padded rows have k = 0 and w = 0, which leave the
    carried state unchanged, and are cut from the output."""
    _check_mode(mode)
    B, H, T, K = q.shape
    V = v.shape[-1]
    if T == 0:
        return (torch.zeros((B, H, 0, V), dtype=torch.float32,
                            device=q.device),
                _state0(initial_state, B, H, K, V, q.device).clone())
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        q, k, v, w = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, w))
    N = (T + pad) // C
    f32 = torch.float32
    # [N, B, H, C, *]: one step of the loop below per chunk; inputs keep
    # their dtype and are upcast one chunk at a time.
    split = lambda t: t.reshape(B, H, N, C, t.shape[-1]).movedim(2, 0)
    qc, kc, vc, wc = split(q), split(k), split(v), split(w)
    strict = mode == "rwkv6"
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device),
                      diagonal=-1 if strict else 0)
    uf = None if u is None else u.to(f32)

    S = _state0(initial_state, B, H, K, V, q.device)
    outs = []
    for n in range(N):
        qn, kn, vn = qc[n].to(f32), kc[n].to(f32), vc[n].to(f32)
        wn = wc[n].to(f32)
        cw = torch.cumsum(wn, dim=-2)                    # inclusive
        cw_read = cw - wn if strict else cw
        # intra-chunk pair decays D[t,s,k] = exp(cw_read[t] - cw[s]), masked
        # [B,H,C,C,K].  The masked (non-causal) pairs have positive
        # differences that can overflow exp; they are set to 0 before it,
        # else their zero cotangent times exp = inf makes the gradient NaN
        # (the JAX package's jnp.where(mask, exp(diff), 0) has that fault)
        diff = cw_read[..., :, None, :] - cw[..., None, :, :]
        zero = torch.zeros((), dtype=f32, device=q.device)
        D = torch.where(mask[:, :, None],
                        torch.exp(torch.where(mask[:, :, None], diff, zero)),
                        zero)
        P = torch.einsum("bhtk,bhsk,bhtsk->bhts", qn, kn, D)
        o = P @ vn                                       # [B,H,C,V]
        if strict:
            if uf is not None:
                diag = torch.einsum("bhtk,hk,bhtk->bht", qn, uf, kn)
            else:
                diag = torch.einsum("bhtk,bhtk->bht", qn, kn)
            o = o + diag[..., None] * vn
        # inter-chunk: read the carried state, decayed since the chunk start
        o = o + torch.einsum("bhck,bhkv->bhcv", qn * torch.exp(cw_read), S)
        # state update
        a_end = torch.exp(cw[:, :, -1, :])               # [B,H,K]
        kd = kn * torch.exp(cw[:, :, -1:, :] - cw)
        S = a_end[..., None] * S + torch.einsum("bhck,bhcv->bhkv", kd, vn)
        outs.append(o)
    o = torch.stack(outs, dim=2).reshape(B, H, N * C, V)
    return o[:, :, :T], S


def linear_scan_subchunked(q, k, v, w, u=None, mode: str = "ssd",
                           chunk: int = 64, initial_state=None):
    """The kernel's formulation, step for step; matches linear_scan_chunked
    to f32 tolerance.  Chunks of C = min(chunk, T) rows, each cut into
    subchunks of SUBCHUNK rows (zero-padded, like a ragged T):

      1. every chunk at once: cw = cumsum(w), its decay exp(cw_end) and its
         state contribution dS = (k exp(cw_end - cw))^T v;
      2. the scan across chunks, S_n = exp(cw_end,n) S_{n-1} + dS_n, keeping
         the state S_{n-1} each chunk reads;
      3. every chunk at once: o = P v + q_read S_{n-1}.  Pairs inside one
         subchunk keep the pairwise decay exp(cw_read[t] - cw[s]).  A pair
         of query subchunk I and an earlier key subchunk J factors through
         the pivots p_I = cw_read[first row of I] and c_J = cw[last row of
         J] into qs[t] exp(p_I - c_J) kj[s], with qs = q exp(cw_read - p_I)
         and kj = k exp(c_J - cw): every exponent is <= 0.  q_read is
         qs exp(p_I).
    """
    _check_mode(mode)
    B, H, T, K = q.shape
    V = v.shape[-1]
    if T == 0:
        return (torch.zeros((B, H, 0, V), dtype=torch.float32,
                            device=q.device),
                _state0(initial_state, B, H, K, V, q.device).clone())
    f32 = torch.float32
    C = min(chunk, T)
    N = -(-T // C)
    sub = SUBCHUNK
    Cs = -(-C // sub) * sub                   # chunk rows, padded
    ns = Cs // sub
    # [B, H, N, Cs, *], zero rows past T and past C in each chunk
    def split(t):
        t = F.pad(t.to(f32), (0, 0, 0, N * C - T))
        t = t.reshape(B, H, N, C, t.shape[-1])
        return F.pad(t, (0, 0, 0, Cs - C))
    q, k, v, w = split(q), split(k), split(v), split(w)
    strict = mode == "rwkv6"
    cw = torch.cumsum(w, dim=-2)
    cwr = cw - w if strict else cw

    # 1. chunk states
    cw_end = cw[..., -1:, :]
    a_end = torch.exp(cw_end[..., 0, :])                       # [B,H,N,K]
    dS = torch.einsum("bhnck,bhncv->bhnkv", k * torch.exp(cw_end - cw), v)

    # 2. the scan across chunks: s_in[:, :, n] is the state chunk n reads
    S = _state0(initial_state, B, H, K, V, q.device)
    s_in = []
    for n in range(N):
        s_in.append(S)
        S = a_end[:, :, n, :, None] * S + dS[:, :, n]
    s_in = torch.stack(s_in, dim=2)                            # [B,H,N,K,V]

    # 3. chunk outputs
    rows = torch.arange(Cs, device=q.device)
    first = (rows // sub) * sub
    p_row = cwr[..., first, :]                    # p_I of each row's I
    c_row = cw[..., first + sub - 1, :]           # c_J of each row's J
    qs = q * torch.exp(cwr - p_row)
    kj = k * torch.exp(c_row - cw)
    P = torch.zeros(q.shape[:3] + (Cs, Cs), dtype=f32, device=q.device)
    mask = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                 device=q.device), diagonal=-1 if strict else 0)
    uf = None if u is None else u.to(f32)[None, :, None, None, :]
    for I in range(ns):
        r = slice(I * sub, (I + 1) * sub)
        diff = cwr[..., r, None, :] - cw[..., None, r, :]      # [..,s,s,K]
        D = torch.where(mask[:, :, None], torch.exp(diff),
                        torch.zeros((), dtype=f32, device=q.device))
        P[..., r, r] = torch.einsum("bhntk,bhnsk,bhntsk->bhnts",
                                    q[..., r, :], k[..., r, :], D)
        if strict:
            bonus = q[..., r, :] * k[..., r, :]
            if uf is not None:
                bonus = bonus * uf
            P[..., r, r] += torch.diag_embed(bonus.sum(-1))
        for J in range(I):
            c = slice(J * sub, (J + 1) * sub)
            f = torch.exp(cwr[..., I * sub, :] - cw[..., J * sub + sub - 1, :])
            P[..., r, c] = torch.einsum("bhntk,bhnk,bhnsk->bhnts",
                                        qs[..., r, :], f, kj[..., c, :])
    q_read = qs * torch.exp(p_row)
    o = P @ v + q_read @ s_in                                  # [B,H,N,Cs,V]
    o = o[..., :C, :].reshape(B, H, N * C, V)
    return o[:, :, :T], S
