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
  * linear_scan_chunked -- the chunk-parallel formulation the CUDA kernel
    (csrc/linear_scan.cu) implements: intra-chunk masked pair products,
    inter-chunk state carry.  Every decay factor is exp of a non-positive
    difference, so nothing overflows.

Used on CPU tensors (kernels/linear_scan/ops.py dispatches here), by the
tests, and by chip_smoke.py to hold the kernel on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear_scan_seq", "linear_scan_chunked", "MODES"]

MODES = ("ssd", "rwkv6")


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
        diff = cw_read[..., :, None, :] - cw[..., None, :, :]   # [B,H,C,C,K]
        D = torch.where(mask[:, :, None], torch.exp(diff),
                        torch.zeros((), dtype=f32, device=q.device))
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
