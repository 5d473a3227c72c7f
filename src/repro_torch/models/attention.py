"""Grouped-query attention: prefill (blocked online softmax, block-local
sliding window) and decode against a cache.

The JAX package's attention is plain jnp (no Pallas kernel), and so is this
port of it: `torch.einsum`/`torch.matmul` in the JAX package's blocked
form, one code path on the card and on the CPU.  A fast attention for
Hopper is later work.

  * `flash_attention` -- query blocks x KV blocks with an online softmax
    (peak score memory one [B, qb, kv, G, kb] tile);
  * `local_attention` -- block-local sliding-window attention: query block
    i attends key blocks i-1 and i;
  * `decode_attention` -- one query against a cache.

GQA throughout: queries are reshaped to [B, T, kv, G, dh] and the einsums
run over the group axis (no repeated K/V).  Dots run in the input dtype,
the softmax in f32.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (apply_qk_norm, apply_rope, dense,
                                       dense_init, qk_norm_init)

__all__ = ["flash_attention", "local_attention", "decode_attention",
           "attention_init", "attention_apply", "attention_decode"]

NEG_INF = -1e30
INT_MAX = torch.iinfo(torch.int32).max


def _group_q(q, n_kv: int):
    """[B, T, H, dh] -> [B, T, kv, G, dh] with G = H // kv."""
    B, T, H, dh = q.shape
    return q.reshape(B, T, n_kv, H // n_kv, dh)


def _pad_t(x, pad: int, value=0):
    """Pad axis 1 of x at the end by `pad` entries of `value`."""
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=1)


# --------------------------------------------------------------------------- #
# Flash attention: query blocks x KV blocks with an online softmax.
# --------------------------------------------------------------------------- #
def flash_attention(q, k, v, *, causal: bool = True, kv_block: int = 1024,
                    q_block: int = 1024, q_positions=None,
                    kv_positions=None):
    """q: [B, Tq, H, dh]; k, v: [B, Tk, kv, dh] -> [B, Tq, H, dh].

    Padded KV positions are int32 max (masked); the causal mask compares
    positions.  As in the JAX package, every KV block is visited, those
    above a query block's diagonal fully masked.
    """
    B, Tq, H, dh = q.shape
    Tk, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv
    scale = dh ** -0.5
    kb_sz = min(kv_block, Tk)
    qb_sz = min(q_block, Tq)
    pad_k = (-Tk) % kb_sz
    pad_q = (-Tq) % qb_sz
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev).expand(B, Tq)
    if kv_positions is None:
        kv_positions = torch.arange(Tk, device=dev).expand(B, Tk)
    if pad_k:
        k, v = _pad_t(k, pad_k), _pad_t(v, pad_k)
        kv_positions = _pad_t(kv_positions, pad_k, INT_MAX)
    if pad_q:
        q = _pad_t(q, pad_q)
        q_positions = _pad_t(q_positions, pad_q, 0)
    nk = (Tk + pad_k) // kb_sz
    nq = (Tq + pad_q) // qb_sz

    qg = _group_q(q, n_kv) * torch.tensor(scale, dtype=q.dtype)
    f32 = torch.float32
    outs = []
    for i in range(nq):
        q_i = qg[:, i * qb_sz:(i + 1) * qb_sz]              # [B,qb,kv,G,dh]
        qp_i = q_positions[:, i * qb_sz:(i + 1) * qb_sz]
        m = torch.full((B, qb_sz, n_kv, G), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, qb_sz, n_kv, G), dtype=f32, device=dev)
        acc = torch.zeros((B, qb_sz, n_kv, G, dh), dtype=f32, device=dev)
        for j in range(nk):
            k_j = k[:, j * kb_sz:(j + 1) * kb_sz]
            v_j = v[:, j * kb_sz:(j + 1) * kb_sz]
            p_j = kv_positions[:, j * kb_sz:(j + 1) * kb_sz]
            s = torch.einsum("btkgd,bjkd->btkgj", q_i, k_j).to(f32)
            mask = (p_j[:, None, :] <= qp_i[:, :, None] if causal
                    else (p_j[:, None, :] < INT_MAX).expand(B, qb_sz, -1))
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "btkgj,bjkd->btkgd", p.to(v_j.dtype), v_j).to(f32)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=1).reshape(B, Tq + pad_q, H, dh)
    return out[:, :Tq].to(q.dtype)


# --------------------------------------------------------------------------- #
# Block-local sliding-window attention (O(T * window) compute).
# --------------------------------------------------------------------------- #
def local_attention(q, k, v, *, window: int, q_positions=None):
    """Causal sliding-window attention; token t attends (t-window, t].

    Blocked at `window`: query block i attends key blocks i-1 and i, which
    covers the window exactly; positions outside are masked.  One query
    block at a time, as the JAX package's scan (peak one [B, w, kv, G, 2w]
    score tile).  `q_positions` is accepted and unused, as in the JAX
    package.
    """
    B, T, H, dh = q.shape
    n_kv = k.shape[2]
    G = H // n_kv
    scale = dh ** -0.5
    w = min(window, T)
    pad = (-T) % w
    if pad:
        q, k, v = _pad_t(q, pad), _pad_t(k, pad), _pad_t(v, pad)
    Tp = T + pad
    N = Tp // w
    dev = q.device

    qb = _group_q(q, n_kv).reshape(B, N, w, n_kv, G, dh)
    kb = k.reshape(B, N, w, n_kv, dh)
    vb = v.reshape(B, N, w, n_kv, dh)
    # context = [previous block ; own block] -> [B, N, 2w, kv, dh]
    prev = lambda x: torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    kc = torch.cat([prev(kb), kb], dim=2)
    vc = torch.cat([prev(vb), vb], dim=2)

    qpos = torch.arange(Tp, device=dev).reshape(N, w)         # [N, w]
    kpos = torch.cat([qpos - w, qpos], dim=1)                 # [N, 2w]
    mask = ((kpos[:, None, :] <= qpos[:, :, None])
            & (kpos[:, None, :] > qpos[:, :, None] - w)
            & (kpos[:, None, :] >= 0))                        # [N, w, 2w]
    sc = torch.tensor(scale, dtype=q.dtype)
    outs = []
    for i in range(N):
        s = torch.einsum("btkgd,bjkd->btkgj", qb[:, i] * sc,
                         kc[:, i]).to(torch.float32)
        s = torch.where(mask[i][None, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("btkgj,bjkd->btkgd", p.to(vc.dtype),
                                 vc[:, i]))
    out = torch.stack(outs, dim=1).reshape(B, Tp, H, dh)[:, :T]
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# Decode: one query step against a cache.
# --------------------------------------------------------------------------- #
def decode_attention(q, k_cache, v_cache, kv_positions, q_position):
    """q: [B, 1, H, dh]; caches [B, S, kv, dh]; kv_positions [B, S]
    (absolute, int32 max for empty slots); q_position [B].

    The dots run in the cache dtype (never upcast); the softmax in f32 on
    the [B, kv, G, S] scores.
    """
    B, _, H, dh = q.shape
    n_kv = k_cache.shape[2]
    qg = _group_q(q, n_kv)[:, 0] * torch.tensor(dh ** -0.5, dtype=q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(k_cache.dtype),
                     k_cache).to(torch.float32)
    valid = kv_positions <= q_position[:, None]                    # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype),
                       v_cache).to(torch.float32)
    out = out / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, 1, H, dh).to(q.dtype)


# --------------------------------------------------------------------------- #
# Full attention block (projections + rope + qk-norm + core + out proj)
# --------------------------------------------------------------------------- #
def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool = False,
                   norm_kind: str = "rmsnorm", dtype=torch.float32) -> dict:
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype),
    }
    if qk_norm:
        p["qk_norm"] = qk_norm_init(head_dim, norm_kind, dtype, gen.device)
    return p


def _project_qkv(params, x, n_heads, n_kv, head_dim, *, positions, rope,
                 rope_theta, rope_fraction, rope_interleaved, norm_kind):
    B, T, _ = x.shape
    q = dense(params["wq"], x).reshape(B, T, n_heads, head_dim)
    k = dense(params["wk"], x).reshape(B, T, n_kv, head_dim)
    v = dense(params["wv"], x).reshape(B, T, n_kv, head_dim)
    if "qk_norm" in params:
        q, k = apply_qk_norm(params["qk_norm"], q, k, norm_kind)
    if rope != "none":
        kw = dict(theta=rope_theta, fraction=rope_fraction,
                  interleaved=rope_interleaved)
        q = apply_rope(q, positions, **kw)
        k = apply_rope(k, positions, **kw)
    return q, k, v


def attention_apply(params, x, *, n_heads, n_kv, head_dim, positions=None,
                    causal=True, window=None, rope="neox", rope_theta=1e4,
                    rope_fraction=1.0, rope_interleaved=False,
                    norm_kind="rmsnorm", kv_block=1024, x_kv=None,
                    return_kv=False):
    """Prefill attention.  x_kv (cross-attention source) overrides the KV
    input; window selects the block-local path."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    if x_kv is None:
        q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim,
                               positions=positions, rope=rope,
                               rope_theta=rope_theta,
                               rope_fraction=rope_fraction,
                               rope_interleaved=rope_interleaved,
                               norm_kind=norm_kind)
    else:  # cross-attention: queries from x, keys/values from x_kv, no rope
        Tk = x_kv.shape[1]
        q = dense(params["wq"], x).reshape(B, T, n_heads, head_dim)
        k = dense(params["wk"], x_kv).reshape(B, Tk, n_kv, head_dim)
        v = dense(params["wv"], x_kv).reshape(B, Tk, n_kv, head_dim)
    if window is not None and x_kv is None and causal:
        out = local_attention(q, k, v, window=window)
    else:
        out = flash_attention(q, k, v, causal=causal and x_kv is None,
                              kv_block=kv_block)
    y = dense(params["wo"], out.reshape(B, T, n_heads * head_dim))
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(params, x, cache, *, n_heads, n_kv, head_dim, position,
                     rope="neox", rope_theta=1e4, rope_fraction=1.0,
                     rope_interleaved=False, norm_kind="rmsnorm",
                     cache_kind="full", cross_kv=None):
    """One-token decode.  cache = {"k", "v", "pos"}; position [B] absolute.

    cache_kind "full": slot = position; "ring": slot = position % S (the
    SWA/local layers keep the last S tokens).  Each row writes its own slot
    (an index write over arange(B)); a slot past the end is clamped to the
    last, as jax.lax.dynamic_update_slice clamps.  Unlike the JAX package,
    the cache's tensors are UPDATED IN PLACE and returned: at full width
    they are gigabytes, and a copy per step would double them.
    cross_kv: precomputed (k, v) encoder projections for cross-attention
    (the cache is not updated).
    """
    B = x.shape[0]
    if cross_kv is not None:
        q = dense(params["wq"], x).reshape(B, 1, n_heads, head_dim)
        k_all, v_all = cross_kv
        Tk = k_all.shape[1]
        kv_pos = torch.arange(Tk, device=x.device).expand(B, Tk)
        out = decode_attention(q, k_all, v_all, kv_pos,
                               torch.full((B,), Tk, dtype=torch.int32,
                                          device=x.device))
        y = dense(params["wo"], out.reshape(B, 1, n_heads * head_dim))
        return y, cache

    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim,
                           positions=position[:, None], rope=rope,
                           rope_theta=rope_theta,
                           rope_fraction=rope_fraction,
                           rope_interleaved=rope_interleaved,
                           norm_kind=norm_kind)
    k_cache, v_cache, kv_pos = cache["k"], cache["v"], cache["pos"]
    S = k_cache.shape[1]
    slot = position % S if cache_kind == "ring" else position.clamp(0, S - 1)
    rows = torch.arange(B, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    kv_pos[rows, slot] = position.to(kv_pos.dtype)
    out = decode_attention(q, k_cache, v_cache, kv_pos, position)
    y = dense(params["wo"], out.reshape(B, 1, n_heads * head_dim))
    return y, {"k": k_cache, "v": v_cache, "pos": kv_pos}
