"""Decode caches for every block kind the port runs.

  * "attn"/"global": full cache {"k", "v": [B, S, kv, dh] in cfg.dtype,
    "pos": [B, S] int32}, S = max_len;
  * "swa"/"local": ring cache, the same layout, S = min(window, max_len)
    (slot = position % S);
  * "rwkv6": {"tm_last", "cm_last": [B, d] in cfg.dtype, "wkv": [B, H, K, V]
    f32};
  * "mamba2": {"conv": [B, W-1, conv_dim] in cfg.dtype, "ssm": [B, H, K, V]
    f32};
  * the shared block (Zamba2): a full cache per invocation at 2*d_model
    geometry, n_kv = shared_n_heads, dh = 2*d_model / shared_n_heads.

`pos` starts at int32 max, so empty slots are masked by the decode
attention (its kv_pos <= q_pos test).

The cache is {"layers": [one entry per layer], "pos": [B] int32} and, with
a shared block, "shared": [one entry per invocation] (cycles, plus one when
there is a tail).  The encoder-decoder's (`whisper_cache_init`) is
{"self": [a full cache per decoder layer], "cross": [{"k", "v": [B, T_enc,
kv, dh]} per decoder layer], "pos": [B]}.  Unlike the JAX package, whose
leaves carry a leading n_cycles (or layer) axis for its layer scan, every
leaf here has the batch on axis 0 (BATCH_AXIS), which is what
serve/engine.py writes a request's slot along.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["cache_init", "cache_specs", "whisper_cache_init", "BATCH_AXIS",
           "n_shared"]

BATCH_AXIS = 0
INT_MAX = torch.iinfo(torch.int32).max


def _attn_entry(cfg, B: int, S: int, device, *, n_kv=None,
                head_dim=None) -> dict:
    n_kv = n_kv if n_kv is not None else cfg.n_kv_heads
    head_dim = head_dim if head_dim is not None else cfg.head_dim
    return {
        "k": torch.zeros((B, S, n_kv, head_dim), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((B, S, n_kv, head_dim), dtype=cfg.dtype,
                         device=device),
        "pos": torch.full((B, S), INT_MAX, dtype=torch.int32, device=device),
    }


def _entry(cfg, kind: str, B: int, max_len: int, device) -> dict:
    if kind in ("attn", "global"):
        return _attn_entry(cfg, B, max_len, device)
    if kind in ("swa", "local"):
        return _attn_entry(cfg, B, min(cfg.window, max_len), device)
    if kind == "rwkv6":
        H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {
            "tm_last": torch.zeros((B, cfg.d_model), dtype=cfg.dtype,
                                   device=device),
            "cm_last": torch.zeros((B, cfg.d_model), dtype=cfg.dtype,
                                   device=device),
            "wkv": torch.zeros((B, H, K, K), dtype=torch.float32,
                               device=device),
        }
    if kind == "mamba2":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        conv_dim = d_inner + 2 * cfg.ssm_state
        return {
            "conv": torch.zeros((B, cfg.conv_width - 1, conv_dim),
                                dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((B, H, cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=torch.float32, device=device),
        }
    raise ValueError(kind)


def n_shared(cfg) -> int:
    """Shared-block invocations: one a cycle, one more before the tail."""
    if not cfg.shared_every:
        return 0
    return cfg.cycles + (1 if cfg.tail else 0)


def cache_init(cfg, B: int, max_len: int, device=None) -> dict:
    """Zeroed cache for `decode_step`.  `max_len` sizes the attention
    caches.  `device=None` means the CUDA card (raises without one)."""
    device = resolve_device(device)
    cache = {"layers": [_entry(cfg, kind, B, max_len, device)
                        for kind in cfg.layer_kinds()],
             "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
    if cfg.shared_every:
        d_in = 2 * cfg.d_model
        cache["shared"] = [
            _attn_entry(cfg, B, max_len, device, n_kv=cfg.shared_n_heads,
                        head_dim=d_in // cfg.shared_n_heads)
            for _ in range(n_shared(cfg))]
    return cache


def cache_specs(cfg, B: int, max_len: int) -> dict:
    """`cache_init`'s tree as meta tensors: shapes and dtypes, no storage
    (the dry-run's input spec)."""
    return cache_init(cfg, B, max_len, device="meta")


def whisper_cache_init(cfg, B: int, max_len: int, T_enc: int | None = None,
                       device=None) -> dict:
    """Zeroed encoder-decoder cache: each decoder layer's self-attention
    cache of `max_len` positions and its cross-attention K/V over `T_enc`
    encoder frames (filled by prefill).  `T_enc=None` is `max_len`, as the
    JAX package's zoo sizes it: a prefill cache over fewer frames then does
    not fit the engine's slots (its copy_ raises), as JAX's does not.
    `device=None` means the CUDA card (raises without one)."""
    device = resolve_device(device)
    T_enc = max_len if T_enc is None else T_enc
    cross = lambda: torch.zeros((B, T_enc, cfg.n_kv_heads, cfg.head_dim),
                                dtype=cfg.dtype, device=device)
    return {"self": [_attn_entry(cfg, B, max_len, device)
                     for _ in range(cfg.n_layers)],
            "cross": [{"k": cross(), "v": cross()}
                      for _ in range(cfg.n_layers)],
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
