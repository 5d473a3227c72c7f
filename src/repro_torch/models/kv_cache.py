"""Decode caches, for the block kinds the port runs (RWKV-6).

  * "rwkv6": {"tm_last", "cm_last": [B, d] in cfg.dtype, "wkv": [B, H, K, V]
    f32}

The cache is {"layers": [one entry per layer], "pos": [B] int32}.  Unlike
the JAX package, whose leaves carry a leading n_cycles axis for its layer
scan, every leaf here has the batch on axis 0 (BATCH_AXIS), which is what
serve/engine.py writes a request's slot along.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["cache_init", "BATCH_AXIS"]

BATCH_AXIS = 0


def _entry(cfg, kind: str, B: int, device) -> dict:
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
    raise NotImplementedError(
        f"decode cache for block kind {kind!r} is not ported yet "
        "(ROADMAP.md, Queue 1 item 15)")


def cache_init(cfg, B: int, max_len: int, device=None) -> dict:
    """Zeroed cache for `decode_step`.  `max_len` sizes attention caches;
    the recurrent state of RWKV-6 does not depend on it.  `device=None`
    means the CUDA card (raises without one)."""
    device = resolve_device(device)
    if cfg.shared_every:
        raise NotImplementedError("shared attention blocks are not ported "
                                  "yet (ROADMAP.md, Queue 1 item 15)")
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    return {"layers": [_entry(cfg, kind, B, device) for kind in kinds],
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
