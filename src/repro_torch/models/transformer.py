"""Decoder-only LM assembly, for the block kinds the port runs (RWKV-6).

The JAX package stacks per-layer parameters as [n_cycles, ...] leaves and
scans over cycles.  Here `params["layers"]` is a list with one parameter
dict per layer, in depth order, and the forward passes loop over it.

Paths:
  * `prefill`     -- the prompt through every layer, emitting the decode
                     cache; on the card each layer launches the linear-scan
                     kernel once;
  * `decode_step` -- one token against the cache (no kernel).

`forward` / `loss_fn` come with the training slice; attention, MoE, Mamba2
and shared blocks raise NotImplementedError (ROADMAP.md, Queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import rwkv6 as rw
from repro_torch.models.kv_cache import cache_init
from repro_torch.models.layers import (apply_norm, embed_init, embed_lookup,
                                       norm_init, unembed)

__all__ = ["LMConfig", "init_params", "prefill", "decode_step",
           "check_supported"]


@dataclass(frozen=True)
class LMConfig:
    """The JAX package's LMConfig field for field, without its execution
    knobs (use_pallas, interpret, remat, scan_layers); dtype is a torch
    dtype."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer pattern
    pattern: tuple = ("attn",)
    shared_every: int = 0            # zamba2: shared attn block per cycle
    # attention
    rope: str = "neox"               # "neox" | "none"
    rope_theta: float = 1e4
    rope_theta_local: float = 1e4    # gemma3 local layers
    rope_fraction: float = 1.0       # chatglm3: 0.5
    rope_interleaved: bool = False
    qk_norm: bool = False
    qk_norm_kind: str = "rmsnorm"
    window: int = 0                  # swa / local window
    norm: str = "rmsnorm"
    mlp_kind: str = "swiglu"
    embed_scale: bool = False        # gemma: x *= sqrt(d)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0       # gemma-style tanh soft capping
    # MoE
    n_experts: int = 0
    top_k: int = 2
    dense_ff: int = 0                # arctic parallel dense-residual FFN
    moe_group_size: int = 512
    moe_capacity: float = 1.25
    aux_loss_weight: float = 0.01
    # SSM / RWKV
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    rwkv_head_dim: int = 64
    # shared block (zamba2) geometry
    shared_n_heads: int = 0
    shared_d_ff: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    # execution
    dtype: Any = torch.float32
    kv_block: int = 1024
    scan_chunk: int = 64

    def with_(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    @property
    def cycles(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def layer_kinds(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)]
                for i in range(self.n_layers)]


def check_supported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    missing = sorted(set(cfg.layer_kinds()) - {"rwkv6"})
    if missing or cfg.shared_every or cfg.enc_layers:
        what = ", ".join(missing) or ("shared blocks" if cfg.shared_every
                                      else "encoder-decoder")
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported yet (ROADMAP.md, Queue 1 item "
            "15); the port runs RWKV-6 layers only")


def _block_init(gen, cfg: LMConfig, kind: str) -> dict:
    dt = cfg.dtype
    return {"norm1": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
            "rwkv": rw.rwkv6_init(gen, cfg.d_model, cfg.rwkv_head_dim,
                                  cfg.d_ff, dt),
            "norm2": norm_init(cfg.d_model, cfg.norm, dt, gen.device)}


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from `seed`, drawn by a torch.Generator on the
    target device (3.1B parameters are not drawn on the host).
    `device=None` means the CUDA card (raises without one)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
        "layers": [_block_init(gen, cfg, kind) for kind in cfg.layer_kinds()],
        "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.dtype, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype)
    return params


def _embed(cfg: LMConfig, params, tokens):
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _table(cfg: LMConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def prefill(cfg: LMConfig, params, tokens, max_len: int):
    """tokens [B, T] -> (cache sized for max_len, last_logits [B, V] f32)."""
    check_supported(cfg)
    B, T = tokens.shape
    x = _embed(cfg, params, tokens)
    cache = cache_init(cfg, B, max_len, x.device)
    entries = []
    for p in params["layers"]:
        h = apply_norm(p["norm1"], x, cfg.norm)
        y, (tm_last, wkv) = rw.rwkv6_time_mix(
            p["rwkv"], h, head_dim=cfg.rwkv_head_dim, chunk=cfg.scan_chunk)
        x = x + y
        h = apply_norm(p["norm2"], x, cfg.norm)
        y, cm_last = rw.rwkv6_channel_mix(p["rwkv"], h)
        x = x + y
        entries.append({"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv})
    cache["layers"] = entries
    cache["pos"] = torch.full((B,), T, dtype=torch.int32, device=x.device)
    # the final norm is per position: only the last one is needed
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    return cache, unembed(_table(cfg, params), x)[:, 0]


def decode_step(cfg: LMConfig, params, cache, tokens1):
    """One decode step.  tokens1: [B] int.  Returns (cache, logits [B, V])."""
    check_supported(cfg)
    x1 = _embed(cfg, params, tokens1[:, None])
    entries = []
    for p, entry in zip(params["layers"], cache["layers"]):
        h = apply_norm(p["norm1"], x1, cfg.norm)[:, 0]
        y, tm_last, wkv = rw.rwkv6_time_mix_decode(
            p["rwkv"], h, entry["tm_last"], entry["wkv"],
            head_dim=cfg.rwkv_head_dim)
        x1 = x1 + y[:, None, :]
        h = apply_norm(p["norm2"], x1, cfg.norm)[:, 0]
        y, cm_last = rw.rwkv6_channel_mix_decode(p["rwkv"], h,
                                                 entry["cm_last"])
        x1 = x1 + y[:, None, :]
        entries.append({"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv})
    cache = {"layers": entries, "pos": cache["pos"] + 1}
    x1 = apply_norm(params["final_norm"], x1, cfg.norm)
    logits = unembed(_table(cfg, params), x1)[:, 0]
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return cache, logits
