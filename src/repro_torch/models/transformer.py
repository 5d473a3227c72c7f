"""Decoder-only LM assembly: attention ("attn", "swa", "local", "global"),
RWKV-6 and Mamba-2 blocks, Zamba2's weight-shared attention block, and the
MoE FFN of the attention blocks (`n_experts`; arctic adds a parallel dense
FFN of `dense_ff`).

The JAX package stacks per-layer parameters as [n_cycles, ...] leaves and
scans over cycles.  Here `params["layers"]` is a list with one parameter
dict per layer, in depth order, and the passes loop over it.  Layer l is of
kind cfg.pattern[l % len(pattern)].  With a shared block
(`cfg.shared_every`), its one parameter copy `params["shared"]` runs
before every layer l with l % len(pattern) == 0: at the top of every cycle
and before the first tail layer, each invocation with its own cache.

Paths:
  * `forward`     -- logits for every position and the MoE auxiliary
                     loss (no cache);
  * `prefill`     -- the prompt through every layer, emitting the decode
                     cache; on the card each RWKV-6 and Mamba-2 layer
                     launches the linear-scan kernel once;
  * `decode_step` -- one token against the cache (no kernel);
  * `loss_fn`     -- next-token cross-entropy plus the weighted MoE
                     auxiliary loss, what training differentiates.

As in the JAX package, `forward` and `decode_step` apply `logit_softcap`
and `prefill` does not; prefill and decode drop the MoE auxiliary loss.
With `cfg.remat` (the default, as in the JAX package) and grad enabled,
`forward` recomputes each cycle of layers in the backward
(`torch.utils.checkpoint`, non-reentrant; the JAX package's
`jax.checkpoint` of its scan body): only a cycle's input stays saved, and
on the card each RWKV-6 or Mamba-2 layer launches the scan twice a
training step.  The tail layers are not recomputed, as in JAX.  The
encoder-decoder is models/encdec.py.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rw
from repro_torch.models.kv_cache import cache_init
from repro_torch.models.layers import (apply_norm, dense, dense_init,
                                       embed_init, embed_lookup, mlp,
                                       mlp_init, norm_init, unembed)

__all__ = ["LMConfig", "init_params", "forward", "loss_fn", "prefill",
           "decode_step", "ATTN_KINDS"]

ATTN_KINDS = ("attn", "swa", "local", "global")


@dataclass(frozen=True)
class LMConfig:
    """The JAX package's LMConfig field for field, without its execution
    knobs use_pallas, interpret and scan_layers; dtype is a torch dtype.
    `remat` recomputes each cycle of layers in the backward (module
    docstring)."""
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
    remat: bool = True
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


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _block_init(gen, cfg: LMConfig, kind: str) -> dict:
    dt, dev = cfg.dtype, gen.device
    p = {"norm1": norm_init(cfg.d_model, cfg.norm, dt, dev)}
    if kind in ATTN_KINDS:
        p["attn"] = attn.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.qk_norm, cfg.qk_norm_kind, dt)
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, dev)
        if cfg.n_experts:
            p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff,
                                        cfg.n_experts, cfg.mlp_kind, dt)
            if cfg.dense_ff:
                p["ffn"] = mlp_init(gen, cfg.d_model, cfg.dense_ff,
                                    cfg.mlp_kind, dt)
        else:
            p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt)
    elif kind == "rwkv6":
        p["rwkv"] = rw.rwkv6_init(gen, cfg.d_model, cfg.rwkv_head_dim,
                                  cfg.d_ff, dt)
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, dev)
    elif kind == "mamba2":
        p["mamba"] = m2.mamba2_init(
            gen, cfg.d_model, state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand, conv_width=cfg.conv_width, dtype=dt)
    else:
        raise ValueError(kind)
    return p


def _shared_block_init(gen, cfg: LMConfig) -> dict:
    """Zamba2 shared block: full attention + GELU MLP over concat(x, x0),
    then a projection back to d_model."""
    dt, dev = cfg.dtype, gen.device
    d_in = 2 * cfg.d_model
    hd = d_in // cfg.shared_n_heads
    return {
        "norm1": norm_init(d_in, cfg.norm, dt, dev),
        "attn": attn.attention_init(gen, d_in, cfg.shared_n_heads,
                                    cfg.shared_n_heads, hd, False, cfg.norm,
                                    dt),
        "norm2": norm_init(d_in, cfg.norm, dt, dev),
        "ffn": mlp_init(gen, d_in, cfg.shared_d_ff, "gelu", dt),
        "out": {"down": dense_init(gen, d_in, cfg.d_model, dt)},
    }


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from `seed`, drawn by a torch.Generator on the
    target device (billions of parameters are not drawn on the host).
    `device=None` means the CUDA card (raises without one)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
        "layers": [_block_init(gen, cfg, kind) for kind in cfg.layer_kinds()],
        "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.dtype, device),
    }
    if cfg.shared_every:
        params["shared"] = _shared_block_init(gen, cfg)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype)
    return params


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _attn_kwargs(cfg: LMConfig, kind: str) -> dict:
    theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
    window = cfg.window if kind in ("swa", "local") else None
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope=cfg.rope, rope_theta=theta,
                rope_fraction=cfg.rope_fraction,
                rope_interleaved=cfg.rope_interleaved,
                norm_kind=cfg.qk_norm_kind, window=window,
                kv_block=cfg.kv_block)


def _ffn_apply(cfg: LMConfig, p, h):
    """The dense MLP, the MoE, or arctic's MoE plus its dense residual FFN.
    Returns (y, aux): the MoE auxiliary loss, 0.0 for a dense MLP."""
    if cfg.n_experts:
        y, aux = moe_mod.moe_apply(
            p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.moe_capacity, group_size=cfg.moe_group_size,
            mlp_kind=cfg.mlp_kind)
        if cfg.dense_ff:
            y = y + mlp(p["ffn"], h, cfg.mlp_kind)
        return y, aux
    return mlp(p["ffn"], h, cfg.mlp_kind), 0.0


def _mamba_kwargs(cfg: LMConfig) -> dict:
    return dict(state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, conv_width=cfg.conv_width)


def _fill_attn_cache(entry, k, v, positions):
    """Write prefill K/V [B, T, ...] into a fresh cache entry sized S, in
    place.  When T >= S (a ring, or a prompt that fills the cache) the last
    S tokens are kept and rolled by T % S, so the token at position p lands
    on slot p % S, where decode writes it."""
    T = k.shape[1]
    S = entry["k"].shape[1]
    if T >= S:
        k, v, positions = k[:, T - S:], v[:, T - S:], positions[:, T - S:]
        if T % S:
            k, v, positions = (torch.roll(t, T % S, dims=1)
                               for t in (k, v, positions))
    entry["k"][:, :T].copy_(k)
    entry["v"][:, :T].copy_(v)
    entry["pos"][:, :T].copy_(positions)
    return entry


def _block(cfg: LMConfig, kind: str, p, x, positions, entry=None):
    """Prefill / forward of one block, x: [B, T, d].  Returns (x, entry,
    aux): with `entry` (a fresh cache entry) the filled entry, else None;
    aux is the MoE auxiliary loss (0.0 without one)."""
    aux = 0.0
    if kind in ATTN_KINDS:
        h = apply_norm(p["norm1"], x, cfg.norm)
        y, (k, v) = attn.attention_apply(p["attn"], h, positions=positions,
                                         causal=True, return_kv=True,
                                         **_attn_kwargs(cfg, kind))
        x = x + y
        if entry is not None:
            entry = _fill_attn_cache(entry, k, v, positions)
        h = apply_norm(p["norm2"], x, cfg.norm)
        y, aux = _ffn_apply(cfg, p, h)
        x = x + y
    elif kind == "rwkv6":
        h = apply_norm(p["norm1"], x, cfg.norm)
        y, (tm_last, wkv) = rw.rwkv6_time_mix(
            p["rwkv"], h, head_dim=cfg.rwkv_head_dim, chunk=cfg.scan_chunk)
        x = x + y
        h = apply_norm(p["norm2"], x, cfg.norm)
        y, cm_last = rw.rwkv6_channel_mix(p["rwkv"], h)
        x = x + y
        entry = {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv}
    elif kind == "mamba2":
        h = apply_norm(p["norm1"], x, cfg.norm)
        y, (conv, ssm) = m2.mamba2_apply(p["mamba"], h, chunk=cfg.scan_chunk,
                                         **_mamba_kwargs(cfg))
        x = x + y
        entry = {"conv": conv, "ssm": ssm}
    else:
        raise ValueError(kind)
    return x, entry, aux


def _block_decode(cfg: LMConfig, kind: str, p, x1, entry, position):
    """x1: [B, 1, d].  Returns (x1, entry)."""
    if kind in ATTN_KINDS:
        h = apply_norm(p["norm1"], x1, cfg.norm)
        kw = _attn_kwargs(cfg, kind)
        window = kw.pop("window")
        kw.pop("kv_block")
        y, entry = attn.attention_decode(
            p["attn"], h, entry, position=position,
            cache_kind="ring" if window else "full", **kw)
        x1 = x1 + y
        h = apply_norm(p["norm2"], x1, cfg.norm)
        x1 = x1 + _ffn_apply(cfg, p, h)[0]
    elif kind == "rwkv6":
        h = apply_norm(p["norm1"], x1, cfg.norm)[:, 0]
        y, tm_last, wkv = rw.rwkv6_time_mix_decode(
            p["rwkv"], h, entry["tm_last"], entry["wkv"],
            head_dim=cfg.rwkv_head_dim)
        x1 = x1 + y[:, None, :]
        h = apply_norm(p["norm2"], x1, cfg.norm)[:, 0]
        y, cm_last = rw.rwkv6_channel_mix_decode(p["rwkv"], h,
                                                 entry["cm_last"])
        x1 = x1 + y[:, None, :]
        entry = {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv}
    elif kind == "mamba2":
        h = apply_norm(p["norm1"], x1, cfg.norm)[:, 0]
        y, entry = m2.mamba2_decode(p["mamba"], h, entry,
                                    **_mamba_kwargs(cfg))
        x1 = x1 + y[:, None, :]
    else:
        raise ValueError(kind)
    return x1, entry


def _shared_forward(cfg: LMConfig, p, x, x0, positions, cache=None,
                    position=None, prefill_entry=None):
    """Zamba2 shared block over concat(x, x0); returns (delta, entry):
    decode with `cache` (and `position`), prefill with `prefill_entry`,
    else forward (entry None)."""
    h_in = torch.cat([x, x0], dim=-1)
    h = apply_norm(p["norm1"], h_in, cfg.norm)
    d_in = h.shape[-1]
    kw = dict(n_heads=cfg.shared_n_heads, n_kv=cfg.shared_n_heads,
              head_dim=d_in // cfg.shared_n_heads, rope="neox",
              rope_theta=cfg.rope_theta, norm_kind=cfg.norm)
    entry = None
    if cache is not None:                              # decode
        a, entry = attn.attention_decode(p["attn"], h, cache,
                                         position=position, **kw)
    else:                                              # prefill / forward
        a, (k, v) = attn.attention_apply(p["attn"], h, positions=positions,
                                         causal=True, kv_block=cfg.kv_block,
                                         return_kv=True, **kw)
        if prefill_entry is not None:
            entry = _fill_attn_cache(prefill_entry, k, v, positions)
    h_in = h_in + a
    h = apply_norm(p["norm2"], h_in, cfg.norm)
    h_in = h_in + mlp(p["ffn"], h, "gelu")
    return dense(p["out"]["down"], h_in), entry


def _shared_here(cfg: LMConfig, layer: int) -> bool:
    """The shared block runs before this layer: the top of a cycle, or the
    first tail layer."""
    return bool(cfg.shared_every) and layer % len(cfg.pattern) == 0


# --------------------------------------------------------------------------- #
# Paths
# --------------------------------------------------------------------------- #
def _embed(cfg: LMConfig, params, tokens):
    """Embedding lookup in cfg.dtype; gemma's sqrt(d_model) scale is first
    rounded to cfg.dtype, as the JAX package's jnp.asarray(.., dtype)."""
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def _table(cfg: LMConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _softcap(cfg: LMConfig, logits):
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _positions(B: int, T: int, device):
    return torch.arange(T, device=device).expand(B, T)


def _recompute(cfg: LMConfig, fn, *args):
    """fn(*args), recomputed in the backward when `cfg.remat` and grad is
    enabled (the JAX package's `jax.checkpoint`)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def forward(cfg: LMConfig, params, tokens):
    """tokens [B, T] -> (logits [B, T, V] f32, aux): aux is the MoE
    auxiliary loss summed over layers, a 0-dim f32 tensor (0 without MoE),
    as the JAX package's forward returns.  Each cycle of len(cfg.pattern)
    layers, with the shared block at its top, is one unit of recomputation
    (`cfg.remat`); the tail's layers run after the cycles."""
    B, T = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions(B, T, x.device)
    x0 = x
    kinds, layers = cfg.layer_kinds(), params["layers"]

    def run(lo: int, hi: int, x, aux):
        for layer in range(lo, hi):
            if _shared_here(cfg, layer):
                delta, _ = _shared_forward(cfg, params["shared"], x, x0,
                                           positions)
                x = x + delta
            x, _, a = _block(cfg, kinds[layer], layers[layer], x, positions)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    P = len(cfg.pattern)
    for c in range(cfg.cycles):
        x, aux = _recompute(cfg, partial(run, c * P, (c + 1) * P), x, aux)
    x, aux = run(cfg.cycles * P, cfg.n_layers, x, aux)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _softcap(cfg, unembed(_table(cfg, params), x)), aux


def next_token_nll(logits, tokens):
    """Mean next-token cross-entropy of logits [B, T, V] against tokens
    [B, T]: logsumexp minus the gold logit, in the logits' dtype, as the
    JAX package computes it."""
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def loss_fn(cfg: LMConfig, params, batch):
    """Next-token cross-entropy plus cfg.aux_loss_weight x the MoE
    auxiliary loss.  batch: {"tokens": [B, T] int}.  Returns (loss,
    {"nll", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens)
    nll = next_token_nll(logits, tokens)
    loss = nll + cfg.aux_loss_weight * aux
    return loss, {"nll": nll, "aux": aux}


def prefill(cfg: LMConfig, params, tokens, max_len: int):
    """tokens [B, T] -> (cache sized for max_len, last_logits [B, V] f32).
    No logit soft-capping here, as in the JAX package."""
    B, T = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions(B, T, x.device)
    cache = cache_init(cfg, B, max_len, x.device)
    x0 = x
    P = len(cfg.pattern)
    for layer, (kind, p) in enumerate(zip(cfg.layer_kinds(),
                                          params["layers"])):
        if _shared_here(cfg, layer):
            delta, entry = _shared_forward(
                cfg, params["shared"], x, x0, positions,
                prefill_entry=cache["shared"][layer // P])
            cache["shared"][layer // P] = entry
            x = x + delta
        x, cache["layers"][layer], _ = _block(cfg, kind, p, x, positions,
                                              cache["layers"][layer])
    cache["pos"] = torch.full((B,), T, dtype=torch.int32, device=x.device)
    # the final norm is per position: only the last one is needed
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    return cache, unembed(_table(cfg, params), x)[:, 0]


def decode_step(cfg: LMConfig, params, cache, tokens1):
    """One decode step.  tokens1: [B] int.  Returns (cache, logits [B, V]).
    Attention caches are updated in place (models/attention.py)."""
    position = cache["pos"]
    x1 = _embed(cfg, params, tokens1[:, None])
    x0 = x1
    P = len(cfg.pattern)
    entries, shared = [], []
    for layer, (kind, p, entry) in enumerate(zip(
            cfg.layer_kinds(), params["layers"], cache["layers"])):
        if _shared_here(cfg, layer):
            delta, sc = _shared_forward(cfg, params["shared"], x1, x0, None,
                                        cache=cache["shared"][layer // P],
                                        position=position)
            shared.append(sc)
            x1 = x1 + delta
        x1, entry = _block_decode(cfg, kind, p, x1, entry, position)
        entries.append(entry)
    new = {"layers": entries, "pos": position + 1}
    if cfg.shared_every:
        new["shared"] = shared
    x1 = apply_norm(params["final_norm"], x1, cfg.norm)
    return new, _softcap(cfg, unembed(_table(cfg, params), x1)[:, 0])
