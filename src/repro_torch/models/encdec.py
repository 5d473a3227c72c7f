"""Whisper-style encoder-decoder backbone, as the JAX package's
models/encdec.py.

The conv/mel frontend is a stub there and here: the encoder takes
precomputed frame embeddings [B, T_enc, d].  The encoder is
`cfg.enc_layers` bidirectional attention blocks over sinusoidal positions;
the decoder `cfg.n_layers` blocks of causal self-attention, cross-attention
and an MLP over a learned position table, with the embedding tied to the
unembedding.  LayerNorm, plain GELU, no RoPE (all from the config).

The JAX package stacks each side's layers as [L, ...] leaves and scans;
here `params["enc_layers"]` and `params["dec_layers"]` are lists of one
dict per layer.  Prefill computes each decoder layer's cross K/V once and
stores it in the cache (models/kv_cache.py's `whisper_cache_init`);
decode reads it through `attention_decode(cross_kv=...)`.  No kernel of
the port runs here: the JAX package's attention and MLPs are plain jnp.
`whisper_loss` is the next-token cross-entropy of the teacher-forced
decoder over the encoded frames; with `cfg.remat` and grad enabled each
encoder and decoder block is recomputed in the backward, as the JAX
package checkpoints each of them.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.kv_cache import whisper_cache_init
from repro_torch.models.layers import (apply_norm, embed_init, embed_lookup,
                                       generator, mlp, mlp_init, norm_init,
                                       sinusoidal_positions, unembed)
from repro_torch.models.transformer import (LMConfig, _fill_attn_cache,
                                            _recompute, next_token_nll)

__all__ = ["whisper_init", "whisper_param_specs", "whisper_cache_specs",
           "whisper_encode", "whisper_decode_forward",
           "whisper_loss", "whisper_prefill", "whisper_decode_step",
           "whisper_cache_init"]


def _attn_init(gen, cfg: LMConfig) -> dict:
    return attn.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, False, cfg.norm, cfg.dtype)


def _enc_block_init(gen, cfg: LMConfig) -> dict:
    dt, dev = cfg.dtype, gen.device
    return {"norm1": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "attn": _attn_init(gen, cfg),
            "norm2": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt)}


def _dec_block_init(gen, cfg: LMConfig) -> dict:
    dt, dev = cfg.dtype, gen.device
    return {"norm1": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "self": _attn_init(gen, cfg),
            "normx": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "cross": _attn_init(gen, cfg),
            "norm2": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt)}


def whisper_init(cfg: LMConfig, seed: int = 0, device=None,
                 max_position: int = 4096) -> dict:
    """Random parameters from `seed`, drawn by a torch.Generator on the
    target device; the decoder's learned position table has `max_position`
    rows.  `device=None` means the CUDA card (raises without one); "meta"
    lays the tree out without storage (`whisper_param_specs`)."""
    device = resolve_device(device)
    gen = generator(device, seed)
    dt = cfg.dtype
    dec_pos = torch.randn((max_position, cfg.d_model), dtype=torch.float32,
                          device=device, generator=gen) * 0.01
    return {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "dec_pos": {"w": dec_pos.to(dt)},
        "enc_layers": [_enc_block_init(gen, cfg)
                       for _ in range(cfg.enc_layers)],
        "enc_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
        "dec_layers": [_dec_block_init(gen, cfg)
                       for _ in range(cfg.n_layers)],
        "dec_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
    }


def whisper_param_specs(cfg: LMConfig, max_position: int = 4096) -> dict:
    """`whisper_init`'s tree as meta tensors: no allocation, no draws."""
    return whisper_init(cfg, device="meta", max_position=max_position)


def whisper_cache_specs(cfg: LMConfig, B: int, max_len: int,
                        T_enc: int | None = None) -> dict:
    """`whisper_cache_init`'s tree as meta tensors."""
    return whisper_cache_init(cfg, B, max_len, T_enc, device="meta")


def _kw(cfg: LMConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope="none", norm_kind=cfg.norm)


def whisper_encode(cfg: LMConfig, params, enc_x):
    """enc_x [B, T_enc, d] frame embeddings -> [B, T_enc, d].  The frames
    are cast to the model's dtype before the positions are added, as in the
    JAX package."""
    T = enc_x.shape[1]
    x = (enc_x.to(cfg.dtype)
         + sinusoidal_positions(T, cfg.d_model, cfg.dtype, enc_x.device)[None])
    def block(p, x):
        x = x + attn.attention_apply(p["attn"],
                                     apply_norm(p["norm1"], x, cfg.norm),
                                     causal=False, kv_block=cfg.kv_block,
                                     **_kw(cfg))
        return x + mlp(p["ffn"], apply_norm(p["norm2"], x, cfg.norm),
                       cfg.mlp_kind)
    for p in params["enc_layers"]:
        x = _recompute(cfg, partial(block, p), x)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _dec_block(cfg: LMConfig, p, x, enc_out, positions, entry=None):
    """One decoder block over x [B, T, d].  With `entry` (the layer's
    fresh self-attention cache) returns (x, filled entry, cross K/V), else
    (x, None, None)."""
    a, (k, v) = attn.attention_apply(
        p["self"], apply_norm(p["norm1"], x, cfg.norm), positions=positions,
        causal=True, return_kv=True, kv_block=cfg.kv_block, **_kw(cfg))
    x = x + a
    a, cross = attn.attention_apply(
        p["cross"], apply_norm(p["normx"], x, cfg.norm), x_kv=enc_out,
        return_kv=True, kv_block=cfg.kv_block, **_kw(cfg))
    x = x + a
    x = x + mlp(p["ffn"], apply_norm(p["norm2"], x, cfg.norm), cfg.mlp_kind)
    if entry is None:
        return x, None, None
    return x, _fill_attn_cache(entry, k, v, positions), cross


def _dec_embed(cfg: LMConfig, params, tokens):
    """Token embeddings plus the learned positions of the first T rows."""
    T = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    return x + params["dec_pos"]["w"][:T][None].to(cfg.dtype)


def whisper_decode_forward(cfg: LMConfig, params, tokens, enc_out):
    """tokens [B, T], enc_out [B, T_enc, d] -> logits [B, T, V] (f32)."""
    B, T = tokens.shape
    x = _dec_embed(cfg, params, tokens)
    positions = torch.arange(T, device=x.device).expand(B, T)
    block = lambda p, x, enc_out: _dec_block(cfg, p, x, enc_out,
                                             positions)[0]
    for p in params["dec_layers"]:
        x = _recompute(cfg, partial(block, p), x, enc_out)
    x = apply_norm(params["dec_norm"], x, cfg.norm)
    return unembed(params["embed"], x)


def whisper_loss(cfg: LMConfig, params, batch):
    """batch {"enc_x": [B, T_enc, d], "tokens": [B, T]} -> (nll, {"nll",
    "aux"}): the teacher-forced decoder's next-token cross-entropy; aux is
    0 (no MoE)."""
    enc_out = whisper_encode(cfg, params, batch["enc_x"])
    tokens = batch["tokens"]
    nll = next_token_nll(
        whisper_decode_forward(cfg, params, tokens, enc_out), tokens)
    return nll, {"nll": nll,
                 "aux": torch.zeros((), dtype=torch.float32,
                                    device=nll.device)}


def whisper_prefill(cfg: LMConfig, params, batch, max_len: int):
    """batch {"enc_x": [B, T_enc, d], "tokens": [B, T]} -> (cache, last
    logits [B, V] f32).  The encoder runs once; each decoder layer's
    self-attention cache (sized max_len) is filled and its cross K/V over
    the T_enc frames stored."""
    enc_out = whisper_encode(cfg, params, batch["enc_x"])
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = _dec_embed(cfg, params, tokens)
    positions = torch.arange(T, device=x.device).expand(B, T)
    cache = whisper_cache_init(cfg, B, max_len, enc_out.shape[1], x.device)
    for p, entry, cross in zip(params["dec_layers"], cache["self"],
                               cache["cross"]):
        x, _, (xk, xv) = _dec_block(cfg, p, x, enc_out, positions, entry)
        cross["k"].copy_(xk)
        cross["v"].copy_(xv)
    cache["pos"] = torch.full((B,), T, dtype=torch.int32, device=x.device)
    x = apply_norm(params["dec_norm"], x[:, -1:, :], cfg.norm)
    return cache, unembed(params["embed"], x)[:, 0]


def whisper_decode_step(cfg: LMConfig, params, cache, tokens1):
    """One decode step, tokens1 [B] -> (cache, logits [B, V] f32).  Each
    slot's token takes the position row of its own `pos`; the self caches
    are written in place, the cross caches only read."""
    position = cache["pos"]
    x = embed_lookup(params["embed"], tokens1[:, None]).to(cfg.dtype)
    x = x + params["dec_pos"]["w"][position][:, None, :].to(cfg.dtype)
    for p, entry, cross in zip(params["dec_layers"], cache["self"],
                               cache["cross"]):
        a, _ = attn.attention_decode(
            p["self"], apply_norm(p["norm1"], x, cfg.norm), entry,
            position=position, **_kw(cfg))
        x = x + a
        a, _ = attn.attention_decode(
            p["cross"], apply_norm(p["normx"], x, cfg.norm), None,
            position=position, cross_kv=(cross["k"], cross["v"]),
            **_kw(cfg))
        x = x + a
        x = x + mlp(p["ffn"], apply_norm(p["norm2"], x, cfg.norm),
                    cfg.mlp_kind)
    cache = dict(cache, pos=position + 1)
    x = apply_norm(params["dec_norm"], x, cfg.norm)
    return cache, unembed(params["embed"], x)[:, 0]
