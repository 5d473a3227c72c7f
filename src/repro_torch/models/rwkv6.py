"""RWKV-6 "Finch" block: data-dependent token-shift and decay time-mix, and
squared-ReLU channel-mix.

Sequences run through the chunked linear recurrence (kernels/linear_scan,
mode "rwkv6": read before the update, bonus u) -- on the card, the CUDA
kernel csrc/linear_scan.cu.  Decode is the exact O(1)-state per-step update
and runs no kernel, as in the JAX package.

As in the JAX package, the five ddlerp token-shift mixes (w, k, v, r, g)
share one two-layer LoRA producing all five deltas.  Parameters are a plain
dict of tensors under the JAX package's names.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models.layers import apply_norm, dense, dense_init, norm_init

__all__ = ["rwkv6_init", "rwkv6_time_mix", "rwkv6_channel_mix",
           "rwkv6_time_mix_decode", "rwkv6_channel_mix_decode",
           "rwkv6_state_init"]

_TM_LORA = 32
_DECAY_LORA = 64


def rwkv6_init(gen: torch.Generator, d_model: int, head_dim: int = 64,
               d_ff: int = 0, dtype=torch.float32) -> dict:
    """Random parameters drawn on the generator's device (the JAX package's
    distributions; the draws themselves differ)."""
    H, K = d_model // head_dim, head_dim
    dev = gen.device
    s = 1.0 / math.sqrt(d_model)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    normal = lambda *shape: (torch.randn(shape, dtype=torch.float32,
                                         device=dev, generator=gen)
                             * s).to(dtype)
    return {
        # --- time mix ---------------------------------------------------- #
        "time_maa_x": zeros(d_model),
        "time_maa_5": zeros(5, d_model),                 # w,k,v,r,g base mix
        "tm_lora_a": normal(d_model, 5 * _TM_LORA),
        "tm_lora_b": zeros(5, _TM_LORA, d_model),
        "time_decay": torch.linspace(-6.0, -1.0, K, dtype=torch.float32,
                                     device=dev).repeat(H).to(dtype),
        "decay_lora_a": normal(d_model, _DECAY_LORA),
        "decay_lora_b": zeros(_DECAY_LORA, d_model),
        "time_faaaa": torch.full((H, K), 0.5, dtype=dtype, device=dev),
        "wr": dense_init(gen, d_model, d_model, dtype),
        "wk": dense_init(gen, d_model, d_model, dtype),
        "wv": dense_init(gen, d_model, d_model, dtype),
        "wg": dense_init(gen, d_model, d_model, dtype),
        "wo": dense_init(gen, d_model, d_model, dtype),
        "ln_x": norm_init(d_model, "layernorm", dtype, dev),
        # --- channel mix -------------------------------------------------- #
        "cm_maa_k": zeros(d_model),
        "cm_maa_r": zeros(d_model),
        "cm_wk": dense_init(gen, d_model, d_ff, dtype),
        "cm_wv": dense_init(gen, d_ff, d_model, dtype),
        "cm_wr": dense_init(gen, d_model, d_model, dtype),
    }


def _ddlerp(p, x, sx):
    """Data-dependent lerp producing the 5 mixed inputs (w, k, v, r, g).

    x: [B, T, d]; sx = shifted(x) - x.  Returns [5, B, T, d]."""
    xxx = x + sx * p["time_maa_x"]
    lora = torch.tanh(xxx @ p["tm_lora_a"])
    lora = lora.reshape(*lora.shape[:-1], 5, _TM_LORA)
    delta = torch.einsum("btfr,frd->fbtd", lora, p["tm_lora_b"])
    base = p["time_maa_5"][:, None, None, :]
    return x[None] + sx[None] * (base + delta)


def _token_shift(x, last):
    """shift(x)[t] = x[t-1], with `last` ([B, d]) as x[-1]."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _decay_log(p, xw):
    """Data-dependent log decay, -exp(...) <= 0, in f32."""
    dl = torch.tanh(xw @ p["decay_lora_a"])
    return -torch.exp(p["time_decay"].to(torch.float32)
                      + (dl @ p["decay_lora_b"]).to(torch.float32))


def rwkv6_time_mix(p, x, *, head_dim: int, last_x=None, state=None,
                   chunk: int = 64):
    """x: [B, T, d] -> (y, (new_last_x, new_state)); state [B, H, K, V]."""
    B, T, d = x.shape
    H, K = d // head_dim, head_dim
    if last_x is None:
        last_x = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, last_x) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    w_log = _decay_log(p, xw)

    heads = lambda z: z.reshape(B, T, H, K).transpose(1, 2)
    r = heads(dense(p["wr"], xr))
    k = heads(dense(p["wk"], xk))
    v = heads(dense(p["wv"], xv))
    g = F.silu(dense(p["wg"], xg))
    o, new_state = linear_scan(r, k, v, heads(w_log), u=p["time_faaaa"],
                               mode="rwkv6", chunk=chunk,
                               initial_state=state)
    o = o.transpose(1, 2).reshape(B, T, d).to(x.dtype)
    o = apply_norm(p["ln_x"], o, "layernorm") * g
    # a copy: a view of the last token would keep all of x alive in the cache
    return dense(p["wo"], o), (x[:, -1, :].clone(), new_state)


def rwkv6_channel_mix(p, x, *, last_x=None):
    B, T, d = x.shape
    if last_x is None:
        last_x = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, last_x) - x
    xk = x + sx * p["cm_maa_k"]
    xr = x + sx * p["cm_maa_r"]
    k = torch.square(F.relu(dense(p["cm_wk"], xk)))
    kv = dense(p["cm_wv"], k)
    return torch.sigmoid(dense(p["cm_wr"], xr)) * kv, x[:, -1, :].clone()


# --------------------------------------------------------------------------- #
# Decode (single token, exact recurrence; no kernel)
# --------------------------------------------------------------------------- #
def rwkv6_state_init(batch: int, d_model: int, head_dim: int,
                     dtype=torch.float32, device=None) -> dict:
    H, K = d_model // head_dim, head_dim
    return {
        "tm_last": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "cm_last": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, K, head_dim), dtype=torch.float32,
                           device=device),
    }


def rwkv6_time_mix_decode(p, x1, last_x, state, *, head_dim: int):
    """x1: [B, d] single token.  Returns (y [B, d], new_last, new_state)."""
    B, d = x1.shape
    H, K = d // head_dim, head_dim
    sx = (last_x - x1)[:, None, :]
    xw, xk, xv, xr, xg = (z[:, 0] for z in _ddlerp(p, x1[:, None, :], sx))
    w_log = _decay_log(p, xw)
    heads = lambda z: z.reshape(B, H, K)
    r = heads(dense(p["wr"], xr)).to(torch.float32)
    k = heads(dense(p["wk"], xk)).to(torch.float32)
    v = heads(dense(p["wv"], xv)).to(torch.float32)
    g = F.silu(dense(p["wg"], xg))
    w = torch.exp(heads(w_log))
    u = p["time_faaaa"].to(torch.float32)

    kv = k[..., :, None] * v[..., None, :]                 # [B, H, K, V]
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    new_state = w[..., None] * state + kv
    o = o.reshape(B, d).to(x1.dtype)
    o = apply_norm(p["ln_x"], o, "layernorm") * g
    return dense(p["wo"], o), x1, new_state


def rwkv6_channel_mix_decode(p, x1, last_x):
    sx = last_x - x1
    xk = x1 + sx * p["cm_maa_k"]
    xr = x1 + sx * p["cm_maa_r"]
    k = torch.square(F.relu(dense(p["cm_wk"], xk)))
    kv = dense(p["cm_wv"], k)
    return torch.sigmoid(dense(p["cm_wr"], xr)) * kv, x1
