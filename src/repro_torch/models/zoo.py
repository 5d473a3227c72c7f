"""Model API: what serve/engine.py calls, for every architecture of the
zoo: the decoder-only LMs (attention, MoE, RWKV-6 and Mamba-2 blocks,
Zamba2's shared block) and the encoder-decoder (Whisper).

`build(cfg, max_position=4096)` returns a ModelApi:
    init(seed, device=None)                   -> params
    param_specs()                             -> params as meta tensors
    loss(params, batch)                       -> (loss, {"nll", "aux"})
    prefill(params, batch, max_len)           -> (cache, logits)
    decode(params, cache, tokens1)            -> (cache, logits)
    cache_specs(B, max_len, T_enc=None)       -> cache as meta tensors
    cache_init(B, max_len, device=None, T_enc=None) -> zeroed cache
    batch_specs(B, T)                         -> a batch as meta tensors
    stack_key(path)                           -> the JAX leaf of a port leaf
A decoder-only batch is {"tokens": [B, T]}; the encoder-decoder's
(`is_encdec`) adds {"enc_x": [B, T_enc, d]}, and its cache's cross K/V
span T_enc frames, `max_len` when not given (as in the JAX package).
The specs are the JAX package's allocation-free trees: meta tensors with
each leaf's shape and dtype.  `param_specs` and `cache_specs` run the
code of `init` and `cache_init` on the meta device; `batch_specs` gives
int32 tokens and Whisper's frames in cfg.dtype with T_enc = T, as JAX's.

`stack_key` maps the path of a parameter leaf (train/checkpoint.py's
`tree_flatten`; a prefix such as a train state's "opt/mu/" is kept) to
the leaf of the JAX package's tree it is a slice of:
JAX stacks the layers of each pattern position over the cycles (Whisper's
encoder and decoder layers over the depth), the port keeps one dict per
layer.  The gradient compressor groups leaves by it, as JAX compresses
each stacked leaf whole.  `loss` is what training differentiates
(train/train_state.py): the decoder-only LMs' `transformer.loss_fn`,
Whisper's `encdec.whisper_loss`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.kv_cache import (cache_init, cache_specs,
                                         whisper_cache_init)
from repro_torch.models.transformer import LMConfig

__all__ = ["ModelApi", "build"]


@dataclass(frozen=True)
class ModelApi:
    cfg: LMConfig
    init: Callable
    param_specs: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    cache_specs: Callable
    cache_init: Callable
    batch_specs: Callable
    stack_key: Callable
    is_encdec: bool = False


def _stack_key(cfg: LMConfig, path: str) -> tuple:
    parts = path.split("/")
    for i, part in enumerate(parts[:-1]):
        if not parts[i + 1].isdigit():
            continue
        head, rest = parts[:i], parts[i + 2:]
        if part in ("enc_layers", "dec_layers"):
            return (*head, part, *rest)
        if part == "layers":
            layer, P = int(parts[i + 1]), len(cfg.pattern)
            if layer < cfg.cycles * P:
                return (*head, "layers", layer % P, *rest)
            return (*head, "tail", layer - cfg.cycles * P, *rest)
    return tuple(parts)


def _lm_batch_specs(cfg: LMConfig, B: int, T: int) -> dict:
    return {"tokens": torch.empty((B, T), dtype=torch.int32, device="meta")}


def _whisper_batch_specs(cfg: LMConfig, B: int, T: int) -> dict:
    return {"enc_x": torch.empty((B, T, cfg.d_model), dtype=cfg.dtype,
                                 device="meta"),
            "tokens": torch.empty((B, T), dtype=torch.int32, device="meta")}


def build(cfg: LMConfig, max_position: int = 4096) -> ModelApi:
    if cfg.enc_layers:
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, device=None: encdec.whisper_init(
                cfg, seed, device, max_position),
            param_specs=lambda: encdec.whisper_param_specs(cfg,
                                                           max_position),
            loss=partial(encdec.whisper_loss, cfg),
            prefill=partial(encdec.whisper_prefill, cfg),
            decode=partial(encdec.whisper_decode_step, cfg),
            cache_specs=lambda B, S, T_enc=None: encdec.whisper_cache_specs(
                cfg, B, S, T_enc),
            cache_init=lambda B, S, device=None, T_enc=None:
                whisper_cache_init(cfg, B, S, T_enc, device),
            batch_specs=partial(_whisper_batch_specs, cfg),
            stack_key=partial(_stack_key, cfg),
            is_encdec=True,
        )

    def lm_prefill(params, batch, max_len):
        return tfm.prefill(cfg, params, batch["tokens"], max_len)

    return ModelApi(
        cfg=cfg,
        init=partial(tfm.init_params, cfg),
        param_specs=lambda: tfm.param_specs(cfg),
        loss=partial(tfm.loss_fn, cfg),
        prefill=lm_prefill,
        decode=partial(tfm.decode_step, cfg),
        cache_specs=lambda B, S, T_enc=None: cache_specs(cfg, B, S),
        cache_init=lambda B, S, device=None, T_enc=None:
            cache_init(cfg, B, S, device),
        batch_specs=partial(_lm_batch_specs, cfg),
        stack_key=partial(_stack_key, cfg),
    )
