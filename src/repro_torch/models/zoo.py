"""Model API: what serve/engine.py calls, for every architecture of the
zoo: the decoder-only LMs (attention, MoE, RWKV-6 and Mamba-2 blocks,
Zamba2's shared block) and the encoder-decoder (Whisper).

`build(cfg, max_position=4096)` returns a ModelApi:
    init(seed, device=None)                   -> params
    loss(params, batch)                       -> (loss, {"nll", "aux"})
    prefill(params, batch, max_len)           -> (cache, logits)
    decode(params, cache, tokens1)            -> (cache, logits)
    cache_init(B, max_len, device=None, T_enc=None) -> zeroed cache
    stack_key(path)                           -> the JAX leaf of a port leaf
A decoder-only batch is {"tokens": [B, T]}; the encoder-decoder's
(`is_encdec`) adds {"enc_x": [B, T_enc, d]}, and its cache's cross K/V
span T_enc frames, `max_len` when not given (as in the JAX package).

`stack_key` maps the path of a parameter leaf (train/checkpoint.py's
`tree_flatten`) to the leaf of the JAX package's tree it is a slice of:
JAX stacks the layers of each pattern position over the cycles (Whisper's
encoder and decoder layers over the depth), the port keeps one dict per
layer.  The gradient compressor groups leaves by it, as JAX compresses
each stacked leaf whole.  `loss` is what training differentiates
(train/train_state.py): the decoder-only LMs' `transformer.loss_fn`,
Whisper's `encdec.whisper_loss`.
The JAX package's allocation-free `param_specs`, `cache_specs` and
`batch_specs` come with ROADMAP.md, Queue 1 item 7.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.kv_cache import cache_init, whisper_cache_init
from repro_torch.models.transformer import LMConfig

__all__ = ["ModelApi", "build"]


@dataclass(frozen=True)
class ModelApi:
    cfg: LMConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    cache_init: Callable
    stack_key: Callable
    is_encdec: bool = False


def _stack_key(cfg: LMConfig, path: str) -> tuple:
    parts = path.split("/")
    if parts[0] in ("enc_layers", "dec_layers"):
        return (parts[0], *parts[2:])
    if parts[0] == "layers":
        layer, P = int(parts[1]), len(cfg.pattern)
        if layer < cfg.cycles * P:
            return ("layers", layer % P, *parts[2:])
        return ("tail", layer - cfg.cycles * P, *parts[2:])
    return tuple(parts)


def build(cfg: LMConfig, max_position: int = 4096) -> ModelApi:
    if cfg.enc_layers:
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, device=None: encdec.whisper_init(
                cfg, seed, device, max_position),
            loss=partial(encdec.whisper_loss, cfg),
            prefill=partial(encdec.whisper_prefill, cfg),
            decode=partial(encdec.whisper_decode_step, cfg),
            cache_init=lambda B, S, device=None, T_enc=None:
                whisper_cache_init(cfg, B, S, T_enc, device),
            stack_key=partial(_stack_key, cfg),
            is_encdec=True,
        )

    def lm_prefill(params, batch, max_len):
        return tfm.prefill(cfg, params, batch["tokens"], max_len)

    return ModelApi(
        cfg=cfg,
        init=partial(tfm.init_params, cfg),
        loss=partial(tfm.loss_fn, cfg),
        prefill=lm_prefill,
        decode=partial(tfm.decode_step, cfg),
        cache_init=lambda B, S, device=None, T_enc=None:
            cache_init(cfg, B, S, device),
        stack_key=partial(_stack_key, cfg),
    )
