"""Model API: what serve/engine.py calls, for every architecture of the
zoo: the decoder-only LMs (attention, MoE, RWKV-6 and Mamba-2 blocks,
Zamba2's shared block) and the encoder-decoder (Whisper).

`build(cfg, max_position=4096)` returns a ModelApi:
    init(seed, device=None)                   -> params
    prefill(params, batch, max_len)           -> (cache, logits)
    decode(params, cache, tokens1)            -> (cache, logits)
    cache_init(B, max_len, device=None, T_enc=None) -> zeroed cache
A decoder-only batch is {"tokens": [B, T]}; the encoder-decoder's
(`is_encdec`) adds {"enc_x": [B, T_enc, d]}, and its cache's cross K/V
span T_enc frames, `max_len` when not given (as in the JAX package).

The JAX package's `loss` and `batch_specs` come with LM training
(ROADMAP.md, Queue 1 item 6), `param_specs` and `cache_specs` with item 7.
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
    prefill: Callable
    decode: Callable
    cache_init: Callable
    is_encdec: bool = False


def build(cfg: LMConfig, max_position: int = 4096) -> ModelApi:
    if cfg.enc_layers:
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, device=None: encdec.whisper_init(
                cfg, seed, device, max_position),
            prefill=partial(encdec.whisper_prefill, cfg),
            decode=partial(encdec.whisper_decode_step, cfg),
            cache_init=lambda B, S, device=None, T_enc=None:
                whisper_cache_init(cfg, B, S, T_enc, device),
            is_encdec=True,
        )

    def lm_prefill(params, batch, max_len):
        return tfm.prefill(cfg, params, batch["tokens"], max_len)

    return ModelApi(
        cfg=cfg,
        init=partial(tfm.init_params, cfg),
        prefill=lm_prefill,
        decode=partial(tfm.decode_step, cfg),
        cache_init=lambda B, S, device=None, T_enc=None:
            cache_init(cfg, B, S, device),
    )
