"""Model API: what serve/engine.py calls, for the decoder-only LMs the port
runs (attention, RWKV-6 and Mamba-2 blocks, Zamba2's shared block).

`build(cfg)` returns a ModelApi:
    init(seed, device=None)            -> params
    prefill(params, batch, max_len)    -> (cache, logits)
    decode(params, cache, tokens1)     -> (cache, logits)
    cache_init(B, max_len, device=None)-> zeroed cache

The JAX package's `loss` and `batch_specs` come with LM training
(ROADMAP.md, Queue 1 item 6), `param_specs` and `cache_specs` with item 7,
and its encoder-decoder build with item 5.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

from repro_torch.models import transformer as tfm
from repro_torch.models.kv_cache import cache_init
from repro_torch.models.transformer import LMConfig

__all__ = ["ModelApi", "build"]


@dataclass(frozen=True)
class ModelApi:
    cfg: LMConfig
    init: Callable
    prefill: Callable
    decode: Callable
    cache_init: Callable


def build(cfg: LMConfig) -> ModelApi:
    tfm.check_supported(cfg)

    def lm_prefill(params, batch, max_len):
        return tfm.prefill(cfg, params, batch["tokens"], max_len)

    return ModelApi(
        cfg=cfg,
        init=partial(tfm.init_params, cfg),
        prefill=lm_prefill,
        decode=partial(tfm.decode_step, cfg),
        cache_init=partial(cache_init, cfg),
    )
