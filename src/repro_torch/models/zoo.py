"""Model API: what serve/engine.py calls, for the decoder-only LMs the port
runs.

`build(cfg)` returns a ModelApi:
    init(seed, device=None)            -> params
    prefill(params, batch, max_len)    -> (cache, logits)
    decode(params, cache, tokens1)     -> (cache, logits)
    cache_init(B, max_len, device=None)-> zeroed cache

The JAX package's `loss`, `param_specs`, `cache_specs` and `batch_specs`
come with the training slice.
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
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP.md, Queue 1 item 15)")
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
