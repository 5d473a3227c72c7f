"""Architecture registry: ``get_arch(<id>)`` -> full config + smoke config.

The registry names every architecture the JAX package has, and the port
serves them all.  `SHAPES` are the JAX package's four input-shape cells.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any

__all__ = ["SHAPES", "Shape", "ArchSpec", "get_arch", "list_archs",
           "FULL_ATTN_SKIP"]


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ArchSpec:
    name: str
    config: Any                    # full LMConfig
    smoke: Any                     # reduced LMConfig (CPU-runnable)
    skip_shapes: dict = field(default_factory=dict)   # name -> reason
    notes: str = ""

    def shapes(self):
        return [s for n, s in SHAPES.items() if n not in self.skip_shapes]


FULL_ATTN_SKIP = ("pure full-attention arch: 500k-token decode has no "
                  "sub-quadratic/windowed/recurrent mode; skipped per the "
                  "assignment shape rules (recorded in DESIGN.md)")

_ARCHS = {
    "chameleon-34b": "chameleon_34b",
    "arctic-480b": "arctic_480b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-7b": "zamba2_7b",
    "qwen3-8b": "qwen3_8b",
    "starcoder2-15b": "starcoder2_15b",
    "chatglm3-6b": "chatglm3_6b",
    "gemma3-12b": "gemma3_12b",
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_arch(name: str) -> ArchSpec:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.SPEC
