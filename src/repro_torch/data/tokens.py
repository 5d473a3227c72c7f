"""Synthetic LM data pipeline: deterministic, seekable token streams.

The JAX package's data/tokens.py, copied (it is pure numpy, and the port
imports nothing of that package): the same draws, so every batch is
byte-identical to JAX's.  Sampling is Zipf-distributed over the vocab with
a deterministic order-2 Markov mix so the LM loss actually decreases (pure
uniform tokens have no learnable structure).  `TokenStream.batch_at(step)`
is addressable by step -- a resumed run re-produces the exact batch
sequence (required for the bit-exact restart test).  Batches are numpy
(tokens int32, Whisper's `enc_x` float32); the caller moves them to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenStream"]


@dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    d_frontend: int | None = None     # whisper: also emit frame embeddings

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        # zipf over a capped vocab for realistic token frequencies
        z = rng.zipf(1.3, size=(self.batch, self.seq_len)).astype(np.int64)
        tokens = (z - 1) % self.vocab
        # inject learnable structure: token[t] ~ (token[t-1] * 31 + 7) for a
        # third of positions.
        follow = (tokens[:, :-1] * 31 + 7) % self.vocab
        mask = rng.random((self.batch, self.seq_len - 1)) < 0.33
        tokens[:, 1:] = np.where(mask, follow, tokens[:, 1:])
        out = {"tokens": tokens.astype(np.int32)}
        if self.d_frontend:
            out["enc_x"] = rng.standard_normal(
                (self.batch, self.seq_len, self.d_frontend)
            ).astype(np.float32) * 0.1
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def iter_from(self, step: int):
        while True:
            yield self.batch_at(step)
            step += 1
