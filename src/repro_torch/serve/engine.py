"""Batched serving engine: prefill + decode with continuous slot management.

`ServeEngine` keeps a fixed decode batch of `slots`; requests are admitted
into free slots (prefill, which on the card runs the linear-scan kernel in
every RWKV-6 and Mamba-2 layer), stepped together (one decode_step for the
whole batch), and retired on EOS or length.  Greedy or temperature
sampling.

A request's batch-1 prefill cache is copied into its slot in place, leaf
by leaf along the cache's batch axis (models/kv_cache.py: axis 0 of every
tensor leaf), whatever the tree holds: per-layer recurrent states,
attention k/v/pos, Zamba2's shared-block caches, the encoder-decoder's
self and cross caches.  The engine runs without autograd.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.kv_cache import BATCH_AXIS
from repro_torch.models.zoo import ModelApi

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [T] int
    enc_x: np.ndarray | None = None     # [T_enc, d] frame embeddings
    max_new_tokens: int = 32
    eos_id: int | None = None
    temperature: float = 0.0
    generated: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """`device=None` means the CUDA card and raises without one; pass
    "cpu" for the plain PyTorch path.  Temperature sampling draws from a
    torch.Generator on the device seeded with `seed` (its draws differ from
    the JAX engine's PRNG; greedy decoding does not draw)."""

    def __init__(self, api: ModelApi, *, slots: int = 4, max_len: int = 256,
                 seed: int = 0, device=None):
        self.api = api
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = None
        self.cache = None
        self.active: dict[int, Request] = {}     # slot -> request
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ #
    def load(self, params):
        self.params = params
        self.cache = self.api.cache_init(self.slots, self.max_len,
                                         self.device)

    def _write_slot(self, slot: int, src_cache):
        """Copy a batch-1 prefill cache into slot `slot` of the batched
        cache, in place, walking both trees together."""
        def merge(dst, src):
            if isinstance(dst, dict):
                for name in dst:
                    merge(dst[name], src[name])
            elif isinstance(dst, list):
                for d, s in zip(dst, src):
                    merge(d, s)
            else:
                dst.select(BATCH_AXIS, slot).copy_(src.select(BATCH_AXIS, 0))
        merge(self.cache, src_cache)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if s not in self.active]

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        """Prefill `req` into a free slot; False if the engine is full."""
        free = self.free_slots()
        if not free or self.params is None:
            return False
        slot = free[0]
        tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 dtype=torch.long, device=self.device)
        batch = {"tokens": tokens}
        if req.enc_x is not None:
            batch["enc_x"] = torch.as_tensor(np.asarray(req.enc_x)[None],
                                             device=self.device)
        src_cache, logits = self.api.prefill(self.params, batch, self.max_len)
        self._write_slot(slot, src_cache)
        self.active[slot] = req
        req.generated.append(self._sample(logits[0], req))
        return True

    def _sample(self, logits, req: Request, greedy: int | None = None) -> int:
        if req.temperature <= 0.0:
            return int(torch.argmax(logits)) if greedy is None else greedy
        probs = torch.softmax(logits.to(torch.float32) / req.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=self._gen))

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self) -> list[Request]:
        """One decode step for every active slot; returns the finished."""
        if not self.active:
            return []
        tokens = torch.zeros((self.slots,), dtype=torch.long)
        for slot, req in self.active.items():
            tokens[slot] = req.generated[-1]
        self.cache, logits = self.api.decode(self.params, self.cache,
                                             tokens.to(self.device))
        greedy = torch.argmax(logits, dim=-1).tolist()    # one device sync
        finished = []
        for slot, req in list(self.active.items()):
            tok = self._sample(logits[slot], req, greedy[slot])
            req.generated.append(tok)
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens):
                req.done = True
                finished.append(req)
                del self.active[slot]
        return finished

    # ------------------------------------------------------------------ #
    def generate(self, reqs: list[Request]) -> list[Request]:
        """Run a request list to completion with continuous admission."""
        pending = list(reqs)
        done: list[Request] = []
        while pending or self.active:
            while pending and self.admit(pending[0]):
                pending.pop(0)
            done.extend(self.step())
        return done
