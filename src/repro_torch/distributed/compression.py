"""Gradient compression for the data-parallel reduction.

The JAX package's distributed/compression.py with its arithmetic.  Two
composable schemes:

  * top-k sparsification with ERROR FEEDBACK (memory): each step sends only
    the largest-|g| fraction per leaf; the residual is carried and added to
    the next step's gradient, preserving convergence (Stich et al. 2018).
  * int8 quantization: per-leaf symmetric scale, quantize -> dequantize.

`Compressor.apply` is functional: the error state threads through the
train state under state["comp"] (train/train_state.py).  On one card there
is no reduction to shrink; the compressor still changes what the optimizer
sees, exactly as in the JAX package (`launch/train.py --compress`).

The JAX package stacks a model's layers into one leaf ([n_cycles, ...]),
so its top-k threshold and int8 scale are taken over every layer at once;
the port keeps a leaf per layer.  `group` (the model API's `stack_key`)
names the JAX leaf each of the port's leaves belongs to, and the leaves of
one group share one threshold and one scale, which gives JAX's numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Hashable

import torch

from repro_torch.train.checkpoint import tree_flatten, tree_unflatten

__all__ = ["Compressor", "topk_compressor", "int8_compressor",
           "quantize_int8", "dequantize_int8"]

PyTree = Any


def quantize_int8(x, amax=None):
    """Symmetric per-tensor int8 quantization. Returns (q, scale).  `amax`:
    the largest |value| of the tensor's group, if it is quantized as part of
    one (default: its own)."""
    amax = (torch.max(torch.abs(x)) if amax is None else amax).to(
        torch.float32)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _groups(paths, group) -> list[list[int]]:
    """Leaf indices grouped by `group(path)` (each leaf alone without
    one), in order of first appearance."""
    if group is None:
        return [[i] for i in range(len(paths))]
    out: dict = {}
    for i, p in enumerate(paths):
        out.setdefault(group(p), []).append(i)
    return list(out.values())


def _topk_masks(xs, keep_frac: float):
    """Masks keeping the top `keep_frac` fraction of |x| over all of `xs`
    together (ties with the k-th largest kept too, as in the JAX
    package)."""
    flat = torch.cat([torch.abs(x.reshape(-1)) for x in xs])
    k = max(int(flat.numel() * keep_frac), 1)
    thresh = torch.topk(flat, k).values[-1]
    return [(torch.abs(x) >= thresh).to(x.dtype) for x in xs]


@dataclass(frozen=True)
class Compressor:
    keep_frac: float | None = None      # top-k sparsification fraction
    int8: bool = False
    # path of a leaf (train/checkpoint.tree_flatten's) -> the key of the
    # JAX leaf it is part of; leaves of one key share threshold and scale
    group: Callable[[str], Hashable] | None = None

    def init(self, grads: PyTree) -> PyTree:
        if self.keep_frac is None:
            return None
        leaves, _ = tree_flatten(grads)
        return tree_unflatten(grads, [
            torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in leaves])

    def apply(self, grads: PyTree, err: PyTree | None):
        """grads -> (compressed grads, new error state)."""
        leaves, paths = tree_flatten(grads)
        groups = _groups(paths, self.group)
        if self.keep_frac is not None:
            errs = tree_flatten(err if err is not None
                                else self.init(grads))[0]
            sent, new_err = list(leaves), list(errs)
            for idx in groups:
                corrected = [leaves[i].to(torch.float32) + errs[i]
                             for i in idx]
                masks = _topk_masks(corrected, self.keep_frac)
                for i, c, m in zip(idx, corrected, masks):
                    s = c * m
                    sent[i], new_err[i] = s.to(leaves[i].dtype), c - s
            leaves, err = sent, tree_unflatten(grads, new_err)
        if self.int8:
            out = list(leaves)
            for idx in groups:
                amax = torch.max(torch.stack(
                    [torch.max(torch.abs(leaves[i])) for i in idx]))
                for i in idx:
                    q, s = quantize_int8(leaves[i], amax)
                    out[i] = dequantize_int8(q, s).to(leaves[i].dtype)
            leaves = out
        return tree_unflatten(grads, leaves), err

    def wire_bytes_per_param(self) -> float:
        """Modeled bytes/param on the DP reduction: top-k sends
        (value + index) per kept entry; int8 sends 1 byte."""
        value = 1.0 if self.int8 else 4.0
        if self.keep_frac is not None:
            return self.keep_frac * (value + 4.0)
        return value


def topk_compressor(keep_frac: float = 0.1, int8: bool = False,
                    group=None) -> Compressor:
    return Compressor(keep_frac=keep_frac, int8=int8, group=group)


def int8_compressor(group=None) -> Compressor:
    return Compressor(int8=True, group=group)
