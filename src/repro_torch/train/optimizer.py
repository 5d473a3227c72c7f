"""AdamW and global-norm clipping over nested dicts and lists of tensors.

The pieces core/fleet.py and core/trainer.py need, with the JAX package's arithmetic: the same
update formula, bias correction from a shared int32 step counter, and leaves
visited in JAX's pytree order (dicts by sorted key, lists in order), so
sums over leaves add in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["AdamState", "Optimizer", "adamw", "apply_updates", "global_norm",
           "clip_by_global_norm", "tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves of nested dicts (in sorted-key order) and lists (in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over nested dicts and lists of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, node, *(r[i] for r in rest))
                for i, node in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """Inverse of `tree_leaves`: the structure of `like` filled from
    `leaves` (given in sorted-key order)."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [fill(x) for x in node]
        return next(it)
    return fill(like)


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar, shared by every leaf
    mu: Any
    nu: Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float | None = 1.0) -> Optimizer:
    """Functional AdamW: `update` returns new updates and a new state and
    leaves its arguments untouched."""

    def init(params) -> AdamState:
        leaf = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=leaf.device),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state: AdamState, params=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        t = step.to(torch.float32)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
