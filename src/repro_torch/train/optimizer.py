"""Minimal optax-style optimizers over nested dicts and lists of tensors.

The JAX package's train/optimizer.py with its arithmetic: the same update
formulas, f32 moments, updates cast to the parameter's dtype, bias
correction from a shared int32 step counter, learning rates that are a
float or a schedule of the step, and leaves visited in JAX's pytree order
(dicts by sorted key, lists in order), so sums over leaves add in the same
order.  Clipping promotes as JAX does: a bf16 gradient times the f32 scale
is f32.

Every `update(grads, state, params=None, *, donate=False)` works leaf by
leaf.  It is functional by default: new moments and updates, its arguments
untouched.  With `donate=True` the caller hands over `state` (JAX's buffer
donation): each leaf's new moments are written into the old moments'
tensors as soon as they are computed, so a step holds no second copy of the
optimizer state (at 3.1B parameters the f32 moments alone are 24.8 GB).
The numbers are the same either way; `apply_updates(..., donate=True)`
likewise writes the new parameters into the old ones.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["AdamState", "SgdState", "AdafactorState", "Optimizer", "adamw",
           "sgd", "adafactor", "apply_updates", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "tree_leaves",
           "tree_map", "tree_unflatten"]


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


def _unzip(out, n: int):
    """A tree whose leaves are n-tuples -> n trees of its structure."""
    if isinstance(out, dict):
        parts = {k: _unzip(v, n) for k, v in out.items()}
        return tuple({k: parts[k][i] for k in out} for i in range(n))
    if isinstance(out, list):
        parts = [_unzip(v, n) for v in out]
        return tuple([part[i] for part in parts] for i in range(n))
    return out


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar, shared by every leaf
    mu: Any
    nu: Any


class SgdState(NamedTuple):
    step: torch.Tensor
    mom: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any      # row second moment (factored leaves) or the full v
    vc: Any      # column second moment (factored leaves) or a [1] zero


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total))


def _clip_scale(grads, max_norm: float):
    """(scale, norm): the factor `clip_by_global_norm` multiplies by."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def _scaled(g, scale):
    """g * scale with JAX's promotion (a bf16 g times the f32 scale is
    f32)."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


def clip_by_global_norm(tree, max_norm: float):
    scale, norm = _clip_scale(tree, max_norm)
    return tree_map(lambda g: _scaled(g, scale), tree), norm


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """Linear warm-up over `warmup_steps`, then a cosine to 0 at
    `total_steps`: lr(step) -> a 0-dim f32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup_steps, warm, cos)
    return lr


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _decay_into(m, beta, x, donate: bool):
    """beta * m + (1 - beta) * x, written into m when `donate`."""
    if donate:
        return m.mul_(beta).add_((1 - beta) * x)
    return beta * m + (1 - beta) * x


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float | None = 1.0) -> Optimizer:
    """AdamW with global-norm clipping; `lr` a float or a schedule of the
    (1-based) step."""
    lr_fn = _lr_fn(lr)

    def init(params) -> AdamState:
        leaf = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=leaf.device),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state: AdamState, params=None, *, donate=False):
        scale = _clip_scale(grads, clip_norm)[0] if clip_norm is not None \
            else None
        step = state.step + 1
        t = step.to(torch.float32)
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def one(g, m, v, p):
            g = _scaled(g, scale) if scale is not None else g
            g = g.float()
            m = _decay_into(m, b1, g, donate)
            v = _decay_into(v, b2, torch.square(g), donate)
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.float()
            return u.to(p.dtype if p is not None else u.dtype), m, v

        p_tree = params if params is not None else tree_map(
            lambda _: None, grads)
        out = tree_map(one, grads, state.mu, state.nu, p_tree)
        updates, mu, nu = _unzip(out, 3)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.9,
        clip_norm: float | None = None) -> Optimizer:
    """SGD with heavy-ball momentum (kept in the parameter's dtype)."""
    lr_fn = _lr_fn(lr)

    def init(params) -> SgdState:
        leaf = tree_leaves(params)[0]
        return SgdState(step=torch.zeros((), dtype=torch.int32,
                                         device=leaf.device),
                        mom=tree_map(torch.zeros_like, params))

    def update(grads, state: SgdState, params=None, *, donate=False):
        del params
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1

        def one(m, g):
            if donate:
                return m.mul_(momentum).add_(g)
            return momentum * m + g
        mom = tree_map(one, state.mom, grads)
        updates = tree_map(lambda m: -lr_fn(step) * m, mom)
        return updates, SgdState(step=step, mom=mom)

    return Optimizer(init=init, update=update)


def adafactor(lr: float | Callable = 1e-2, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018): factored second moments over the
    last two axes (leading axes are batch), no momentum, the t^-0.8 decay
    and RMS clipping of the update."""
    lr_fn = _lr_fn(lr)

    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params) -> AdafactorState:
        leaf = tree_leaves(params)[0]
        f32 = dict(dtype=torch.float32)

        def vr0(p):
            shape = p.shape[:-1] if factored(p) else p.shape
            return torch.zeros(shape, device=p.device, **f32)

        def vc0(p):
            shape = p.shape[:-2] + p.shape[-1:] if factored(p) else (1,)
            return torch.zeros(shape, device=p.device, **f32)

        return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                               device=leaf.device),
                              vr=tree_map(vr0, params),
                              vc=tree_map(vc0, params))

    def update(grads, state: AdafactorState, params=None, *, donate=False):
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def one(g, vr, vc, p):
            g = g.float()
            g2 = torch.square(g) + eps
            if factored(p):
                vr_n = _decay_into(vr, beta, g2.mean(dim=-1), donate)
                vc_n = _decay_into(vc, beta, g2.mean(dim=-2), donate)
                denom = vr_n.mean(dim=-1, keepdim=True)
                vhat = (vr_n / torch.clamp(denom, min=eps))[..., None] \
                    * vc_n[..., None, :]
                u = g * torch.rsqrt(torch.clamp(vhat, min=eps))
            else:
                vr_n = _decay_into(vr, beta, g2, donate)
                vc_n = vc
                u = g * torch.rsqrt(torch.clamp(vr_n, min=eps))
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr_t * u).to(p.dtype), vr_n, vc_n

        out = tree_map(one, grads, state.vr, state.vc, params)
        updates, vr, vc = _unzip(out, 3)
        return updates, AdafactorState(step=step, vr=vr, vc=vc)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates, *, donate=False):
    """params + updates in each parameter's dtype; with `donate` the sums
    are written into the parameters' own tensors."""
    if donate:
        return tree_map(lambda p, u: p.add_(u) if u.dtype == p.dtype
                        else p.copy_((p + u).to(p.dtype)), params, updates)
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
