"""Generic model-recovery training loop (Merinda, Emily, PinnSR: anything
with `.loss(params, batch, sparsify) -> (loss, aux)`).

Handles the sparsity switch (`sparsify_after`), the NaN guard (restore
the last good params and start the optimizer afresh: the single-process
form of a fault-tolerant restart) and the loss history.  The optimizer
is functional: every step makes new tensors and leaves the old ones
alone, so `last_good` never aliases a tensor that a later step changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.train.optimizer import (Optimizer, adamw, apply_updates,
                                         tree_leaves, tree_unflatten)

__all__ = ["FitResult", "fit"]


@dataclass
class FitResult:
    params: Any
    history: list = field(default_factory=list)
    nan_restarts: int = 0


def _update(model, opt, params, opt_state, batch, sparsify: bool):
    """One optimizer step on the gradient of every leaf of `params`."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = model.loss(tree_unflatten(params, leaves), batch,
                               sparsify)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    updates, opt_state = opt.update(tree_unflatten(params, grads), opt_state,
                                    params)
    return (apply_updates(params, updates), opt_state, loss.detach(),
            {k: v.detach() for k, v in aux.items()})


def fit(model, params, batches: Iterator, *, steps: int,
        optimizer: Optimizer | None = None, lr: float = 3e-3,
        sparsify_after: float = 0.5, log_every: int = 0,
        post_step: Callable | None = None) -> FitResult:
    """Fit a model-recovery model for `steps` batches.

    sparsify_after: fraction of `steps` after which the top-|Theta| mask is
    enabled (the paper's pruning phase).  A step whose loss is not finite
    is dropped: params go back to the last good ones and the optimizer
    state starts afresh.  `post_step(step, params) -> params` runs after
    every good step.
    """
    opt = optimizer or adamw(lr=lr)
    opt_state = opt.init(params)
    history = []
    nan_restarts = 0
    last_good = params
    sparsify_step = int(steps * sparsify_after)
    for step, batch in enumerate(batches):
        if step >= steps:
            break
        params, opt_state, loss, aux = _update(model, opt, params, opt_state,
                                               batch, step >= sparsify_step)
        lv = float(loss)
        if not math.isfinite(lv):
            params = last_good
            opt_state = opt.init(params)
            nan_restarts += 1
            continue
        last_good = params
        history.append(lv)
        if log_every and step % log_every == 0:
            print(f"  step {step:5d}  loss {lv:.6f}  " + " ".join(
                f"{k}={float(v):.5f}" for k, v in aux.items()))
        if post_step is not None:
            params = post_step(step, params)
    return FitResult(params=params, history=history,
                     nan_restarts=nan_restarts)
