"""Train state and the generic (microbatched, compressible) train step.

The JAX package's train/train_state.py.  `make_train_step(loss_fn, opt)`
builds the step every launcher runs: the gradient of `loss_fn` by
autograd, gradient accumulation over microbatches (a Python loop where JAX
scans: peak activation and logit memory divides by `grad_accum`), an
optional compressor with its error-feedback state under state["comp"]
(distributed/compression.py), then the optimizer update.  PyTorch runs
eagerly, so there is nothing to compile; on the card the step is as many
kernel launches as its ops.

`donate=True` is JAX's buffer donation: the step consumes the state it is
given, writing the new parameters and optimizer moments into its tensors
(train/optimizer.py), so a 3.1B-parameter AdamW step holds one copy of
them.  The numbers are the same as without it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.optimizer import (Optimizer, apply_updates,
                                         tree_leaves, tree_map,
                                         tree_unflatten)

__all__ = ["init_state", "make_train_step", "value_and_grad"]

PyTree = Any


def init_state(params: PyTree, opt: Optimizer) -> dict:
    device = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def value_and_grad(loss_fn: Callable, params: PyTree, batch):
    """((loss, metrics), grads) of loss_fn(params, batch) -> (loss, metrics
    dict), as `jax.value_and_grad(..., has_aux=True)`: grads shaped like
    params, zeros for a leaf the loss does not reach; loss and metrics
    detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def rs(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{n} microbatches")
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    split = {k: rs(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def make_train_step(loss_fn: Callable, opt: Optimizer, *, grad_accum: int = 1,
                    compressor=None, accum_dtype=torch.float32,
                    donate: bool = False) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict).

    Returns train_step(state, batch) -> (state, metrics).  When
    `grad_accum > 1` the batch (a dict of tensors) is split along axis 0,
    the microbatches' gradients are summed into an `accum_dtype` buffer and
    averaged, the loss averaged; the other metrics are the last
    microbatch's.  `compressor` (optional) maps grads -> grads with
    persistent error state under state["comp"].  `donate`: the step
    consumes `state` (module docstring)."""

    def train_step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for mb in _split_microbatches(batch, grad_accum):
                (lm, metrics), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = loss + lm
            inv = 1.0 / grad_accum
            grads = tree_map(lambda g: g * inv, grads)
            loss = loss * inv

        new_state = dict(state)
        if compressor is not None:
            grads, new_state["comp"] = compressor.apply(grads,
                                                        state.get("comp"))
        with torch.no_grad():
            updates, new_state["opt"] = opt.update(grads, state["opt"],
                                                   params, donate=donate)
            del grads
            new_state["params"] = apply_updates(params, updates,
                                                donate=donate)
        new_state["step"] = state["step"] + 1
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
