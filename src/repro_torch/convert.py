"""Carry weights and optimizer state across from the JAX package.

Both functions take host trees of numpy arrays (the JAX pytrees after
`np.asarray` on every leaf) and return the port's tensors, so a test can
start the port from the JAX package's own random draws.  Nothing here
imports JAX: the JAX `AdamState` is a NamedTuple, unpacked positionally as
(step, mu, nu).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.train.optimizer import AdamState

__all__ = ["merinda_params_from_jax", "fleet_state_from_jax"]


def _tensors(tree, device, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def merinda_params_from_jax(tree, device="cpu") -> dict:
    """`Merinda.init` params ({"gru", "head", "norm"} of arrays, optionally
    with a leading fleet axis) -> the port's nested dict of float32
    tensors."""
    return _tensors(tree, device)


def fleet_state_from_jax(state, device="cpu") -> dict:
    """`FleetMerinda.init` state ({"params", "opt": AdamState(step, mu, nu),
    "step", "steps"}) -> the port's fleet state."""
    step, mu, nu = state["opt"]
    return {
        "params": merinda_params_from_jax(state["params"], device),
        "opt": AdamState(step=_tensors(step, device, torch.int32),
                         mu=_tensors(mu, device), nu=_tensors(nu, device)),
        "step": _tensors(state["step"], device, torch.int32),
        "steps": _tensors(state["steps"], device, torch.int32),
    }
