"""Carry weights and optimizer state across from the JAX package.

Every function takes a host tree of numpy arrays (the JAX pytree after
`np.asarray` on every leaf) and returns the port's tensors, so a test can
start the port from the JAX package's own random draws.  Nothing here
imports JAX: the JAX `AdamState` is a NamedTuple, unpacked positionally as
(step, mu, nu).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.train.optimizer import AdamState

__all__ = ["merinda_params_from_jax", "baseline_params_from_jax",
           "fleet_state_from_jax", "lm_params_from_jax",
           "whisper_params_from_jax", "train_state_from_jax"]


def _tensors(tree, device, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def merinda_params_from_jax(tree, device="cpu") -> dict:
    """`Merinda.init` params ({"gru", "head", "norm"} of arrays, optionally
    with a leading fleet axis) -> the port's nested dict of float32
    tensors."""
    return _tensors(tree, device)


def baseline_params_from_jax(tree, device="cpu") -> dict:
    """`Emily.init` ({"mlp": [{"w", "b"}, ...]}) or `PinnSR.init` params
    ({"mlp", "freqs", "y_mu", "y_sigma", "theta", "mask"}) -> the port's
    dicts and lists of float32 tensors."""
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


def _cycle(tree, c: int):
    if isinstance(tree, dict):
        return {k: _cycle(v, c) for k, v in tree.items()}
    return np.asarray(tree)[c]


def _lm_tensors(tree, device, dtype):
    """Leaves as `dtype` tensors, except an MoE router's, which stays f32
    whatever the model's dtype (as the JAX package draws it)."""
    if isinstance(tree, dict):
        return {k: _lm_tensors(v, device,
                               torch.float32 if k == "router" else dtype)
                for k, v in tree.items()}
    # via f32: torch cannot read numpy's bfloat16 (ml_dtypes) arrays
    return torch.tensor(np.asarray(tree, dtype=np.float32),
                        device=device).to(dtype)


def lm_params_from_jax(tree, cfg, device="cpu") -> dict:
    """`transformer.init_params` params of the JAX package -> the port's.

    JAX stacks each pattern position's layers as [n_cycles, ...] leaves
    under tree["layers"] (a list over pattern positions) plus an unstacked
    tree["tail"]; the port keeps one dict per layer in depth order.
    Zamba2's shared block (tree["shared"], one dict) is carried as it is,
    and so are an MoE layer's "moe" leaves (the expert stacks [n_cycles, E,
    d, f] split per layer like any other) and arctic's dense "ffn".  Leaves
    become tensors of `cfg.dtype` (a torch dtype) on `device`, the MoE
    router f32.
    """
    p = len(cfg.pattern)
    layers = [_cycle(tree["layers"][i], c) for c in range(cfg.cycles)
              for i in range(p)] + list(tree.get("tail", []))
    conv = lambda t: _lm_tensors(t, device, cfg.dtype)
    out = {"embed": conv(tree["embed"]),
           "layers": [conv(layer) for layer in layers],
           "final_norm": conv(tree["final_norm"])}
    if "shared" in tree:
        out["shared"] = conv(tree["shared"])
    if "unembed" in tree:
        out["unembed"] = conv(tree["unembed"])
    return out


def whisper_params_from_jax(tree, cfg, device="cpu") -> dict:
    """`encdec.whisper_init` params of the JAX package -> the port's: the
    stacked [L, ...] leaves of tree["enc_layers"] and tree["dec_layers"]
    become lists of per-layer dicts; "embed", "dec_pos", "enc_norm" and
    "dec_norm" are carried as they are, all as `cfg.dtype` on `device`."""
    conv = lambda t: _lm_tensors(t, device, cfg.dtype)
    out = {k: conv(tree[k])
           for k in ("embed", "dec_pos", "enc_norm", "dec_norm")}
    for side, n in (("enc_layers", cfg.enc_layers),
                    ("dec_layers", cfg.n_layers)):
        out[side] = [conv(_cycle(tree[side], i)) for i in range(n)]
    return out


def train_state_from_jax(state, cfg, device="cpu") -> dict:
    """An LM train state of the JAX package (`train_state.init_state` and
    its steps: {"params", "opt": AdamState(step, mu, nu), "step"}, and
    "comp", the compressor's error state, if present) -> the port's, so a
    port run continues a JAX run.  Params go through `lm_params_from_jax`
    (`whisper_params_from_jax` for an encoder-decoder) in `cfg.dtype`; the
    moments and the error state, which are f32 whatever the model's dtype,
    the same way in f32; the step counters become int32 tensors."""
    conv = whisper_params_from_jax if cfg.enc_layers else lm_params_from_jax
    f32 = cfg.with_(dtype=torch.float32)
    step, mu, nu = state["opt"]
    out = {"params": conv(state["params"], cfg, device),
           "opt": AdamState(step=_tensors(step, device, torch.int32),
                            mu=conv(mu, f32, device),
                            nu=conv(nu, f32, device)),
           "step": _tensors(state["step"], device, torch.int32)}
    if state.get("comp") is not None:
        out["comp"] = conv(state["comp"], f32, device)
    return out
