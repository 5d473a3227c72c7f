"""Fleet digital twinning: many independent MERINDA instances in one call.

Params stay stacked on a leading slot axis (every leaf [F, ...]); one
`train_step_per_slot` advances every refit slot with one GRU-scan launch
over per-slot weights and one RK4 launch over the folded [F * B] windows.

Per-slot gradients come from the SUM of the per-slot losses: slots share no
operation, so each slot's gradient is its own (what JAX gets from `vmap`
over `value_and_grad`).  Clipping is per slot, and a slot whose step is
non-finite gets zero gradients so NaNs never reach its params.  The JAX
sharding annotations have no counterpart on one GPU and are dropped.

`reset_slot` writes the slot's rows IN PLACE (JAX's `.at[].set` copies);
`train_step_per_slot` returns a new state and leaves its input alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.merinda import Merinda, MerindaConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.train.optimizer import (adamw, apply_updates, tree_leaves,
                                         tree_map, tree_unflatten)

__all__ = ["FleetConfig", "FleetMerinda"]


@dataclass(frozen=True)
class FleetConfig:
    merinda: MerindaConfig
    fleet: int                  # number of concurrent twins (refit slots)
    windows_per_twin: int = 32  # S_B per twin per step
    lr: float = 3e-3
    sparsify_after: int = 200   # per-slot warmup steps before the top-k mask
    grad_clip: float = 1.0      # per-twin gradient clip


class FleetMerinda:
    def __init__(self, cfg: FleetConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Merinda(cfg.merinda)
        # clipping is PER TWIN in train_step_per_slot: a global clip would
        # couple slots through the norm
        self.opt = adamw(lr=cfg.lr, clip_norm=None)

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator | None = None, params=None):
        """Fresh fleet state.  `params` (stacked, leaves [F, ...]) is taken
        as given; otherwise each slot draws from `generator` in turn."""
        if params is None:
            draws = [self.model.init(generator) for _ in range(self.cfg.fleet)]
            params = tree_map(lambda *xs: torch.stack(xs), *draws)
        params = tree_map(lambda p: p.to(self.device, torch.float32), params)
        return {"params": params, "opt": self.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device),
                "steps": torch.zeros((self.cfg.fleet,), dtype=torch.int32,
                                     device=self.device)}

    # ------------------------------------------------------------------ #
    def slot_grads(self, params, y_win, u_win, sparsify):
        """Per-slot (loss [F], ok [F], grads): gradients of the summed
        per-slot losses, clipped to `grad_clip` per slot, and zeroed (with
        the loss) for slots whose step is non-finite."""
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = self.model.loss(params, (y_win, u_win), sparsify)
            leaves = tree_leaves(params)
            grads = torch.autograd.grad(loss.sum(), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss = loss.detach()
        F = loss.shape[0]
        per_slot = lambda v, g: v.reshape((F,) + (1,) * (g.ndim - 1))
        # per-slot clip_by_global_norm, then the finite check on the clipped
        # grads (an inf gradient makes its slot's scale 0 and the grad NaN)
        sq = 0
        for g in grads:
            sq = sq + torch.sum(torch.square(g.float()).reshape(F, -1), dim=1)
        scale = torch.clamp(self.cfg.grad_clip / (torch.sqrt(sq) + 1e-9),
                            max=1.0)
        grads = [g * per_slot(scale, g) for g in grads]
        ok = torch.isfinite(loss)
        for g in grads:
            ok = ok & torch.isfinite(g).reshape(F, -1).all(dim=1)
        grads = [torch.where(per_slot(ok, g), g, torch.zeros_like(g))
                 for g in grads]
        return (torch.where(ok, loss, torch.zeros_like(loss)), ok,
                tree_unflatten(params, grads))

    def train_step_per_slot(self, state, y_win, u_win):
        """One step for every slot.  y_win [F, S_B, k+1, n], u_win
        [F, S_B, k, m].  The sparsify warmup is per slot.  Returns (state,
        loss [F], ok [F]); loss is 0 where the step was skipped."""
        sparsify = state["steps"] > self.cfg.sparsify_after     # [F] bool
        loss, ok, grads = self.slot_grads(state["params"], y_win, u_win,
                                          sparsify)
        updates, opt = self.opt.update(grads, state["opt"], state["params"])
        return ({"params": apply_updates(state["params"], updates),
                 "opt": opt, "step": state["step"] + 1,
                 "steps": state["steps"] + 1}, loss, ok)

    def train_step(self, state, y_win, u_win):
        """One step for every slot; returns the mean loss over slots whose
        step was finite."""
        state, loss, ok = self.train_step_per_slot(state, y_win, u_win)
        return state, torch.sum(loss) / torch.clamp(torch.sum(ok), min=1)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def reset_slot(self, state, slot: int, fresh=None, y_win=None,
                   u_win=None, generator: torch.Generator | None = None):
        """Re-initialize slot `slot` IN PLACE (admission of a new twin).

        `fresh` holds the slot's new random leaves (drawn from `generator`
        when None).  With the admitted twin's windows [N, k+1, n] given, the
        slot's norm stats are computed from them — the random leaves never
        depend on them.  Adam moments of the slot are zeroed; the shared
        bias-correction step stays global.
        """
        if fresh is None:
            fresh = self.model.init(generator)
        if y_win is not None:
            fresh = {**fresh, "norm": self.model.norm_stats(y_win, u_win)}
        for dst, src in zip(tree_leaves(state["params"]), tree_leaves(fresh)):
            dst[slot] = src.to(dst.device, dst.dtype)
        for moments in (state["opt"].mu, state["opt"].nu):
            for leaf in tree_leaves(moments):
                leaf[slot] = 0.0
        state["steps"][slot] = 0
        return state

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def recover_all(self, state, y_win, u_win):
        """Batched model extraction, no polish: theta [F, n, L]."""
        return self.model.recover(state["params"], y_win, u_win)

