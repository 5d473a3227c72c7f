"""Mixture-of-Experts: group-wise top-k routing with capacity, GShard-style
einsum dispatch and combine, as the JAX package's models/moe.py.

Tokens are reshaped to G groups of n, each token's top-k experts take the
next free slot of their expert's capacity C = ceil(top_k * n *
capacity_factor / E) in the group (slot-sequential: every token's first
choice before any second choice), and overflowing assignments are dropped.
The dispatch one-hot [G, n, E, C] gathers each expert's capacity buffer,
the experts' FFNs run as batched products over E, and the combine weights
scatter the outputs back.  The JAX package has no Pallas kernel here: its
products are einsums, and so are these (one code path on the card and on
the CPU).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _GATED, _PLAIN, dense_init

__all__ = ["moe_init", "moe_apply", "router_topk", "moe_groups"]


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             mlp_kind: str = "swiglu", dtype=torch.float32) -> dict:
    """Expert stacks [E, d_in, d_out] in `dtype`, truncated-normal (+-2
    sigma) at fan-in scale, drawn in f32 an expert at a time (arctic's
    [128, 7168, 4864] stack would need 18 GB of f32 at once); the router
    stays f32 whatever `dtype` is, as in the JAX package."""
    dev = gen.device

    def expert_mat(d_in, d_out):
        s = 1.0 / math.sqrt(d_in)
        out = torch.empty((n_experts, d_in, d_out), dtype=dtype, device=dev)
        w = torch.empty((d_in, d_out), dtype=torch.float32, device=dev)
        for e in range(n_experts):
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            out[e].copy_(w * s)
        return {"w": out}

    p = {"router": dense_init(gen, d_model, n_experts, torch.float32),
         "experts": {"up": expert_mat(d_model, d_ff),
                     "down": expert_mat(d_ff, d_model)}}
    if mlp_kind in _GATED:
        p["experts"]["gate"] = expert_mat(d_model, d_ff)
    return p


def router_topk(logits, top_k: int, capacity: int):
    """logits [G, n, E] -> (combine [G, n, E, C] f32, aux loss, a 0-dim
    f32 tensor).

    Softmax in f32; the top-k renormalised over themselves (mixtral); the
    Switch load-balancing loss E * sum_e f_e * p_e from the first choice.
    Ties go to the lower expert index, as jax.lax.top_k's (a stable
    descending sort; torch.topk does not promise an order).  A position
    outside [0, C) -- a dropped assignment, or -1 for a token not on this
    expert -- has no one-hot row in the JAX package; F.one_hot raises on
    it, so the index is clamped and the row zeroed by the keep mask.
    """
    G, n, E = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = top.values[..., :top_k], top.indices[..., :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=1)                                      # [G, E]
    ce = F.one_hot(topi[..., 0], E).to(torch.float32).mean(dim=1)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))

    counts = torch.zeros((G, 1, E), dtype=torch.float32, device=logits.device)
    combine = torch.zeros((G, n, E, capacity), dtype=torch.float32,
                          device=logits.device)
    for j in range(top_k):
        ohj = F.one_hot(topi[..., j], E).to(torch.float32)      # [G, n, E]
        pos = torch.cumsum(ohj, dim=1) - 1.0 + counts           # [G, n, E]
        keep = ohj * (pos < capacity)
        pc = F.one_hot(pos.to(torch.long).clamp(0, capacity - 1),
                       capacity).to(torch.float32)              # [G,n,E,C]
        combine = combine + topv[..., j, None, None] * pc * keep[..., None]
        counts = counts + ohj.sum(dim=1, keepdim=True)
    return combine, aux


def moe_groups(N: int, n_experts: int, top_k: int, capacity_factor: float,
               group_size: int):
    """(G, n, C) for N tokens: G = N // min(group_size, N) groups of n = N //
    G tokens, capacity C per expert and group.  Raises ValueError where G
    does not divide N: the JAX package's reshape fails there too (N = 1,025
    at group 512 is 2 groups of 512 and one token left over)."""
    gs = min(group_size, N)
    G = max(N // gs, 1)
    n = N // G
    if G * n != N:
        raise ValueError(
            f"moe_apply: {N} tokens do not split into {G} groups of {n} "
            f"(group_size {group_size}); the token count must be below "
            f"{2 * group_size} or a multiple of the group count")
    C = max(int(math.ceil(top_k * n * capacity_factor / n_experts)), 1)
    return G, n, C


def moe_apply(params, x, *, n_experts: int, top_k: int = 2,
              capacity_factor: float = 1.25, group_size: int = 512,
              mlp_kind: str = "swiglu"):
    """x [B, T, d] -> (y [B, T, d], aux loss).  The router product runs in
    the activation dtype (its f32 weights cast), the routing in f32, and the
    four einsums in the input dtype, as in the JAX package."""
    B, T, d = x.shape
    G, n, C = moe_groups(B * T, n_experts, top_k, capacity_factor,
                         group_size)
    xg = x.reshape(G, n, d)
    logits = torch.matmul(xg, params["router"]["w"].to(x.dtype)
                          ).to(torch.float32)
    combine, aux = router_topk(logits, top_k, C)                # [G,n,E,C]
    dispatch = (combine > 0).to(x.dtype)

    xd = torch.einsum("gnd,gnec->gecd", xg, dispatch)
    we = params["experts"]
    up = torch.einsum("gecd,edf->gecf", xd, we["up"]["w"])
    if mlp_kind in _GATED:
        gate = torch.einsum("gecd,edf->gecf", xd, we["gate"]["w"])
        h = _GATED[mlp_kind](gate) * up
    else:
        h = _PLAIN[mlp_kind](up)
    yd = torch.einsum("gecf,efd->gecd", h, we["down"]["w"])
    y = torch.einsum("gecd,gnec->gnd", yd, combine.to(x.dtype))
    return y.reshape(B, T, d), aux
