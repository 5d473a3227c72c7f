"""Cell builders: one program per (arch x shape), as the JAX package's
launch/cells.py.

A *cell* is the unit of the dry-run: for an architecture and an input
shape this module produces (fn, arg_specs) such that `fn(*arg_specs)` is
the program the launcher runs on the card, here on meta tensors:
  * train_*   -> make_train_step(loss, opt, grad_accum, donate=True) over
                 the train state's specs
  * prefill_* -> prefill emitting the caches
  * decode_*  -> one-token decode_step against a filled cache
`trace_cell` runs it under the op counter (launch/opcount.py), the
counterpart of JAX's `lower_cell`: nothing is allocated on any device.
The spec trees of `in_shardings` / `out_shardings` are the one-card
rules' (distributed/sharding.py), kept for the record.  GRAD_ACCUM,
ADAFACTOR_ARCHS, SEQ_KV_ARCHS define the program and are JAX's values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, ArchSpec, Shape, get_arch
from repro_torch.distributed.sharding import (P, ShardingRules, axis_rules,
                                              cache_shardings,
                                              logical_to_sharding,
                                              param_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.opcount import OpCounter
from repro_torch.models.zoo import ModelApi, build
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.optimizer import adafactor, adamw
from repro_torch.train.train_state import make_train_step, state_specs

__all__ = ["Cell", "build_cell", "trace_cell", "GRAD_ACCUM",
           "ADAFACTOR_ARCHS", "SEQ_KV_ARCHS"]

# Microbatching per arch for train_4k: keeps the live logits microbatch
# ([B/ga, T, V/tp] f32) and MoE dispatch buffers inside HBM (see
# EXPERIMENTS.md §Dry-run for the measured per-device bytes).
GRAD_ACCUM = {
    "gemma3-12b": 16,       # 262k vocab
    "qwen3-8b": 8,          # 152k vocab
    "chameleon-34b": 16,    # d_model 8192: layer-scan residual stack
    "arctic-480b": 16,      # 1.9B params/chip at 256 chips: see EXPERIMENTS
                            # (32 was tried: -2 GiB memory but 3.8x wire —
                            # refuted; §Perf)
    "mixtral-8x22b": 16,    # 56 layers x d 6144 residual stack
    "starcoder2-15b": 8,    # d 6144 residual stack (40L)
    "whisper-large-v3": 4,
    "default": 4,
}

# Adafactor where AdamW's 8 bytes/param of moments cannot fit 16 GB/chip.
ADAFACTOR_ARCHS = {"arctic-480b"}

# Sequence-shard K/V during training (ring-attention-style): K/V heads (8)
# cannot split over model=16, and the flash tiles + expert buffers leave no
# headroom for replicated KV at 56 layers.  Costs ~10% wire; measured in
# §Perf (mixtral hillclimb).
SEQ_KV_ARCHS = {"mixtral-8x22b"}


@dataclass
class Cell:
    arch: str
    shape: Shape
    fn: Callable
    arg_specs: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple
    api: ModelApi
    n_params: int
    n_active_params: int
    rules: ShardingRules | None = None   # per-cell act-rule overrides


def _count_params(specs) -> tuple[int, int]:
    """(total, active) param counts; MoE experts count top_k/E as active."""
    total = active = 0
    leaves, paths = tree_flatten(specs)
    for leaf, path in zip(leaves, paths):
        n = leaf.numel()
        total += n
        if "experts" in path.split("/"):
            continue  # added below at active ratio
        active += n
    return total, active


def _moe_active(api: ModelApi, total: int, dense_active: int) -> int:
    cfg = api.cfg
    if not cfg.n_experts:
        return dense_active
    expert_total = total - dense_active
    return dense_active + expert_total * cfg.top_k // cfg.n_experts


def _model_flops(cell, shape) -> float:
    """MODEL_FLOPS convention: 6*N*D train, 2*N*D inference (N = active
    params for MoE); attention flops excluded (recorded convention)."""
    n = cell.n_active_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token/sample


def _batch_shardings(rules, batch_specs):
    return {k: logical_to_sharding(P(("pod", "data"),
                                     *([None] * (v.ndim - 1))),
                                   rules.mesh, tuple(v.shape))
            for k, v in batch_specs.items()}


def _opt_for(arch: str, lr: float = 1e-4):
    if arch in ADAFACTOR_ARCHS:
        return adafactor(lr=lr)
    return adamw(lr=lr, weight_decay=0.1)


def build_cell(arch: str, shape_name: str | Shape,
               rules: ShardingRules | None = None, *,
               grad_accum: int | None = None,
               cfg_overrides: dict | None = None) -> Cell:
    """The cell of `arch` at `shape_name` (a key of SHAPES, or a Shape of
    one's own, e.g. a launcher's batch); `rules` default to the one-card
    mesh's."""
    spec: ArchSpec = get_arch(arch)
    shape = shape_name if isinstance(shape_name, Shape) else \
        SHAPES[shape_name]
    if shape.name in spec.skip_shapes:
        raise ValueError(f"{arch} skips {shape.name}: "
                         f"{spec.skip_shapes[shape.name]}")
    rules = rules or ShardingRules(mesh=make_production_mesh())
    cfg = spec.config
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    if arch in SEQ_KV_ARCHS:
        act = dict(rules.act)
        act["kv_bt"] = P(("pod", "data"), "model", None, None)
        rules = ShardingRules(mesh=rules.mesh, act=act, params=rules.params)
    B, T = shape.global_batch, shape.seq_len
    api = build(cfg, max_position=T)
    p_specs = api.param_specs()
    p_shard = param_shardings(rules, p_specs, api.stack_key)
    total, dense_active = _count_params(p_specs)
    active = _moe_active(api, total, dense_active)

    if shape.kind == "train":
        ga = grad_accum or GRAD_ACCUM.get(arch, GRAD_ACCUM["default"])
        opt = _opt_for(arch)
        # arctic: accumulate in bf16, as the JAX package does
        accum_dtype = (torch.bfloat16 if arch in ADAFACTOR_ARCHS
                       else torch.float32)
        fn = make_train_step(api.loss, opt, grad_accum=ga,
                             accum_dtype=accum_dtype, donate=True)
        s_specs = state_specs(p_specs, opt)
        s_shard = param_shardings(rules, s_specs, api.stack_key)
        b_specs = api.batch_specs(B, T)
        b_shard = _batch_shardings(rules, b_specs)
        return Cell(arch, shape, fn, (s_specs, b_specs),
                    (s_shard, b_shard), (s_shard, None), (0,), api,
                    total, active, rules)

    if shape.kind == "prefill":
        def fn(params, batch):
            return api.prefill(params, batch, T)

        b_specs = api.batch_specs(B, T)
        b_shard = _batch_shardings(rules, b_specs)
        c_specs = api.cache_specs(B, T)
        c_shard = cache_shardings(rules, c_specs, batch=B)
        logits_shard = logical_to_sharding(
            P(("pod", "data"), "model"), rules.mesh, (B, cfg.vocab))
        return Cell(arch, shape, fn, (p_specs, b_specs),
                    (p_shard, b_shard), (c_shard, logits_shard), (), api,
                    total, active, rules)

    # decode: one new token against a cache of seq_len.
    def fn(params, cache, tokens1):
        return api.decode(params, cache, tokens1)

    c_specs = api.cache_specs(B, T)
    c_shard = cache_shardings(rules, c_specs, batch=B)
    t_specs = torch.empty((B,), dtype=torch.int32, device="meta")
    t_shard = logical_to_sharding(P(("pod", "data")), rules.mesh, (B,))
    logits_shard = logical_to_sharding(
        P(("pod", "data"), "model"), rules.mesh, (B, cfg.vocab))
    return Cell(arch, shape, fn, (p_specs, c_specs, t_specs),
                (p_shard, c_shard, t_shard), (c_shard, logits_shard), (1,),
                api, total, active, rules)


def trace_cell(cell: Cell) -> OpCounter:
    """Run the cell's program on its meta specs under the op counter and
    return the counter.  The specs are consumed: a train cell's step
    writes its state in place."""
    with axis_rules(cell.rules), OpCounter() as oc:
        oc.arguments(cell.arg_specs)
        oc.outputs(cell.fn(*cell.arg_specs))
    return oc
