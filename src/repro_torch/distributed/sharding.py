"""Sharding rules on one GPU: logical activation and parameter names ->
mesh PartitionSpecs, as the JAX package's distributed/sharding.py.

Model code there annotates activations with LOGICAL names (`shard(x,
"act_btd")`) and this module maps them, and every parameter path, onto the
mesh axes ('pod', 'data', 'model'): DP/FSDP over ('pod', 'data'), TP and
EP over 'model', sequence-sharded decode caches.  The rule tables below
are that module's, verbatim.

On one card there is nothing to place, so this port keeps the logic and
drops the placement:
  * `PartitionSpec` is a tuple of entries (an axis name, a tuple of axis
    names, or None per dimension);
  * a mesh is anything with `shape` (axis -> size) and `axis_names`
    (launch/mesh.py's `Mesh`, the one-device stand-in);
  * `logical_to_sharding` returns the repaired spec itself (JAX wraps it
    in a NamedSharding);
  * `shard(x, name)` returns `x`: no torch.distributed, no copies.

The port keeps one parameter dict per layer where JAX stacks each pattern
position's layers into one [n_cycles, ...] leaf.  `param_shardings` with
a model API's `stack_key` gives a per-layer leaf the spec JAX gives its
stacked leaf, minus the stacking axis; the cache's per-layer leaves have
their base rank, so `cache_shardings` gives them the base spec.
"""
from __future__ import annotations

import math
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["PartitionSpec", "P", "axis_rules", "shard", "ShardingRules",
           "param_shardings", "cache_shardings", "logical_to_sharding",
           "DEFAULT_ACT_RULES", "DEFAULT_PARAM_RULES", "active_rules"]

_LOCAL = threading.local()


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of them, or None
    (replicated); `P("data", None)` as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# --------------------------------------------------------------------------- #
# Activation rules: logical name -> PartitionSpec (tuple entries = multi-axis)
# --------------------------------------------------------------------------- #
DEFAULT_ACT_RULES: dict[str, P] = {
    # [B, T, d_model] residual stream: batch over pod+data, d replicated.
    # (Megatron-style sequence parallelism — T over 'model' — was measured
    # and REJECTED as the default: qwen3 train memory 8.1 -> 2.6 GiB but
    # wire bytes 3.2x and roofline fraction 0.072 -> 0.023; see §Perf.)
    "act_btd": P(("pod", "data"), None, None),
    # [B, T, d_ff] / moe hidden: hidden over model (TP).
    "act_ffn": P(("pod", "data"), None, "model"),
    # [B, T, V] logits: vocab over model.
    "act_btv": P(("pod", "data"), None, "model"),
    # [B, T, H, dh] attention heads over model.
    "act_bthd": P(("pod", "data"), None, "model", None),
    # [B, H, T, dh]
    "act_bhtd": P(("pod", "data"), "model", None, None),
    # KV cache (prefill/train): [B, T, kv, dh] heads over model when divisible.
    "kv_bt": P(("pod", "data"), None, "model", None),
    # decode KV cache: sequence-sharded over model (flash-decode).
    "kv_seq": P(("pod", "data"), "model", None, None),
    # long-context (B=1) decode cache: sequence over every axis.
    "kv_seq_all": P(None, ("pod", "data", "model"), None, None),
    # MoE grouped tokens [G, n, d]: groups over pod+data+model.
    "act_gnd": P(("pod", "data"), None, None),
    # MoE dispatched [G, E, C, d] / hidden [G, E, C, f]: E over model.
    "act_gecd": P(("pod", "data"), "model", None, None),
    "act_gecf": P(("pod", "data"), "model", None, None),
    # MoE combine/dispatch one-hots [G, n, E, C].
    "act_gnec": P(("pod", "data"), None, "model", None),
    # recurrent state [B, H, K, V(head)] (rwkv6 / mamba2): heads over model.
    "state_bhkv": P(("pod", "data"), "model", None, None),
    # ---- online twin serving (twin/*): every per-twin / per-slot axis is
    # data-parallel over ('pod','data'), mirroring the FleetMerinda fleet
    # axis, so one sharded TwinServer tick advances every shard's slots. ----
    # telemetry rings [S, cap, n|m] and their write heads [S].
    "twin_ring": P(("pod", "data"), None, None),
    "twin_count": P(("pod", "data")),
    # serving theta store [S, n, L].
    "twin_theta": P(("pod", "data"), None, None),
    # refit window batches [F, S_B, k(+1), n|m] (fleet axis leading).
    "twin_windows": P(("pod", "data"), None, None, None),
    # per-slot scalars [F]: step counters, losses.
    "twin_fleet": P(("pod", "data")),
}

# --------------------------------------------------------------------------- #
# Param rules: path regex -> PartitionSpec.  First match wins; matched against
# "/"-joined tree paths like "layers/attn/wq/w".
# --------------------------------------------------------------------------- #
DEFAULT_PARAM_RULES: list[tuple[str, P]] = [
    # adafactor factored stats: expert stats sharded, the rest replicated
    # (they are O(d_in + d_out) — tiny except for the expert stack).
    (r".*opt/v[rc]/.*experts/(gate|up|down)/w$", P(None, "model", "data")),
    (r".*opt/v[rc]/.*", P()),
    # embeddings / unembed: vocab over model, d over data (FSDP).
    (r".*(embed|unembed|lm_head|dec_pos)/w$", P("model", "data")),
    # attention projections: qkv column-parallel, out row-parallel.
    (r".*(wq|wk|wv|wr|wg|wqkv|in_proj)/w$", P("data", "model")),
    (r".*(wo|out_proj)/w$", P("model", "data")),
    # MoE experts: [E, d_in, d_out] expert axis over model, d_in over data.
    (r".*experts/(gate|up)/w$", P("model", "data", None)),
    (r".*experts/down/w$", P("model", None, "data")),
    (r".*router/w$", P("data", None)),
    # MLP: column-parallel up/gate, row-parallel down.
    (r".*(gate|up)/w$", P("data", "model")),
    (r".*down/w$", P("model", "data")),
    # mamba2 / rwkv6 fused projections.
    (r".*(xproj|zproj|dt_proj|abc_proj)/w$", P("data", "model")),
    (r".*(time_mix|decay|bonus).*", P()),
    (r".*conv/.*", P()),
    # norms / scalars / biases: replicated.
    (r".*", P()),
]


@dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    act: dict[str, P] = field(default_factory=lambda: dict(DEFAULT_ACT_RULES))
    params: tuple = tuple(DEFAULT_PARAM_RULES)

    def act_spec(self, name: str) -> P:
        return self.act[name]


def _strip_missing_axes(spec: P, mesh) -> P:
    """Drop mesh axes the current mesh does not define (e.g. 'pod' on the
    single-pod mesh) so one rule set serves every mesh."""
    names = set(mesh.axis_names)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def _axes_size(entry, mesh) -> int:
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return math.prod(mesh.shape[a] for a in axes)


def _shardable(dim: int, entry, mesh) -> bool:
    size = _axes_size(entry, mesh)
    return size <= 1 or dim % size == 0


def logical_to_sharding(spec: P, mesh, shape=None, repair: bool = False,
                        pad_ok: bool = False) -> P:
    """The spec `spec` takes on `mesh` for a leaf of `shape`: axes the mesh
    lacks dropped, axes that do not divide their dimension dropped (kept
    when `pad_ok` and the dimension is at least the axis size: JAX pads
    activations), and with `repair` each dropped axis moved to the largest
    free dimension it divides (mixtral's 8 experts over model=16 shard the
    expert FFN dimension instead)."""
    spec = _strip_missing_axes(spec, mesh)
    if shape is not None:
        entries = list(spec) + [None] * (len(shape) - len(spec))
        dropped: list = []
        for i, (d, e) in enumerate(zip(shape, entries)):
            if _shardable(d, e, mesh):
                continue
            if pad_ok and d >= _axes_size(e, mesh):
                continue
            dropped.append(e)
            entries[i] = None
        if repair and dropped:
            for e in dropped:
                size = _axes_size(e, mesh)
                cands = [i for i, (d, cur) in enumerate(zip(shape, entries))
                         if cur is None and d % size == 0 and d >= size]
                if cands:
                    target = max(cands, key=lambda i: shape[i])
                    entries[target] = e
        spec = P(*entries)
    return spec


# --------------------------------------------------------------------------- #
# Context + activation annotation
# --------------------------------------------------------------------------- #
@contextmanager
def axis_rules(rules: ShardingRules | None):
    prev = getattr(_LOCAL, "rules", None)
    _LOCAL.rules = rules
    try:
        yield rules
    finally:
        _LOCAL.rules = prev


def active_rules() -> ShardingRules | None:
    return getattr(_LOCAL, "rules", None)


def shard(x, name: str):
    """The JAX package's activation constraint: `x` itself, on one card
    inside rules or out (there is nothing to place)."""
    del name
    return x


# --------------------------------------------------------------------------- #
# Param tree -> spec tree
# --------------------------------------------------------------------------- #
def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map_with_path(fn: Callable, node, path: tuple = ()):
    """fn(path, leaf) over nested dicts, NamedTuples, lists and tuples;
    a path is train/checkpoint.py's: keys, indices and field names."""
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_map_with_path(fn, v, path + (name,))
                            for name, v in zip(node._fields, node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(node))
    if node is None:
        return None
    return fn(path, node)


def _leaves_with_path(tree) -> list[tuple[tuple, Any]]:
    out: list = []
    _map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def cache_shardings(rules: ShardingRules, cache: Any, *, batch: int) -> Any:
    """Decode/prefill cache tree -> specs: KV caches sequence-sharded over
    'model' (over the whole mesh at batch == 1), recurrent states batch
    over ('pod', 'data') and heads over 'model' where divisible.  Extra
    leading axes (JAX's stacked layers) get None; the port's per-layer
    leaves have the base rank."""
    mesh = rules.mesh
    bd = ("pod", "data")
    seq = ("pod", "data", "model") if batch == 1 else "model"
    BASE = {
        "k": (4, P(bd, seq, None, None)),
        "v": (4, P(bd, seq, None, None)),
        "pos": (2, P(bd, seq)),
        "wkv": (4, P(bd, "model", None, None)),
        "ssm": (4, P(bd, "model", None, None)),
        "conv": (3, P(bd, None, None)),
        "tm_last": (2, P(bd, None)),
        "cm_last": (2, P(bd, None)),
    }

    def assign(path, leaf):
        last = path[-1] if path else ""
        shape = tuple(leaf.shape)
        if last == "pos" and leaf.ndim == 1:          # top-level position
            return logical_to_sharding(P(bd), mesh, shape)
        if last not in BASE:
            raise AssertionError(f"no cache rule for {'/'.join(path)}")
        base_rank, spec = BASE[last]
        missing = len(shape) - base_rank
        spec = P(*([None] * missing), *spec)
        return logical_to_sharding(spec, mesh, shape)

    return _map_with_path(assign, cache)


_STACKED = ("layers", "enc_layers", "dec_layers")


def param_shardings(rules: ShardingRules, params: Any,
                    stack_key: Callable | None = None) -> Any:
    """Map a params(-shaped) tree -- params, or a train state -- to specs
    by the path rules (first match wins).  Rules are written for the
    per-layer rank: extra leading dimensions get None, and a rule longer
    than the leaf keeps its last entries.

    With `stack_key` (a model API's), a leaf is matched as the JAX leaf it
    is a slice of: at that leaf's path, and when JAX stacks it over the
    cycles (the key names "layers", "enc_layers" or "dec_layers"), at the
    stacked shape (n, *shape), n the number of leaves sharing the key; the
    leaf gets that spec without its first entry.  Without it, every leaf
    is taken as it is (a tree in JAX's layout)."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules.params]

    def spec_for(name: str, shape: tuple) -> P:
        for pat, spec in compiled:
            if pat.match(name):
                missing = len(shape) - len(spec)
                if missing > 0:
                    spec = P(*([None] * missing), *spec)
                elif missing < 0:
                    spec = P(*list(spec)[-len(shape):] if shape else ())
                return logical_to_sharding(spec, rules.mesh, shape,
                                           repair=True)
        raise AssertionError(f"no param rule matched {name}")

    if stack_key is None:
        return _map_with_path(
            lambda path, leaf: spec_for("/".join(path), tuple(leaf.shape)),
            params)

    keys = {path: stack_key("/".join(path))
            for path, _ in _leaves_with_path(params)}
    counts: dict = {}
    for key in keys.values():
        counts[key] = counts.get(key, 0) + 1

    def assign(path, leaf):
        key = keys[path]
        name = "/".join(str(k) for k in key)
        shape = tuple(leaf.shape)
        if any(k in _STACKED for k in key):
            return P(*spec_for(name, (counts[key], *shape))[1:])
        return spec_for(name, shape)

    return _map_with_path(assign, params)
