"""The port's sharding rules (distributed/sharding.py) against the JAX
package's on the same mesh sizes.

JAX's `logical_to_sharding` wraps its spec in a NamedSharding, which needs
a real mesh; here its module's NamedSharding is swapped for a function
returning the spec (monkeypatch, for the test's duration), so JAX's logic
runs on the fake meshes of tests/test_sharding.py and its PartitionSpecs
are compared with the port's tuples.  A spec entry is compared as the
tuple of axis names it names (JAX's PartitionSpec iterates a one-name
tuple as the name).

Cases: tests/test_sharding.py's (strip, shardable, rule order, repair,
cache rank dispatch, the no-op outside rules, a JAX-layout tree on the
one-card mesh), the rule tables verbatim, and at FULL size every
architecture's parameters and AdamW / Adafactor train state on the
16x16 and 2x16x16 meshes: each port leaf gets the spec JAX gives the
stacked leaf it is a slice of (found through `ModelApi.stack_key`), less
the stacking axis; every cache leaf JAX's spec less the stacking axis.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as jsh
from repro.models.zoo import build as jax_build
from repro.train import optimizer as jopt
from repro.train.train_state import state_specs as jax_state_specs
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models.zoo import build
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.train_state import state_specs


class FakeMesh:
    """Duck-typed mesh: just axis names/sizes (enough for spec logic)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))


POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
SINGLE = FakeMesh({"data": 16, "model": 16})
SMALL = FakeMesh({"data": 4, "model": 2})


@pytest.fixture
def jax_specs(monkeypatch):
    """JAX's sharding module returning bare PartitionSpecs."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    return jsh


def _norm(spec) -> tuple:
    """A spec as a tuple of axis-name tuples (None -> ())."""
    out = []
    for e in spec:
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    return tuple(out)


def _jp(spec: P) -> JP:
    return JP(*spec)


def test_rule_tables_are_jax_verbatim():
    assert {k: _norm(v) for k, v in sh.DEFAULT_ACT_RULES.items()} == {
        k: _norm(v) for k, v in jsh.DEFAULT_ACT_RULES.items()}
    assert [(p, _norm(s)) for p, s in sh.DEFAULT_PARAM_RULES] == [
        (p, _norm(s)) for p, s in jsh.DEFAULT_PARAM_RULES]


@pytest.mark.parametrize("mesh", [SMALL, SINGLE, POD],
                         ids=["4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("spec", [P(("pod", "data"), "model"),
                                  P(None, ("pod", "data", "model")),
                                  P("pod", None, "data")])
def test_strip_missing_axes(spec, mesh):
    got = sh._strip_missing_axes(spec, mesh)
    assert _norm(got) == _norm(jsh._strip_missing_axes(_jp(spec), mesh))
    if mesh is SMALL and spec == P(("pod", "data"), "model"):
        assert got == P(("data",), "model")


def test_shardable():
    cases = [(8, "data"), (6, "data"), (6, "model"), (5, None),
             (4, ("data", "model")), (16, ("data", "model")), (1, None)]
    for dim, entry in cases:
        assert sh._shardable(dim, entry, SMALL) == jsh._shardable(
            dim, entry, SMALL), (dim, entry)
    assert sh._shardable(8, "data", SMALL)
    assert not sh._shardable(6, "data", SMALL)
    assert not sh._shardable(4, ("data", "model"), SMALL)


def test_param_rules_order():
    """Expert rules must match before generic gate/up rules, in both."""
    for rules in (sh.DEFAULT_PARAM_RULES, jsh.DEFAULT_PARAM_RULES):
        for path, want in (("layers/0/moe/experts/up/w",
                            (("model",), ("data",), ())),
                           ("layers/0/ffn/up/w", (("data",), ("model",)))):
            spec = next(s for pat, s in rules if re.compile(pat).match(path))
            assert _norm(spec) == want


@pytest.mark.parametrize("kw", [{}, {"repair": True}, {"pad_ok": True},
                                {"repair": True, "pad_ok": True}],
                         ids=["plain", "repair", "pad_ok", "both"])
@pytest.mark.parametrize("mesh", [SINGLE, POD], ids=["16x16", "2x16x16"])
def test_logical_to_sharding_matches_jax(mesh, kw, jax_specs):
    """mixtral's 8 experts over model=16 (the repair moves the axis to the
    expert FFN dimension), whisper's 20 heads and 51,866-token vocab
    (pad_ok), and divisible shapes."""
    cases = [
        (P("model", "data", None), (8, 6144, 16384)),
        (P("model", None, "data"), (8, 16384, 6144)),
        (P(("pod", "data"), None, "model", None), (32, 1500, 20, 64)),
        (P("model", "data"), (51866, 1280)),
        (P("data", "model"), (2560, 2560)),
        (P(("pod", "data"), "model"), (1, 65536)),
        (P(None, "model"), (7, 5)),
    ]
    for spec, shape in cases:
        got = sh.logical_to_sharding(spec, mesh, shape, **kw)
        want = jax_specs.logical_to_sharding(_jp(spec), mesh, shape, **kw)
        assert _norm(got) == _norm(want), (spec, shape, kw)
    got = sh.logical_to_sharding(P("model", "data", None), SINGLE,
                                 (8, 6144, 16384), repair=True)
    assert _norm(got) == ((), ("data",), ("model",))


def test_param_shardings_on_the_one_card_mesh():
    """A JAX-layout tree (stacked leading axis) on the 1x1 mesh: every leaf
    gets a spec, stacked leading axes padded with None."""
    mesh = make_local_mesh()
    rules = sh.ShardingRules(mesh=mesh)
    params = {
        "layers": {"attn": {"wq": {"w": np.zeros((4, 8, 16))}}},  # stacked
        "embed": {"w": np.zeros((32, 8))},
        "norm": {"scale": np.zeros((8,))},
    }
    out = sh.param_shardings(rules, params)
    assert out["layers"]["attn"]["wq"]["w"] == P(None, "data", "model")
    assert out["embed"]["w"] == P("model", "data")
    assert out["norm"]["scale"] in (P(), P(None))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1


def test_cache_shardings_rank_dispatch(jax_specs):
    rules = sh.ShardingRules(mesh=make_local_mesh())
    cache = {"layers": [{"k": np.zeros((2, 8, 2, 4)),       # per layer
                         "v": np.zeros((2, 8, 2, 4)),
                         "pos": np.zeros((2, 8), np.int32)}],
             "pos": np.zeros((2,), np.int32)}
    out = sh.cache_shardings(rules, cache, batch=2)
    assert _norm(out["layers"][0]["k"]) == (("data",), ("model",), (), ())
    assert _norm(out["pos"]) == (("data",),)
    jrules = jsh.ShardingRules(mesh=jax.make_mesh((1, 1), ("data", "model")))
    stacked = {"layers": [{"k": jnp.zeros((3, 2, 8, 2, 4))}],
               "pos": jnp.zeros((2,), jnp.int32)}
    jout = jax_specs.cache_shardings(jrules, stacked, batch=2)
    assert _norm(jout["layers"][0]["k"])[1:] == _norm(out["layers"][0]["k"])


def test_shard_noop_outside_and_inside_rules():
    import torch
    x = torch.ones((4, 4))
    assert sh.shard(x, "act_btd") is x
    rules = sh.ShardingRules(mesh=make_local_mesh())
    with sh.axis_rules(rules):
        assert sh.active_rules() is rules
        assert sh.shard(x, "act_btd") is x
    assert sh.active_rules() is None


def test_mesh_stand_in_refuses_more_than_one_card():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="pod"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        make_local_mesh(data=2)
    assert make_production_mesh() == Mesh((1, 1), ("data", "model"))


# --------------------------------------------------------------------------- #
# FULL size: every leaf's spec is its JAX leaf's, less the stacking axis
# --------------------------------------------------------------------------- #
def _param_stacked(key: tuple) -> bool:
    return any(k in ("layers", "enc_layers", "dec_layers") for k in key)


def _cache_key(cfg):
    """The JAX cache leaf a port cache path is a slice of (as in
    tests/test_torch_specs.py), and whether JAX stacks it."""
    P_, cyc = len(cfg.pattern), cfg.cycles
    blocks = ("blocks",) if cfg.shared_every else ()

    def key_of(path: str) -> tuple:
        parts = path.split("/")
        if parts[0] in ("self", "cross"):
            return (parts[0], *parts[2:])
        if parts[0] == "layers":
            layer = int(parts[1])
            if layer < cyc * P_:
                return ("layers", *blocks, layer % P_, *parts[2:])
            return ("tail", *blocks, layer - cyc * P_, *parts[2:])
        if parts[0] == "shared":
            return ("layers" if int(parts[1]) < cyc else "tail", "shared",
                    *parts[2:])
        return tuple(parts)
    return key_of


def _cache_stacked(key: tuple) -> bool:
    return key[0] in ("layers", "self", "cross")


def _flat_specs(specs) -> list:
    """The port's spec tree flattened in train/checkpoint.py's order."""
    out = []

    def walk(node):
        if isinstance(node, P):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(specs)
    return out


def _check_tree(tree, specs, jspecs, key_of, stacked) -> int:
    """Each port leaf's spec against JAX's spec of the leaf it slices, less
    the stacking axis where JAX stacks it; returns the leaves checked."""
    jflat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, JP))[0]:
        jflat["/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)] = spec
    _, paths = tree_flatten(tree)
    flat = _flat_specs(specs)
    assert len(flat) == len(paths)
    for path, spec in zip(paths, flat):
        key = key_of(path)
        want = _norm(jflat["/".join(map(str, key))])
        assert _norm(spec) == (want[1:] if stacked(key) else want), \
            (path, spec, want)
    return len(paths)


@pytest.fixture(scope="module")
def apis():
    return {}


def _apis(arch, cache):
    if arch not in cache:
        cache[arch] = (build(get_arch(arch).config),
                       jax_build(jax_get_arch(arch).config))
    return cache[arch]


@pytest.mark.parametrize("mesh", [SINGLE, POD], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_shardings_equal_jax_at_full_size(arch, mesh, jax_specs, apis):
    api, japi = _apis(arch, apis)
    params = api.param_specs()
    specs = sh.param_shardings(sh.ShardingRules(mesh=mesh), params,
                               api.stack_key)
    jspecs = jax_specs.param_shardings(jax_specs.ShardingRules(mesh=mesh),
                                       japi.param_specs())
    assert _check_tree(params, specs, jspecs, api.stack_key,
                       _param_stacked) > 0


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["arctic-480b", "mixtral-8x22b",
                                  "rwkv6-3b", "whisper-large-v3",
                                  "zamba2-7b"])
def test_state_shardings_equal_jax_at_full_size(arch, optimizer, jax_specs,
                                                apis):
    """The train state, optimizer moments included (Adafactor's factored
    statistics have their own rules); Adafactor's unstacked (1,)
    placeholders are replicated on both sides."""
    api, japi = _apis(arch, apis)
    state = state_specs(api.param_specs(), getattr(opt, optimizer)())
    specs = sh.param_shardings(sh.ShardingRules(mesh=POD), state,
                               api.stack_key)
    jstate = jax_state_specs(japi.param_specs(), getattr(jopt, optimizer)())
    jspecs = jax_specs.param_shardings(jax_specs.ShardingRules(mesh=POD),
                                       jstate)
    placeholders = {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
                        k, "name", k)))) for k in path)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(
                        jstate)[0] if tuple(leaf.shape) == (1,)}

    def stacked(key):
        # the (1,) placeholder moment is one unstacked JAX leaf
        return _param_stacked(key) and \
            "/".join(map(str, key)) not in placeholders

    assert _check_tree(state, specs, jspecs, api.stack_key, stacked) > 0


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b", "gemma3-12b",
                                  "whisper-large-v3"])
def test_cache_shardings_equal_jax_at_full_size(arch, batch, jax_specs,
                                                apis):
    """Per-layer cache leaves have their base rank: JAX's spec of the
    stacked leaf without its leading None (the sequence over the whole mesh
    at batch 1)."""
    api, japi = _apis(arch, apis)
    cache = api.cache_specs(batch, 256)
    specs = sh.cache_shardings(sh.ShardingRules(mesh=POD), cache,
                               batch=batch)
    jspecs = jax_specs.cache_shardings(jax_specs.ShardingRules(mesh=POD),
                                       japi.cache_specs(batch, 256),
                                       batch=batch)
    assert _check_tree(cache, specs, jspecs, _cache_key(api.cfg),
                       _cache_stacked) > 0
