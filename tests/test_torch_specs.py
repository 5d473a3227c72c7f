"""The port's allocation-free specs: `param_specs`, `cache_specs`,
`batch_specs` and `state_specs` as meta tensors.

On every SMOKE config the specs equal the port's own init leaf by leaf in
path, shape and dtype (the JAX package's
`test_archs_smoke.py::test_param_specs_match_init`), and every leaf is on
the meta device.  At FULL size, for all ten architectures, they equal the
JAX package's specs (`jax.eval_shape`; neither side allocates) per
`stack_key` group: the JAX leaf is the port leaves' stack, shape (n,
*port_shape) with n the group's size, or the port leaf's own shape where
JAX does not stack it (embeddings, norms, the zamba2 tail); dtypes equal;
elements and bytes equal in total.  The one exception is Adafactor's
placeholder: a leaf too small to factor gets a (1,) column moment on
both sides, which JAX does not stack, so the port's per-layer copies add
4 bytes a layer beyond the first (checked to the byte).

The split of layout from drawing leaves `init_params`' draws as they
were: the fingerprints below (sum of leaf sums weighted by leaf index,
sum of squares, in float64, seed 3) were taken from the port's
`init_params` before `param_specs` existed, and are held to rtol 1e-12.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.zoo import build as jax_build
from repro.train import optimizer as jopt
from repro.train.train_state import state_specs as jax_state_specs
from repro_torch.configs import get_arch, list_archs
from repro_torch.models.kv_cache import cache_init
from repro_torch.models.zoo import build
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.train_state import init_state, state_specs

ARCHS = list_archs()
CACHE_B, CACHE_S = 2, 96

FINGERPRINTS = {
    "arctic-480b": (5022.722792919107, 3103.42309223205),
    "chameleon-34b": (5313.7263444013215, 1604.3439631558363),
    "chatglm3-6b": (3904.726762153637, 1628.6800593119665),
    "gemma3-12b": (33900.35263258477, 3650.7556997039574),
    "mixtral-8x22b": (3430.5180896115558, 2713.5066578248784),
    "qwen3-8b": (5234.938414948559, 1692.6800593119665),
    "rwkv6-3b": (-1481.6168559332675, 4197.625098432366),
    "starcoder2-15b": (4768.552138044965, 1425.2269023011975),
    "whisper-large-v3": (24684.850172472154, 2827.8040913354234),
    "zamba2-7b": (96566.45542782036, 9107.656664279133),
}


def _layout(tree):
    leaves, paths = tree_flatten(tree)
    return [(p, tuple(t.shape), t.dtype) for p, t in zip(paths, leaves)]


def _jax_leaves(tree) -> dict:
    """{"/"-joined path: (shape, dtype name)} of a JAX spec tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        out[name] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _groups(tree, key_of) -> dict:
    """{JAX path: (n leaves, shape, dtype name)} of a port tree grouped by
    `key_of(path)`; the leaves of a group share shape and dtype."""
    out: dict = {}
    for path, shape, dtype in _layout(tree):
        key = "/".join(map(str, key_of(path)))
        n, s, d = out.get(key, (0, shape, _dtype_name(dtype)))
        assert (s, d) == (shape, _dtype_name(dtype)), (key, s, shape)
        out[key] = (n + 1, s, d)
    return out


def _stacked(key: str) -> bool:
    return any(k in ("layers", "enc_layers", "dec_layers", "self", "cross")
               for k in key.split("/"))


def _compare(port_groups: dict, jax_leaves: dict, placeholders=()):
    """Every JAX leaf is its group's stack (or the leaf itself), every port
    group has its JAX leaf, and elements and bytes agree in total but for
    `placeholders` (JAX paths of unstacked (1,) leaves)."""
    assert set(port_groups) == set(jax_leaves)
    extra = 0
    for key, (n, shape, dtype) in port_groups.items():
        jshape, jdtype = jax_leaves[key]
        assert jdtype == dtype, key
        if key in placeholders:
            assert jshape == shape == (1,), key
            extra += (n - 1) * np.prod(shape) * torch.finfo(
                getattr(torch, dtype)).bits // 8
        elif _stacked(key):
            assert jshape == (n, *shape), (key, jshape, n, shape)
        else:
            assert n == 1 and jshape == shape, (key, jshape, n, shape)
    return extra


def _bytes(tree) -> int:
    return sum(t.nbytes for t in tree_flatten(tree)[0])


def _jax_bytes(leaves: dict) -> int:
    return sum(int(np.prod(s)) * np.dtype(
        jax.numpy.dtype(d)).itemsize for s, d in leaves.values())


# --------------------------------------------------------------------------- #
# SMOKE: the specs are the port's own init, laid out without allocation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_init(arch):
    api = build(get_arch(arch).smoke)
    assert _layout(api.param_specs()) == _layout(api.init(seed=0,
                                                          device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_state_specs_match_their_init(arch):
    cfg = get_arch(arch).smoke
    api = build(cfg)
    assert _layout(api.cache_specs(2, 40)) == _layout(
        api.cache_init(2, 40, device="cpu"))
    params = api.init(seed=0, device="cpu")
    for make in (opt.adamw, opt.adafactor, opt.sgd):
        assert _layout(state_specs(api.param_specs(), make())) == _layout(
            init_state(params, make()))
    batch = api.batch_specs(3, 16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == (
        {"tokens": ((3, 16), torch.int32)} | (
            {"enc_x": ((3, 16, cfg.d_model), cfg.dtype)}
            if api.is_encdec else {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_allocate_nothing(arch):
    """Every leaf of every spec tree is a meta tensor, the step counters
    included, at full size (arctic-480b's 477B parameters)."""
    api = build(get_arch(arch).config)
    params = api.param_specs()
    trees = (params, api.cache_specs(4, 4096), api.batch_specs(4, 4096),
             state_specs(params, opt.adamw()),
             state_specs(params, opt.adafactor()))
    for tree in trees:
        assert all(t.is_meta for t in tree_flatten(tree)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_unchanged_by_the_split(arch):
    leaves, _ = tree_flatten(build(get_arch(arch).smoke).init(seed=3,
                                                              device="cpu"))
    got = (sum((i + 1) * float(x.double().sum())
               for i, x in enumerate(leaves)),
           sum(float(x.double().square().sum()) for x in leaves))
    np.testing.assert_allclose(got, FINGERPRINTS[arch], rtol=1e-12)


def test_meta_generator_neither_draws_nor_advances():
    from repro_torch.models.layers import generator
    gen = generator("meta")
    assert gen.device.type == "meta"
    before = gen.get_state().clone()
    build(get_arch("rwkv6-3b").smoke).init(device="meta")
    torch.randn((4,), device="meta", generator=gen)
    assert torch.equal(gen.get_state(), before)


# --------------------------------------------------------------------------- #
# FULL size: the port's specs against the JAX package's
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def full():
    return {}


def _apis(arch, cache):
    if arch not in cache:
        cache[arch] = (build(get_arch(arch).config),
                       jax_build(jax_get_arch(arch).config))
    return cache[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_at_full_size(arch, full):
    api, japi = _apis(arch, full)
    specs = api.param_specs()
    jleaves = _jax_leaves(japi.param_specs())
    assert _compare(_groups(specs, api.stack_key), jleaves) == 0
    assert _bytes(specs) == _jax_bytes(jleaves)
    assert sum(t.numel() for t in tree_flatten(specs)[0]) == sum(
        int(np.prod(s)) for s, _ in jleaves.values())


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_jax_at_full_size(arch, optimizer, full):
    api, japi = _apis(arch, full)
    state = state_specs(api.param_specs(), getattr(opt, optimizer)())
    jleaves = _jax_leaves(jax_state_specs(japi.param_specs(),
                                          getattr(jopt, optimizer)()))
    groups = _groups(state, api.stack_key)
    placeholders = {k for k, (n, s, _) in groups.items()
                    if k.startswith("opt/vc/") and s == (1,)}
    if optimizer == "adamw":
        assert not placeholders
    extra = _compare(groups, jleaves, placeholders)
    assert _bytes(state) == _jax_bytes(jleaves) + extra


def _cache_key(cfg):
    """The JAX cache leaf a port cache path is a slice of: decoder-only
    LMs stack each pattern position's entries over the cycles (with a
    shared block, under "blocks", its entry under "shared"), the tail and
    its shared entry unstacked; Whisper stacks "self" and "cross" over the
    decoder layers."""
    P, cyc = len(cfg.pattern), cfg.cycles

    def key_of(path: str) -> tuple:
        parts = path.split("/")
        if parts[0] in ("self", "cross"):
            return (parts[0], *parts[2:])
        blocks = ("blocks",) if cfg.shared_every else ()
        if parts[0] == "layers":
            layer = int(parts[1])
            if layer < cyc * P:
                return ("layers", *blocks, layer % P, *parts[2:])
            return ("tail", *blocks, layer - cyc * P, *parts[2:])
        if parts[0] == "shared":
            return ("layers" if int(parts[1]) < cyc else "tail", "shared",
                    *parts[2:])
        return tuple(parts)
    return key_of


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax_at_full_size(arch, full):
    api, japi = _apis(arch, full)
    specs = api.cache_specs(CACHE_B, CACHE_S)
    jleaves = _jax_leaves(japi.cache_specs(CACHE_B, CACHE_S))
    assert _compare(_groups(specs, _cache_key(api.cfg)), jleaves) == 0
    assert _bytes(specs) == _jax_bytes(jleaves)


def test_cache_specs_are_cache_init_on_meta():
    cfg = get_arch("zamba2-7b").smoke.with_(n_layers=10)
    assert _layout(build(cfg).cache_specs(2, 32)) == _layout(
        cache_init(cfg, 2, 32, device="cpu"))
