"""The port's MoE (models/moe.py) against the JAX package's models/moe.py
on the same numpy inputs and parameters: `router_topk` and `moe_apply`
for a gated (swiglu) and a plain (gelu) expert FFN, at capacity 8.0 (no
token drops) and 1.25 (drops); tests/test_moe.py's cases on the port;
the two traps of the translation (a one-hot of a position outside
[0, C), and the order of tied experts); and the token count both
packages refuse.

Tolerances: `router_topk`'s combine weights and aux loss 1e-6 (the same
f32 softmax), the dispatch's support equal exactly, `moe_apply`'s output
and aux rtol = atol = 1e-4 in f32 (sums in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

ROUTER_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
D, FF, E = 16, 24, 4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _params(kind, seed=0):
    """JAX's init with seeded noise on every leaf (numpy), and the port's
    copy."""
    params = _np_tree(jmoe.moe_init(jax.random.PRNGKey(seed), D, FF, E, kind,
                                    jnp.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return params, _torch_tree(params)


def _router_both(logits, k, capacity):
    jc, jaux = jmoe.router_topk(jnp.asarray(logits), k, capacity)
    c, aux = moe.router_topk(torch.from_numpy(logits), k, capacity)
    return (np.asarray(jc), float(jaux)), (c.numpy(), float(aux))


def _router_close(logits, k, capacity):
    (jc, jaux), (c, aux) = _router_both(logits, k, capacity)
    assert c.shape == jc.shape
    np.testing.assert_array_equal(c > 0, jc > 0)
    np.testing.assert_allclose(c, jc, **ROUTER_TOL)
    np.testing.assert_allclose(aux, jaux, **ROUTER_TOL)
    return c


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_router_topk_matches_jax(top_k, capacity_factor):
    G, n = 3, 32
    C = max(int(math.ceil(top_k * n * capacity_factor / E)), 1)
    logits = np.random.default_rng(top_k).normal(size=(G, n, E)) * 2.0
    logits[..., 0] += 1.5                    # expert 0 in demand
    c = _router_close(logits.astype(np.float32), top_k, C)
    kept = (c > 0).sum()
    if capacity_factor == 1.25:
        assert kept < G * n * top_k          # some assignments dropped
    else:
        assert kept == G * n * top_k


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_moe_apply_matches_jax(kind, capacity_factor):
    jparams, params = _params(kind)
    rng = np.random.default_rng(1)
    # a shared offset crowds the tokens onto a few experts
    x = (rng.normal(size=(2, 48, D)) + 2.0 * rng.normal(size=D)
         ).astype(np.float32)
    kw = dict(n_experts=E, top_k=2, capacity_factor=capacity_factor,
              group_size=32, mlp_kind=kind)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, jparams),
                              jnp.asarray(x), **kw)
    y, aux = moe.moe_apply(params, torch.from_numpy(x), **kw)
    assert y.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # the routing itself: the same groups, the same support
    G, n, C = moe.moe_groups(96, E, 2, capacity_factor, 32)
    logits = (x.reshape(G, n, D) @ jparams["router"]["w"]).astype(np.float32)
    c = _router_close(logits, 2, C)
    dropped = G * n * 2 - (c > 0).sum()
    assert (dropped > 0) == (capacity_factor == 1.25)


def _prop_normalised():
    """Capacity ample: every token's kept weights sum to 1; aux > 0."""
    logits = np.random.default_rng(0).normal(size=(1, 16, 4))
    c, aux = moe.router_topk(torch.from_numpy(logits), 2, 16)
    np.testing.assert_allclose(c.sum(dim=(2, 3)).numpy(), 1.0, rtol=1e-5)
    assert float(aux) > 0.0


def _prop_capacity_drop():
    """All 8 tokens pick expert 0 first; capacity 2 keeps exactly 2."""
    logits = torch.zeros((1, 8, 4))
    logits[..., 0] = 10.0
    c, _ = moe.router_topk(logits, 1, capacity=2)
    assert int((c.sum(dim=(2, 3)) > 0).sum()) == 2


def _prop_no_slot_collisions():
    """Tokens on the same expert occupy different capacity slots."""
    logits = torch.zeros((1, 4, 2))
    logits[..., 0] = 5.0
    c, _ = moe.router_topk(logits, 1, capacity=4)
    assert int((c[0, :, 0, :] > 0).sum(dim=0).max()) <= 1


def _prop_permutation_equivariance():
    """No drops: permuting tokens permutes outputs identically."""
    _, params = _params("swiglu", seed=3)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 16, D), generator=gen)
    kw = dict(n_experts=E, top_k=2, group_size=16, capacity_factor=8.0)
    y, _ = moe.moe_apply(params, x, **kw)
    perm = torch.randperm(16, generator=gen)
    y_p, _ = moe.moe_apply(params, x[:, perm], **kw)
    torch.testing.assert_close(y[:, perm], y_p, rtol=2e-5, atol=2e-5)


def _prop_capacity_shape():
    """The combine buffer's last axis is the capacity."""
    logits = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 64, 8)).astype(np.float32))
    for cf in (1.0, 2.0):
        C = max(int(np.ceil(2 * 64 * cf / 8)), 1)
        c, _ = moe.router_topk(logits, 2, C)
        assert c.shape == (1, 64, 8, C)


def _prop_finite_and_shaped():
    """moe_apply's output is finite and shaped like its input."""
    for seed in range(4):
        _, params = _params("swiglu", seed=seed)
        x = torch.randn((2, 8, D), generator=torch.Generator().manual_seed(
            seed))
        y, aux = moe.moe_apply(params, x, n_experts=E, top_k=2,
                               group_size=16, capacity_factor=8.0)
        assert y.shape == x.shape and bool(torch.isfinite(y).all())
        assert math.isfinite(float(aux))


PROPS = {"normalised_weights": _prop_normalised,
         "capacity_drop": _prop_capacity_drop,
         "no_slot_collisions": _prop_no_slot_collisions,
         "permutation_equivariance": _prop_permutation_equivariance,
         "capacity_shape": _prop_capacity_shape,
         "finite_and_shaped": _prop_finite_and_shaped}


@pytest.mark.parametrize("prop", sorted(PROPS))
def test_jax_moe_cases_on_the_port(prop):
    """tests/test_moe.py's cases, run on the port."""
    PROPS[prop]()


def test_out_of_range_positions_have_no_one_hot_row():
    """pos = -1 (a token before the first on its expert) and pos >= C (a
    dropped assignment) give zero rows, as jax.nn.one_hot's, where
    F.one_hot would raise: 12 tokens, all on experts 0 and 1, capacity 3."""
    logits = np.zeros((2, 12, 4), np.float32)
    logits[..., 0], logits[..., 1] = 4.0, 3.0
    logits[1, :, 2] = np.linspace(0, 5, 12)     # the later tokens prefer 2
    c = _router_close(logits, 2, 3)
    kept = (c > 0).sum(axis=(0, 1, 3))
    assert kept.max() <= 2 * 3 and (c > 0).sum() < 2 * 12 * 2
    assert (c[:, 3:, 0] == 0).all()             # expert 0 full after 3


def test_tied_logits_go_to_the_lower_expert():
    """Equal logits: jax.lax.top_k takes the lower index first; so must
    the port (a stable descending sort), down to the slot positions."""
    logits = np.zeros((1, 6, 4), np.float32)
    logits[0, 3:, 1:] = 1.5                     # ties among 1, 2, 3
    chosen = _router_close(logits, 2, 6).sum(-1)[0] > 0         # [n, E]
    np.testing.assert_array_equal(chosen, [[1, 1, 0, 0]] * 3
                                  + [[0, 1, 1, 0]] * 3)


def test_both_packages_refuse_1025_tokens_at_group_512():
    """The reference's reshape fails where the group count does not divide
    the tokens (1,025 = 2 x 512 + 1); the port raises a ValueError that
    names the constraint, and pads nothing."""
    jparams, params = _params("swiglu")
    x = np.zeros((1, 1025, D), np.float32)
    kw = dict(n_experts=E, top_k=2, group_size=512)
    with pytest.raises(TypeError, match="reshape"):
        jmoe.moe_apply(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x),
                       **kw)
    with pytest.raises(ValueError, match="1025 tokens do not split"):
        moe.moe_apply(params, torch.from_numpy(x), **kw)
    for T in (600, 1024, 1536):                 # these split: both run
        assert moe.moe_groups(T, E, 2, 1.25, 512)[0] * \
            moe.moe_groups(T, E, 2, 1.25, 512)[1] == T


def test_router_stays_f32_in_a_bf16_model():
    p = moe.moe_init(torch.Generator().manual_seed(0), D, FF, E, "swiglu",
                     torch.bfloat16)
    assert p["router"]["w"].dtype == torch.float32
    assert {k: v["w"].dtype for k, v in p["experts"].items()} == dict.fromkeys(
        ("up", "down", "gate"), torch.bfloat16)
    assert p["experts"]["up"]["w"].shape == (E, D, FF)
    assert p["experts"]["down"]["w"].shape == (E, FF, D)
    x = torch.randn((1, 8, D)).to(torch.bfloat16)
    y, aux = moe.moe_apply(p, x, n_experts=E)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
