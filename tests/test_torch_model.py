"""Model-level parity: library, MERINDA loss/grads, AdamW, FleetMerinda.

Both packages start from the same numbers: the JAX package's own random
draws (converted with repro_torch.convert) and seeded numpy data.
Tolerances: losses rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (fp32
reductions in another order); multi-step training rtol 1e-3 (the
differences compound through Adam's normalization), as the JAX package's
own Pallas-vs-jnp fleet test holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fleet import FleetConfig as JaxFleetConfig
from repro.core.fleet import FleetMerinda as JaxFleet
from repro.core.library import make_library as jax_make_library
from repro.core.merinda import Merinda as JaxMerinda
from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.systems.simulate import register_systems
from repro.train.optimizer import adamw as jax_adamw
from repro_torch.convert import fleet_state_from_jax, merinda_params_from_jax
from repro_torch.core.fleet import FleetConfig, FleetMerinda
from repro_torch.core.library import make_library
from repro_torch.core.merinda import Merinda, MerindaConfig, median_midpoint
from repro_torch.train.optimizer import adamw, tree_leaves

_MODEL = dict(n=2, m=1, order=2, hidden=16, head_hidden=16, n_active=6)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _windows(seed, lead, k, n, m):
    rng = np.random.default_rng(seed)
    y = (0.3 * rng.normal(size=lead + (k + 1, n))).astype(np.float32)
    u = (0.2 * rng.normal(size=lead + (k, m))).astype(np.float32)
    return y, u


# --------------------------------------------------------------------------- #
def _registered_shapes():
    shapes = set()
    for cls in register_systems().values():
        spec = cls().spec
        for order in {2, 3, spec.order}:
            shapes.add((spec.n, spec.m, order))
    return sorted(shapes)


@pytest.mark.parametrize("n,m,order", _registered_shapes())
def test_library_matches_jax(n, m, order):
    lib, jlib = make_library(n, m, order), jax_make_library(n, m, order)
    assert lib.size == jlib.size
    np.testing.assert_array_equal(lib.term_indices, jlib.term_indices)
    assert lib.term_indices.dtype == jlib.term_indices.dtype
    assert lib.names == jlib.names
    rng = np.random.default_rng(n * 100 + m * 10 + order)
    y = rng.normal(size=(5, n)).astype(np.float32)
    u = rng.normal(size=(5, m)).astype(np.float32)
    got = lib.eval(torch.from_numpy(y), torch.from_numpy(u) if m else None)
    want = jlib.eval(jnp.asarray(y), jnp.asarray(u) if m else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
def _jax_params(seed):
    """JAX init with a non-zero output layer (the zero init would make every
    coefficient tie in the sparsify mask) and a real norm."""
    jm = JaxMerinda(JaxMerindaConfig(**_MODEL))
    y, u = _windows(seed, (8,), 12, 2, 1)
    norm = jm.norm_stats(jnp.asarray(y), jnp.asarray(u))
    p = _np_tree(jm.init(jax.random.PRNGKey(seed), norm))
    rng = np.random.default_rng(seed)
    p["head"]["w2"] = (0.05 * rng.normal(size=p["head"]["w2"].shape)
                       ).astype(np.float32)
    return jm, p, y, u


@pytest.mark.parametrize("sparsify", [False, True])
def test_merinda_loss_and_grads_match_jax(sparsify):
    jm, p, y, u = _jax_params(0)
    (jl, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, p), (jnp.asarray(y), jnp.asarray(u)),
        sparsify)
    model = Merinda(MerindaConfig(**_MODEL))
    tp = merinda_params_from_jax(p)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    tl, taux = model.loss(tp, (torch.from_numpy(y), torch.from_numpy(u)),
                          sparsify)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("ode_loss", "l1", "coll"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    for grp in ("gru", "head"):
        for name, g in jg[grp].items():
            np.testing.assert_allclose(tp[grp][name].grad.numpy(),
                                       np.asarray(g), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{grp}.{name}")


def test_norm_stats_and_recover_match_jax():
    jm, p, y, u = _jax_params(1)
    model = Merinda(MerindaConfig(**_MODEL))
    jn = jm.norm_stats(jnp.asarray(y), jnp.asarray(u))
    tn = model.norm_stats(torch.from_numpy(y), torch.from_numpy(u))
    for k in jn:
        np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]),
                                   rtol=1e-5, err_msg=k)
    # 8 windows: an even count, where jnp.median averages the middle pair
    jt = jm.recover(jax.tree.map(jnp.asarray, p), jnp.asarray(y),
                    jnp.asarray(u), polish=False)
    tt = model.recover(merinda_params_from_jax(p), torch.from_numpy(y),
                       torch.from_numpy(u))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-7)
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(median_midpoint(x, 0)) == float(jnp.median(x.numpy(), 0))


def test_adamw_20_steps_match_jax():
    rng = np.random.default_rng(5)
    params = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jopt, topt = jax_adamw(lr=3e-3), adamw(lr=3e-3)    # clip_norm=1.0
    jp, tp = jax.tree.map(jnp.asarray, params), merinda_params_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(20):
        g = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
             "b": rng.normal(size=(5,)).astype(np.float32)}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, ts = topt.update(merinda_params_from_jax(g), ts, tp)
        tp = {"a": {"w": tp["a"]["w"] + tu["a"]["w"]}, "b": tp["b"] + tu["b"]}
    assert int(ts.step) == int(js.step) == 20
    np.testing.assert_allclose(tp["a"]["w"].numpy(), np.asarray(jp["a"]["w"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tp["b"].numpy(), np.asarray(jp["b"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.nu["b"].numpy(), np.asarray(js.nu["b"]),
                               rtol=1e-5, atol=1e-9)


# --------------------------------------------------------------------------- #
def test_fleet_train_step_and_recover_match_jax():
    """Six per-slot steps across sparsify_after=3, then recover_all over 8
    windows per slot (an even count: the median averages the middle pair).

    Each step starts both packages from the same (JAX) state and compares
    the per-slot losses, skip flags and clipped gradients; the Adam update
    on top is held to JAX by test_adamw_20_steps_match_jax.  Comparing
    free-running parameters instead would measure Adam's amplification of
    near-zero gradients (|g| ~ eps), not the port."""
    cfg = dict(fleet=4, windows_per_twin=8, sparsify_after=3)
    jfleet = JaxFleet(JaxFleetConfig(merinda=JaxMerindaConfig(**_MODEL),
                                     **cfg))
    fleet = FleetMerinda(FleetConfig(merinda=MerindaConfig(**_MODEL), **cfg),
                         device="cpu")
    y, u = _windows(2, (4, 8), 12, 2, 1)
    jy, ju = jnp.asarray(y), jnp.asarray(u)
    ty, tu = torch.from_numpy(y), torch.from_numpy(u)
    js = jfleet.init(jax.random.PRNGKey(1))
    for step in range(6):
        ts = fleet_state_from_jax(_np_tree(js))
        sparsify = js["steps"] > cfg["sparsify_after"]
        jl, jok, jg = jax.vmap(jfleet._twin_grad)(js["params"], jy, ju,
                                                  sparsify)
        tl, tok, tg = fleet.slot_grads(ts["params"], ty, tu,
                                       ts["steps"] > cfg["sparsify_after"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {step}")
        ts, tl2, _ = fleet.train_step_per_slot(ts, ty, tu)
        js, jl2, _ = jfleet.train_step_per_slot(js, jy, ju)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_array_equal(ts["steps"].numpy(),
                                      np.asarray(js["steps"]))
    ts = fleet_state_from_jax(_np_tree(js))
    np.testing.assert_allclose(fleet.recover_all(ts, ty, tu).numpy(),
                               np.asarray(jfleet.recover_all(js, jy, ju)),
                               rtol=1e-4, atol=1e-6)

    # admission: reset one slot from the JAX draw, norm from its windows
    key = jax.random.PRNGKey(9)
    js = jfleet.reset_slot(js, jnp.int32(2), key, jy[2], ju[2])
    fresh = merinda_params_from_jax(_np_tree(jfleet.model.init(key)))
    fleet.reset_slot(ts, 2, fresh, ty[2], tu[2])
    for a, b in zip(tree_leaves(ts["params"]),
                    jax.tree.leaves(js["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(tree_leaves(ts["opt"].mu), jax.tree.leaves(js["opt"].mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts["steps"].numpy(), np.asarray(js["steps"]))


def test_fleet_skips_non_finite_slot():
    """A slot whose window integrates to overflow gets zero grads and loss
    0; its neighbours step normally."""
    fleet = FleetMerinda(FleetConfig(merinda=MerindaConfig(**_MODEL),
                                     fleet=3, windows_per_twin=4),
                         device="cpu")
    state = fleet.init(torch.Generator().manual_seed(0))
    y, u = _windows(3, (3, 4), 12, 2, 1)
    y[1] *= 1e30                                # slot 1: overflowing window
    new, loss, ok = fleet.train_step_per_slot(state, torch.from_numpy(y),
                                              torch.from_numpy(u))
    assert ok.tolist() == [True, False, True]
    assert float(loss[1]) == 0.0
    for a, b in zip(tree_leaves(new["params"]), tree_leaves(state["params"])):
        assert torch.equal(a[1], b[1])
        assert torch.isfinite(a).all()
    # train_step: the mean over the slots whose step was finite
    _, mean = fleet.train_step(state, torch.from_numpy(y), torch.from_numpy(u))
    assert torch.allclose(mean, (loss[0] + loss[2]) / 2)


# --------------------------------------------------------------------------- #
def test_f8_true_theta_and_simulation_match_jax():
    """The port's copy of the F-8 rows places the same coefficients, and its
    RK4-substepped simulation follows the JAX integrator (fp32, 10 substeps
    x 40 samples; 1e-5 absolute)."""
    from repro.core.odeint import integrate
    from repro.systems.f8_crusader import F8Crusader as JaxF8
    from repro_torch.systems.f8_crusader import F8Crusader, simulate

    jsys, tsys = JaxF8(), F8Crusader()
    lib, jlib = make_library(3, 1, 3), jax_make_library(3, 1, 3)
    np.testing.assert_array_equal(tsys.true_theta(lib),
                                  jsys.true_theta(jlib))
    rng = np.random.default_rng(6)
    y0 = rng.uniform(-0.05, 0.1, size=(4, 3)).astype(np.float32)
    us = (0.03 * rng.normal(size=(4, 40, 1))).astype(np.float32)
    want = np.stack([np.asarray(integrate(jsys.rhs, jnp.asarray(y0[b]),
                                          jnp.asarray(us[b]), 0.01,
                                          substeps=10)) for b in range(4)])
    ys, noisy, _ = simulate(tsys, torch.Generator().manual_seed(0), batch=4,
                            horizon=40, y0=y0, us=us)
    np.testing.assert_allclose(ys.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(noisy, ys)          # noise_std defaults to 0
