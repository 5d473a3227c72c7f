"""EMILY and PINN+SR baselines: the port against the JAX package.

Both packages start from the JAX package's own init (converted with
repro_torch.convert) on Lotka-Volterra (m = 0) and pathogen (m = 1)
traces.  Tolerances: forward values and losses rtol 1e-5; gradients of
every leaf rtol 1e-4 / atol 1e-6 (fp32 sums in another order, through a
24-step RK4 unroll or a forward-mode derivative); STLSQ of the learned
rhs rtol 1e-3 / atol 1e-3 with the support equal (the thresholded
regression's tolerance in tests/test_torch_recovery.py); four `fit`
steps rtol 1e-3 (the multi-step tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.emily import Emily as JaxEmily
from repro.core.emily import EmilyConfig as JaxEmilyConfig
from repro.core.pinn_sr import PinnSR as JaxPinnSR
from repro.core.pinn_sr import PinnSRConfig as JaxPinnSRConfig
from repro.core.trainer import fit as jax_fit
from repro.data.pipeline import make_windows as jax_make_windows
from repro.systems.simulate import register_systems as jax_registry
from repro.systems.simulate import simulate_batch as jax_simulate_batch
from repro_torch.convert import baseline_params_from_jax
from repro_torch.core.emily import Emily, EmilyConfig
from repro_torch.core.pinn_sr import PinnSR, PinnSRConfig
from repro_torch.core.trainer import fit
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

SYSTEMS = ["lotka_volterra", "pathogenic_attack"]
GRAD = dict(rtol=1e-4, atol=1e-6)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _trace(name, horizon=60):
    system = jax_registry()[name]()
    tr = jax_simulate_batch(system, jax.random.PRNGKey(11), batch=2,
                            horizon=horizon, noise_std=0.01)
    return system, tr


def _grads(loss_fn, params):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves))
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def _assert_grads(tgrads, jgrads, what):
    for i, (g, j) in enumerate(zip(tgrads, jax.tree.leaves(jgrads))):
        g = np.zeros_like(np.asarray(j)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(j), **GRAD,
                                   err_msg=f"{what} leaf {i}")


# --------------------------------------------------------------------------- #
def _emily(name):
    # 200 samples: ten PRBS holds a trace, so every input monomial is
    # identifiable (over three holds u^2 is nearly collinear with 1, u)
    system, tr = _trace(name, horizon=200)
    y, u = jax_make_windows(tr.ys_noisy, tr.us, window=24, stride=8)
    spec = system.spec
    kw = dict(n=spec.n, m=spec.m, order=spec.order, dt=spec.dt, hidden=16)
    jem, em = JaxEmily(JaxEmilyConfig(**kw)), Emily(EmilyConfig(**kw))
    p = _np_tree(jem.init(jax.random.PRNGKey(2)))
    # a non-zero output layer, so the learned rhs is not identically 0
    rng = np.random.default_rng(2)
    p["mlp"][-1]["w"] = (0.3 * rng.normal(size=p["mlp"][-1]["w"].shape)
                         ).astype(np.float32)
    return jem, em, p, np.array(y), np.array(u)


def test_emily_init_zeroes_the_output_layer():
    em = Emily(EmilyConfig(n=2, m=1, hidden=8, depth=2))
    p = em.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(layer["w"].shape) for layer in p["mlp"]] == \
        [(3, 8), (8, 8), (8, 2)]
    assert torch.all(p["mlp"][-1]["w"] == 0)
    assert 0 < float(p["mlp"][0]["w"].abs().max()) <= 3 ** -0.5
    y0 = torch.randn(4, 2)
    ys = em.node_forward(p, y0, torch.zeros(4, 5, 1))
    assert torch.equal(ys, y0[:, None].expand(4, 6, 2))


@pytest.mark.parametrize("name", SYSTEMS)
def test_emily_forward_loss_grads_and_recover_match_jax(name):
    jem, em, p, y, u = _emily(name)
    jp, tp = jax.tree.map(jnp.asarray, p), baseline_params_from_jax(p)
    ty, tu = torch.from_numpy(y), torch.from_numpy(u)
    want = jem.node_forward(jp, jnp.asarray(y[:, 0]), jnp.asarray(u))
    got = em.node_forward(tp, ty[:, 0], tu)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    (jl, _), jg = jax.value_and_grad(jem.loss, has_aux=True)(
        jp, (jnp.asarray(y), jnp.asarray(u)))
    tl, tg = _grads(lambda q: em.loss(q, (ty, tu)), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _assert_grads(tg, jg, "emily")
    jt = np.asarray(jem.recover(jp, jnp.asarray(y), jnp.asarray(u)))
    tt = em.recover(tp, ty, tu).numpy()
    assert np.any(jt != 0)
    np.testing.assert_array_equal(tt != 0, jt != 0)
    np.testing.assert_allclose(tt, jt, rtol=1e-3, atol=1e-3)


def test_emily_fit_matches_jax():
    jem, em, p, y, u = _emily("pathogenic_attack")
    batches = [(y[i:i + 4], u[i:i + 4]) for i in range(0, 16, 4)]
    jres = jax_fit(jem, jax.tree.map(jnp.asarray, p),
                   iter([tuple(map(jnp.asarray, b)) for b in batches]),
                   steps=4, lr=3e-3)
    tres = fit(em, baseline_params_from_jax(p),
               iter([tuple(map(torch.from_numpy, b)) for b in batches]),
               steps=4, lr=3e-3)
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params), jax.tree.leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


# --------------------------------------------------------------------------- #
def _pinn(name, threshold=0.05):
    system, tr = _trace(name)
    spec = system.spec
    kw = dict(n=spec.n, m=spec.m, order=spec.order, dt=spec.dt, hidden=16,
              depth=2, n_fourier=4, horizon=60, threshold=threshold)
    jpm, pm = JaxPinnSR(JaxPinnSRConfig(**kw)), PinnSR(PinnSRConfig(**kw))
    p = _np_tree(jpm.init(jax.random.PRNGKey(3), tr.ys[0]))
    # a non-zero theta, so the physics residual and L1 carry gradient
    rng = np.random.default_rng(3)
    p["theta"] = (0.2 * rng.normal(size=p["theta"].shape)).astype(np.float32)
    batch = (np.array(tr.ys_noisy[0]), np.array(tr.us[0]))
    return jpm, pm, p, batch, np.array(tr.ys[0])


@pytest.mark.parametrize("name", SYSTEMS)
def test_pinn_sr_init_matches_jax_statistics(name):
    jpm, pm, p, batch, ys = _pinn(name)
    tp = pm.init(torch.Generator().manual_seed(0), torch.from_numpy(ys),
                 device="cpu")
    for key in ("freqs", "y_mu", "y_sigma", "mask"):
        np.testing.assert_allclose(tp[key].numpy(), p[key], rtol=1e-6,
                                   err_msg=key)
    assert torch.all(tp["theta"] == 0)
    assert [tuple(layer["w"].shape) for layer in tp["mlp"]] == \
        [tuple(layer["w"].shape) for layer in p["mlp"]]


@pytest.mark.parametrize("name", SYSTEMS)
def test_pinn_sr_net_loss_and_grads_match_jax(name):
    """net and its forward-mode time derivative at every sample, then the
    data + physics + L1 loss and the gradient of every leaf (the
    derivative differentiated again: reverse over forward mode)."""
    jpm, pm, p, batch, _ = _pinn(name)
    jp, tp = jax.tree.map(jnp.asarray, p), baseline_params_from_jax(p)
    ts = np.arange(60, dtype=np.float32) * pm.cfg.dt
    jy, jdot = jax.vmap(lambda t: jpm.net_and_dot(jp, t))(jnp.asarray(ts))
    ty, tdot = pm.net_and_dot(tp, torch.from_numpy(ts))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdot.detach().numpy(), np.asarray(jdot),
                               rtol=1e-5, atol=1e-5)
    jb = tuple(map(jnp.asarray, batch))
    tb = tuple(map(torch.from_numpy, batch))
    (jl, jaux), jg = jax.value_and_grad(jpm.loss, has_aux=True)(jp, jb)
    tl, tg = _grads(lambda q: pm.loss(q, tb), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _, taux = pm.loss(tp, tb)
    for key in ("data", "phys", "l1"):
        np.testing.assert_allclose(float(taux[key].detach()), float(jaux[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_grads(tg, jg, "pinn_sr")


def test_pinn_sr_l1_gradient_at_zero_is_jax_s():
    """theta starts at 0, where JAX's |x| has gradient +1 (torch.abs: 0)."""
    jpm, pm, p, batch, _ = _pinn("lotka_volterra")
    p["theta"] = np.zeros_like(p["theta"])
    jp, tp = jax.tree.map(jnp.asarray, p), baseline_params_from_jax(p)
    _, jg = jax.value_and_grad(jpm.loss, has_aux=True)(
        jp, tuple(map(jnp.asarray, batch)))
    _, tg = _grads(lambda q: pm.loss(q, tuple(map(torch.from_numpy, batch))),
                   tp)
    _assert_grads(tg, jg, "pinn_sr at theta = 0")


def test_pinn_sr_threshold_recover_and_fit_match_jax():
    jpm, pm, p, batch, _ = _pinn("pathogenic_attack", threshold=0.15)
    jp, tp = jax.tree.map(jnp.asarray, p), baseline_params_from_jax(p)
    jt, tt = jpm.apply_threshold(jp), pm.apply_threshold(tp)
    for key in ("theta", "mask"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]))
    assert 0 < float(tt["mask"].sum()) < tt["mask"].numel()
    np.testing.assert_array_equal(pm.recover(tt).numpy(),
                                  np.asarray(jpm.recover(jt)))

    def post(step, params, model):
        return model.apply_threshold(params) if step == 1 else params

    jres = jax_fit(jpm, jp, iter([tuple(map(jnp.asarray, batch))] * 4),
                   steps=4, lr=2e-3, post_step=lambda s, q: post(s, q, jpm))
    tres = fit(pm, tp, iter([tuple(map(torch.from_numpy, batch))] * 4),
               steps=4, lr=2e-3, post_step=lambda s, q: post(s, q, pm))
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params), jax.tree.leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
