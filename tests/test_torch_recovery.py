"""Offline model recovery: the port against the JAX package.

Sparse regression runs on each registered system's JAX trace at the
recovery-quality noise (tests/test_recovery_quality.py: 6 traces, noise
0.002, windows of 40 at stride 11, threshold 0.02) and is compared with
JAX's output.  Both solve float32 normal equations, summed in another
order: coefficients rtol 1e-3 / atol 1e-3 after thresholding, 1e-3 /
1e-5 for the ridge refit on a fixed support.  F-8's normal equations are
too ill-conditioned for float32 (their condition number in float64 is
about 5e7: u^3 columns of ~1e-4 beside y0 columns of ~1), so there the
port and JAX are each held to the float64 solution instead (ROADMAP,
Queue 3).

Training: `fit` on 6 given batches across the sparsify switch, and its
NaN restart, with losses and params at rtol 1e-3 (the multi-step
tolerance of tests/test_torch_model.py: differences compound through
Adam's normalization).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jax_metrics
from repro.core.merinda import Merinda as JaxMerinda
from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.core.sparse_regression import masked_ridge as jax_masked_ridge
from repro.core.sparse_regression import stlsq as jax_stlsq
from repro.core.trainer import fit as jax_fit
from repro.data.pipeline import make_windows as jax_make_windows
from repro.systems.simulate import register_systems as jax_registry
from repro.systems.simulate import simulate_batch as jax_simulate_batch
from repro_torch.convert import merinda_params_from_jax
from repro_torch.core import metrics
from repro_torch.core.merinda import Merinda, MerindaConfig
from repro_torch.core.sparse_regression import masked_ridge, stlsq
from repro_torch.core.trainer import fit
from repro_torch.launch.train import parser, train_merinda
from repro_torch.train.optimizer import tree_leaves

JAX_REGISTRY = jax_registry()
NOISE, WINDOW, STRIDE, THRESHOLD = 0.002, 40, 11, 0.02


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _regression_data(name):
    """(phi [N, L], dy [N, n], true theta) of the system's JAX trace, as
    tests/test_recovery_quality.py builds them."""
    system = JAX_REGISTRY[name]()
    tr = jax_simulate_batch(system, jax.random.PRNGKey(2), batch=6,
                            horizon=system.spec.horizon, noise_std=NOISE)
    y_win, u_win = jax_make_windows(tr.ys_noisy, tr.us, window=WINDOW,
                                    stride=STRIDE)
    n, m, dt = system.spec.n, system.spec.m, system.spec.dt
    dy = ((y_win[:, 2:, :] - y_win[:, :-2, :]) / (2 * dt)).reshape(-1, n)
    y = y_win[:, 1:-1, :].reshape(-1, n)
    u = u_win[:, 1:, :].reshape(y.shape[0], m)
    lib = system.library()
    phi = lib.eval(y, u if m else None)
    return (np.array(phi), np.array(dy),
            system.true_theta(lib).astype(np.float32))


def _both(phi, dy, mask):
    """(JAX stlsq, port stlsq, JAX masked ridge, port masked ridge)."""
    tphi, tdy = torch.from_numpy(phi), torch.from_numpy(dy)
    return (np.asarray(jax_stlsq(phi, dy, threshold=THRESHOLD)),
            stlsq(tphi, tdy, threshold=THRESHOLD).numpy(),
            np.asarray(jax_masked_ridge(phi, dy, jnp.asarray(mask))),
            masked_ridge(tphi, tdy, torch.from_numpy(mask)).numpy())


@pytest.mark.parametrize("name", [n for n in sorted(JAX_REGISTRY)
                                  if n != "f8_crusader"])
def test_stlsq_and_masked_ridge_match_jax(name):
    phi, dy, true = _regression_data(name)
    mask = (true != 0).astype(np.float32)
    j_st, t_st, j_mr, t_mr = _both(phi, dy, mask)
    np.testing.assert_array_equal(t_st != 0, j_st != 0)       # support
    np.testing.assert_allclose(t_st, j_st, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(t_mr, j_mr, rtol=1e-3, atol=1e-5)
    assert np.all(t_mr[mask == 0] == 0)


def test_stlsq_f8_is_closer_to_float64_than_jax():
    """F-8 (ROADMAP Queue 3): the float32 supports of the port and JAX
    differ in one entry of 105; the port's STLSQ support is no farther
    from the float64 one than JAX's, and its ridge refit on the true
    support is within 5e-3 of float64 (JAX's about 2e-2)."""
    phi, dy, true = _regression_data("f8_crusader")
    mask = (true != 0).astype(np.float32)
    j_st, t_st, j_mr, t_mr = _both(phi, dy, mask)
    f64 = lambda fn, *a: fn(*(torch.from_numpy(x).double() for x in a),
                            **({"threshold": THRESHOLD} if fn is stlsq
                               else {})).numpy()
    s64, r64 = f64(stlsq, phi, dy), f64(masked_ridge, phi, dy, mask)
    off = lambda a, b: int(np.sum((a != 0) != (b != 0)))
    assert off(t_st, j_st) <= 1
    assert off(t_st, s64) <= off(j_st, s64)
    nz = mask > 0
    rel = lambda a: np.max(np.abs(a - r64)[nz] / np.abs(r64[nz]))
    assert rel(t_mr) <= 5e-3
    assert rel(t_mr) <= rel(j_mr)


# --------------------------------------------------------------------------- #
_MODEL = dict(order=2, hidden=16, head_hidden=16, n_active=6)


def _windows(name, batch=3, horizon=60, window=12, stride=4):
    system = JAX_REGISTRY[name]()
    tr = jax_simulate_batch(system, jax.random.PRNGKey(5), batch=batch,
                            horizon=horizon, noise_std=0.01)
    y, u = jax_make_windows(tr.ys_noisy, tr.us, window, stride)
    return system, np.array(y), np.array(u)


def _jax_model(system, y, u, seed=0, w2=0.05):
    """JAX Merinda params from its own init, with a non-zero output layer
    (the zero init would make every coefficient tie in the top-k)."""
    cfg = dict(n=system.spec.n, m=system.spec.m, dt=system.spec.dt,
               **_MODEL)
    jm = JaxMerinda(JaxMerindaConfig(**cfg))
    p = _np_tree(jm.init(jax.random.PRNGKey(seed),
                         jm.norm_stats(jnp.asarray(y), jnp.asarray(u))))
    rng = np.random.default_rng(seed)
    p["head"]["w2"] = (w2 * rng.normal(size=p["head"]["w2"].shape)
                       ).astype(np.float32)
    return jm, Merinda(MerindaConfig(**cfg)), p


@pytest.mark.parametrize("name", ["lotka_volterra", "pathogenic_attack"])
def test_recover_polishes_by_default_like_jax(name):
    """`recover()` with no arguments is JAX's polished recovery (m = 0 and
    m = 1); polish=False is the pooled, re-sparsified theta."""
    system, y, u = _windows(name)
    jm, model, p = _jax_model(system, y, u)
    jp = jax.tree.map(jnp.asarray, p)
    tp = merinda_params_from_jax(p)
    ty, tu = torch.from_numpy(y), torch.from_numpy(u)
    j_raw = np.asarray(jm.recover(jp, jnp.asarray(y), jnp.asarray(u),
                                  polish=False))
    t_raw = model.recover(tp, ty, tu, polish=False).numpy()
    np.testing.assert_array_equal(t_raw != 0, j_raw != 0)
    np.testing.assert_allclose(t_raw, j_raw, rtol=1e-5, atol=1e-7)
    want = np.asarray(jm.recover(jp, jnp.asarray(y), jnp.asarray(u)))
    got = model.recover(tp, ty, tu).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)  # ridge
    assert not np.allclose(got, t_raw)        # the polish changed values


@pytest.mark.parametrize("name", ["f8_crusader", "lotka_volterra"])
@pytest.mark.parametrize("blowup", [False, True])
def test_reconstruction_mse_and_coefficient_error_match_jax(name, blowup):
    """Both reconstruction MSEs on a perturbed true theta; `blowup` scales
    it 300x so trajectories overflow and the Table I score's divergence
    clamp (10x the data envelope, NaN and inf mapped onto it) decides."""
    system, y, u = _windows(name, horizon=80, window=24, stride=8)
    lib = system.library()
    rng = np.random.default_rng(3)
    true = system.true_theta(lib).astype(np.float32)
    theta = (true * (1 + 0.1 * rng.normal(size=true.shape))
             ).astype(np.float32)
    if blowup:
        theta *= 300.0
    ty, tu, tt = (torch.from_numpy(a) for a in (y, u, theta))
    from repro_torch.core.library import make_library
    tlib = make_library(system.spec.n, system.spec.m, system.spec.order)
    want = jax_metrics.reconstruction_mse(lib, jnp.asarray(theta),
                                          jnp.asarray(y), jnp.asarray(u),
                                          system.spec.dt)
    got = metrics.reconstruction_mse(tlib, tt, ty, tu, system.spec.dt)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if blowup:
        assert got > np.max(np.abs(y)) ** 2     # the clamp, not the data
    else:
        cfg = JaxMerindaConfig(n=system.spec.n, m=system.spec.m,
                               order=system.spec.order, dt=system.spec.dt)
        jm = JaxMerinda(cfg)
        model = Merinda(MerindaConfig(n=system.spec.n, m=system.spec.m,
                                      order=system.spec.order,
                                      dt=system.spec.dt))
        np.testing.assert_allclose(
            float(model.reconstruction_mse(tt, ty, tu)),
            float(jm.reconstruction_mse(jnp.asarray(theta), jnp.asarray(y),
                                        jnp.asarray(u))), rtol=1e-4)
    np.testing.assert_allclose(
        metrics.coefficient_error(tt, true),
        jax_metrics.coefficient_error(jnp.asarray(theta), true), rtol=1e-5)


# --------------------------------------------------------------------------- #
def _fit_case(nan_at=None):
    system, y, u = _windows("pathogenic_attack", batch=4, horizon=120)
    jm, model, p = _jax_model(system, y, u, seed=1, w2=0.0)
    rng = np.random.default_rng(4)
    batches = []
    for step in range(6):
        idx = rng.choice(len(y), size=8, replace=False)
        yb = y[idx].copy()
        if step == nan_at:
            yb[0, 3] = np.nan
        batches.append((yb, u[idx]))
    jres = jax_fit(jm, jax.tree.map(jnp.asarray, p),
                   iter([tuple(map(jnp.asarray, b)) for b in batches]),
                   steps=6, lr=3e-3, sparsify_after=0.5)
    tres = fit(model, merinda_params_from_jax(p),
               iter([tuple(map(torch.from_numpy, b)) for b in batches]),
               steps=6, lr=3e-3, sparsify_after=0.5)
    return jres, tres


@pytest.mark.parametrize("nan_at", [None, 4])
def test_fit_matches_jax(nan_at):
    """6 steps across the sparsify switch (step 3); with `nan_at` one batch
    is non-finite, so that step is dropped: params back to the last good
    ones and AdamW started afresh, in both packages."""
    jres, tres = _fit_case(nan_at)
    assert tres.nan_restarts == jres.nan_restarts == (nan_at is not None)
    assert len(tres.history) == len(jres.history)
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params), jax.tree.leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


def test_train_merinda_runs_on_the_cpu(capsys):
    args = parser().parse_args(["--merinda", "pathogenic_attack",
                                "--steps", "3", "--hidden", "16"])
    assert (args.window, args.batch, args.lr) == (16, 8, 3e-3)
    result, theta, mse = train_merinda(args, device="cpu")
    assert len(result.history) == 3 and result.nan_restarts == 0
    assert theta.shape == (2, 10) and np.isfinite(mse)
    out = capsys.readouterr().out
    assert "reconstruction MSE" in out and "dy0/dt" in out
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        from repro_torch.launch.train import main
        main(["--arch", "qwen3-8b"])
