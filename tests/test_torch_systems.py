"""Systems, integrators and windows: the port against the JAX package.

Every registered system: spec and ground truth exactly, the library rhs at
rtol 1e-5 / atol 1e-6 (fp32 sums in another order), and the substepped
simulation from the JAX trace's own y0 and inputs within 1e-5 absolute
over 50 samples (the F-8 simulation test's tolerance; rounding differences
of 1e-7 relative, which a chaotic system such as Lorenz amplifies over a
longer horizon).  The input draws cannot match JAX's random streams, so
they are checked for their law instead: PRBS levels and holds, sine
amplitudes, initial states in range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jax_odeint
from repro.core.library import make_library as jax_make_library
from repro.data.pipeline import WindowDataset as JaxWindowDataset
from repro.data.pipeline import make_windows as jax_make_windows
from repro.systems.f8_crusader import F8Crusader as JaxF8
from repro.systems.simulate import register_systems as jax_registry
from repro.systems.simulate import simulate_batch as jax_simulate_batch
from repro_torch.core import odeint
from repro_torch.core.library import make_library
from repro_torch.data.pipeline import WindowDataset, make_windows
from repro_torch.systems.base import PRBS_HOLD, PRBS_LEVELS
from repro_torch.systems.f8_crusader import F8Crusader
from repro_torch.systems.simulate import (register_systems, simulate,
                                          simulate_batch, simulate_from)

JAX_REGISTRY = jax_registry()
REGISTRY = register_systems()
NAMES = sorted(JAX_REGISTRY)


def test_registry_names_match_jax():
    assert sorted(REGISTRY) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_spec_rows_and_true_theta_match_jax(name):
    js, ts = JAX_REGISTRY[name](), REGISTRY[name]()
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(js.spec)
    assert ts.rows() == js.rows()
    for order in (js.spec.order, js.spec.order + 1):
        jlib = jax_make_library(js.spec.n, js.spec.m, order)
        lib = make_library(js.spec.n, js.spec.m, order)
        np.testing.assert_array_equal(ts.true_theta(lib),
                                      js.true_theta(jlib))
    np.testing.assert_array_equal(ts.true_theta(), js.true_theta())


@pytest.mark.parametrize("name", NAMES)
def test_rhs_matches_jax(name):
    js, ts = JAX_REGISTRY[name](), REGISTRY[name]()
    n, m = js.spec.n, js.spec.m
    rng = np.random.default_rng(len(name))
    lo, hi = np.asarray(js.spec.y0_low), np.asarray(js.spec.y0_high)
    y = rng.uniform(lo, hi, size=(16, n)).astype(np.float32)
    u = rng.uniform(-1, 1, size=(16, m)).astype(np.float32)
    want = js.rhs(jnp.asarray(y), jnp.asarray(u) if m else None)
    got = ts.rhs(torch.from_numpy(y), torch.from_numpy(u) if m else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_simulation_from_jax_draws_matches_jax(name):
    """The JAX trace's own y0 and inputs through the port's substepped
    integration (10 RK4 substeps a sample, the kernel's plain version)."""
    js, ts = JAX_REGISTRY[name](), REGISTRY[name]()
    tr = jax_simulate_batch(js, jax.random.PRNGKey(3), batch=3, horizon=50)
    ys, us = np.array(tr.ys), np.array(tr.us)
    got = simulate_from(ts, ys[:, 0], us, device="cpu")
    np.testing.assert_allclose(got.ys.numpy(), ys, rtol=0, atol=1e-5)
    assert got.ys.shape == (3, 51, js.spec.n)
    assert torch.equal(got.ys_noisy, got.ys)        # no noise asked for
    assert torch.equal(got.us, torch.from_numpy(us))


@pytest.mark.parametrize("name", NAMES)
def test_sampled_inputs_and_states_follow_the_spec(name):
    ts = REGISTRY[name]()
    spec = ts.spec
    gen = torch.Generator().manual_seed(0)
    y0 = ts.sample_y0(gen, (64,))
    assert y0.shape == (64, spec.n) and y0.dtype == torch.float32
    assert (y0 >= torch.tensor(spec.y0_low)).all()
    assert (y0 <= torch.tensor(spec.y0_high)).all()
    us = ts.sample_inputs(gen, 101, (5, 2))
    assert us.shape == (101, 5, 2, spec.m) and us.dtype == torch.float32
    if spec.input_kind == "prbs":
        levels = torch.tensor(PRBS_LEVELS) * spec.input_scale
        assert torch.isin(us, levels).all()
        segs = us[:100].reshape(100 // PRBS_HOLD, PRBS_HOLD, -1)
        assert (segs == segs[:, :1]).all()          # held PRBS_HOLD samples
        assert len(torch.unique(us)) == 4           # every level drawn
    elif spec.input_kind == "sum_of_sines":
        # four tones of amplitude <= 1 each
        assert (us.abs() <= 4 * spec.input_scale).all()
        assert us.std() > 0.05 * spec.input_scale
    else:
        assert spec.m == 0


def test_f8_fleet_of_two_matches_jax():
    js, ts = JaxF8(n_aircraft=2), F8Crusader(n_aircraft=2)
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(js.spec)
    assert ts.spec.name == "f8_crusader_6d" and ts.spec.n == 6
    np.testing.assert_array_equal(ts.true_theta(), js.true_theta())
    rng = np.random.default_rng(9)
    y = (0.1 * rng.normal(size=(4, 6))).astype(np.float32)
    u = (0.05 * rng.normal(size=(4, 1))).astype(np.float32)
    np.testing.assert_allclose(
        ts.rhs(torch.from_numpy(y), torch.from_numpy(u)).numpy(),
        np.asarray(js.rhs(jnp.asarray(y), jnp.asarray(u))), rtol=1e-5,
        atol=1e-6)


def test_simulate_batch_and_simulate_draw_y0_inputs_then_noise():
    """Draw order y0, inputs, noise from one generator; the noise is scaled
    by each trace's per-channel std over time (ddof 0)."""
    ts = F8Crusader()
    tr = simulate_batch(ts, torch.Generator().manual_seed(4), 3, horizon=30,
                        noise_std=0.01, device="cpu")
    gen = torch.Generator().manual_seed(4)
    y0 = ts.sample_y0(gen, (3,))
    us = ts.sample_inputs(gen, 30, (3,)).movedim(0, 1)
    noise = torch.randn((3, 31, 3), generator=gen)
    assert torch.equal(tr.us, us)
    assert torch.equal(tr.ys[:, 0], y0)
    want = tr.ys + 0.01 * noise * tr.ys.std(dim=1, keepdim=True,
                                            correction=0)
    assert torch.equal(tr.ys_noisy, want)
    one = simulate(ts, torch.Generator().manual_seed(4), horizon=30,
                   device="cpu")
    assert one.ys.shape == (31, 3) and one.us.shape == (30, 1)
    assert one.dt == ts.spec.dt


# --------------------------------------------------------------------------- #
def _f(y, u):
    return jnp.stack([y[..., 1], -y[..., 0] + u[..., 0]], axis=-1) \
        if isinstance(y, jnp.ndarray) else \
        torch.stack([y[..., 1], -y[..., 0] + u[..., 0]], dim=-1)


@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("rk4", 4),
                                             ("euler", 3)])
def test_integrate_and_steps_match_jax(method, substeps):
    rng = np.random.default_rng(substeps)
    y0 = rng.normal(size=(5, 2)).astype(np.float32)
    us = rng.normal(size=(12, 5, 1)).astype(np.float32)
    want = jax_odeint.integrate(_f, jnp.asarray(y0), jnp.asarray(us), 0.05,
                                method=method, substeps=substeps)
    got = odeint.integrate(_f, torch.from_numpy(y0), torch.from_numpy(us),
                           0.05, method=method, substeps=substeps)
    assert got.shape == (13, 5, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for name in ("rk4_step", "euler_step"):
        w = getattr(jax_odeint, name)(_f, jnp.asarray(y0),
                                      jnp.asarray(us[0]), 0.05)
        g = getattr(odeint, name)(_f, torch.from_numpy(y0),
                                  torch.from_numpy(us[0]), 0.05)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("m", [1, 0])
def test_poly_ode_integrate_matches_jax(m):
    lib, jlib = make_library(2, m, 3), jax_make_library(2, m, 3)
    rng = np.random.default_rng(7 + m)
    theta = (0.3 * rng.normal(size=(4, 2, lib.size))).astype(np.float32)
    y0 = (0.5 * rng.normal(size=(4, 2))).astype(np.float32)
    us = (0.2 * rng.normal(size=(10, 4, m))).astype(np.float32)
    want = jax_odeint.poly_ode_integrate(
        jnp.asarray(theta), jnp.asarray(y0), jnp.asarray(us), 0.02,
        library=jlib, substeps=2)
    got = odeint.poly_ode_integrate(
        torch.from_numpy(theta), torch.from_numpy(y0), torch.from_numpy(us),
        0.02, library=lib, substeps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("lead,window,stride,m", [
    ((), 24, 8, 1), ((3,), 24, 6, 1), ((2,), 10, None, 0), ((4,), 40, 11, 2)])
def test_windows_and_dataset_match_jax_exactly(lead, window, stride, m):
    rng = np.random.default_rng(window)
    ys = rng.normal(size=lead + (121, 3)).astype(np.float32)
    us = rng.normal(size=lead + (120, m)).astype(np.float32)
    jy, ju = jax_make_windows(jnp.asarray(ys), jnp.asarray(us), window,
                              stride)
    ty, tu = make_windows(torch.from_numpy(ys), torch.from_numpy(us),
                          window, stride)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    jds = JaxWindowDataset.from_trace(jnp.asarray(ys), jnp.asarray(us), 0.01,
                                      window, stride)
    tds = WindowDataset.from_trace(torch.from_numpy(ys),
                                   torch.from_numpy(us), 0.01, window,
                                   stride)
    assert tds.n_windows == jds.n_windows and tds.dt == jds.dt
    np.testing.assert_array_equal(tds.y_win.numpy(), np.asarray(jds.y_win))
    if m:
        for t, j in zip(tds.norm_stats(), jds.norm_stats()):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_dataset_batches_cover_every_window(drop_remainder):
    """JAX's permutation stream cannot be matched; each epoch must still
    visit every window once (less the dropped remainder)."""
    ys = torch.arange(3 * 61 * 2, dtype=torch.float32).reshape(3, 61, 2)
    us = torch.zeros((3, 60, 1))
    ds = WindowDataset.from_trace(ys, us, 0.01, window=10, stride=5)
    assert ds.n_windows == 33
    seen = [y[:, 0, 0] for y, _ in ds.batches(
        torch.Generator().manual_seed(0), 8, epochs=2,
        drop_remainder=drop_remainder)]
    per_epoch = 4 if drop_remainder else 5
    assert len(seen) == 2 * per_epoch
    for e in range(2):
        firsts = torch.cat(seen[e * per_epoch:(e + 1) * per_epoch])
        assert len(firsts) == (32 if drop_remainder else 33)
        assert len(torch.unique(firsts)) == len(firsts)
