"""Kernel-level parity: the port's GRU scan and RK4 integrator against JAX.

The same numpy inputs (seeded) go through the JAX wrapper — with its jnp
reference and with the Pallas kernel in interpret mode — and through the
port's wrapper on CPU tensors (the plain PyTorch version).  Tolerances:
forward 1e-5 absolute (fp32 accumulation in another order), gradients
rtol 1e-4 / atol 1e-5 (a backward through T recurrent steps compounds the
rounding differences).  The CUDA kernels themselves are held against the
plain version by tests/test_torch_cuda.py, which skips without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.library import make_library as jax_make_library
from repro.kernels.gru.ops import gru_scan as jax_gru_scan
from repro.kernels.rk4.ops import rk4_poly_solve as jax_rk4
from repro.systems.f8_crusader import F8Crusader as JaxF8
from repro_torch.core.library import make_library
from repro_torch.kernels.gru.ops import gru_scan
from repro_torch.kernels.gru.ref import gru_scan_ref
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref

JAX_BACKENDS = {"jnp": {}, "pallas": dict(use_pallas=True, interpret=True)}
FWD = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _gru_inputs(seed, lead, D, H, fleet=None):
    rng = np.random.default_rng(seed)
    wlead = () if fleet is None else (fleet,)
    sx, sh = 1 / np.sqrt(D), 1 / np.sqrt(H)
    return {
        "xs": rng.normal(size=lead + (D,)).astype(np.float32),
        "h0": (0.1 * rng.normal(size=lead[:-1] + (H,))).astype(np.float32),
        "wx": rng.uniform(-sx, sx, wlead + (D, 3 * H)).astype(np.float32),
        "wh": rng.uniform(-sh, sh, wlead + (H, 3 * H)).astype(np.float32),
        "b": (0.1 * rng.normal(size=wlead + (3 * H,))).astype(np.float32),
    }


_ARGS = ("xs", "h0", "wx", "wh", "b")


def _jax_gru(inp, fleet, kw):
    """(hs, hT, grads of sum(hT^2) + mean(hs^2) w.r.t. every input)."""
    def run(xs, h0, wx, wh, b):
        if fleet:
            return jax.vmap(lambda *a: jax_gru_scan(*a, **kw))(xs, h0, wx,
                                                               wh, b)
        return jax_gru_scan(xs, h0, wx, wh, b, **kw)

    def loss(*args):
        hs, hT = run(*args)
        return jnp.sum(hT ** 2) + jnp.mean(hs ** 2)

    args = [jnp.asarray(inp[k]) for k in _ARGS]
    hs, hT = run(*args)
    grads = jax.grad(loss, argnums=tuple(range(5)))(*args)
    return np.asarray(hs), np.asarray(hT), [np.asarray(g) for g in grads]


def _torch_gru(inp):
    args = [_t(inp[k], grad=True) for k in _ARGS]
    hs, hT = gru_scan(*args)
    (torch.sum(hT ** 2) + torch.mean(hs ** 2)).backward()
    return (hs.detach().numpy(), hT.detach().numpy(),
            [a.grad.numpy() for a in args])


@pytest.mark.parametrize("backend", sorted(JAX_BACKENDS))
@pytest.mark.parametrize("case", ["shared", "folded4d", "fleet",
                                  "served_h32", "served_h64"])
def test_gru_forward_and_grad_match_jax(backend, case):
    if case == "shared":
        inp, fleet = _gru_inputs(0, (6, 9), 5, 16), False
    elif case == "folded4d":            # shared weights, leading axes folded
        inp, fleet = _gru_inputs(1, (3, 5, 7), 4, 8), False
    elif case == "fleet":               # per-slot weights on a fleet axis
        inp, fleet = _gru_inputs(2, (3, 8, 12), 5, 16, fleet=3), True
    else:       # the served widths: the online tick's H=32, the fleet's 64
        H = 32 if case == "served_h32" else 64
        inp, fleet = _gru_inputs(H, (2, 3, 24), 4, H, fleet=2), True
    hs_j, hT_j, g_j = _jax_gru(inp, fleet, JAX_BACKENDS[backend])
    hs_t, hT_t, g_t = _torch_gru(inp)
    assert hs_t.shape == hs_j.shape and hT_t.shape == hT_j.shape
    np.testing.assert_allclose(hs_t, hs_j, **FWD)
    np.testing.assert_allclose(hT_t, hT_j, **FWD)
    for name, a, b in zip(_ARGS, g_t, g_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


def test_gru_wide_hidden_matches_jax():
    """H = 256, past the CUDA kernel's fast paths (136): the plain version
    the wide path is held to on the card agrees with JAX's reference,
    forward and gradients."""
    inp = _gru_inputs(256, (3, 10), 4, 256)
    hs_j, hT_j, g_j = _jax_gru(inp, False, JAX_BACKENDS["jnp"])
    hs_t, hT_t, g_t = _torch_gru(inp)
    np.testing.assert_allclose(hs_t, hs_j, **FWD)
    np.testing.assert_allclose(hT_t, hT_j, **FWD)
    for name, a, b in zip(_ARGS, g_t, g_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


def test_gru_shape_guards_raise():
    inp = _gru_inputs(3, (2, 7), 4, 8)
    with pytest.raises(ValueError, match="inconsistent"):
        gru_scan(_t(inp["xs"]), torch.zeros(2, 9), _t(inp["wx"]),
                 _t(inp["wh"]), _t(inp["b"]))
    fl = _gru_inputs(4, (3, 2, 7), 4, 8, fleet=3)
    with pytest.raises(ValueError, match="fleet"):
        gru_scan(_t(fl["xs"][:2]), _t(fl["h0"][:2]), _t(fl["wx"]),
                 _t(fl["wh"]), _t(fl["b"]))


# --------------------------------------------------------------------------- #
def _rk4_inputs(seed, lead, n, m, order, T):
    lib = make_library(n, m, order)
    rng = np.random.default_rng(seed)
    return lib, {
        "theta": (0.1 * rng.normal(size=lead + (n, lib.size))).astype(
            np.float32),
        "y0": (0.3 * rng.normal(size=lead + (n,))).astype(np.float32),
        "us": (0.2 * rng.normal(size=lead + (T, m))).astype(np.float32),
    }


@pytest.mark.parametrize("backend", sorted(JAX_BACKENDS))
@pytest.mark.parametrize("n,m,order", [(2, 1, 2), (2, 0, 2), (3, 1, 3),
                                       (3, 0, 3)])
def test_rk4_forward_and_grad_match_jax(backend, n, m, order):
    kw = JAX_BACKENDS[backend]
    lead = (2, 5)                        # fleet-shaped: folds into B
    lib, inp = _rk4_inputs(10 * n + m + order, lead, n, m, order, 8)
    jlib = jax_make_library(n, m, order)
    names = ("theta", "y0", "us")

    def jloss(th, y, u):
        return jnp.mean(jax_rk4(th, y, u, dt=0.02, library=jlib, **kw) ** 2)

    jargs = [jnp.asarray(inp[k]) for k in names]
    ys_j = np.asarray(jax_rk4(*jargs, dt=0.02, library=jlib, **kw))
    g_j = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)

    targs = [_t(inp[k], grad=True) for k in names]
    ys_t = rk4_poly_solve(*targs, dt=0.02, library=lib)
    torch.mean(ys_t ** 2).backward()
    assert ys_t.shape == ys_j.shape == lead + (9, n)
    np.testing.assert_allclose(ys_t.detach().numpy(), ys_j, **FWD)
    for name, a, b in zip(names, targs, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, rtol=1e-4, atol=1e-6)


def test_rk4_f8_stack_matches_jax():
    """F8Crusader(n_aircraft=6): n = 18 states, one input, L = 1,540 terms
    at order 3, past the CUDA warp path's 16 states.  The plain version
    (forward, and the backward the card replays) against JAX's reference
    on JAX's own system: its true theta perturbed, y0 and inputs near
    trim, 20 steps."""
    system = JaxF8(n_aircraft=6)
    jlib = system.library()
    lib = make_library(18, 1, 3)
    assert lib.size == jlib.size == 1540
    rng = np.random.default_rng(18)
    true = np.asarray(system.true_theta(jlib), np.float32)
    inp = {"theta": (true * (1 + 0.05 * rng.normal(size=(2,) + true.shape))
                     ).astype(np.float32),
           "y0": rng.uniform(-0.05, 0.05, (2, 18)).astype(np.float32),
           "us": (0.03 * rng.normal(size=(2, 20, 1))).astype(np.float32)}
    names = ("theta", "y0", "us")
    jargs = [jnp.asarray(inp[k]) for k in names]
    ys_j = np.asarray(jax_rk4(*jargs, dt=0.01, library=jlib))
    g_j = jax.grad(lambda *a: jnp.mean(jax_rk4(*a, dt=0.01, library=jlib)
                                       ** 2), argnums=(0, 1, 2))(*jargs)
    targs = [_t(inp[k], grad=True) for k in names]
    ys_t = rk4_poly_solve(*targs, dt=0.01, library=lib)
    torch.mean(ys_t ** 2).backward()
    assert ys_t.shape == (2, 21, 18)
    np.testing.assert_allclose(ys_t.detach().numpy(), ys_j, **FWD)
    for name, a, b in zip(names, targs, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, rtol=1e-4, atol=1e-6)


def test_rk4_shape_guard_raises():
    lib, inp = _rk4_inputs(6, (4,), 2, 1, 2, 6)
    with pytest.raises(ValueError, match="library"):
        rk4_poly_solve(_t(inp["theta"][:, :, :-1]), _t(inp["y0"]),
                       _t(inp["us"]), dt=0.02, library=lib)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    inp = _gru_inputs(7, (3, 6), 4, 8)
    lib, rk = _rk4_inputs(8, (5,), 3, 1, 3, 6)
    before = (gru_scan.launches, rk4_poly_solve.launches)
    hs, hT = gru_scan(*(_t(inp[k]) for k in _ARGS))
    hs_r, hT_r = gru_scan_ref(*(_t(inp[k]) for k in _ARGS))
    ys = rk4_poly_solve(_t(rk["theta"]), _t(rk["y0"]), _t(rk["us"]),
                        dt=0.01, library=lib)
    ys_r = rk4_poly_solve_ref(_t(rk["theta"]), _t(rk["y0"]), _t(rk["us"]),
                              0.01, lib.term_indices)
    assert (gru_scan.launches, rk4_poly_solve.launches) == before
    assert torch.equal(hs, hs_r) and torch.equal(hT, hT_r)
    assert torch.equal(ys, ys_r)
