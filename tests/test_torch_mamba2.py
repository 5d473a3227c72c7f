"""The port's Mamba-2 block (models/mamba2.py) against the JAX package's, on
the same numpy inputs and parameters, at zamba2-7b SMOKE width (d_model
64, state 16, head dim 16: 8 SSD heads; chunk 16, so T = 37 is ragged).

Parameters come from JAX's `mamba2_init` with seeded numpy noise on every
leaf.  `mamba2_apply` and `mamba2_decode`, fresh and with carried conv and
SSM states; once against JAX with its Pallas scan in interpret mode, as
JAX's own kernel tests run it.  Tolerance rtol = atol = 1e-4 in f32 (the
recurrence summed in chunks in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm2
from repro_torch.configs import get_arch
from repro_torch.models import mamba2 as m2

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = get_arch("zamba2-7b").smoke
KW = dict(state=CFG.ssm_state, head_dim=CFG.ssm_head_dim,
          expand=CFG.ssm_expand, conv_width=CFG.conv_width)
D_INNER = CFG.ssm_expand * CFG.d_model
H = D_INNER // CFG.ssm_head_dim
CONV_DIM = D_INNER + 2 * CFG.ssm_state


@pytest.fixture(scope="module")
def params():
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jm2.mamba2_init(jax.random.PRNGKey(0), CFG.d_model,
                                     **KW))
    rng = np.random.default_rng(0)
    p = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), p)
    return p, jax.tree.map(torch.from_numpy, p)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **TOL,
                               err_msg=what)


def _states(rng, B):
    conv = rng.normal(size=(B, CFG.conv_width - 1, CONV_DIM))
    ssm = 0.1 * rng.normal(size=(B, H, CFG.ssm_state, CFG.ssm_head_dim))
    return conv.astype(np.float32), ssm.astype(np.float32)


def test_init_tree_matches_jax(params):
    jp, _ = params
    mine = m2.mamba2_init(torch.Generator().manual_seed(0), CFG.d_model, **KW)
    flat = lambda t: {k: tuple(np.shape(v)) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert {str(k): v for k, v in flat(jax.tree.map(
        lambda t: t.numpy(), mine)).items()} == {
        str(k): v for k, v in flat(jp).items()}
    # the deterministic leaves equal JAX's
    ref = jm2.mamba2_init(jax.random.PRNGKey(0), CFG.d_model, **KW)
    for name in ("A_log", "D"):
        _close(mine[name], ref[name], name)
    np.testing.assert_array_equal(mine["conv"]["b"].numpy(), 0.0)
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_mamba2_apply_matches_jax(params, carry):
    jp, tp = params
    rng = np.random.default_rng(1)
    B, T = 2, 37
    x = rng.normal(size=(B, T, CFG.d_model)).astype(np.float32)
    conv, ssm = _states(rng, B) if carry else (None, None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    jy, (jconv, jssm) = jm2.mamba2_apply(jp, j(x), conv_state=j(conv),
                                         ssm_state=j(ssm), chunk=16, **KW)
    y, (nconv, nssm) = m2.mamba2_apply(tp, t(x), conv_state=t(conv),
                                       ssm_state=t(ssm), chunk=16, **KW)
    _close(y, jy, "y")
    _close(nconv, jconv, "conv state")
    _close(nssm, jssm, "ssm state")


def test_mamba2_apply_matches_jax_pallas_interpret(params):
    """JAX's scan through its Pallas kernel in interpret mode."""
    jp, tp = params
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 40, CFG.d_model)).astype(np.float32)
    conv, ssm = _states(rng, 1)
    jy, (jconv, jssm) = jm2.mamba2_apply(
        jp, jnp.asarray(x), conv_state=jnp.asarray(conv),
        ssm_state=jnp.asarray(ssm), chunk=16, use_pallas=True,
        interpret=True, **KW)
    y, (nconv, nssm) = m2.mamba2_apply(
        tp, torch.from_numpy(x), conv_state=torch.from_numpy(conv),
        ssm_state=torch.from_numpy(ssm), chunk=16, **KW)
    _close(y, jy, "y")
    _close(nconv, jconv, "conv state")
    _close(nssm, jssm, "ssm state")


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_mamba2_decode_matches_jax(params, carry):
    jp, tp = params
    rng = np.random.default_rng(3)
    B = 3
    if carry:
        conv, ssm = _states(rng, B)
    else:
        st = m2.mamba2_state_init(B, CFG.d_model, **KW)
        conv, ssm = st["conv"].numpy(), st["ssm"].numpy()
        ref = jm2.mamba2_state_init(B, CFG.d_model, **KW)
        assert conv.shape == ref["conv"].shape
        assert ssm.shape == ref["ssm"].shape
    jstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    state = {"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)}
    for step in range(4):
        x1 = rng.normal(size=(B, CFG.d_model)).astype(np.float32)
        jy, jstate = jm2.mamba2_decode(jp, jnp.asarray(x1), jstate, **KW)
        y, state = m2.mamba2_decode(tp, torch.from_numpy(x1), state, **KW)
        _close(y, jy, f"step {step} y")
        for name in ("conv", "ssm"):
            _close(state[name], jstate[name], f"step {step} {name}")


def test_apply_in_two_segments_equals_one(params):
    """A sequence split in two with the conv and SSM states carried equals
    one whole pass; and decoding the next token from the prefill's states
    equals the whole pass's last output."""
    _, tp = params
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 30, CFG.d_model)).astype(
        np.float32))
    whole, (conv, ssm) = m2.mamba2_apply(tp, x, chunk=16, **KW)
    y1, (c1, s1) = m2.mamba2_apply(tp, x[:, :13], chunk=16, **KW)
    y2, (c2, s2) = m2.mamba2_apply(tp, x[:, 13:], conv_state=c1,
                                   ssm_state=s1, chunk=16, **KW)
    torch.testing.assert_close(torch.cat([y1, y2], 1), whole, **TOL)
    torch.testing.assert_close(c2, conv, **TOL)
    torch.testing.assert_close(s2, ssm, **TOL)
    _, (c29, s29) = m2.mamba2_apply(tp, x[:, :29], chunk=16, **KW)
    y_last, _ = m2.mamba2_decode(tp, x[:, 29], {"conv": c29, "ssm": s29},
                                 **KW)
    torch.testing.assert_close(y_last, whole[:, 29], **TOL)
