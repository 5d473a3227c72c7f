"""The port's linear recurrence (kernels/linear_scan) against the JAX
package's, on the same numpy inputs.

The JAX side runs its sequential oracle, its chunked reference and the
Pallas kernel in interpret mode; the port runs its sequential oracle, its
chunked version, the public wrapper on CPU tensors (which dispatches to
the chunked version) and the plain version of the CUDA kernel's own
formulation (`linear_scan_subchunked`: chunk states, a scan across chunks,
pivot-factored subchunk pairs).  Tolerance rtol = atol = 2e-4, the JAX
package's own f32 tolerance between its chunked forms and the oracle (sums
over up to 64 x 64 terms in another order).  The CUDA kernel is held against the
plain chunked version by tests/test_torch_cuda.py, which skips without a
card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.linear_scan import linear_scan_pallas
from repro.kernels.linear_scan.ref import (linear_scan_chunked as
                                           jax_chunked)
from repro.kernels.linear_scan.ref import linear_scan_seq as jax_seq
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import (linear_scan_chunked,
                                                 linear_scan_seq,
                                                 linear_scan_subchunked)

TOL = dict(rtol=2e-4, atol=2e-4)

# (B, H, T, K, V, chunk): the JAX kernel tests' CASES
CASES = [
    (1, 1, 32, 8, 8, 8),
    (2, 3, 65, 16, 8, 16),   # T not a multiple of the chunk: padding path
    (2, 2, 128, 32, 64, 64),
    (1, 2, 17, 8, 8, 64),    # chunk > T: C = T
]


def _inputs(seed, B, H, T, K, V, strong=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=0.5: (scale * rng.normal(size=s)).astype(np.float32)
    # log-decay in [-0.22, -9e-4], the JAX tests' data-dependent range, or
    # with `strong` in [-7.4, -0.37]: decays down to exp(-7.4) a step
    lo, hi = (-1.0, 2.0) if strong else (-7.0, -1.5)
    w = -np.exp(rng.uniform(lo, hi, (B, H, T, K))).astype(np.float32)
    return dict(q=f(B, H, T, K), k=f(B, H, T, K), v=f(B, H, T, V), w=w,
                u=f(H, K, scale=0.3))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jax(fn, a, u, **kw):
    o, s = fn(*(jnp.asarray(a[n]) for n in "qkvw"),
              None if u is None else jnp.asarray(u), **kw)
    return _np(o), _np(s)


def _torch(fn, a, u, **kw):
    o, s = fn(*(torch.from_numpy(a[n]) for n in "qkvw"),
              None if u is None else torch.from_numpy(u), **kw)
    assert o.dtype == s.dtype == torch.float32
    return o.numpy(), s.numpy()


@pytest.mark.parametrize("mode,bonus", [("ssd", False), ("rwkv6", True),
                                        ("rwkv6", False)],
                         ids=["ssd", "rwkv6", "rwkv6-no-u"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_port_matches_jax_seq_chunked_and_pallas(mode, bonus, case):
    B, H, T, K, V, chunk = case
    a = _inputs(sum(case), B, H, T, K, V)
    u = a["u"] if bonus else None
    want = {
        "jax seq": _jax(jax_seq, a, u, mode=mode),
        "jax chunked": _jax(jax_chunked, a, u, mode=mode, chunk=chunk),
    }
    if not (mode == "rwkv6" and u is None):
        # The JAX Pallas kernel weighs the current token by u = 0 when u is
        # None (linear_scan.py:100-101); both JAX references, and the port,
        # weigh it by 1.  Its only caller (models/rwkv6.py) always passes u.
        want["jax pallas"] = _jax(linear_scan_pallas, a, u, mode=mode,
                                  chunk=chunk, interpret=True)
    got = {
        "port seq": _torch(linear_scan_seq, a, u, mode=mode),
        "port chunked": _torch(linear_scan_chunked, a, u, mode=mode,
                               chunk=chunk),
        "port wrapper": _torch(linear_scan, a, u, mode=mode, chunk=chunk),
    }
    for gname, (go, gs) in got.items():
        assert go.shape == (B, H, T, V) and gs.shape == (B, H, K, V)
        for wname, (wo, ws) in want.items():
            np.testing.assert_allclose(go, wo, **TOL,
                                       err_msg=f"o: {gname} vs {wname}")
            np.testing.assert_allclose(gs, ws, **TOL,
                                       err_msg=f"S: {gname} vs {wname}")


@pytest.mark.parametrize("mode", ["ssd", "rwkv6"])
def test_initial_state_carry_matches_jax(mode):
    """Two halves with the state carried equal one whole scan, and equal
    JAX's chunked and Pallas forms given the same carried state."""
    B, H, T, K, V = 2, 2, 64, 16, 16
    a = _inputs(7, B, H, T, K, V)
    u = a["u"] if mode == "rwkv6" else None
    half = {n: (x[:, :, :T // 2], x[:, :, T // 2:]) for n, x in a.items()
            if n != "u"}
    first = {n: h[0] for n, h in half.items()}
    second = {n: h[1] for n, h in half.items()}
    o_full, s_full = _torch(linear_scan_seq, a, u, mode=mode)
    o1, s1 = _torch(linear_scan, first, u, mode=mode, chunk=16)
    o2, s2 = _torch(linear_scan, second, u, mode=mode, chunk=16,
                    initial_state=torch.from_numpy(s1))
    np.testing.assert_allclose(np.concatenate([o1, o2], axis=2), o_full,
                               **TOL)
    np.testing.assert_allclose(s2, s_full, **TOL)
    for fn, kw in ((jax_chunked, {}), (linear_scan_pallas,
                                       dict(interpret=True))):
        jo, js = _jax(fn, second, u, mode=mode, chunk=16,
                      initial_state=jnp.asarray(s1), **kw)
        np.testing.assert_allclose(o2, jo, **TOL)
        np.testing.assert_allclose(s2, js, **TOL)


def test_bf16_inputs_are_upcast_like_jax():
    """bf16 q/k/v: both packages upcast the same rounded values, so the f32
    tolerance holds."""
    B, H, T, K, V = 1, 2, 40, 16, 16
    a = _inputs(3, B, H, T, K, V)
    tq = {n: torch.from_numpy(a[n]).to(torch.bfloat16) for n in "qkv"}
    o, s = linear_scan(tq["q"], tq["k"], tq["v"], torch.from_numpy(a["w"]),
                       torch.from_numpy(a["u"]), mode="rwkv6", chunk=16)
    jo, js = jax_chunked(*(jnp.asarray(tq[n].float().numpy(), jnp.bfloat16)
                           for n in "qkv"), jnp.asarray(a["w"]),
                         jnp.asarray(a["u"]), mode="rwkv6", chunk=16)
    np.testing.assert_allclose(o.numpy(), _np(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), _np(js), **TOL)


def test_cpu_wrapper_launches_no_kernel_and_checks_shapes():
    a = _inputs(0, 1, 2, 8, 4, 4)
    q, k, v, w = (torch.from_numpy(a[n]) for n in "qkvw")
    before = linear_scan.launches
    linear_scan(q, k, v, w, mode="ssd")
    assert linear_scan.launches == before
    with pytest.raises(ValueError, match="mode"):
        linear_scan(q, k, v, w, mode="gla")
    with pytest.raises(ValueError, match=r"\[B, H, T, K\]"):
        linear_scan(q, k[..., :3], v, w)
    with pytest.raises(ValueError, match="u"):
        linear_scan(q, k, v, w, torch.zeros(3, 4), mode="rwkv6")
    with pytest.raises(ValueError, match="initial_state"):
        linear_scan(q, k, v, w, initial_state=torch.zeros(1, 2, 4, 5))


# (B, H, T, K, V, chunk, strong) at the edges of the kernel's subchunks
SUB_CASES = [
    (1, 2, 13, 8, 8, 64, False),      # T < 16: one chunk, a partial subchunk
    (2, 3, 65, 16, 8, 16, False),     # ragged T
    (1, 2, 100, 16, 16, 24, False),   # chunk 24: three subchunks of 8
    (2, 2, 128, 32, 64, 64, False),   # whole chunks of eight subchunks
    (1, 2, 70, 16, 16, 64, True),     # decays down to exp(-7.4) a step
]


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("mode,bonus", [("ssd", False), ("rwkv6", True),
                                        ("rwkv6", False)],
                         ids=["ssd", "rwkv6", "rwkv6-no-u"])
@pytest.mark.parametrize("case", SUB_CASES,
                         ids=lambda c: "x".join(map(str, c[:6]))
                         + ("-strong" if c[6] else ""))
def test_subchunked_form_matches_jax(case, mode, bonus, carry):
    """The plain version of the kernel's formulation against the JAX oracle,
    chunked reference and interpret-mode Pallas kernel, from a zero or a
    carried initial state."""
    B, H, T, K, V, chunk, strong = case
    a = _inputs(sum(case[:6]), B, H, T, K, V, strong=strong)
    u = a["u"] if bonus else None
    s0 = (0.1 * np.random.default_rng(T).normal(size=(B, H, K, V))
          ).astype(np.float32) if carry else None
    j0 = {} if s0 is None else dict(initial_state=jnp.asarray(s0))
    t0 = {} if s0 is None else dict(initial_state=torch.from_numpy(s0))
    want = {"jax seq": _jax(jax_seq, a, u, mode=mode, **j0),
            "jax chunked": _jax(jax_chunked, a, u, mode=mode, chunk=chunk,
                                **j0)}
    if not (mode == "rwkv6" and u is None):   # see the test above
        want["jax pallas"] = _jax(linear_scan_pallas, a, u, mode=mode,
                                  chunk=chunk, interpret=True, **j0)
    go, gs = _torch(linear_scan_subchunked, a, u, mode=mode, chunk=chunk,
                    **t0)
    assert go.shape == (B, H, T, V) and gs.shape == (B, H, K, V)
    assert np.isfinite(go).all() and np.isfinite(gs).all()
    for wname, (wo, ws) in want.items():
        np.testing.assert_allclose(go, wo, **TOL, err_msg=f"o vs {wname}")
        np.testing.assert_allclose(gs, ws, **TOL, err_msg=f"S vs {wname}")
