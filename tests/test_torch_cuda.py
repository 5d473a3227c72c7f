"""The hand-written CUDA kernels against their plain PyTorch versions.

Runs only where there is a CUDA card (it skips here otherwise) and imports
nothing of JAX, so it also runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are the serving path's (GRU: 8 refit slots x B windows, T=24, D=4,
H=32; RK4: n=3, order 3, T=24) with a full and a ragged batch.  Tolerances:
forward GRU 1e-5 absolute and RK4 rtol 1e-4 / atol 1e-5 (fp32 sums in
another order than the plain version); gradients rtol 1e-4 / atol 1e-5 (the
backward replays the plain version on the saved inputs).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.library import make_library
from repro_torch.kernels.gru.ops import gru_scan
from repro_torch.kernels.gru.ref import gru_scan_ref
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref

GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.tensor(a, dtype=torch.float32, device=dev,
                         requires_grad=True) for a in arrays]


def _grads(fn, args):
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(torch.mean(o * o) for o in outs).backward()
    return outs, [a.grad for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 61])
@pytest.mark.parametrize("fleet", [8, None])
def test_gru_kernel_matches_plain_version(cuda, B, fleet):
    rng = np.random.default_rng(B)
    D, H = 4, 32
    wl = (fleet,) if fleet else ()
    lead = (fleet or 2, B)
    arrays = (rng.normal(size=lead + (24, D)),
              0.1 * rng.normal(size=lead + (H,)),
              rng.uniform(-0.5, 0.5, wl + (D, 3 * H)),
              rng.uniform(-0.18, 0.18, wl + (H, 3 * H)),
              0.1 * rng.normal(size=wl + (3 * H,)))
    args, ref_args = _on(cuda, *arrays), _on(cuda, *arrays)
    before = gru_scan.launches
    outs, grads = _grads(gru_scan, args)
    torch.cuda.synchronize()
    assert gru_scan.launches == before + 1
    ref_outs, ref_grads = _grads(gru_scan_ref, ref_args)
    for o, r in zip(outs, ref_outs):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 61])
@pytest.mark.parametrize("m", [1, 0])
def test_rk4_kernel_matches_plain_version(cuda, B, m):
    rng = np.random.default_rng(B + m)
    lib = make_library(3, m, 3)
    arrays = (0.1 * rng.normal(size=(B, 3, lib.size)),
              0.3 * rng.normal(size=(B, 3)),
              0.2 * rng.normal(size=(B, 24, m)))
    args, ref_args = _on(cuda, *arrays), _on(cuda, *arrays)
    before = rk4_poly_solve.launches
    outs, grads = _grads(
        lambda *a: rk4_poly_solve(*a, dt=0.01, library=lib), args)
    torch.cuda.synchronize()
    assert rk4_poly_solve.launches == before + 1
    ref_outs, ref_grads = _grads(
        lambda *a: rk4_poly_solve_ref(*a, 0.01, lib.indices_on(cuda)),
        ref_args)
    torch.testing.assert_close(outs[0], ref_outs[0], rtol=1e-4, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **GRAD)
