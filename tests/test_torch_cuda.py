"""The hand-written CUDA kernels against their plain PyTorch versions.

Runs only where there is a CUDA card (it skips here otherwise) and imports
nothing of JAX, so it also runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are the serving path's (GRU: 8 refit slots x B windows, T=24, D=4,
H=32, and H=16, 48, 64, 100, T=1, 50 (two prologue chunks), B=1, D=5;
RK4: n=3, order 3, T=24) with a full and a ragged batch, and RK4 at
one instance, a fleet of 2048, n = 1 without inputs, L past two term
groups and orders above 4.  Offline recovery's shapes: the GRU at input
widths 2 and 3 (hidden 64) and at F-8's recover (776 windows, hidden
96); RK4 at every registered system's (n, m, order) and over one
6,000-step F-8 simulation (each trace within 1e-4 of its envelope).  The
kernels' wide paths: RK4 at F8Crusader(n_aircraft=6, 11, 12) (n = 18, 33,
36 states past the warp path's 16; Theta staged, read through L2, and Phi
in two chunks) and at 1 + n + m = 35, the GRU at H = 137, 160, 256 and
1100 past the fast paths' 136, and at that edge (H = 136) at D = 4 and
16.  Tolerances: forward GRU 1e-5 absolute and RK4
rtol 1e-4 / atol 1e-5 (fp32 sums in another order than the plain version);
gradients rtol 1e-4 / atol 1e-5 (the backward replays the plain version on
the saved inputs).  The linear scan (RWKV-6 prefill: H=40, K=V=64, chunk
64; plus a short, a wide, an odd, a long (B*H=160, T=4096), a ragged
(T=2047) and a 24-row-chunk shape) is held to its plain chunked version at
rtol = atol = 2e-4, the JAX package's f32 tolerance: both sides upcast the
same bf16 or f32 values and sum in f32 in another order; so is the scan in
ssd mode on Mamba-2's operands (zamba2-7b's H=112, K=V=64 over 2048
tokens, and the SMOKE width K=V=16).  A 2-layer zamba2-7b at full width
in f32, card against CPU (prefill and 2 decode steps, 1e-3).  The MoE and
the encoder-decoder run no kernel of ours; their einsums and attention are
held card against CPU in f32: `moe_apply` at mixtral-8x22b's width
(d_model 6144, d_ff 16384) with 2 experts, and `whisper_encode` at
whisper-large-v3's width over 1,500 frames (2 layers), both within 1e-3.
Training: the scan's gradients (kernel forward, the plain version replayed
in the backward) against the plain version's, each within 1e-3 of its
envelope, and one AdamW step of rwkv6-3b SMOKE card against CPU.  The
allocation-free specs: every leaf's shape, dtype and bytes equal to what
init allocates on the card (rwkv6, zamba2, whisper SMOKE).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.library import make_library
from repro_torch.kernels.gru.ops import gru_scan
from repro_torch.kernels.gru.ref import gru_scan_ref
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
from repro_torch.systems.f8_crusader import F8Crusader
from repro_torch.systems.simulate import register_systems

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
@pytest.mark.parametrize("H", [16, 32, 48, 64, 100])
@pytest.mark.parametrize("T", [1, 24, 50])
@pytest.mark.parametrize("B", [1, 8, 61])
@pytest.mark.parametrize("fleet", [8, None])
@pytest.mark.parametrize("D", [4, 5])
def test_gru_kernel_matches_plain_version(cuda, H, T, B, fleet, D):
    # the serving width's cases (H=32, T=24, D=4) keep their first seed;
    # Wh's range 0.18 * sqrt(32 / H) keeps h's scale at every width
    rng = np.random.default_rng(B if (H, T, D) == (32, 24, 4)
                                else (B, H, T, D))
    wl = (fleet,) if fleet else ()
    lead = (fleet or 2, B)
    s = 0.18 * (32 / H) ** 0.5
    arrays = (rng.normal(size=lead + (T, D)),
              0.1 * rng.normal(size=lead + (H,)),
              rng.uniform(-0.5, 0.5, wl + (D, 3 * H)),
              rng.uniform(-s, s, wl + (H, 3 * H)),
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,order,T", [
    (1, 3, 1, 3, 50),        # predict: one instance, L = 35 > 32
    (2048, 3, 1, 3, 32),     # a fleet: 512 blocks
    (7, 1, 0, 3, 24),        # n = 1, m = 0: no input lane
    (5, 6, 1, 3, 10),        # L = 120: term groups past the registers
    (3, 2, 1, 6, 8),         # order 6: padded to 8 factors
    (2, 16, 15, 1, 6),       # n = 16, 1 + n + m = 32 lanes
], ids=lambda x: str(x))
def test_rk4_kernel_shapes(cuda, B, n, m, order, T):
    rng = np.random.default_rng(B + n + m + order)
    lib = make_library(n, m, order)
    theta, y0, us = (torch.tensor(a, dtype=torch.float32, device=cuda)
                     for a in (0.05 * rng.normal(size=(B, n, lib.size)),
                               0.3 * rng.normal(size=(B, n)),
                               0.2 * rng.normal(size=(B, T, m))))
    before = rk4_poly_solve.launches
    with torch.no_grad():
        ys = rk4_poly_solve(theta, y0, us, dt=0.01, library=lib)
    torch.cuda.synchronize()
    assert rk4_poly_solve.launches == before + 1
    ref = rk4_poly_solve_ref(theta, y0, us, 0.01, lib.indices_on(cuda))
    torch.testing.assert_close(ys, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,B", [(2, 64, 64), (3, 64, 64), (2, 64, 13),
                                   (3, 64, 13), (4, 96, 776)])
def test_gru_kernel_offline_widths(cuda, D, H, B):
    """Offline recovery's encoder: Table I's m = 0 systems (D = n = 2, 3)
    at hidden 64, and F-8's recover over 776 windows at hidden 96; shared
    weights, forward and gradients."""
    rng = np.random.default_rng((D, H, B))
    s = 0.18 * (32 / H) ** 0.5
    arrays = (rng.normal(size=(B, 24, D)), 0.1 * rng.normal(size=(B, H)),
              rng.uniform(-0.5, 0.5, (D, 3 * H)),
              rng.uniform(-s, s, (H, 3 * H)), 0.1 * rng.normal(size=(3 * H,)))
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


def _system_inputs(name, B, T, substeps, seed):
    """A registered system's library and perturbed coefficients, y0 and
    inputs from its spec (inputs repeated `substeps` times)."""
    system = register_systems()[name]()
    lib = system.library()
    gen = torch.Generator().manual_seed(seed)
    true = torch.as_tensor(system.true_theta(lib), dtype=torch.float32)
    theta = true * (1 + 0.05 * torch.randn((B,) + true.shape, generator=gen))
    y0 = system.sample_y0(gen, (B,))
    us = system.sample_inputs(gen, T, (B,)).movedim(0, 1)
    return (lib, system.spec.dt / substeps,
            (theta, y0, us.repeat_interleave(substeps, dim=1)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(register_systems()))
def test_rk4_kernel_at_every_system_shape(cuda, name):
    """Every registered system's (n, m, order), m = 0 included: 61
    instances, 24 steps of its own dt, forward and gradients."""
    lib, dt, arrays = _system_inputs(name, 61, 24, 1, len(name))
    args = [a.to(cuda).requires_grad_() for a in arrays]
    ref_args = [a.to(cuda).requires_grad_() for a in arrays]
    before = rk4_poly_solve.launches
    outs, grads = _grads(
        lambda *a: rk4_poly_solve(*a, dt=dt, library=lib), args)
    torch.cuda.synchronize()
    assert rk4_poly_solve.launches == before + 1
    ref_outs, ref_grads = _grads(
        lambda *a: rk4_poly_solve_ref(*a, dt, lib.indices_on(cuda)),
        ref_args)
    torch.testing.assert_close(outs[0], ref_outs[0], rtol=1e-4, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **GRAD)


@pytest.mark.cuda
def test_rk4_kernel_over_a_simulation(cuda):
    """One F-8 simulation in one launch: 4 traces of 600 samples x 10
    substeps = 6,000 steps, each trace within 1e-4 of its envelope of the
    plain version (rounding over 6,000 steps)."""
    lib, dt, arrays = _system_inputs("f8_crusader", 4, 600, 10, 0)
    theta, y0, us = (a.to(cuda) for a in arrays)
    with torch.no_grad():
        ys = rk4_poly_solve(theta, y0, us, dt=dt, library=lib)
        ref = rk4_poly_solve_ref(theta, y0, us, dt, lib.indices_on(cuda))
    assert ys.shape == (4, 6001, 3)
    finite = torch.isfinite(ref).flatten(1).all(dim=1)
    assert torch.equal(torch.isfinite(ys).flatten(1).all(dim=1), finite)
    err = (ys - ref)[finite].abs().flatten(1).max(dim=1).values
    assert (err <= 1e-4 * ref[finite].abs().flatten(1).max(dim=1).values
            ).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,T", [(6, 300), (11, 300), (12, 20)])
def test_rk4_kernel_wide_path_f8_stacks(cuda, k, T):
    """F8Crusader(n_aircraft=k) stacks k airframes: n = 3k states and one
    shared input, past the warp path's 16 states.  The wide path (a block
    an instance) runs it: k = 6 (L = 1,540) with Theta staged in shared
    memory, k = 11 (L = 7,770) reading Theta through L2, k = 12 (L =
    9,880) in two Phi chunks.  B = 2, forward and gradients, at the
    tolerances of every other system."""
    system = F8Crusader(n_aircraft=k)
    lib = system.library()
    gen = torch.Generator().manual_seed(k)
    true = torch.as_tensor(system.true_theta(lib), dtype=torch.float32)
    arrays = (true * (1 + 0.05 * torch.randn((2,) + true.shape,
                                             generator=gen)),
              system.sample_y0(gen, (2,)),
              system.sample_inputs(gen, T, (2,)).movedim(0, 1))
    args = [a.to(cuda).requires_grad_() for a in arrays]
    ref_args = [a.to(cuda).requires_grad_() for a in arrays]
    before = rk4_poly_solve.launches
    outs, grads = _grads(
        lambda *a: rk4_poly_solve(*a, dt=system.spec.dt, library=lib), args)
    torch.cuda.synchronize()
    assert rk4_poly_solve.launches == before + 1
    assert outs[0].shape == (2, T + 1, 3 * k)
    assert torch.isfinite(outs[0]).all()
    ref_outs, ref_grads = _grads(
        lambda *a: rk4_poly_solve_ref(*a, system.spec.dt,
                                      lib.indices_on(cuda)), ref_args)
    torch.testing.assert_close(outs[0], ref_outs[0], rtol=1e-4, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **GRAD)


@pytest.mark.cuda
def test_rk4_kernel_wide_path_many_inputs(cuda):
    """1 + n + m > 32 with n <= 16 (n = 4, m = 30) also takes the wide
    path; order 2, 61 instances, forward and gradients."""
    lib = make_library(4, 30, 2)
    rng = np.random.default_rng(30)
    arrays = (0.05 * rng.normal(size=(61, 4, lib.size)),
              0.1 * rng.normal(size=(61, 4)),
              0.1 * rng.normal(size=(61, 24, 30)))
    args, ref_args = _on(cuda, *arrays), _on(cuda, *arrays)
    outs, grads = _grads(
        lambda *a: rk4_poly_solve(*a, dt=0.01, library=lib), args)
    ref_outs, ref_grads = _grads(
        lambda *a: rk4_poly_solve_ref(*a, 0.01, lib.indices_on(cuda)),
        ref_args)
    torch.testing.assert_close(outs[0], ref_outs[0], rtol=1e-4, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,F,B", [(4, 136, 2, 5), (4, 137, 2, 5),
                                     (4, 160, 8, 8), (4, 256, 8, 8),
                                     (16, 136, 2, 5), (16, 137, 2, 5),
                                     (4, 1100, 1, 3)])
def test_gru_kernel_wide_path(cuda, D, H, F, B):
    """Hidden widths past the fast paths' 136 (Wh no longer fits a block's
    shared memory beside the prologue) take the wide path: Wh read through
    L2, up to 1024 threads a sequence, several units a thread past H =
    1024.  H = 136 is the fast paths' edge at D = 4 and at D = 16; per-slot
    weights, T = 24, forward and gradients."""
    rng = np.random.default_rng((D, H, F, B))
    s = 0.18 * (32 / H) ** 0.5
    arrays = (rng.normal(size=(F, B, 24, D)), 0.1 * rng.normal(size=(F, B, H)),
              rng.uniform(-0.5, 0.5, (F, D, 3 * H)),
              rng.uniform(-s, s, (F, H, 3 * H)),
              0.1 * rng.normal(size=(F, 3 * H)))
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


def _scan_inputs(dev, B, H, T, K, V, dtype, seed, strong=False):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=dtype: torch.tensor(a, dtype=torch.float32,
                                         device=dev).to(dt)
    lo, hi = (-1.0, 2.0) if strong else (-7.0, -1.5)
    return (t(0.5 * rng.normal(size=(B, H, T, K))),
            t(0.5 * rng.normal(size=(B, H, T, K))),
            t(0.5 * rng.normal(size=(B, H, T, V))),
            t(-np.exp(rng.uniform(lo, hi, (B, H, T, K))), torch.float32),
            t(0.3 * rng.normal(size=(H, K)), torch.float32))


SCAN_SHAPES = {                      # (B, H, T, K, V, chunk)
    "prefill": (1, 40, 1000, 64, 64, 64),
    "short": (1, 40, 37, 64, 64, 64),
    "wide": (3, 48, 130, 64, 64, 64),
    "odd": (2, 3, 50, 10, 6, 16),
    "long": (4, 40, 4096, 64, 64, 64),     # B*H = 160, 64 chunks
    "ragged": (1, 8, 2047, 64, 64, 64),    # T not a multiple of 16
    "chunk24": (2, 4, 333, 32, 48, 24),    # chunks of three subchunks
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SCAN_SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode,bonus", [("ssd", False), ("rwkv6", True),
                                        ("rwkv6", False)],
                         ids=["ssd", "rwkv6", "rwkv6-no-u"])
def test_linear_scan_kernel_matches_plain_version(cuda, shape, dtype, mode,
                                                  bonus):
    B, H, T, K, V, chunk = SCAN_SHAPES[shape]
    q, k, v, w, u = _scan_inputs(cuda, B, H, T, K, V, dtype, T + K)
    u = u if bonus else None
    s0 = 0.1 * torch.randn(B, H, K, V, device=cuda)
    before = linear_scan.launches
    with torch.no_grad():
        o, s = linear_scan(q, k, v, w, u, mode=mode, chunk=chunk,
                           initial_state=s0)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    ro, rs = linear_scan_chunked(q, k, v, w, u, mode=mode, chunk=chunk,
                                 initial_state=s0)
    torch.testing.assert_close(o, ro, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, rs, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ssd", "rwkv6"])
def test_linear_scan_kernel_carry_and_strong_decay(cuda, mode):
    """Two halves with the state carried equal the whole, and decays down
    to exp(-7.4) per step neither overflow nor leave the plain version."""
    q, k, v, w, u = _scan_inputs(cuda, 1, 40, 300, 64, 64, torch.bfloat16,
                                 5, strong=True)
    with torch.no_grad():
        o, s = linear_scan(q, k, v, w, u, mode=mode)
        o1, s1 = linear_scan(*(x[:, :, :130] for x in (q, k, v, w)), u,
                             mode=mode)
        o2, s2 = linear_scan(*(x[:, :, 130:] for x in (q, k, v, w)), u,
                             mode=mode, initial_state=s1)
    ro, rs = linear_scan_chunked(q, k, v, w, u, mode=mode)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    torch.testing.assert_close(o, ro, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, rs, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(torch.cat([o1, o2], dim=2), o, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(s2, s, rtol=2e-4, atol=2e-4)


def _mamba2_operands(dev, B, H, T, K, V, dtype, seed):
    """The scan's operands as models/mamba2.py builds them: q = C_t and
    k = B_t shared by every head, v = dt * x, w = -exp(A_log) * dt one
    value a head broadcast over K, A_log = log(linspace(1, 16, H)) as
    mamba2_init draws it and dt = softplus(N(0, 2) + dt_bias), so a step
    decays by up to exp(-16 dt) with dt reaching several units."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    C = f32(rng.normal(size=(B, 1, T, K)))
    Bt = f32(rng.normal(size=(B, 1, T, K)))
    dt_bias = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                 H))))
    dt = torch.nn.functional.softplus(
        f32(2.0 * rng.normal(size=(B, H, T)) + dt_bias[None, :, None]))
    a = torch.linspace(1.0, 16.0, H, device=dev)
    x = f32(rng.normal(size=(B, H, T, V))).to(dtype)
    return (C.to(dtype).expand(B, H, T, K), Bt.to(dtype).expand(B, H, T, K),
            x * dt[..., None].to(dtype),
            (-a[None, :, None] * dt)[..., None].expand(B, H, T, K))


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["zamba2 H=112 K=V=64",
                                   "smoke H=8 K=V=16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_linear_scan_kernel_at_mamba2_operands(cuda, width, dtype):
    """ssd mode on Mamba-2's own operands: zamba2-7b's 112 heads of
    K = V = 64 over a 2048-token prefill, and the SMOKE width K = V = 16,
    fresh and from a carried state."""
    H, K, T = (112, 64, 2048) if width.startswith("zamba2") else (8, 16, 333)
    q, k, v, w = _mamba2_operands(cuda, 1, H, T, K, K, dtype, K)
    s0 = 0.1 * torch.randn(1, H, K, K, device=cuda)
    for init in (None, s0):
        with torch.no_grad():
            o, s = linear_scan(q, k, v, w, mode="ssd", initial_state=init)
        torch.cuda.synchronize()
        ro, rs = linear_scan_chunked(q, k, v, w, mode="ssd",
                                     initial_state=init)
        assert torch.isfinite(o).all() and torch.isfinite(s).all()
        torch.testing.assert_close(o, ro, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(s, rs, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_zamba2_prefill_card_against_cpu(cuda):
    """zamba2-7b at full width, 2 layers (no whole cycle: the shared block
    runs once, before the tail), f32: the same weights on the card and on
    the CPU give prefill logits and 2 decode steps within 1e-3 (3584- and
    14336-long f32 dot products summed in another order), equal greedy
    tokens, and the prefill launched the scan once a layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    cfg = get_arch("zamba2-7b").config.with_(n_layers=2,
                                             dtype=torch.float32)
    params = tfm.init_params(cfg, seed=3, device=cuda)
    host = _to_cpu(params)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(1, 200)))
    out = []
    with torch.no_grad():
        for dev, p in ((cuda, params), ("cpu", host)):
            before = linear_scan.launches
            cache, logits = tfm.prefill(cfg, p, prompt.to(dev), 210)
            launched = linear_scan.launches - before
            steps = [logits.cpu()]
            for _ in range(2):
                tok = torch.argmax(logits, dim=-1)
                cache, logits = tfm.decode_step(cfg, p, cache, tok)
                steps.append(logits.cpu())
            out.append((launched, steps))
    assert out[0][0] == cfg.n_layers and out[1][0] == 0
    for card, cpu in zip(out[0][1], out[1][1]):
        assert torch.argmax(card) == torch.argmax(cpu)
        torch.testing.assert_close(card, cpu, rtol=1e-3, atol=1e-3)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# the scan's gradients, kernel forward against the plain forward: each
# leaf within this share of its envelope (max |g|); the backward replays
# the plain version on the same inputs, so the gradients differ only by
# the cotangent 2 o / N, which the kernel's o carries to within 2e-4.  A
# bf16 leaf's gradient is rounded to bf16: one rounding apart is up to
# 2^-7 of the envelope, added to its limit
SCAN_GRAD_REL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_linear_scan_kernel_gradients_match_plain_version(cuda, mode,
                                                          dtype):
    """Kernel forward, plain backward replayed under autograd: the
    gradients of q, k, v, w, u and the initial state equal the plain
    version's (each in its input's dtype), one launch a call."""
    q, k, v, w, u = _scan_inputs(cuda, 2, 8, 300, 64, 64, dtype, 11)
    s0 = 0.1 * torch.randn((2, 8, 64, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
    args = [t.clone().requires_grad_() for t in (q, k, v, w, u, s0)]
    ref_args = [t.clone().requires_grad_() for t in (q, k, v, w, u, s0)]
    uu = lambda a: a[4] if mode == "rwkv6" else None
    before = linear_scan.launches
    o, s = linear_scan(*args[:4], uu(args), mode=mode,
                       initial_state=args[5])
    assert linear_scan.launches == before + 1
    ro, rs = linear_scan_chunked(*ref_args[:4], uu(ref_args), mode=mode,
                                 initial_state=ref_args[5])
    loss = lambda o, s: torch.mean(o * o) + torch.mean(s * s)
    grads = torch.autograd.grad(loss(o, s), args, allow_unused=True)
    ref = torch.autograd.grad(loss(ro, rs), ref_args, allow_unused=True)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1       # the backward replays
    for i, (g, r) in enumerate(zip(grads, ref)):
        if r is None:                                # u in ssd mode
            assert g is None and mode == "ssd" and i == 4
            continue
        assert g.dtype == args[i].dtype
        scale = float(r.abs().max())
        limit = SCAN_GRAD_REL + (2.0 ** -7 if g.dtype == torch.bfloat16
                                 else 0.0)
        assert float((g.float() - r.float()).abs().max()) <= \
            limit * scale, i


@pytest.mark.cuda
def test_rwkv6_smoke_train_step_card_against_cpu(cuda):
    """One AdamW step (train_lm's optimizer) of rwkv6-3b SMOKE in f32, card
    against CPU from the same weights and tokens: loss and every parameter
    within 1e-4 (64-wide f32 sums in another order); on the card the scan
    launched twice a layer (each layer recomputed in the backward)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.zoo import build
    from repro_torch.train.optimizer import (adamw, cosine_schedule,
                                             tree_leaves)
    from repro_torch.train.train_state import init_state, make_train_step
    cfg = get_arch("rwkv6-3b").smoke.with_(remat=True)
    api = build(cfg)
    batch = TokenStream(vocab=cfg.vocab, batch=2, seq_len=96).batch_at(0)
    params = api.init(seed=0, device="cpu")
    out = []
    for dev in (cuda, "cpu"):
        o = adamw(lr=cosine_schedule(3e-3, 1, 3), weight_decay=0.1)
        step = make_train_step(api.loss, o)
        state = init_state(_to(params, dev), o)
        before = linear_scan.launches
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in batch.items()})
        out.append((linear_scan.launches - before, m["loss"].cpu(),
                    _to_cpu(state["params"])))
    assert out[0][0] == 2 * cfg.n_layers and out[1][0] == 0
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _fleet_ticks(srv, ys, ticks=8, per_tick=10):
    """Per tick: grants, active slots, per-shard losses, guard events."""
    out = []
    for t in range(ticks):
        srv.ingest_many([(i, ys[i, t * per_tick:(t + 1) * per_tick])
                         for i in range(ys.shape[0])])
        rep = srv.tick()
        out.append((rep.grants, rep.n_active, [r.loss for r in rep.reports],
                    [(e.tick, e.twin_id, e.kind, e.score)
                     for e in rep.events], rep.dead_shards))
    return out


@pytest.mark.cuda
def test_federated_workers_equal_in_process_shards_on_the_card(cuda):
    """2 worker processes, each with its own CUDA context, serve what 2
    in-process shards serve on the card: grants, active slots and guard
    transitions equal, losses and scores within 1e-6 relative (the same
    kernels on the same inputs); every worker launched both kernels."""
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.systems.lotka_volterra import LotkaVolterra
    from repro_torch.systems.simulate import simulate_batch
    from repro_torch.twin import (FederatedTwinConfig, FederatedTwinServer,
                                  GuardConfig, ShardedTwinConfig,
                                  ShardedTwinServer, TwinServerConfig)
    system = LotkaVolterra()
    ys = simulate_batch(system, torch.Generator().manual_seed(0), 8,
                        horizon=300, noise_std=0.002,
                        device="cpu").ys_noisy.numpy()
    cfg = TwinServerConfig(
        merinda=MerindaConfig(n=2, m=0, order=2, hidden=16, head_hidden=16,
                              n_active=6, dt=system.spec.dt),
        max_twins=4, refit_slots=2, capacity=128, window=16, stride=8,
        windows_per_twin=4, steps_per_tick=1, deploy_after=2,
        min_residency=1, max_residency=4, guard=GuardConfig(window=16))
    true = np.asarray(system.true_theta(system.library()), np.float32)
    thetas = np.stack([true if i % 3 else -true for i in range(8)])
    kw = dict(total_slots=3, rebalance_every=2)
    inproc = ShardedTwinServer(ShardedTwinConfig.uniform(cfg, 2, **kw))
    try:
        inproc.deploy_many(list(range(8)), thetas)
        want = _fleet_ticks(inproc, ys)
    finally:
        inproc.close()
    fed = FederatedTwinServer(FederatedTwinConfig.uniform(cfg, 2, **kw))
    try:
        fed.deploy_many(list(range(8)), thetas)
        got = _fleet_ticks(fed, ys)
        procs = fed.worker_processes()
    finally:
        fed.close()
    for t, (g, w) in enumerate(zip(got, want)):
        assert (g[0], g[1], g[4]) == (w[0], w[1], w[4]) == \
            (w[0], w[1], 0), t
        assert [e[:3] for e in g[3]] == [e[:3] for e in w[3]], t
        np.testing.assert_allclose([e[3] for e in g[3]],
                                   [e[3] for e in w[3]], rtol=1e-6)
        assert [x is None for x in g[2]] == [x is None for x in w[2]], t
        np.testing.assert_allclose([x for x in g[2] if x is not None],
                                   [x for x in w[2] if x is not None],
                                   rtol=1e-6)
    assert any(x is not None for t in want for x in t[2])
    assert all(p["device"].startswith("cuda") for p in procs)
    assert all(p["gru_scan_launches"] > 0 and p["rk4_poly_launches"] > 0
               for p in procs)


@pytest.mark.cuda
def test_moe_apply_card_against_cpu(cuda):
    """mixtral-8x22b's expert width with 2 experts (2.4 GB of f32 weights a
    side), 1,024 tokens in 2 groups of 512 at capacity 1.25: the same
    routing (support equal) and outputs within 1e-3 (6144- and 16384-long
    f32 dot products in another order)."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.moe_init(gen, 6144, 16384, 2, "swiglu", torch.float32)
    host = _to_cpu(params)
    x = torch.randn((2, 512, 6144), device=cuda, generator=gen)
    kw = dict(n_experts=2, top_k=2, capacity_factor=1.25, group_size=512)
    routed = []
    real = moe.router_topk

    def record(logits, top_k, capacity):
        combine, aux = real(logits, top_k, capacity)
        routed.append((combine > 0).cpu())
        return combine, aux
    moe.router_topk = record
    try:
        with torch.no_grad():
            y, aux = moe.moe_apply(params, x, **kw)
            y_cpu, aux_cpu = moe.moe_apply(host, x.cpu(), **kw)
    finally:
        moe.router_topk = real
    assert torch.equal(routed[0], routed[1])
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_whisper_encode_card_against_cpu(cuda):
    """whisper-large-v3's width (d_model 1280, 20 heads, d_ff 5120), 2
    encoder layers, 1,500 frames drawn x 0.1: the card's encoder output
    within 1e-3 of the CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec
    cfg = get_arch("whisper-large-v3").config.with_(
        enc_layers=2, n_layers=1, dtype=torch.float32)
    params = encdec.whisper_init(cfg, seed=0, device=cuda)
    host = _to_cpu(params)
    enc_x = torch.from_numpy((np.random.default_rng(0).normal(
        size=(1, 1500, cfg.d_model)) * 0.1).astype(np.float32))
    with torch.no_grad():
        got = encdec.whisper_encode(cfg, params, enc_x.to(cuda))
        want = encdec.whisper_encode(cfg, host, enc_x)
    assert got.shape == (1, 1500, cfg.d_model)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_specs_bytes_equal_init_on_the_card(cuda, arch):
    """The allocation-free specs against what init allocates on the card:
    every leaf's shape, dtype and bytes for the parameters (SMOKE), the
    AdamW state, the cache and a batch."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.zoo import build
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_state import init_state, state_specs

    def layout(tree):
        return [(tuple(t.shape), t.dtype, t.nbytes)
                for t in tree_flatten(tree)[0]]

    cfg = get_arch(arch).smoke
    api = build(cfg)
    params = api.init(seed=0, device=cuda)
    assert layout(api.param_specs()) == layout(params)
    assert layout(state_specs(api.param_specs(), adamw())) == layout(
        init_state(params, adamw()))
    assert layout(api.cache_specs(2, 64)) == layout(
        api.cache_init(2, 64, device=cuda))
    batch = TokenStream(vocab=cfg.vocab, batch=2, seq_len=64,
                        d_frontend=cfg.d_model if api.is_encdec else None
                        ).batch_at(0)
    specs = api.batch_specs(2, 64)
    assert set(specs) == set(batch)
    assert [tuple(specs[k].shape) for k in sorted(specs)] == [
        batch[k].shape for k in sorted(batch)]
