"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (src/repro_torch) only; it imports nothing of JAX.  Phases,
each of which raises on failure (the script then exits nonzero):

  1. build   the hand-written CUDA kernels from csrc/ (nvcc, one process per
             source, all started together);
  2. check   each kernel against its plain PyTorch version at the serving
             paths' shapes (plus a ragged batch, RK4 with m == 0, GRU with
             shared and per-slot weights, at H = 16, 48, 64, 96, 100, 128,
             136, T = 1, 50, B = 1 and the offline fleet's shape, forward
             and gradients; the linear
             scan in both modes, bf16 and f32, with and without the bonus,
             ragged, short, carried and wide);
  3. serve   64 F-8 twins at the repo's own serving width
             (examples/online_twinning.py), warm-started with the true
             theta, 12 airframes damaged mid-stream, 40 ticks of 8 samples
             per twin, then predict and scenario requests;
  4. parity  the first 10 ticks again on the CPU (plain versions), per-tick
             losses and admissions held to the card's;
  5. LM      rwkv6-3b at its published width (32 layers, d_model 2560, bf16,
             random weights from a seed) behind a 4-slot ServeEngine: 8
             greedy requests, prompts of 256-2048 tokens, 32 new tokens each;
             then one more prefill and 4 decode steps under torch.profiler;
  6. LM parity  the same architecture at 2 layers in f32, card against CPU:
             prefill and 16 decode steps' logits, greedy tokens;
  7. time    each kernel and its plain version at every serving shape (GRU:
             the online tick's refit, the offline fleet's and the F-8
             training width's; RK4: refit,
             guard, promote, predict, scenario, a fleet of 2048; the scan:
             prompts of 256-4096 tokens, 4 prompts of 2048), and the scan's
             three launches apart.

Kernel launch counts are set to 0 just before each serving path (tick,
predict, scenario, LM prefill, LM decode) and read just after it.

The last three lines of output are the kernel JSON line, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.  Without a CUDA
device the script exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

CHUNK = 8             # telemetry samples per twin per tick
HISTORY = 96          # samples each twin has streamed before the first tick
TWINS, DAMAGED, TICKS, DAMAGE_TICK, WARMUP = 64, 12, 40, 4, 3
PARITY_TICKS = 10
PROFILE_TICKS = 3     # extra ticks traced by torch.profiler after serving
# H100 SXM peaks: f32 outside the tensor cores, TF32 on them (dense), HBM
FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
GRU_TOL = dict(rtol=0.0, atol=1e-5)        # fp32, sums in another order
RK4_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # backward replays the plain path
# linear scan against its plain chunked version: both sides upcast the same
# bf16 / f32 values and sum in f32 in another order -- the JAX package's f32
# tolerance between its chunked forms and the sequential oracle
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# card against CPU, f32 LM logits: 2560- and 8960-long f32 dot products and
# the recurrence summed in another order, through 2 layers
LM_TOL = dict(rtol=1e-3, atol=1e-3)
LM_SLOTS, LM_REQUESTS, LM_NEW, LM_PROMPTS = 4, 8, 32, (256, 2048)
LM_PARITY_LAYERS, LM_PARITY_PROMPT, LM_PARITY_STEPS = 2, 300, 16
LM_PROFILE_STEPS = 4  # decode steps traced by torch.profiler after serving
# the kernels each serving path must launch (the LM decode path none)
# the CUDA kernels of csrc/, as the profiler names them
OWN_KERNELS = ("gru_scan_kernel", "rk4_poly_kernel", "chunk_state_kernel",
               "state_scan_kernel", "chunk_output_kernel")
PATH_KERNELS = {"tick": ("gru_scan", "rk4_poly"), "predict": ("rk4_poly",),
                "scenario": ("rk4_poly",), "lm_prefill": ("linear_scan",),
                "lm_decode": ()}


def _server_config():
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.server import TwinServerConfig
    return TwinServerConfig(
        merinda=MerindaConfig(n=3, m=1, order=3, dt=0.01, hidden=32,
                              head_hidden=32, n_active=24),
        max_twins=TWINS, refit_slots=8, capacity=256, window=24, stride=8,
        windows_per_twin=8, steps_per_tick=2, sparsify_after=40,
        deploy_after=16, min_residency=4, max_residency=24,
        guard=GuardConfig(window=32), deadline_s=1.0)


def _systems():
    """Nominal and elevator-damaged F-8, confined to the trim neighbourhood
    as examples/online_twinning.py does (half the y0 range, inputs 0.03)."""
    from repro_torch.systems.f8_crusader import F8Crusader
    base = F8Crusader()
    nominal = dataclasses.replace(
        base, y0_low=tuple(0.5 * v for v in base.y0_low),
        y0_high=tuple(0.5 * v for v in base.y0_high), input_scale=0.03)
    return nominal, dataclasses.replace(nominal, elevator_effectiveness=0.25)


def telemetry(device, seed: int = 0):
    """Host arrays ys [TWINS, HISTORY + (TICKS+PROFILE_TICKS)*CHUNK + 1, 3],
    us [..., 1]:
    all airframes nominal until DAMAGE_TICK, then the first DAMAGED lose
    three quarters of their elevator authority."""
    from repro_torch.systems.f8_crusader import simulate, sum_of_sines
    nominal, damaged = _systems()
    gen = torch.Generator().manual_seed(seed)
    pre = HISTORY + DAMAGE_TICK * CHUNK
    post = (TICKS + PROFILE_TICKS - DAMAGE_TICK) * CHUNK
    ys1, noisy1, us1 = simulate(nominal, gen, batch=TWINS, horizon=pre,
                                noise_std=0.002, device=device)
    us2 = sum_of_sines(gen, TWINS, post, 1, nominal.dt, nominal.input_scale)
    _, noisy2, _ = simulate(nominal, gen, batch=TWINS, horizon=post,
                            noise_std=0.002, y0=ys1[:, -1], us=us2,
                            device=device)
    _, noisy_d, _ = simulate(damaged, gen, batch=DAMAGED, horizon=post,
                             noise_std=0.002, y0=ys1[:DAMAGED, -1],
                             us=us2[:DAMAGED], device=device)
    noisy2[:DAMAGED] = noisy_d
    ys = torch.cat([noisy1[:, :-1], noisy2], dim=1).cpu().numpy()
    us = torch.cat([us1.cpu(), us2], dim=1).numpy()
    return ys, us


def _stream(srv, ys, us, t: int):
    lo = HISTORY + t * CHUNK
    srv.ingest_many((i, ys[i, lo:lo + CHUNK], us[i, lo:lo + CHUNK])
                    for i in range(TWINS))
    return srv.tick()


def serve(device, ys, us, ticks: int):
    """Warm-start every twin with the true theta, stream HISTORY samples,
    then `ticks` ticks of CHUNK samples per twin.  Returns (server,
    reports)."""
    from repro_torch.twin.server import TwinServer
    srv = TwinServer(_server_config(), device=device)
    nominal, _ = _systems()
    srv.deploy_many(range(TWINS), nominal.true_theta(srv.fleet.model.lib))
    srv.ingest_many((i, ys[i, :HISTORY], us[i, :HISTORY])
                    for i in range(TWINS))
    reports = []
    for t in range(ticks):
        reports.append(_stream(srv, ys, us, t))
        if t + 1 == WARMUP:
            srv.reset_latency_stats()
    return srv, reports


# --------------------------------------------------------------------------- #
# kernel checks and timing
# --------------------------------------------------------------------------- #
def _gru_inputs(gen, dev, lead, fleet, T=24, H=32):
    D = 4
    wl = (fleet,) if fleet else ()
    rand = lambda *s: torch.rand(s, generator=gen) * 2 - 1
    return [(rand(*lead, T, D)).to(dev),
            (0.1 * rand(*lead, H)).to(dev),
            (rand(*wl, D, 3 * H) / D ** 0.5).to(dev),
            (rand(*wl, H, 3 * H) / H ** 0.5).to(dev),
            (0.1 * rand(*wl, 3 * H)).to(dev)]


def _rk4_inputs(gen, dev, lead, T, m):
    from repro_torch.core.library import make_library
    nominal, _ = _systems()
    lib = make_library(3, m, 3)
    if m:
        base = torch.as_tensor(nominal.true_theta(lib), dtype=torch.float32)
    else:
        base = torch.zeros(3, lib.size)
        base[0, 1], base[1, 3], base[2, 1] = -0.9, 1.0, -4.2
    theta = base + 0.05 * torch.randn(lead + (3, lib.size), generator=gen)
    y0 = 0.1 * torch.randn(lead + (3,), generator=gen)
    us = 0.03 * torch.randn(lead + (T, m), generator=gen)
    return lib, [t.to(dev) for t in (theta, y0, us)]


def _grads(fn, args):
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(torch.sum(o * o) for o in outs).backward()
    return [o.detach() for o in outs], [a.grad for a in args]


def _close(name, got, want, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{name}: {m}")
    return max(float((g - w).abs().max()) for g, w in zip(got, want)
               if g.numel())


def check_kernels(dev):
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.gru.ref import gru_scan_ref
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    gen = torch.Generator().manual_seed(1)
    worst = {"gru_scan": 0.0, "rk4_poly": 0.0}
    gru_cases = [("refit F=8 B=8", (8, 8), 8, 24, 32),
                 ("ragged F=8 B=61", (8, 61), 8, 24, 32),
                 ("shared weights [2, 61]", (2, 61), None, 24, 32),
                 ("H=16 F=8 B=8", (8, 8), 8, 24, 16),
                 ("H=48 F=8 B=13", (8, 13), 8, 24, 48),
                 ("H=64 F=8 B=8", (8, 8), 8, 24, 64),
                 ("H=96 F=2 B=5", (2, 5), 2, 24, 96),
                 ("H=128 F=2 B=5", (2, 5), 2, 24, 128),
                 ("H=136 F=2 B=5", (2, 5), 2, 24, 136),
                 ("T=1 F=8 B=8", (8, 8), 8, 1, 32),
                 ("B=1 F=8", (8, 1), 8, 24, 32),
                 ("fleet F=16 B=32 H=64", (16, 32), 16, 24, 64),
                 ("H=100 F=2 B=5", (2, 5), 2, 24, 100),
                 ("T=50 F=8 B=8", (8, 8), 8, 50, 32),
                 ("T=50 H=100 F=2 B=5", (2, 5), 2, 50, 100)]
    for label, lead, fleet, T, H in gru_cases:
        args = _gru_inputs(gen, dev, lead, fleet, T, H)
        outs, grads = _grads(gru_scan, args)
        ref_outs, ref_grads = _grads(gru_scan_ref, args)
        torch.cuda.synchronize()
        err = _close(f"gru {label}", outs, ref_outs, GRU_TOL)
        _close(f"gru {label} grads", grads, ref_grads, GRAD_TOL)
        worst["gru_scan"] = max(worst["gru_scan"], err)
        print(f"  gru_scan   {label:24s} max|err| {err:.3e}")
    rk4_cases = [("refit B=64 T=24", (64,), 24, 1),
                 ("guard B=64 T=32", (64,), 32, 1),
                 ("promote B=8 T=32", (8,), 32, 1),
                 ("predict B=1 T=50", (1,), 50, 1),
                 ("scenario [4, 8] T=50", (4, 8), 50, 1),
                 ("ragged B=61 T=24", (61,), 24, 1),
                 ("m=0 B=61 T=24", (61,), 24, 0),
                 ("fleet B=2048 T=32", (2048,), 32, 1)]
    for label, lead, T, m in rk4_cases:
        lib, args = _rk4_inputs(gen, dev, lead, T, m)
        idx = lib.indices_on(dev)
        Bf = int(np.prod(lead))
        flat = lambda th, y, u: (th.reshape(Bf, 3, lib.size),
                                 y.reshape(Bf, 3), u.reshape(Bf, T, m))
        outs, grads = _grads(
            lambda *a: rk4_poly_solve(*a, dt=0.01, library=lib), args)
        ref_outs, ref_grads = _grads(
            lambda *a: rk4_poly_solve_ref(*flat(*a), 0.01, idx).reshape(
                lead + (T + 1, 3)), args)
        torch.cuda.synchronize()
        err = _close(f"rk4 {label}", outs, ref_outs, RK4_TOL)
        _close(f"rk4 {label} grads", grads, ref_grads, GRAD_TOL)
        worst["rk4_poly"] = max(worst["rk4_poly"], err)
        print(f"  rk4_poly   {label:24s} max|err| {err:.3e}")
    worst["linear_scan"] = check_scan(dev)
    return worst


def _scan_inputs(gen, dev, B, H, T, dtype, strong=False):
    """q, k, v (dtype), w (f32 log decay), u (f32) with K = V = 64: the JAX
    kernel tests' distributions; `strong` widens the decay to exp(-7.4) per
    step."""
    K = V = 64
    rand = lambda *s: torch.randn(s, generator=gen)
    lo, hi = (-1.0, 2.0) if strong else (-7.0, -1.5)
    w = -torch.exp(torch.rand((B, H, T, K), generator=gen) * (hi - lo) + lo)
    return ((0.5 * rand(B, H, T, K)).to(dev, dtype),
            (0.5 * rand(B, H, T, K)).to(dev, dtype),
            (0.5 * rand(B, H, T, V)).to(dev, dtype),
            w.to(dev), (0.3 * rand(H, K)).to(dev))


def check_scan(dev) -> float:
    """The linear-scan kernel against its plain chunked version: the RWKV-6
    prefill shape (B=1, H=40, K=V=64, chunk 64) with a ragged T, T < 64
    (C = T), a state carried across two halves, strong decays, and B*H >
    132; both modes, with and without the bonus u, bf16 and f32."""
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
    gen = torch.Generator().manual_seed(3)
    cases = [("prefill B=1 H=40 T=1000", 1, 40, 1000, False),
             ("short B=1 H=40 T=37", 1, 40, 37, False),
             ("strong decay T=300", 1, 40, 300, True),
             ("wide B=4 H=40 T=200", 4, 40, 200, False)]
    variants = [("ssd", False), ("rwkv6", True), ("rwkv6", False)]
    worst = 0.0
    with torch.no_grad():
        for label, B, H, T, strong in cases:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, w, u = _scan_inputs(gen, dev, B, H, T, dtype,
                                             strong=strong)
                for mode, bonus in variants:
                    uu = u if bonus else None
                    got = linear_scan(q, k, v, w, uu, mode=mode)
                    want = linear_scan_chunked(q, k, v, w, uu, mode=mode)
                    torch.cuda.synchronize()
                    name = (f"{label} {mode}{'+u' if bonus else ''} "
                            f"{str(dtype)[6:]}")
                    err = _close(f"linear_scan {name}", got, want, SCAN_TOL)
                    worst = max(worst, err)
                    print(f"  linear_scan {name:40s} max|err| {err:.3e}")
        # a state carried across two halves equals one whole scan
        q, k, v, w, u = _scan_inputs(gen, dev, 1, 40, 1000, torch.bfloat16)
        for mode in ("ssd", "rwkv6"):
            whole = linear_scan(q, k, v, w, u, mode=mode)
            o1, s1 = linear_scan(*(x[:, :, :450] for x in (q, k, v, w)), u,
                                 mode=mode)
            o2, s2 = linear_scan(*(x[:, :, 450:] for x in (q, k, v, w)), u,
                                 mode=mode, initial_state=s1)
            torch.cuda.synchronize()
            err = _close(f"linear_scan carry {mode}",
                         (torch.cat([o1, o2], dim=2), s2), whole, SCAN_TOL)
            worst = max(worst, err)
            print(f"  linear_scan {'carry 450 + 550 ' + mode:40s} "
                  f"max|err| {err:.3e}")
    return worst


def _device_ms(fn, reps: int = 20, rounds: int = 10) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph,
    replayed `rounds` times between CUDA events (no host launch gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * reps)


def _eager_ms(fn, reps: int = 200) -> float:
    """Time of one call launched from Python, host overhead included."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops: float, nbytes: float, tf32_flops: float = 0.0):
    """The larger of the operations' time (f32 ones outside the tensor
    cores, TF32 ones on them) and the bytes' time, in ms."""
    t_ops = flops / FP32_FLOPS + tf32_flops / TF32_FLOPS
    t_bytes = nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _scan_work_pairwise(B, H, T, K, V, C, rwkv6: bool):
    """Operations of the chunked formulation with every decay in the
    pairwise form (the count of the earlier kernel), for the causal pairs
    this T has: per (t, s) pair and k, q*k*decay (3) plus the decay's
    subtraction and exponential (2); P v; q_read S; the state update; 2 per
    multiply-add."""
    ops = 0.0
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        strict = c * (c - 1) // 2
        diag = c                                    # s == t: bonus or 1
        pair_ops = (strict * K * 5 + diag * K * 3) if rwkv6 else \
            ((strict + diag) * K * 5)
        ops += (pair_ops + (strict + diag) * V * 2    # P v
                + c * K * (2 + 2 * V)                 # q*2^cw_read, @ S
                + c * K * (3 + 2 * V)                 # kd, kd^T v
                + K * (1 + 2 * V))                    # 2^cw_end S
    return B * H * ops


def _scan_work(B, H, T, K, V, C, rwkv6: bool, exact_v: bool):
    """Operations of the subchunk form the kernel runs (csrc/linear_scan.cu,
    ref.py::linear_scan_subchunked), for the causal pairs this T has, as
    (f32, TF32).  Pairs inside one SUBCHUNK-row subchunk keep the pairwise
    count above; a pair of query subchunk I and earlier key subchunk J is
    one multiply-add per k on pre-scaled rows, plus one product per (row,
    J, k) for the factor 2^(p_I - c_J).  The scalings: qs and kj
    (subtraction, exponential, product), 2^(p_I - c_J) (2) and 2^p_I (1)
    per subchunk, q_read (1).  The four products -- the off-diagonal
    blocks of P, P v, q_read S, kd^T v -- run on the tensor cores in
    3xTF32 form: 3 TF32 multiply-adds for each, 2 where the other side is
    v and v is exact in TF32 (bf16).  The rest is f32 outside them."""
    from repro_torch.kernels.linear_scan.ref import SUBCHUNK as sub
    nv = 2 if exact_v else 3
    f32 = tf32 = 0.0
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        sizes = [min(sub, c - r) for r in range(0, c, sub)]
        ns = len(sizes)
        inner = sum(b * (b - 1) // 2 for b in sizes)       # s < t, same sub
        outer = c * (c - 1) // 2 - inner                    # earlier sub
        diag = c
        pair_ops = (inner * K * 5 + diag * K * 3) if rwkv6 else \
            ((inner + diag) * K * 5)
        factor_rows = sum(b * i for i, b in enumerate(sizes))   # (t, J<I)
        f32 += (pair_ops + factor_rows * K
                + c * K * 3 * 2                              # qs, kj
                + ns * (ns - 1) // 2 * K * 2 + ns * K         # pivots
                + c * K                                      # q_read
                + c * K * 3                                  # kd
                + K * (1 + 2 * V))                           # 2^cw_end S
        tf32 += (3 * outer * K * 2                           # P, off-diag
                 + nv * (inner + outer + diag) * V * 2       # P v
                 + 3 * c * K * V * 2                         # q_read @ S
                 + nv * c * K * V * 2)                       # kd^T v
    return B * H * f32, B * H * tf32
# the GRU's served shapes, (F, B, T, H) with D = 4: the online tick's refit
# encoder (examples/online_twinning.py; the first, main shape keeps its
# label), the offline fleet's at the JAX package's default width
# (examples/fleet_twinning.py) and F-8 training's batch of 64 windows at
# hidden 96 (examples/train_f8_crusader.py), the one width above 64 the
# repo runs
GRU_SHAPES = {
    "F=8 B=8 T=24 D=4 H=32": (8, 8, 24, 32),
    "fleet F=16 B=32 T=24 D=4 H=64": (16, 32, 24, 64),
    "train F=1 B=64 T=24 D=4 H=96": (1, 64, 24, 96),
}
RK4_SHAPES = {             # the serving paths' calls: (lead, T)
    "refit B=64 T=24": ((64,), 24),
    "guard B=64 T=32": ((64,), 32),
    "promote B=8 T=32": ((8,), 32),
    "predict B=1 T=50": ((1,), 50),
    "scenario [4, 8] T=50": ((4, 8), 50),
    "fleet B=2048 T=32": ((2048,), 32),
}
SCAN_SHAPES = {            # (B, H, T): RWKV-6 prefills of one or 4 prompts
    "T=256": (1, 40, 256), "T=659": (1, 40, 659), "T=1024": (1, 40, 1024),
    "T=2048": (1, 40, 2048), "T=4096": (1, 40, 4096),
    "B=4 T=2048": (4, 40, 2048),
}


def _timed(fn, plain, flops, nbytes, plain_reps=20, tf32_flops=0.0,
           eager=False):
    """Device ms of the kernel and of its plain version, and the bound;
    with `eager`, also each one's time a call launched from Python."""
    bound_ms, bound_by = _bound(flops, nbytes, tf32_flops)
    out = dict(ms=_device_ms(fn), plain_ms=_device_ms(plain, reps=plain_reps),
               bound_ms=bound_ms, bound_by=bound_by)
    if eager:
        out.update(eager_ms=_eager_ms(fn),
                   plain_eager_ms=_eager_ms(plain, reps=10 * plain_reps))
    return out


def _by_shape(line, timings, main):
    """The main shape's numbers as the line's own, every shape's by name."""
    line.update(timings[main])
    for key in ("ms", "plain_ms", "bound_ms"):
        line[f"{key}_by_shape"] = {s: t[key] for s, t in timings.items()}
    line["shape"] = main
    return line


def kernel_lines(dev, paths, worst):
    """One entry per kernel.  `ms`, `plain_ms` and `bound_ms` are at the main
    serving shape -- the GRU at the refit encoder (F=8 slots x B=8 windows,
    T=24, D=4, H=32; also timed at the offline fleet's F=16 x B=32, H=64,
    and at F-8 training's 64 windows, H=96),
    RK4 at the refit decoder (B=64, T=24, n=3, L=35, O=3,
    m=1), the linear scan at the RWKV-6 prefill (B=1, H=40, T=2048,
    K=V=64, C=64, bf16 q/k/v) -- and `*_by_shape` hold every serving shape
    timed.  None has a single PyTorch call computing the same function
    (torch's GRU applies the reset gate after the hidden product; no call
    runs an ODE or a decayed linear recurrence), so library_ms is null."""
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.gru.ref import gru_scan_ref
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    gen = torch.Generator().manual_seed(2)
    common = lambda name: dict(
        name=name, route="cuda", library_ms=None,
        launches=sum(c[name] for c in paths.values()),
        launches_by_path={p: c[name] for p, c in paths.items()},
        max_abs_err=worst[name])
    lines = []
    with torch.no_grad():
        timings = {}
        main = next(iter(GRU_SHAPES))
        for label, (F, B, T, H) in GRU_SHAPES.items():
            args = _gru_inputs(gen, dev, (F, B), F, T, H)
            D = args[0].shape[-1]
            outs = gru_scan(*args)
            # products only (2 per multiply-add): x Wx, h Wh_zr, (r*h) Wh_c
            flops = 2.0 * F * B * T * (D * 3 * H + 3 * H * H)
            nbytes = sum(t.nbytes for t in (*args, *outs))
            timings[label] = _timed(lambda a=args: gru_scan(*a),
                                    lambda a=args: gru_scan_ref(*a), flops,
                                    nbytes, eager=label == main)
        lines.append(_by_shape(dict(
            **common("gru_scan"), source="src/repro_torch/csrc/gru_scan.cu",
            replaces="src/repro/kernels/gru/gru.py:27"), timings, main))

        timings = {}
        for label, (lead, T) in RK4_SHAPES.items():
            lib, (theta, y0, us) = _rk4_inputs(gen, dev, lead, T, 1)
            idx = lib.indices_on(dev)
            Bf, n, L, O = int(np.prod(lead)), 3, lib.size, idx.shape[1]
            ys = rk4_poly_solve(theta, y0, us, dt=0.01, library=lib)
            # per right-hand side: (O-1) products per term for Phi, n*L FMAs
            flops = 4.0 * Bf * T * (L * (O - 1) + 2 * n * L)
            nbytes = sum(t.nbytes for t in (theta, y0, us, idx, ys))
            flat = [t.reshape((Bf,) + t.shape[len(lead):])
                    for t in (theta, y0, us)]
            timings[label] = _timed(
                lambda a=(theta, y0, us), lb=lib: rk4_poly_solve(
                    *a, dt=0.01, library=lb),
                lambda f=flat, ix=idx: rk4_poly_solve_ref(*f, 0.01, ix),
                flops, nbytes, eager=label == "refit B=64 T=24")
        lines.append(_by_shape(dict(
            **common("rk4_poly"), source="src/repro_torch/csrc/rk4_poly.cu",
            replaces="src/repro/kernels/rk4/rk4.py:38"), timings,
            "refit B=64 T=24"))

        timings, pairwise = {}, {}
        K = V = C = 64
        for label, (B, H, T) in SCAN_SHAPES.items():
            q, k, v, w, u = _scan_inputs(gen, dev, B, H, T, torch.bfloat16)
            o, sf = linear_scan(q, k, v, w, u, mode="rwkv6", chunk=C)
            nbytes = sum(t.nbytes for t in (q, k, v, w, u, o, sf))
            f32, tf32 = _scan_work(B, H, T, K, V, C, True, True)
            timings[label] = _timed(
                lambda a=(q, k, v, w, u): linear_scan(*a, mode="rwkv6",
                                                      chunk=C),
                lambda a=(q, k, v, w, u): linear_scan_chunked(
                    *a, mode="rwkv6", chunk=C),
                f32, nbytes, plain_reps=3, tf32_flops=tf32,
                eager=label == "T=2048")
            pairwise[label] = _bound(
                _scan_work_pairwise(B, H, T, K, V, C, True), nbytes)[0]
            if label == "T=2048":
                scan_launches(lambda a=(q, k, v, w, u): linear_scan(
                    *a, mode="rwkv6", chunk=C))
        line = _by_shape(dict(
            **common("linear_scan"),
            source="src/repro_torch/csrc/linear_scan.cu",
            replaces="src/repro/kernels/linear_scan/linear_scan.py:28"),
            timings, "T=2048")
        line["bound_ms_pairwise_form"] = pairwise["T=2048"]
        line["shape"] = f"B=1 H=40 T=2048 K={K} V={V} C={C} rwkv6 bf16"
        lines.append(line)
    return lines


def scan_launches(fn, calls: int = 10):
    """Device time of each of the scan's three launches (chunk states, the
    scan across chunks, chunk outputs) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = [(k, e.self_device_time_total / e.count / 1e3)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA
             for k in OWN_KERNELS if k in e.key]
    if not parts:
        print("linear_scan launches: not measured (no device events)")
        return
    print("linear_scan launches at B=1 H=40 T=2048, device ms per call: "
          + ", ".join(f"{k} {t:.4f}" for k, t in parts))


def counted(paths: dict, path: str, fn, quiet: bool = False):
    """Drive one serving path with every kernel's launch count set to 0 just
    before it, add the counts just after to the path's total (a path driven
    call by call, like the LM engine's, sums its calls), and fail if a
    kernel the path runs was never launched."""
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    kernels = {"gru_scan": gru_scan, "rk4_poly": rk4_poly_solve,
               "linear_scan": linear_scan}
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    total = paths.setdefault(path, dict.fromkeys(kernels, 0))
    for name, k in kernels.items():
        total[name] += k.launches
    if not quiet:
        print(f"kernel launches on the {path} path: {total}")
    for name in PATH_KERNELS[path]:
        if total[name] == 0:
            raise RuntimeError(f"{name} was never launched on the {path} "
                               "path")
    return out


def check_ticks(srv, reports):
    """What the ticks must show: finite losses, at least one promoted refit
    and the guard flagging damaged airframes."""
    losses = [r.loss for r in reports if r.loss is not None]
    if not losses or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"refit losses missing or non-finite: {losses}")
    promoted = sorted(t for t, r in srv.twins.items() if r.deploy_tick > 0)
    flagged = sorted({e.twin_id for e in srv.events})
    print(f"promoted twins: {promoted}")
    print(f"guard-flagged twins: {flagged} (damaged: 0..{DAMAGED - 1})")
    if not promoted:
        raise RuntimeError("no refit was promoted into the theta store")
    if not set(flagged) & set(range(DAMAGED)):
        raise RuntimeError("the guard flagged none of the damaged twins")


def check_answers(srv, preds, scn, ys):
    """Finite predictions and scenario answers of the expected shape, and a
    prediction equal to the plain version's on the same theta and state."""
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    for p in preds:
        if p.shape != (51, 3) or not torch.isfinite(p).all():
            raise RuntimeError(f"bad prediction {tuple(p.shape)}")
    for f in ("ys", "lo", "hi"):
        a = getattr(scn, f)
        if a.shape != (8, 51, 3) or not np.isfinite(a).all():
            raise RuntimeError(f"bad scenario {f} {a.shape}")
    if not (np.all(scn.lo <= scn.ys) and np.all(scn.ys <= scn.hi)
            and np.all((scn.confidence > 0) & (scn.confidence <= 1))):
        raise RuntimeError("scenario envelope does not contain its center")
    # the prediction against the plain version on the CPU, same theta/state
    rec = srv.twins[DAMAGED]
    y0 = torch.as_tensor(ys[DAMAGED, HISTORY + TICKS * CHUNK - 1])[None]
    ref = rk4_poly_solve_ref(srv._theta[rec.ring_slot][None].cpu(), y0,
                             torch.zeros(1, 50, 1), 0.01,
                             srv.fleet.model.lib.term_indices)[0]
    torch.testing.assert_close(preds[1].cpu(), ref, **RK4_TOL)


def check_parity(reports, cpu_reports):
    """Per-tick admissions equal and losses within rtol 1e-3 / atol 1e-4
    (the JAX package's reference-vs-kernel server tolerance)."""
    for t, (rg, rc) in enumerate(zip(reports, cpu_reports)):
        if (rg.n_active, rg.admitted) != (rc.n_active, rc.admitted):
            raise RuntimeError(f"tick {t + 1}: card admitted {rg.admitted} "
                               f"({rg.n_active} active), CPU {rc.admitted} "
                               f"({rc.n_active})")
        if (rg.loss is None) != (rc.loss is None) or (
                rg.loss is not None and not np.isclose(
                    rg.loss, rc.loss, rtol=1e-3, atol=1e-4)):
            raise RuntimeError(f"tick {t + 1}: loss card {rg.loss} vs "
                               f"CPU {rc.loss}")
        print(f"  tick {t + 1:2d} active {rg.n_active} admitted "
              f"{len(rg.admitted)} loss card {rg.loss} cpu {rc.loss}")


# --------------------------------------------------------------------------- #
# LM serving (rwkv6-3b)
# --------------------------------------------------------------------------- #
def _lm_api(cfg, finite: list):
    """The model API with every prefill's and decode's logits recorded as
    finite or not (a device flag, read once at the end)."""
    from repro_torch.models.zoo import build
    api = build(cfg)

    def watch(fn):
        def call(*args):
            cache, logits = fn(*args)
            finite.append(torch.isfinite(logits).all())
            return cache, logits
        return call
    return dataclasses.replace(api, prefill=watch(api.prefill),
                               decode=watch(api.decode))


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_params(v) for v in tree)
    return tree.numel()


def serve_lm(paths: dict):
    """rwkv6-3b at full width behind a 4-slot engine: 8 greedy requests,
    admitted as slots free up; every admit counted on the lm_prefill path
    and every decode step on the lm_decode path."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_arch("rwkv6-3b").config
    finite = []
    api = _lm_api(cfg, finite)
    t0 = time.perf_counter()
    params = api.init(seed=0)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{_n_params(params) / 1e9:.3f}B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"drawn in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(7)
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, size=LM_REQUESTS)
    if np.all(lens % 64 == 0):
        lens[0] += 1
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    engine = ServeEngine(api, slots=LM_SLOTS,
                         max_len=LM_PROMPTS[1] + LM_NEW, seed=0)
    engine.load(params)
    # warm-up outside the counted run: cuBLAS handles, allocator pools
    engine.generate([Request(rid=-1, prompt=prompts[0][:100],
                             max_new_tokens=2)])
    torch.cuda.synchronize()
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    pending, done = list(reqs), []
    prefill_s = decode_s = 0.0
    admitted = steps = 0
    while pending or engine.active:
        while pending and engine.free_slots():
            req = pending.pop(0)
            t0 = time.perf_counter()
            if not counted(paths, "lm_prefill", lambda: engine.admit(req),
                           quiet=True):
                raise RuntimeError(f"request {req.rid} was not admitted")
            prefill_s += time.perf_counter() - t0
            admitted += 1
        t0 = time.perf_counter()
        done += counted(paths, "lm_decode", engine.step, quiet=True)
        decode_s += time.perf_counter() - t0
        steps += 1
    for path in ("lm_prefill", "lm_decode"):
        print(f"kernel launches on the {path} path: {paths[path]}")
    want = cfg.n_layers * admitted
    if paths["lm_prefill"]["linear_scan"] != want:
        raise RuntimeError(f"lm_prefill launched linear_scan "
                           f"{paths['lm_prefill']['linear_scan']} times, "
                           f"expected {cfg.n_layers} x {admitted} = {want}")
    if any(paths["lm_decode"].values()):
        raise RuntimeError(f"lm_decode launched kernels: "
                           f"{paths['lm_decode']}")
    if sorted(r.rid for r in done) != list(range(LM_REQUESTS)):
        raise RuntimeError(f"finished {sorted(r.rid for r in done)}")
    for r in done:
        if len(r.generated) != LM_NEW or not all(
                0 <= t < cfg.vocab for t in r.generated):
            raise RuntimeError(f"request {r.rid}: {r.generated}")
    if not bool(torch.stack(finite).all()):
        raise RuntimeError("non-finite logits on the LM path")
    tokens = int(lens.sum())
    print(f"served {len(done)} requests (prompts {sorted(lens.tolist())}), "
          f"{LM_NEW} tokens each; {len(finite)} logit rows finite")
    print(f"prefill {tokens} tokens in {prefill_s * 1e3:.2f} ms: "
          f"{tokens / prefill_s:.1f} tokens/s; decode {steps} steps of "
          f"{LM_SLOTS} slots in {decode_s * 1e3:.2f} ms: "
          f"{decode_s * 1e3 / steps:.3f} ms per step")
    print(f"request 0 tokens: {reqs[0].generated}")
    # after the counted run: one more prefill, then decode steps, profiled
    extra = Request(rid=LM_REQUESTS, prompt=prompts[-1][:1024],
                    max_new_tokens=LM_PROFILE_STEPS + 1)
    profiled(f"LM prefill of {len(extra.prompt)} tokens",
             lambda: engine.admit(extra))
    profiled(f"{LM_PROFILE_STEPS} LM decode steps (1 active slot)",
             lambda: [engine.step() for _ in range(LM_PROFILE_STEPS)])
    del engine, params
    torch.cuda.empty_cache()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def lm_parity(dev):
    """rwkv6-3b at full width, 2 layers, f32: the same weights (drawn on
    the card) on the card and on the CPU give prefill logits within
    LM_TOL, and equal greedy tokens with logits within LM_TOL for
    LM_PARITY_STEPS decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    cfg = get_arch("rwkv6-3b").config.with_(n_layers=LM_PARITY_LAYERS,
                                            dtype=torch.float32)
    params = tfm.init_params(cfg, seed=1, device=dev)
    cpu_params = _to(params, "cpu")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab,
                                               size=(1, LM_PARITY_PROMPT))
    worst, toks = 0.0, []
    with torch.no_grad():
        caches, logits = [], []
        for d, p in ((dev, params), ("cpu", cpu_params)):
            c, lg = tfm.prefill(cfg, p, torch.as_tensor(prompt, device=d),
                                LM_PARITY_PROMPT + LM_PARITY_STEPS)
            caches.append(c)
            logits.append(lg)
        for step in range(LM_PARITY_STEPS + 1):
            card, host = logits[0].cpu(), logits[1]
            torch.testing.assert_close(card, host, **LM_TOL, msg=lambda m:
                                       f"LM logits, step {step}: {m}")
            worst = max(worst, float((card - host).abs().max()))
            nxt = [int(torch.argmax(lg[0])) for lg in (card, host)]
            if nxt[0] != nxt[1]:
                raise RuntimeError(f"step {step}: card token {nxt[0]}, CPU "
                                   f"{nxt[1]}")
            toks.append(nxt[0])
            if step == LM_PARITY_STEPS:
                break
            for i, (d, p) in enumerate(((dev, params), ("cpu", cpu_params))):
                caches[i], logits[i] = tfm.decode_step(
                    cfg, p, caches[i], torch.tensor([nxt[0]], device=d))
    print(f"prefill of {LM_PARITY_PROMPT} tokens + {LM_PARITY_STEPS} decode "
          f"steps: greedy tokens equal ({toks}), logits max|card - CPU| "
          f"{worst:.3e}")
    del params, cpu_params
    torch.cuda.empty_cache()


def profiled(what: str, fn, top: int = 8):
    """Trace `fn` with torch.profiler and print the device's busy share of
    its wall time and the kernels that fill it (one stream, so summed
    kernel time is busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print(f"{what}: device busy share not measured (the profiler "
              "recorded no device events)")
        return
    print(f"profiled {what}: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    own = [(k, e) for e in kernels for k in OWN_KERNELS if k in e.key]
    print("  the port's kernels: " + (", ".join(
        f"{k} {e.self_device_time_total / 1e3:.3f} ms in {e.count}"
        for k, e in own) or "none"))


def profile_ticks(srv, ys, us):
    """PROFILE_TICKS more ticks under the profiler."""
    def ticks():
        for t in range(TICKS, TICKS + PROFILE_TICKS):
            _stream(srv, ys, us, t)
    profiled(f"{PROFILE_TICKS} ticks", ticks)


# --------------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    from repro_torch.kernels import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print("== 1. build")
    t0 = time.perf_counter()
    lib_path = backend.build_library(verbose=True)
    backend.load_library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    print("== 2. kernels against their plain versions")
    worst = check_kernels(dev)

    print("== 3. serving: 64 F-8 twins on the card")
    ys, us = telemetry(dev)
    paths = {}
    srv, reports = counted(paths, "tick", lambda: serve(None, ys, us, TICKS))
    check_ticks(srv, reports)
    preds = counted(paths, "predict", lambda: [
        srv.predict(tid, 50) for tid in (0, DAMAGED, TWINS - 1)])
    what_if = (0.03 * np.random.default_rng(5).normal(size=(8, 50, 1))
               ).astype(np.float32)
    scn = counted(paths, "scenario", lambda: srv.scenario(0, 50, what_if))
    check_answers(srv, preds, scn, ys)
    lat, stages = srv.latency_summary(), srv.stage_summary()
    print(f"steady-state ticks {lat['ticks']}: p50 {lat['p50_ms']:.2f} ms, "
          f"p99 {lat['p99_ms']:.2f} ms, max {lat['max_ms']:.2f} ms, "
          f"violations {lat['violations']}")
    print("per-stage mean ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    profile_ticks(srv, ys, us)

    print(f"== 4. card against CPU, first {PARITY_TICKS} ticks")
    _, cpu_reports = serve("cpu", ys, us, PARITY_TICKS)
    check_parity(reports, cpu_reports)

    print("== 5. LM serving: rwkv6-3b at full width on the card")
    serve_lm(paths)

    print(f"== 6. LM card against CPU: {LM_PARITY_LAYERS} layers, f32")
    lm_parity(dev)

    print("== 7. kernel times at the serving shapes")
    lines = kernel_lines(dev, paths, worst)
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
