"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (src/repro_torch) only; it imports nothing of JAX.  Phases,
each of which raises on failure (the script then exits nonzero):

  1. build   the hand-written CUDA kernels from csrc/ (nvcc, one process per
             source, all started together);
  2. check   each kernel against its plain PyTorch version at the serving
             path's shapes (plus a ragged batch, RK4 with m == 0, GRU with
             shared and per-slot weights), forward and gradients;
  3. serve   64 F-8 twins at the repo's own serving width
             (examples/online_twinning.py), warm-started with the true
             theta, 12 airframes damaged mid-stream, 40 ticks of 8 samples
             per twin, then predict and scenario requests; the kernels'
             launch counts are set to 0 before each of the three paths
             (tick, predict, scenario) and read after it;
  4. parity  the first 10 ticks again on the CPU (plain versions), per-tick
             losses and admissions held to the card's;
  5. time    each kernel and its plain version at the serving shape.

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
FP32_FLOPS, HBM_BYTES = 67e12, 3.35e12     # H100 SXM: fp32 (no tensor core)
GRU_TOL = dict(rtol=0.0, atol=1e-5)        # fp32, sums in another order
RK4_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # backward replays the plain path
# the kernels each serving path must launch
PATH_KERNELS = {"tick": ("gru_scan", "rk4_poly"), "predict": ("rk4_poly",),
                "scenario": ("rk4_poly",)}


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
def _gru_inputs(gen, dev, lead, fleet):
    D, H = 4, 32
    wl = (fleet,) if fleet else ()
    rand = lambda *s: torch.rand(s, generator=gen) * 2 - 1
    return [(rand(*lead, 24, D)).to(dev),
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
    gru_cases = [("refit F=8 B=8", (8, 8), 8),
                 ("ragged F=8 B=61", (8, 61), 8),
                 ("shared weights [2, 61]", (2, 61), None)]
    for label, lead, fleet in gru_cases:
        args = _gru_inputs(gen, dev, lead, fleet)
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
                 ("m=0 B=61 T=24", (61,), 24, 0)]
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


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_lines(dev, paths, worst):
    """One entry per kernel at its serving shape: the GRU at the refit
    encoder (F=8 slots x B=8 windows, T=24, D=4, H=32), RK4 at the refit
    decoder (B=64, T=24, n=3, L=35, O=3, m=1).  Neither has a single PyTorch
    call computing the same function (torch's GRU applies the reset gate
    after the hidden product), so library_ms is null."""
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.gru.ref import gru_scan_ref
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    gen = torch.Generator().manual_seed(2)
    lines = []
    with torch.no_grad():
        xs, h0, wx, wh, b = args = _gru_inputs(gen, dev, (8, 8), 8)
        (F, B, T, D), H = xs.shape, h0.shape[-1]
        outs = gru_scan(*args)
        # products only (2 per multiply-add): x Wx, h Wh_zr, (r*h) Wh_c
        flops = 2.0 * F * B * T * (D * 3 * H + 3 * H * H)
        nbytes = sum(t.nbytes for t in (*args, *outs))
        bound_ms, bound_by = _bound(flops, nbytes)
        lines.append(dict(
            name="gru_scan", route="cuda",
            source="src/repro_torch/csrc/gru_scan.cu",
            replaces="src/repro/kernels/gru/gru.py:27",
            launches=sum(c["gru_scan"] for c in paths.values()),
            launches_by_path={p: c["gru_scan"] for p, c in paths.items()},
            max_abs_err=worst["gru_scan"],
            ms=_device_ms(lambda: gru_scan(*args)),
            plain_ms=_device_ms(lambda: gru_scan_ref(*args)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            eager_ms=_eager_ms(lambda: gru_scan(*args)),
            plain_eager_ms=_eager_ms(lambda: gru_scan_ref(*args)),
            shape=f"F={F} B={B} T={T} D={D} H={H}"))

        lib, (theta, y0, us) = _rk4_inputs(gen, dev, (64,), 24, 1)
        idx = lib.indices_on(dev)
        (B, n, L), (T, m), O = theta.shape, us.shape[1:], idx.shape[1]
        ys = rk4_poly_solve(theta, y0, us, dt=0.01, library=lib)
        # per right-hand side: (O-1) products per term for Phi, n*L FMAs
        flops = 4.0 * B * T * (L * (O - 1) + 2 * n * L)
        nbytes = sum(t.nbytes for t in (theta, y0, us, idx, ys))
        bound_ms, bound_by = _bound(flops, nbytes)
        kern = lambda: rk4_poly_solve(theta, y0, us, dt=0.01, library=lib)
        plain = lambda: rk4_poly_solve_ref(theta, y0, us, 0.01, idx)
        lines.append(dict(
            name="rk4_poly", route="cuda",
            source="src/repro_torch/csrc/rk4_poly.cu",
            replaces="src/repro/kernels/rk4/rk4.py:38",
            launches=sum(c["rk4_poly"] for c in paths.values()),
            launches_by_path={p: c["rk4_poly"] for p, c in paths.items()},
            max_abs_err=worst["rk4_poly"],
            ms=_device_ms(kern), plain_ms=_device_ms(plain),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            eager_ms=_eager_ms(kern), plain_eager_ms=_eager_ms(plain),
            shape=f"B={B} T={T} n={n} L={L} O={O} m={m}"))
    for line in lines:
        line["kernel_ms"] = line["ms"]
    return lines


def counted(paths: dict, path: str, fn):
    """Drive one serving path with every kernel's launch count set to 0 just
    before it, record the counts just after, and fail if a kernel the path
    runs was never launched."""
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    kernels = {"gru_scan": gru_scan, "rk4_poly": rk4_poly_solve}
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    paths[path] = {name: k.launches for name, k in kernels.items()}
    print(f"kernel launches on the {path} path: {paths[path]}")
    for name in PATH_KERNELS[path]:
        if paths[path][name] == 0:
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


def profile_ticks(srv, ys, us):
    """Trace PROFILE_TICKS more ticks with torch.profiler: the device's busy
    share of their wall time and the kernels that fill it (one stream, so
    summed kernel time is busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(TICKS, TICKS + PROFILE_TICKS):
            _stream(srv, ys, us, t)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("device busy share: not measured (the profiler recorded no "
              "device events)")
        return
    print(f"profiled {PROFILE_TICKS} ticks: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


# --------------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

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

    print("== 5. kernel times at the serving shapes")
    lines = kernel_lines(dev, paths, worst)
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
