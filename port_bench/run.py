"""Run one cell of the benchmark of the PyTorch + CUDA port once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (`configs/<config>.json`, the server as it
is built) and a traffic mix (`traffic/<traffic>.json`), both found by the
names in BENCHMARK.json; each per-layer metric is a reader of its own in
`metrics/<metric>.py`.  The run:

  set-up   builds or loads the port's CUDA library, makes every telemetry
           sample from the seed (telemetry.py), builds the server, deploys
           the F-8 model to every twin, streams the history and runs the
           warm-up ticks;
  window   a closed loop for --seconds: each tick ingests the next `chunk`
           samples of every twin, then ticks; a mix with queries asks that
           many what-if queries after each tick;
  trace    (--trace 1) `trace_ticks` more ticks under torch.profiler;
  check    a few more ticks of the same loop, and their queries, after a
           number of ticks drawn from the seed, recorded and held to the
           plain reference once the servers are freed (check.py,
           reference.py; the limits in `limits/<cell>.json`).

A federated configuration ("topology": "federated") serves through
worker processes, which inherit none of this process's wrappers: the
workers' entry is workers.py's, set by system.build while they start; it
turns TF32 off and installs the recorder, the window's counters and the
traced segment's profiler in each worker.  This process marks the
window's end, the traced segment, the check's recorded ticks and their
end by `worker_processes()` barriers; once `srv.close()` has joined the
workers it reads what each wrote (records, stage times, dropped samples,
peak memory, promote counts, its own ingest seconds a tick, trace events,
and any module of JAX or the JAX package it held, which fails the run as
one in this process does) and merges them as the in-process path reads
them from its shards.  Its own per-tick readings add each tick's slowest
worker (`TickDone.latency_s`).

The last line of standard output is one JSON object; with --trace 0 its
metrics are the cell's end-to-end metrics, with --trace 1 its per-layer
metrics.  Without a CUDA card the run exits 1 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 1):
    print(f"port_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_cell(name: str) -> SimpleNamespace:
    """The cell `name` with its configuration, traffic mix and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return SimpleNamespace(name=name, chips=cell["chips"], cfg=cfg,
                           traffic=traffic, e2e=e2e, layer=layer,
                           limits=limits)


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class Loop:
    """The closed loop that drives the server: ingest, tick, queries."""

    def __init__(self, srv, cell, ys, us, seed: int, recorder, deployed,
                 device):
        import numpy as np
        import torch
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))
        self.srv, self.cell, self.ys, self.us = srv, cell, ys, us
        t = cell.traffic
        self.n = cell.cfg["twins"]
        self.chunk, self.history = t["chunk"], t["history"]
        self.q = t.get("queries")
        if self.q:
            self.q_us = query_inputs(self.q, cell.cfg["merinda"]["m"])
            self.q_next = int(np.random.default_rng([seed, 7])
                              .integers(self.n))
        self.recorder = recorder   # None: a federated server's workers record
        self.tick_index = 0
        self.ticks, self.queries, self.kept_queries = [], [], []
        self.deployed = deployed   # [models, twins, n, L], from deploy()
        self.failed = 0
        self.annotate = None
        self.workers = None        # workers.Host of a federated server

    def _range(self, name):
        import contextlib
        return (self.annotate(name) if self.annotate is not None
                else contextlib.nullcontext())

    def step(self, measured: bool, record: bool = False):
        """One tick and its queries; `measured` ticks are the window's,
        `record`ed ones (after the window) are kept for the check."""
        from repro_torch.twin.scenario import ScenarioRefused
        g = self.tick_index
        lo = self.history + g * self.chunk
        if lo + self.chunk > self.ys.shape[1] - 1:
            raise RuntimeError(f"the run outran its telemetry at tick {g} "
                               f"({self.ys.shape[1] - 1} samples a twin)")
        with self._range("bench.client"):
            batch = [(i, self.ys[i, lo:lo + self.chunk],
                      self.us[i, lo:lo + self.chunk]) for i in range(self.n)]
        with self._range("bench.ingest"):
            t0 = time.perf_counter()
            self.srv.ingest_many(batch)
            t1 = time.perf_counter()
        rec = self.recorder
        if record and rec is not None:
            rec.begin()
        recovers = rec.recovers if rec is not None else 0
        with self._range("bench.tick"):
            t2 = time.perf_counter()
            rep = self.srv.tick()
            self.sync()
            t3 = time.perf_counter()
        reports = rep.reports if hasattr(rep, "reports") else [rep]
        if self.workers is not None and None in reports:
            raise RuntimeError(f"a worker process died at tick {g}")
        if record and rec is not None:
            rec.end(g, reports)
        if measured:
            done = {"tick_s": t3 - t2, "ingest_s": t1 - t0,
                    "samples": self.n * self.chunk,
                    "events": sum(len(r.events) for r in reports)}
            if rec is not None:
                done.update(promotes=rec.recovers - recovers,
                            admitted=sum(len(r.admitted) for r in reports))
            else:       # promotes and admitted come from the workers' files
                done.update(tick=g, worker_s=max(r.latency_s
                                                 for r in reports))
            self.ticks.append(done)
            if t3 - t2 > self.cell.cfg["server"]["deadline_s"]:
                self.failed += 1
        self.tick_index += 1
        if not self.q:
            return
        from port_bench import check as chk, system
        fed = lo + self.chunk
        H = self.q["horizon"]
        for _ in range(self.q["per_tick"]):
            twin = self.q_next % self.n
            self.q_next += 1
            if record:
                shard, row = system.shard_of(self.cell.cfg, twin)
                state = chk.query_state(system.shards(self.srv)[shard], row)
            with self._range("bench.query"):
                t0 = time.perf_counter()
                try:
                    res = self.srv.scenario(twin, H, self.q_us)
                except ScenarioRefused:
                    res = None
                t1 = time.perf_counter()
            if measured:
                self.queries.append({"latency_s": t1 - t0,
                                     "k": self.q_us.shape[0], "horizon": H})
                if res is None:
                    self.failed += 1
            if record and res is not None:
                self.kept_queries.append({
                    "twin": twin, "fed": fed, "us": self.q_us,
                    "state": state, "deployed": self.deployed[:, twin],
                    "answer": (res.ys, res.lo, res.hi, res.confidence)})


def query_inputs(q: dict, m: int):
    """The what-if inputs of every query, [k, horizon, m]: elevator-fade
    ramps, input 0 rising linearly over the horizon to `amplitude` times
    each of k fractions spaced evenly over `fractions`."""
    import numpy as np
    H = q["horizon"]
    fr = np.linspace(*q["fractions"], q["k"], dtype=np.float32)
    us = np.zeros((q["k"], H, m), np.float32)
    us[:, :, 0] = (q["amplitude"] * fr[:, None]
                   * np.linspace(0.0, 1.0, H, dtype=np.float32))
    return us


def deploy(srv, cfg: dict, traffic: dict, seed: int):
    """Deploy the F-8 model to every twin, after `served_models.earlier`
    models of its own (the F-8 coefficients, each scaled by 1 + rel_std x
    a normal draw from the seed), as a twin that has served several models
    holds them for its what-if ensemble.  Returns the models deployed,
    [earlier + 1, twins, n, L], oldest first."""
    import numpy as np
    from port_bench import telemetry
    theta = telemetry.f8_theta(cfg["merinda"]["order"]).astype(np.float32)
    ids = list(range(cfg["twins"]))
    served = traffic.get("served_models") or {"earlier": 0, "rel_std": 0.0}
    rng = np.random.default_rng([seed, 13])
    models = [(theta * (1.0 + served["rel_std"] * rng.standard_normal(
        (len(ids),) + theta.shape))).astype(np.float32)
        for _ in range(served["earlier"])]
    models.append(np.broadcast_to(theta, (len(ids),) + theta.shape))
    for m in models[:-1]:
        srv.deploy_many(ids, m)
    srv.deploy_many(ids, theta)
    return np.stack(models)


def host_probe_ms() -> float:
    """Milliseconds of a fixed piece of pure Python: how fast the host ran
    this process, reported beside the window for reading its spread."""
    t0 = time.perf_counter()
    sum(i * i for i in range(200_000))
    return 1e3 * (time.perf_counter() - t0)


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the port on the card")
    torch.set_num_threads(1)           # one process, one host thread
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    return run(cell, args, torch.device("cuda", 0))


def run(cell, args, device) -> int:
    """One run of `cell` on `device`; prints each compared number beside its
    limit on standard error, then the result line."""
    result, _ = execute(cell, args, device)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        fail(f"modules of JAX or the JAX package loaded: {loaded}", 3)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def execute(cell, args, device):
    """One run of `cell` on `device` (the card; the tests drive it on the
    CPU at a small size): (result, session), the session holding what the
    check observed."""
    import numpy as np
    import torch
    from port_bench import check as chk, system, telemetry, work, workers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.cfg, cell.traffic
    on_card = device.type == "cuda"
    limit_line = power_limit() if on_card else None
    probe = [host_probe_ms()]
    phases = {"start": time.perf_counter() - T_START}
    if on_card:
        torch.zeros(1, device=device)
        phases["cuda_context"] = time.perf_counter() - T_START
        system.build_kernels()
        phases["kernel_library"] = time.perf_counter() - T_START

    samples = traffic["history"] + traffic["ticks"] * traffic["chunk"]
    ys, us = telemetry.fleet(args.seed, cfg["twins"], samples, traffic,
                             device)
    phases["telemetry"] = time.perf_counter() - T_START
    side = workers.Host(cfg["shards"]) if system.federated(cfg) else None
    srv = system.build(cfg, args.seed % 2 ** 31, device,
                       side.entry if side else None)
    if side is not None:
        side.srv = srv
    shards = system.shards(srv)
    deployed = deploy(srv, cfg, traffic, args.seed)
    deploy_bad = chk.check_deploy(shards, cfg)
    h = traffic["history"]
    if h:
        srv.ingest_many([(i, ys[i, :h], us[i, :h])
                         for i in range(cfg["twins"])])
    phases["server"] = time.perf_counter() - T_START
    recorder = side if side is not None else chk.Recorder(shards)
    loop = Loop(srv, cell, ys, us, args.seed,
                None if side is not None else recorder, deployed, device)
    loop.workers = side
    for _ in range(traffic["warmup_ticks"]):
        loop.step(measured=False)
    warm_ms = [round(1e3 * v, 3) for v in list(srv.latencies)]
    srv.reset_latency_stats()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    phases["warmup"] = setup_s

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < args.seconds:
        loop.step(measured=True)
    window_s = time.perf_counter() - w0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    probe.append(host_probe_ms())
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        fail(f"modules of JAX or the JAX package loaded: {loaded}", 3)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if side is None:
        stage_sums(loop.ticks, [s.stage_times for s in shards])
        dropped = sum(int(s.dropped_samples) for s in shards)
    else:
        side.barrier(workers.WINDOW)

    trace = None
    if args.trace:
        trace = traced_segment(loop, traffic["trace_ticks"])

    # the check: consecutive ticks of the same loop once the window (and
    # the traced segment) has closed, after a number of ticks drawn from
    # the seed; every query of those ticks is kept
    c = traffic["check"]
    rng = np.random.default_rng([args.seed, 11])
    for _ in range(int(rng.integers(0, c["skip"] + 1))):
        loop.step(measured=False)
    if side is not None:
        side.barrier(workers.CHECK)
    for _ in range(c["ticks"]):
        loop.step(measured=False, record=True)
    fed = loop.history + loop.tick_index * loop.chunk
    ring_bad = sum(chk.check_ring(s, cfg, chk.Telemetry(ys, us, cfg, traffic,
                                                        "cpu"), i, fed)
                   for i, s in enumerate(shards))
    if side is not None:
        side.barrier(workers.DUMP)
    srv.close()
    if side is not None:
        side.collect(device)
        loaded = side.forbidden()
        if loaded:
            fail("modules of JAX or the JAX package loaded in the worker "
                 f"processes: {loaded}", 3)
        stage_sums(loop.ticks, side.stage_times())
        dropped = side.dropped()
        peak += sum(side.peaks())
        for t in loop.ticks:
            (t["promotes"], t["admitted"],
             t["worker_ingest_s"]) = side.per_tick(t["tick"])
        if trace is not None:
            trace.merge(side.traces())
    del srv, shards, loop.srv
    recorder.shards = []       # the servers are freed before the reference
    if on_card:
        torch.cuda.empty_cache()

    tele = chk.Telemetry(ys, us, cfg, traffic, device)
    readings, exact = chk.evaluate(recorder, loop.kept_queries, tele, cfg,
                                   device)
    readings["exact_mismatch"] = exact + deploy_bad + ring_bad
    readings["unread"] = chk.unread(recorder, loop.kept_queries, cell, cfg)
    checks = {k: {"value": v, "limit": cell.limits["limits"].get(k, 0.0)}
              for k, v in sorted(readings.items())}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    ticks = loop.ticks
    run_info = SimpleNamespace(
        cfg=cfg, traffic=traffic, ticks=ticks, queries=loop.queries,
        window_s=window_s, trace=trace, work=work, power=limit_line,
        flops=sum(work.tick_flops(cfg, t["promotes"]) for t in ticks)
        + sum(work.scenario_flops(cfg, q["k"], q["horizon"])
              for q in loop.queries))
    metrics = {}
    if args.trace:
        for m in cell.layer:
            v = metric_reader(m["name"])(run_info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            "samples_per_s": sum(t["samples"] for t in ticks) / window_s,
            "tick_p90_ms": percentile([t["tick_s"] for t in ticks], 90) * 1e3,
            "setup_s": setup_s}
        if loop.queries:
            values["scenario_p95_ms"] = percentile(
                [q["latency_s"] for q in loop.queries], 95) * 1e3
        for m in cell.e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit": limit_line}
    result = {"correct": bool(correct),
              "attempted": len(ticks) + len(loop.queries),
              "failed": loop.failed + dropped, "metrics": metrics,
              "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["setup_phases_s"] = phases
    tick_ms = [1e3 * t["tick_s"] for t in ticks]
    result["window"] = {
        "ticks": len(ticks), "seconds": window_s,
        "tick_ms": {q: percentile(tick_ms, p) for q, p in
                    (("p10", 10), ("p50", 50), ("p90", 90), ("max", 100))},
        "promote_ticks": sum(t["promotes"] > 0 for t in ticks),
        "admitted": sum(t["admitted"] for t in ticks),
        "events": sum(t["events"] for t in ticks),
        "host_threads": torch.get_num_threads(),
        "host_probe_ms": probe,
        "cpu_s": (ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime),
        "involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
        "loadavg": list(os.getloadavg())}
    result["warmup_tick_ms"] = warm_ms
    if side is not None:
        result["workers"] = {
            "count": cfg["shards"], "memory_peak_bytes": side.peaks(),
            "coordinator_peak_bytes": int(peak - sum(side.peaks())),
            "recorded_calls": side.recorded_calls(),
            "host_cores": len(os.sched_getaffinity(0)),
            "device_span_s": trace.span_s() if trace is not None else None}
    result["checks"] = checks
    return result, SimpleNamespace(recorder=recorder, tele=tele,
                                   queries=loop.kept_queries)


def stage_sums(ticks: list, stage_times: list) -> None:
    """Each tick's `stages`: every stage's host seconds summed over the
    shards (`stage_times`, one per shard, the last len(ticks) of each)."""
    stages = {}
    for times_of in stage_times:
        for stage, times in times_of.items():
            vals = list(times)[-len(ticks):]
            acc = stages.setdefault(stage, [0.0] * len(vals))
            for i, v in enumerate(vals):
                acc[i] += v
    for i, t in enumerate(ticks):
        t["stages"] = {k: v[i] for k, v in stages.items()}


def traced_segment(loop, ticks: int):
    """`ticks` more ticks of the same loop under torch.profiler, with the
    shapes each kernel entry point is called with.  A federated server's
    workers run their own profiler over the same ticks, between two
    barriers; their events are merged in once they have written them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from port_bench import system, workers
    from port_bench.trace import Trace
    side = loop.workers
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if side is not None:
        side.barrier(workers.TRACE_ON)
    with system.kernel_shapes({}) as shapes:
        loop.annotate = record_function
        try:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(ticks):
                    loop.step(measured=False)
                loop.sync()
                window = time.perf_counter() - t0
        finally:
            loop.annotate = None
            if side is not None:
                side.barrier(workers.TRACE_OFF)
    return Trace.read(prof, window, ticks, shapes)


if __name__ == "__main__":
    sys.exit(main())
