"""The program's own spans (the port's tracer, `obs/tracing.py`), read for
the benchmark.

Two segments of the run's loop, one on each side of the traced segment:

  span segment        (before it) 2 x `trace_ticks` ticks, the server's
                      tracer on every other one (off first), no profiler:
                      host milliseconds of every span over the ticks
                      traced, summed per tick over shards (per query for
                      the spans of a what-if query); the tick's and
                      `ingest_many`'s p50 with the tracer on against off,
                      in pairs of neighbouring ticks, is the tracer's cost
                      apart from the host's drift.  It runs before the
                      profiler because a torch.profiler session leaves the
                      process slower for good (1.5-1.8 times a tick on the
                      H100's host, PERF.md);
  attributed segment  (after it) `trace_ticks` ticks, the tracer on under
                      torch.profiler (CPU and CUDA): each span also opens a
                      `twin.<name>` range on the profiler's clock; each
                      device kernel is placed under the innermost range
                      that holds its launching runtime call (matched by
                      correlation id), each idle gap between device
                      operations under the innermost range that holds its
                      middle.

The tracer is turned off again before the check.  `metrics/` readers of
these numbers take `run.spans`, the two segments' objects together.

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a cell as `run.py --trace 1` does, with both segments around its
traced segment, and prints its result line with the `spans` object and the
span metrics.  Without a CUDA card it exits 1 and prints no result.
"""
from __future__ import annotations

import bisect
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

PREFIX = "twin."                # the profiler ranges mirroring spans
OUTSIDE = "outside the program's spans"
# root span -> what its spans are counted per
ROOTS = {"tick": "tick", "sharded_tick": "tick", "ingest_many": "ingest_many",
         "scenario": "scenario"}
STAGES = {"sharded_tick", "tick", "flush", "guard", "schedule", "refit"}
# the profiler's range of an autograd node, and the suffix of the custom
# Functions whose backward replays a kernel's plain version (kernels/*/ops.py)
NODE = "autograd::engine::evaluate_function: "
REPLAYED = "KernelBackward"
NO_NODE = "no autograd node"
# the spans of a tick in which the host waits on the device
TICK_WAITS = ("guard.wait", "refit.wait", "promote.wait", "tick.wait")
# the span metrics: name -> unit
METRICS = {"ingest_span_ms": "ms", "flush_prepare_ms": "ms",
           "refit_forward_ms": "ms", "refit_backward_ms": "ms",
           "refit_update_ms": "ms", "promote_ms": "ms",
           "device_wait_ms": "ms", "forward_kernels_per_tick": "kernels",
           "backward_kernels_per_tick": "kernels",
           "update_kernels_per_tick": "kernels", "scenario_wait_ms": "ms"}


def _median(values):
    return statistics.median(values) if values else None


# ---------------------------------------------------------------------- #
# the tracer's events
# ---------------------------------------------------------------------- #
def host_table(events: list) -> dict:
    """{root kind: {span name: {"ms", "self_ms", "calls"}}}: each span
    name's duration and self time (its duration less its children's) over
    the segment, in ms per root of its kind (per tick, summed over shards;
    per query for a `scenario`), and its calls per root.  Events whose root
    fell out of the tracer's ring, or that carry no ids, are left out."""
    spans = [e for e in events
             if e.get("ph") == "X" and "id" in e.get("args", {})]
    by_id = {e["args"]["id"]: e for e in spans}
    covered: dict = {}
    for e in spans:
        p = e["args"]["parent"]
        covered[p] = covered.get(p, 0.0) + e["dur"]
    roots: dict = {}
    for e in spans:
        if e["args"]["parent"] == 0 and e["name"] in ROOTS:
            kind = ROOTS[e["name"]]
            roots[kind] = roots.get(kind, 0) + 1
    table: dict = {}
    for e in spans:
        root = by_id.get(e["args"]["root"])
        if root is None or root["name"] not in ROOTS:
            continue
        row = table.setdefault(ROOTS[root["name"]], {}).setdefault(
            e["name"], {"ms": 0.0, "self_ms": 0.0, "calls": 0})
        row["ms"] += e["dur"] / 1e3
        row["self_ms"] += (e["dur"] - covered.get(e["args"]["id"], 0.0)) / 1e3
        row["calls"] += 1
    for kind, rows in table.items():
        for row in rows.values():
            for k in row:
                row[k] /= roots[kind]
    return table


def children_share(events: list, name: str = "refit") -> float | None:
    """The share of every `name` span's duration that its children cover."""
    spans = [e for e in events
             if e.get("ph") == "X" and "id" in e.get("args", {})]
    ids = {e["args"]["id"] for e in spans if e["name"] == name}
    total = sum(e["dur"] for e in spans if e["name"] == name)
    inner = sum(e["dur"] for e in spans if e["args"]["parent"] in ids)
    return inner / total if total > 0 else None


def root_ms(events: list, kind: str = "tick") -> list:
    """The duration of every root span of `kind`, in ms."""
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e.get("args", {}).get("parent") == 0
            and ROOTS.get(e["name"]) == kind]


# ---------------------------------------------------------------------- #
# the profiler's trace
# ---------------------------------------------------------------------- #
class Ranges:
    """The program's ranges on the host, [(start_ns, end_ns, name)], nested
    as one thread opens them; `innermost(t)` is the deepest that holds t."""

    def __init__(self, ranges: list):
        self.items = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.items]
        self.parent = []
        stack: list = []
        for i, (s, e, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> int:
        """Index of the deepest range holding t, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return i

    def name(self, i: int) -> str:
        return self.items[i][2] if i >= 0 else OUTSIDE

    def node(self, t: int) -> str:
        """The autograd node holding t, where these are node ranges: the
        outermost replayed kernel backward, else the innermost node."""
        i = self.innermost(t)
        name = self.items[i][2] if i >= 0 else NO_NODE
        while i >= 0:
            if self.items[i][2].endswith(REPLAYED):
                name = self.items[i][2]
            i = self.parent[i]
        return name

    def under(self, i: int, names: set) -> bool:
        """Whether range i, or one that holds it, is named in `names`."""
        while i >= 0:
            if self.items[i][2] in names:
                return True
            i = self.parent[i]
        return False


def attribute(ranges: list, launches: dict, kernels: list, device: list,
              ticks: int, nodes: list = ()) -> dict:
    """Device kernels and idle time by innermost program span, and those of
    `refit.backward` by autograd node.

    ranges    [(start_ns, end_ns, span name)], the program's ranges
    launches  {correlation id: host time of the launching runtime call}
    kernels   [(start_ns, dur_ns, name, correlation id)], device kernels
    device    [(start_ns, dur_ns, name)], every device operation (the idle
              gaps lie between them)
    nodes     [(start_ns, end_ns, node name)], the autograd engine's ranges
    """
    r, n = Ranges(ranges), Ranges(nodes)
    per_tick = max(ticks, 1)
    counts: dict = {}
    back: dict = {}
    unplaced = 0
    for _, _, _, corr in kernels:
        at = launches.get(corr)
        if at is None:
            unplaced += 1
            continue
        name = r.name(r.innermost(at))
        counts[name] = counts.get(name, 0) + 1
        if name == "refit.backward":
            node = n.node(at)
            back[node] = back.get(node, 0) + 1
    idle: dict = {}
    back_idle: dict = {}
    in_tick = below = 0
    end = None
    for s, d, _ in sorted(device):
        if end is not None and s > end:
            i = r.innermost((end + s) // 2)
            name = r.name(i)
            idle[name] = idle.get(name, 0) + (s - end)
            if name == "refit.backward":
                node = n.node((end + s) // 2)
                back_idle[node] = back_idle.get(node, 0) + (s - end)
            if r.under(i, {"tick"}):
                in_tick += s - end
                if name not in STAGES:
                    below += s - end
        end = s + d if end is None else max(end, s + d)
    def top(d, scale, k=10):
        return [[name, v / scale / per_tick] for name, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:k]]

    return {"kernels_per_tick": {k: v / per_tick for k, v in counts.items()},
            "unplaced_kernels": unplaced,
            "idle_top_ms": top(idle, 1e6),
            "backward_kernels_by_node": top(back, 1, 8),
            "backward_idle_ms_by_node": top(back_idle, 1e6, 8),
            "idle_in_tick_ms": in_tick / 1e6 / per_tick,
            "idle_below_stage_share": below / in_tick if in_tick else None}


def _is_runtime(e) -> bool:
    """Whether a host event is a CUDA runtime or driver call, whose
    correlation id is its kernel's (a PyTorch operation's id is its own).
    torch 2.13 names the activity; 2.11, on the H100's machine, does not."""
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    if kind is not None:
        return kind in ("cuda_runtime", "cuda_driver")
    n = e.name()
    return n.startswith("cuda") or (n.startswith("cu") and n[2:3].isupper())


def read_profile(prof, window_s: float, ticks: int):
    """(ranges, launches, kernels, device, nodes) of `attribute` from a
    profiler session: the trace as `trace.py` reads it, less the device-track
    mirrors of the program's ranges, and the correlation ids from the raw
    events."""
    from torch.autograd import DeviceType
    from port_bench.trace import Trace
    t = Trace.read(prof, window_s, ticks, {})
    device = [ev for ev in t.device if not ev[2].startswith(PREFIX)]
    ranges = [(s, e, n[len(PREFIX):]) for s, e, n in t.host
              if n.startswith(PREFIX)]
    nodes = [(s, e, n[len(NODE):]) for s, e, n in t.host
             if n.startswith(NODE)]
    launches, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n = e.name()
            if Trace.is_kernel(n) and not n.startswith((PREFIX, "bench.")):
                kernels.append((e.start_ns(), e.duration_ns(), n,
                                e.correlation_id()))
        elif e.correlation_id() and _is_runtime(e):
            launches[e.correlation_id()] = e.start_ns()
    return ranges, launches, kernels, device, nodes


# ---------------------------------------------------------------------- #
# the two segments
# ---------------------------------------------------------------------- #
def span_cost_us(tracer_type, n: int = 20000) -> dict:
    """Host microseconds of one span on this process's core, with a fresh
    tracer of the server's type off and on (no profiler)."""
    out = {}
    for key, on in (("off", False), ("on", True)):
        tr = tracer_type(enabled=on, capacity=n)
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("s"):
                pass
        out[key] = 1e6 * (time.perf_counter() - t0) / n
    return out


def span_segment(loop, ticks: int) -> dict | None:
    """The span segment on `loop` (run.py's `Loop`): the host side of the
    result line's `spans` object.  None where the server keeps no tracer."""
    tracer = getattr(loop.srv, "tracer", None)
    if tracer is None:
        return None
    srv = loop.srv
    ingest = srv.ingest_many
    paired: dict = {False: [], True: []}      # tracer on? -> [[ingest, tick]]

    def timed_ingest(*a, **k):
        t0 = time.perf_counter()
        out = ingest(*a, **k)
        paired[tracer.enabled].append([1e3 * (time.perf_counter() - t0)])
        return out

    tracer.clear()
    srv.ingest_many = timed_ingest
    try:
        for k in range(2 * ticks):
            tracer.enabled = bool(k % 2)
            loop.step(measured=False)
            paired[tracer.enabled][-1].append(1e3 * srv.latencies[-1])
        loop.sync()
        events = tracer.to_chrome_trace()["traceEvents"]
    finally:
        srv.__dict__.pop("ingest_many", None)
        tracer.enabled = False
        tracer.clear()
    on, off = paired[True], paired[False]
    return {"segment_ticks": ticks,
            "tick_p50_ms": {"spans": _median([t for _, t in on]),
                            "off": _median([t for _, t in off]),
                            "window": _median([1e3 * t["tick_s"]
                                               for t in loop.ticks])},
            "ingest_p50_ms": {"spans": _median([i for i, _ in on]),
                              "off": _median([i for i, _ in off])},
            "span_cost_us": span_cost_us(type(tracer)),
            "refit_children_share": children_share(events),
            "host_ms": host_table(events)}


def attributed_segment(loop, ticks: int) -> dict | None:
    """The attributed segment on `loop`: the device side of the `spans`
    object.  None where the server keeps no tracer."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tracer = getattr(loop.srv, "tracer", None)
    if tracer is None:
        return None
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    tracer.clear()
    tracer.enabled = True
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                loop.step(measured=False)
            loop.sync()
            window = time.perf_counter() - t0
    finally:
        tracer.enabled = False
        tracer.clear()
    ranges, launches, kernels, device, nodes = read_profile(prof, window,
                                                            ticks)
    return attribute(ranges, launches, kernels, device, ticks, nodes)


def host_ms(run, kind: str, *names: str) -> float | None:
    """ms per root of `kind` of the spans `names` together, from the span
    segment; nothing where the run has no such segment or no such root."""
    table = (getattr(run, "spans", None) or {}).get("host_ms", {}).get(kind)
    if not table:
        return None
    return sum(table[n]["ms"] for n in names if n in table)


def kernels(run, name: str) -> float | None:
    """Kernels a tick launched inside span `name` (attributed segment)."""
    s = getattr(run, "spans", None)
    if not s or not s.get("host_ms", {}).get("tick"):
        return None
    if not s["kernels_per_tick"]:
        return None                  # no device trace: the CPU
    return s["kernels_per_tick"].get(name, 0.0)


# ---------------------------------------------------------------------- #
def execute(cell, args, device):
    """`run.execute` with both segments around its traced segment:
    (result, session), the result carrying `spans` and the span metrics."""
    from port_bench import run
    held = {}
    traced = run.traced_segment

    def with_segments(loop, ticks):
        held["span"] = span_segment(loop, ticks)
        trace = traced(loop, ticks)
        held["attributed"] = attributed_segment(loop, ticks)
        return trace

    run.traced_segment = with_segments
    try:
        result, session = run.execute(cell, args, device)
    finally:
        run.traced_segment = traced
    spans = ({**held["span"], **held["attributed"]}
             if held.get("span") and held.get("attributed") else None)
    result["spans"] = spans
    info = SimpleNamespace(spans=spans)
    for name, unit in METRICS.items():
        v = run.metric_reader(name)(info)
        if v is not None:
            result["metrics"][name] = {"value": v, "unit": unit}
    return result, session


def main(argv=None) -> int:
    import argparse
    import os
    root = Path(__file__).resolve().parents[1]
    for p in (root / "src", root):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from port_bench import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    cell = run.load_cell(a.workload)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available():
        run.fail("no CUDA device: this benchmark measures the port on the "
                 "card")
    torch.set_num_threads(1)
    result, _ = execute(cell, SimpleNamespace(seed=a.seed, seconds=a.seconds,
                                              trace=1),
                        torch.device("cuda", 0))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN))
    if loaded:
        run.fail(f"modules of JAX or the JAX package loaded: {loaded}", 3)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
