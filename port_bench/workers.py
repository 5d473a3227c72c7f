"""The benchmark inside the worker processes of a federated configuration.

A configuration with "topology": "federated" is served by a
`FederatedTwinServer`: a coordinator in the benchmark's process and one
spawned worker process a shard, each with a `TwinServer` and a CUDA
context of its own.  A spawned process inherits no monkeypatch, so the
hooks travel by name: `system.build` sets the federation's worker entry
(`federation._worker_main`, which `ShardWorker` reads when it starts a
process) to `Host.entry`, a partial of `worker_main` that spawn pickles
by reference and imports in the child.  There `worker_main`

  * gives the process one host thread and turns TF32 off, as run.py does
    for its own;
  * runs the callables planted in `SETUP` (none in a benchmark run; the
    tests plant faults there);
  * installs, on the `TwinServer` the real entry builds, a
    `check.Recorder`, a count of promote passes and admitted slots a tick,
    the seconds of its own `ingest_many` before each tick,
    the reset of the peak device memory with the window's stats, and the
    profiler with the kernel-entry shape records of the traced segment;
  * then runs the real `_worker_main`.

The parent steers the hooks through one byte of a file that both sides
map, in a temporary directory the parent names: it sets WINDOW, TRACE_ON,
TRACE_OFF, CHECK or DUMP and sends `StatsCmd("process")`
(`worker_processes()`) to every worker as a barrier, and each worker acts
on the byte while it answers: it keeps the window's stage times, dropped
samples and peak memory, starts or stops the profiler, records every tick
from then on for the check, or writes what it kept.  Between barriers a
worker reads nothing of the parent's, so nothing the check does runs
inside the window.  CHECK comes right before the check's recorded ticks,
DUMP right after them: each worker writes one file, with the names of
any module of JAX or the JAX package it holds by then, and `Host.collect`
reads them once `srv.close()` has joined the workers: the records merged
as one recorder over every shard keeps them (`check.merged`), the
window's stage times summed over the workers, their peaks, their promote
and admit counts and their own `ingest_many` seconds a tick, and their
trace events.
"""
from __future__ import annotations

import contextlib
import functools
import mmap
import os
import shutil
import tempfile
import weakref
from pathlib import Path

PLAIN, WINDOW, TRACE_ON, TRACE_OFF, CHECK, DUMP = range(6)
FLAG = "flag"
SETUP: list = []       # callables each worker runs before it builds its server


def _dump_path(folder: Path, shard: int) -> Path:
    return folder / f"worker{shard}.pt"


class Host:
    """The parent's side: the shared byte, the barriers, and what the
    workers wrote.  Once collected, its `records` stand where an
    in-process `check.Recorder`'s do."""

    def __init__(self, shards: int):
        self.count = shards
        self.dir = Path(tempfile.mkdtemp(prefix="port_bench_workers_"))
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, True)
        path = self.dir / FLAG
        path.write_bytes(bytes(mmap.PAGESIZE))
        with open(path, "r+b") as f:
            self.flag = mmap.mmap(f.fileno(), mmap.PAGESIZE)
        self.entry = functools.partial(worker_main, {"dir": str(self.dir),
                                                     "setup": list(SETUP)})
        self.srv = None
        self.records: list = []
        self.out: list = []

    def barrier(self, phase: int) -> None:
        """Every worker acts on `phase` before this returns."""
        self.flag[0] = phase
        try:
            self.srv.worker_processes()
        finally:
            self.flag[0] = PLAIN

    def collect(self, device) -> None:
        """Read each worker's file (after `srv.close()`), then remove the
        directory."""
        import torch
        from port_bench import check
        out = []
        for i in range(self.count):
            path = _dump_path(self.dir, i)
            if not path.exists():
                raise RuntimeError(f"worker {i} wrote nothing to {path.name}")
            out.append(torch.load(path, map_location=device,
                                  weights_only=False))
        self.close()
        self.out = out
        self.records = check.merged([o["records"] for o in out])

    def close(self) -> None:
        self.flag.close()
        self._cleanup()

    # ------------------------------------------------------------------ #
    def stage_times(self) -> list:
        """Each worker's `stage_times` over the window."""
        return [o["window"]["stages"] for o in self.out]

    def dropped(self) -> int:
        return sum(o["window"]["dropped"] for o in self.out)

    def peaks(self) -> list:
        """Each worker's peak device memory over the window."""
        return [o["window"]["peak"] for o in self.out]

    def per_tick(self, tick: int) -> tuple[int, int, float]:
        """(promote passes, admitted slots, the slowest worker's ingest
        seconds) over the workers in `tick`."""
        promotes = admitted = 0
        ingest = 0.0
        for o in self.out:
            p, a, s = o["ticks"].get(tick, (0, 0, 0.0))
            promotes, admitted, ingest = promotes + p, admitted + a, max(
                ingest, s)
        return promotes, admitted, ingest

    def forbidden(self) -> list:
        """Modules of JAX or the JAX package that some worker held after
        the check's ticks."""
        return sorted({m for o in self.out for m in o["forbidden"]})

    def traces(self) -> list:
        return [o["trace"] for o in self.out if o["trace"] is not None]

    def recorded_calls(self) -> list:
        """Each worker's observed calls over the recorded ticks, by kind."""
        counts = []
        for o in self.out:
            by: dict = {}
            for rec in o["records"]:
                for _, kind, _ in rec["calls"]:
                    by[kind] = by.get(kind, 0) + 1
            counts.append(by)
        return counts


# -------------------------------------------------------------------------- #
def worker_main(spec: dict, conn, scfg, shard: int, recovery,
                device: str) -> None:
    """The worker process's entry (see the module docstring)."""
    import torch
    torch.set_num_threads(1)           # one process, one host thread
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fn in spec["setup"]:
        fn()
    from repro_torch.twin import federation
    side = Worker(Path(spec["dir"]), shard)
    real_server, real_stats = federation.TwinServer, federation._process_stats

    def server(*a, **k):
        srv = real_server(*a, **k)
        side.install(srv)
        return srv

    def process_stats(srv):
        side.on_stats()
        return real_stats(srv)

    federation.TwinServer = server
    federation._process_stats = process_stats
    federation._worker_main(conn, scfg, shard, recovery, device)


class Worker:
    """The worker's side: the hooks on its server and what they keep."""

    def __init__(self, folder: Path, shard: int):
        self.dir, self.shard = folder, shard
        with open(folder / FLAG, "rb") as f:
            self.flag = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.srv = self.recorder = None
        self.recording = False
        self.ingest_s = 0.0        # ingest_many seconds since the last tick
        self.ticks: dict = {}      # tick -> (promotes, admitted, ingest s)
        self.window = None
        self.prof = self._stack = None
        self.shapes: dict = {}
        self.traced = 0
        self.trace = None

    def install(self, srv) -> None:
        import time
        import torch
        from port_bench import check
        self.srv = srv
        rec = self.recorder = check.Recorder([srv])
        tick, reset = srv.tick, srv.reset_latency_stats
        ingest_many = srv.ingest_many

        def timed_ingest(*a, **k):
            t0 = time.perf_counter()
            try:
                return ingest_many(*a, **k)
            finally:
                self.ingest_s += time.perf_counter() - t0

        def recorded_tick(*a, **k):
            g = srv.tick_count
            if self.recording:
                rec.begin()
            before = rec.recovers
            rep = tick(*a, **k)
            if self.recording:
                rec.end(g, [rep])
            self.ticks[g] = (rec.recovers - before, len(rep.admitted),
                             self.ingest_s)
            self.ingest_s = 0.0
            self.traced += self.prof is not None
            return rep

        def reset_stats():
            reset()
            if srv.device.type == "cuda":
                torch.cuda.synchronize(srv.device)
                torch.cuda.reset_peak_memory_stats(srv.device)
        srv.ingest_many = timed_ingest
        srv.tick = recorded_tick
        srv.reset_latency_stats = reset_stats

    def on_stats(self) -> None:
        phase = self.flag[0]
        if phase == WINDOW:
            self._keep_window()
        elif phase == TRACE_ON:
            self._start_trace()
        elif phase == TRACE_OFF:
            self._stop_trace()
        elif phase == CHECK:
            self.recording = True
        elif phase == DUMP:
            self._dump()

    def _keep_window(self) -> None:
        import torch
        srv = self.srv
        self.window = {
            "stages": {k: list(v) for k, v in srv.stage_times.items()},
            "dropped": int(srv.dropped_samples),
            "peak": (torch.cuda.max_memory_allocated(srv.device)
                     if srv.device.type == "cuda" else 0)}

    def _start_trace(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        from port_bench import system
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(system.kernel_shapes(self.shapes))
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def _stop_trace(self) -> None:
        from port_bench.trace import Trace
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        self._stack.close()
        t = Trace.read(prof, 0.0, self.traced, self.shapes)
        self.trace = {"device": t.device, "host": t.host, "shapes": t.shapes}

    def _dump(self) -> None:
        import sys
        import torch
        from port_bench.run import FORBIDDEN
        self.recording = False
        path = _dump_path(self.dir, self.shard)
        tmp = path.with_suffix(".part")
        loaded = {m.split(".")[0] for m in sys.modules} & set(FORBIDDEN)
        torch.save({"window": self.window, "ticks": self.ticks,
                    "records": self.recorder.records, "trace": self.trace,
                    "forbidden": sorted(loaded)}, tmp)
        os.replace(tmp, path)


__all__ = ["Host", "worker_main", "SETUP", "PLAIN", "WINDOW",
           "TRACE_ON", "TRACE_OFF", "CHECK", "DUMP"]
