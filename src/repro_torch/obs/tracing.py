"""Per-tick span tracing exportable as Chrome trace-event JSON (Perfetto).

A metric histogram tells you the p99 got worse; a trace tells you WHICH tick
and WHICH stage.  `Tracer.span()` wraps the serving stages in nested spans —

    sharded_tick
    └─ tick (shard=0)
       ├─ flush            (+ pump_flush spans on the BackgroundPump thread)
       ├─ guard
       ├─ schedule
       └─ refit

— recorded as Chrome trace-event "complete" events (`ph: "X"`) that load
directly in Perfetto (https://ui.perfetto.dev) or `chrome://tracing`.

Designed for an always-on service:

  * **ring-bounded buffer** — events live in a `deque(maxlen=capacity)`;
    a long-running server overwrites its oldest spans instead of growing
    (`dropped_events` counts the overwritten ones, loudly);
  * **sampling knob** — `sample_every=N` records every Nth ROOT span and its
    whole subtree, so steady-state tracing cost scales down linearly while
    sampled ticks stay internally complete (a half-recorded tick is useless);
  * **near-free when off** — `enabled=False` makes `span()` return a shared
    no-op context manager: no clock reads, no allocation, one attribute
    check.  The 64-twin tracing-on-vs-off parity test and the 10k-twin
    overhead column in bench_out/online_scale.csv hold the cost honest.

Spans may begin on any thread (the pump flush records from its worker
thread); each thread renders as its own Perfetto track via `tid`, with
thread-name metadata events emitted on first sight.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["Tracer", "NULL_SPAN"]


class _NullSpan:
    """Shared no-op context manager (tracing disabled)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _SkipSpan:
    """Depth bookkeeping for an UNSAMPLED subtree — records nothing, but the
    root/child distinction must survive so the next root re-rolls the
    sampling decision."""

    __slots__ = ("_tls",)

    def __init__(self, tls):
        self._tls = tls

    def __enter__(self):
        self._tls.depth += 1
        return self

    def __exit__(self, *exc):
        self._tls.depth -= 1
        return False


class _Span:
    """One recorded span: clock on enter, event emission on exit."""

    __slots__ = ("_tr", "_tls", "name", "cat", "args", "_t0")

    def __init__(self, tracer, tls, name, cat, args):
        self._tr = tracer
        self._tls = tls
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._tls.depth += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tls.depth -= 1
        self._tr._record(self.name, self.cat, self._t0, t1, self.args)
        return False


class Tracer:
    """Span recorder with a bounded ring buffer; see module docstring.

    Thread-safe: spans may be opened concurrently from the serving thread
    and the ingest/pump threads.  Sampling is decided at ROOT spans only
    (depth 0 on the calling thread) and inherited by the whole subtree.
    """

    def __init__(self, *, capacity: int = 65536, sample_every: int = 1,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.enabled = enabled
        self.capacity = capacity
        self.sample_every = sample_every
        self.dropped_events = 0       # overwritten by the ring (monotonic)
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._roots = 0
        self._tids: dict[int, int] = {}      # thread ident -> compact tid
        self._thread_meta: list[dict] = []   # Perfetto thread_name events
        self._local = threading.local()

    # ------------------------------------------------------------------ #
    def _tls(self):
        tls = self._local
        if not hasattr(tls, "depth"):
            tls.depth = 0
            tls.skip = False
        return tls

    def span(self, name: str, cat: str = "twin", **args):
        """Context manager timing one span; `args` land in the trace event.

        Usage: `with tracer.span("guard", shard="2"): ...` — nesting follows
        the runtime call structure per thread.
        """
        if not self.enabled:
            return NULL_SPAN
        tls = self._tls()
        if tls.depth == 0:
            with self._lock:
                n = self._roots
                self._roots += 1
            tls.skip = (n % self.sample_every) != 0
        if tls.skip:
            return _SkipSpan(tls)
        return _Span(self, tls, name, cat, args)

    # ------------------------------------------------------------------ #
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
                if tid == len(self._tids) - 1:
                    self._thread_meta.append({
                        "name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid,
                        "args": {"name": threading.current_thread().name}})
        return tid

    def _record(self, name, cat, t0, t1, args) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0 - self._t0) * 1e6,          # microseconds
              "dur": (t1 - t0) * 1e6,
              "pid": 0, "tid": self._tid()}
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else str(v)) for k, v in args.items()}
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped_events += 1
            self._events.append(ev)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped_events = 0

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads directly."""
        with self._lock:
            events = self._thread_meta + list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.tracing",
                              "dropped_events": self.dropped_events}}

    def write(self, path) -> None:
        """Dump the trace to `path` as Perfetto-loadable JSON."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
