"""Per-tick span tracing exportable as Chrome trace-event JSON (Perfetto).

A metric histogram tells you the p99 got worse; a trace tells you WHICH tick
and WHICH stage.  `Tracer.span()` wraps every boundary of the serving tick
and of the what-if query in nested spans.  A span marked *wait* wraps a call
that blocks the host on the device (`.cpu()`, `.numpy()`, `synchronize`);
every other span only enqueues device work, so its host time is dispatch:

    ingest_many                 (one a call; args chunks, samples)
    sharded_tick
    └─ tick (shard=i)
       ├─ flush
       │  ├─ pump_flush         host merge and pad (on the BackgroundPump
       │  │                     thread with async ingest); args rows,
       │  │                     padded_rows, samples, padded_samples, dropped
       │  └─ flush.apply        host-to-device copies and the ring scatter
       ├─ guard
       │  ├─ guard.score        rotation select, ring read, rollout; args
       │  │                     scored, width
       │  ├─ guard.wait         wait: the scores to the host
       │  └─ guard.judge        EMA fold, events
       ├─ schedule
       │  ├─ schedule.plan
       │  └─ schedule.apply     evictions, releases, admissions; args
       │                        admitted, evicted
       └─ refit
          ├─ refit.windows
          ├─ refit.step (step=k)   one for each of steps_per_tick
          │  ├─ refit.forward   Merinda.loss (encoder, head, sparsify, decode)
          │  ├─ refit.backward  autograd through both kernels' backwards
          │  └─ refit.update    per-slot clip, finite check, AdamW
          ├─ refit.wait         wait: the loss vector to the host
          ├─ promote            args candidates, promoted
          │  ├─ promote.recover
          │  ├─ promote.score   ring read and the two guard rollouts
          │  ├─ promote.wait    wait: both score vectors to the host
          │  └─ promote.deploy  decision, theta scatter, history push
          └─ tick.wait          wait: the tick's closing synchronize
    scenario (twin, k, horizon, level, effective_k)
    ├─ scenario.rollout         upload, RK4 launch, ensemble reductions
    └─ scenario.wait            wait: the copies to the host

recorded as Chrome trace-event "complete" events (`ph: "X"`) that load
directly in Perfetto (https://ui.perfetto.dev) or `chrome://tracing`.  A
span may add args once it knows them (`with tracer.span(...) as sp:
sp.note(promoted=3)`).

**Cause and request ids.**  Every event carries, in its args, its own `id`,
its `parent`'s (0 for a root) and its `root`'s: the outermost span of its
thread (a `tick` under its `sharded_tick`, a `scenario`, an `ingest_many`).
A reader computes a span's self time (its duration less its children's) and
groups spans by tick or by query without matching times.

**Clocks.**  Spans are timed with `perf_counter_ns`; `ts` is microseconds
since the tracer was built.  `to_chrome_trace()` writes the anchor pair
(`perf_counter_ns`, `time_ns`) taken at that moment into `otherData.clock`,
so `time_ns + 1000 * ts` places a span on the Unix-epoch clock that
torch.profiler's events use.  While a torch.profiler session records, each
recorded span also opens a `torch.profiler.record_function` range named
`twin.<span name>`, which lands in the profiler's trace on the device
events' own clock: a device kernel is placed under the span that launched
it, an idle gap under the span the host was in.  No profiler, no range.

Designed for an always-on service:

  * **ring-bounded buffer** — events live in a `deque(maxlen=capacity)`;
    a long-running server overwrites its oldest spans instead of growing
    (`dropped_events` counts the overwritten ones, loudly);
  * **sampling knob** — `sample_every=N` records every Nth ROOT span and its
    whole subtree, so steady-state tracing cost scales down linearly while
    sampled ticks stay internally complete (a half-recorded tick is useless);
  * **near-free when off** — `enabled=False` makes `span()` return the shared
    no-op `NULL_SPAN`: no clock read, no allocation, no profiler range, one
    attribute check.  `enabled` may be flipped at run time.  On an H100's
    host a span costs 0.2-0.8 us off and 4-15 us recorded (PERF.md);
    `tests/test_torch_obs.py` holds tick reports and served models
    identical with tracing on and off.

Spans may begin on any thread (the pump flush records from its worker
thread); each thread renders as its own Perfetto track via `tid`, with
thread-name metadata events emitted on first sight, and keeps its own
stack of open spans.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque

__all__ = ["Tracer", "NULL_SPAN", "PROFILER_PREFIX"]

PROFILER_PREFIX = "twin."      # torch.profiler ranges mirroring spans

_profiler = None               # (enabled(), record_function), on first use


def _profiler_hooks():
    """torch's profiler switch and range, resolved on the first recorded
    span, so that this module imports nothing beyond the standard library."""
    global _profiler
    if _profiler is None:
        try:
            import torch
            _profiler = (torch.autograd._profiler_enabled,
                         torch.profiler.record_function)
        except ImportError:
            _profiler = (lambda: False, None)
    return _profiler


class _NullSpan:
    """Shared no-op context manager (tracing disabled)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args):
        pass


NULL_SPAN = _NullSpan()


class _SkipSpan:
    """Stack bookkeeping for an UNSAMPLED subtree — records nothing, but the
    root/child distinction must survive so the next root re-rolls the
    sampling decision."""

    __slots__ = ("_tls",)

    def __init__(self, tls):
        self._tls = tls

    def __enter__(self):
        self._tls.stack.append(0)
        return self

    def __exit__(self, *exc):
        self._tls.stack.pop()
        return False

    def note(self, **args):
        pass


class _Span:
    """One recorded span: ids and clock on enter, event emission on exit."""

    __slots__ = ("_tr", "_tls", "name", "cat", "args", "_id", "_parent",
                 "_root", "_t0", "_range")

    def __init__(self, tracer, tls, name, cat, args):
        self._tr = tracer
        self._tls = tls
        self.name = name
        self.cat = cat
        self.args = args

    def note(self, **args):
        """Add args known only once the span has run part of its work."""
        self.args.update(args)

    def __enter__(self):
        stack = self._tls.stack
        self._id = next(self._tr._ids)
        if stack:
            self._parent, self._root = stack[-1], stack[0]
        else:
            self._parent, self._root = 0, self._id
        stack.append(self._id)
        enabled, record_function = _profiler_hooks()
        if enabled():
            self._range = record_function(PROFILER_PREFIX + self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tls.stack.pop()
        self._tr._record(self, t1)
        return False


class Tracer:
    """Span recorder with a bounded ring buffer; see module docstring.

    Thread-safe: spans may be opened concurrently from the serving thread
    and the ingest/pump threads.  Sampling is decided at ROOT spans only
    (an empty span stack on the calling thread) and inherited by the whole
    subtree.
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
        # the anchor: one reading of both clocks, taken together
        self._t0_ns = time.perf_counter_ns()
        self._epoch_ns = time.time_ns()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._roots = 0
        self._tids: dict[int, int] = {}      # thread ident -> compact tid
        self._thread_meta: list[dict] = []   # Perfetto thread_name events
        self._local = threading.local()

    # ------------------------------------------------------------------ #
    def _tls(self):
        tls = self._local
        if not hasattr(tls, "stack"):
            tls.stack = []        # ids of the open spans (0: unsampled)
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
        if not tls.stack:
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

    def _record(self, sp: _Span, t1: int) -> None:
        args = {k: (v if isinstance(v, (int, float, str, bool))
                    else str(v)) for k, v in sp.args.items()}
        args.update(id=sp._id, parent=sp._parent, root=sp._root)
        ev = {"name": sp.name, "cat": sp.cat, "ph": "X",
              "ts": (sp._t0 - self._t0_ns) / 1e3,        # microseconds
              "dur": (t1 - sp._t0) / 1e3,
              "pid": 0, "tid": self._tid(), "args": args}
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
                              "dropped_events": self.dropped_events,
                              "clock": {"perf_counter_ns": self._t0_ns,
                                        "time_ns": self._epoch_ns}}}

    def write(self, path) -> None:
        """Dump the trace to `path` as Perfetto-loadable JSON."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
