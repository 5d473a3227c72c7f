"""Windowing sampled traces into model-recovery batches.

`make_windows` slices traces into the overlapping windows the offline
trainers fit; `WindowDataset` iterates them in shuffled minibatches.  The
online path's `ring_latest` unrolls a telemetry ring back into time order
with gathers only, and `make_ring_windows` windows that trace per slot.
All of it is exact gathers, so windows come out bitwise identical to the
JAX package's.  `BackgroundPump` and `PrefetchIterator` are host threads:
the serving tick's background staging flush and a train loop's prefetcher.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import torch

__all__ = ["make_windows", "WindowDataset", "ring_latest",
           "make_ring_windows", "BackgroundPump", "PrefetchIterator"]


def _windows(ys, us, window: int, stride: int | None):
    """ys [B, T+1, n], us [B, T, m] -> (y_win [B, N, k+1, n],
    u_win [B, N, k, m]); u_win[t] is the input held over step t -> t+1."""
    stride = stride or max(1, window // 2)
    y_win = ys.unfold(1, window + 1, stride).transpose(-1, -2)
    u_win = us.unfold(1, window, stride).transpose(-1, -2)
    return y_win, u_win


def make_windows(ys, us, window: int, stride: int | None = None):
    """Slice a trace ([T+1, n], [T, m]) or a batch of traces ([B, T+1, n],
    [B, T, m]) into overlapping windows, trace-major: (y_win [N, k+1, n],
    u_win [N, k, m]) with k = window and the stride window // 2 by default.
    Integrating from y_win[:, 0] under u_win reproduces y_win."""
    if ys.ndim == 2:
        ys, us = ys[None], us[None]
    y_win, u_win = _windows(ys, us, window, stride)
    return y_win.flatten(0, 1), u_win.flatten(0, 1)


def ring_latest(ring_y, ring_u, count, slots, length: int):
    """Gather the newest `length+1` samples per ring slot, in time order.

    ring_y [S, cap, n], ring_u [S, cap, m]: sample i of slot s lives at
    column i % cap; count [S] = samples written.  slots [B] rows to extract.
    Requires count[slots] >= length+1 (caller-checked; earlier columns are
    stale/zero otherwise).  Returns (ys [B, length+1, n], us [B, length, m]).
    """
    cap = ring_y.shape[1]
    slots = slots.long()
    end = count[slots].long()                                   # [B]
    steps = torch.arange(length + 1, device=ring_y.device)
    idx = (end[:, None] + steps[None, :] - (length + 1)) % cap  # [B, length+1]
    rows = slots[:, None].expand_as(idx)
    return ring_y[rows, idx], ring_u[rows[:, :-1], idx[:, :-1]]


def make_ring_windows(ring_y, ring_u, count, slots, *, window: int,
                      stride: int | None = None, length: int):
    """Sliding windows over the newest `length` ring steps, grouped per
    slot: (y_win [B, N, k+1, n], u_win [B, N, k, m]) with
    N = (length - window) // stride + 1."""
    ys, us = ring_latest(ring_y, ring_u, count, slots, length)
    return _windows(ys, us, window, stride)


@dataclass
class WindowDataset:
    """In-memory windows with shuffled minibatch iteration."""
    y_win: torch.Tensor   # [N, k+1, n]
    u_win: torch.Tensor   # [N, k, m]
    dt: float

    @property
    def n_windows(self) -> int:
        return int(self.y_win.shape[0])

    def norm_stats(self):
        """Per-channel (mu, sigma) over [Y ; U] (std with ddof 0)."""
        xs = torch.cat([self.y_win[:, :-1, :], self.u_win], dim=-1)
        return (xs.mean(dim=(0, 1)),
                xs.std(dim=(0, 1), correction=0) + 1e-6)

    def batches(self, generator: torch.Generator, batch_size: int, *,
                epochs: int = 1,
                drop_remainder: bool = True) -> Iterator[tuple]:
        """(y_win, u_win) minibatches; each epoch is a fresh permutation
        drawn from `generator` on the CPU."""
        n = self.n_windows
        steps = n // batch_size if drop_remainder else -(-n // batch_size)
        for _ in range(epochs):
            perm = torch.randperm(n, generator=generator).to(
                self.y_win.device)
            for s in range(steps):
                idx = perm[s * batch_size:(s + 1) * batch_size]
                yield self.y_win[idx], self.u_win[idx]

    @staticmethod
    def from_trace(ys, us, dt, window: int, stride: int | None = None,
                   normalize: bool = False):
        """`normalize` is accepted and ignored, as in the JAX package: the
        model normalizes from `norm_stats`."""
        y_win, u_win = make_windows(ys, us, window, stride)
        return WindowDataset(y_win=y_win, u_win=u_win, dt=dt)


class BackgroundPump:
    """Event-driven background producer feeding a bounded handoff queue.

    The PrefetchIterator pattern generalized from iterators to swap-based
    producers: a consumer `kick()`s the pump whenever new source material
    exists; the worker thread calls `produce()` (which should atomically take
    the source's current contents — a double-buffer swap) and parks the result
    in a depth-bounded queue.  `queue.put` on a full queue is the
    backpressure: with depth=2 the worker prepares one batch while the
    consumer applies another, and coalesces further kicks until a slot frees.

    Used by twin/server.py to move the host-side telemetry staging flush off
    the serving tick: `produce` swaps the staging buffer and does the numpy
    merge/pad work; the tick thread `drain()`s prepared batches and issues
    every device copy and scatter itself, so the worker never touches the
    device (nor races the tick's CUDA stream).

    `produce` returning None (nothing staged) enqueues nothing.  `idle()` is
    True once every kick issued so far has been fully processed — the drain
    barrier used to guarantee no sample is left in flight.

    A `produce()` exception does NOT kill the worker silently: the error is
    captured in `self.error`, the kick is marked served (so `idle()` and the
    drain barrier cannot deadlock on a dead producer), and the next `drain()`
    re-raises it on the consumer thread where it can be handled.
    """

    def __init__(self, produce, depth: int = 2):
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._kicks = 0          # kicks issued
        self._served = 0         # kicks whose produce() has fully completed
        self._stop = False
        self.error: BaseException | None = None   # first produce() failure
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def kick(self) -> None:
        with self._lock:
            self._kicks += 1
        self._event.set()

    def _run(self) -> None:
        while True:
            self._event.wait()
            if self._stop:
                return
            # clear BEFORE reading the kick counter: a kick landing after the
            # clear re-sets the event (extra wakeup, harmless); the reverse
            # order would clear a fresh kick's wakeup and strand idle()
            self._event.clear()
            with self._lock:
                target = self._kicks
            try:
                item = self._produce()
            except BaseException as e:    # noqa: BLE001 — surfaced via drain
                with self._lock:
                    if self.error is None:
                        self.error = e
                    self._served = target    # keep idle()/drain barrier live
                continue
            if item is not None:
                self._q.put(item)     # blocks when full: backpressure
            with self._lock:
                self._served = target
            if self._stop:
                return

    def drain(self) -> list:
        """Non-blocking: every batch the worker has parked so far.  Re-raises
        a captured `produce()` failure (after handing over any batches that
        completed before it) so producer errors surface on the consumer."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        with self._lock:
            err, self.error = self.error, None
        if err is not None:
            raise err
        return out

    def idle(self) -> bool:
        """True when no kick is pending or mid-produce (queued batches may
        still await drain())."""
        with self._lock:
            return self._served >= self._kicks

    def queue_depth(self) -> int:
        """Prepared batches parked and awaiting drain() — the handoff-queue
        gauge (`twin_pump_queue_depth`): pinned at `depth` means the consumer
        (serving tick) is the bottleneck, 0 means the producer is."""
        return self._q.qsize()

    def close(self) -> None:
        self._stop = True
        self._event.set()
        try:
            self.drain()          # unblock a worker parked on a full queue
        except BaseException:     # noqa: BLE001 — shutdown must not raise
            pass
        self._thread.join(timeout=5.0)


class PrefetchIterator:
    """Background-thread prefetcher with a per-batch deadline.

    If the producer misses `deadline_s` for a batch, the consumer records a
    straggler event and keeps waiting only until the next batch is ready —
    the count is surfaced so a trainer can react
    (distributed/fault_tolerance.py).
    """

    def __init__(self, it: Iterator, depth: int = 2, deadline_s: float = 5.0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._deadline = deadline_s
        self.straggler_events = 0
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self._deadline)
        except queue.Empty:
            self.straggler_events += 1
            item = self._q.get()   # block until ready
        if item is self._done:
            raise StopIteration
        return item
