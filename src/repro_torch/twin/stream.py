"""Per-twin telemetry ring buffers as device tensors with a fused ingest.

`TelemetryRing` keeps one fixed-capacity ring per twin as a single set of
device tensors, so a serving tick does one scatter (`ingest`) and one gather
(`windows` / `latest`) for the whole fleet.  State is a plain dict:

    y     [S, cap, n]   state telemetry
    u     [S, cap, m]   input telemetry (u_t held during y_t -> y_{t+1})
    count [S] int32     samples ever written per slot (write head =
                        count % cap; monotonically increasing)

`ingest` and `clear` update the state tensors IN PLACE and return the same
dict (JAX's `.at[].set` returned new arrays).  Row `S-1` is reserved by
twin/server.py as a scratch row for padded flush rows.

The host side — `StagingBuffer`, `FlushBatch`, `prepare_flush` — is numpy
and threading only, carried over unchanged in behaviour.  Readiness stays a
host gate in the server (`latest` returns stale columns for a slot with
fewer than length+1 samples); nothing here clamps.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.pipeline import make_ring_windows, ring_latest

__all__ = ["RingConfig", "TelemetryRing", "StagingBuffer", "StagingOverflow",
           "FlushBatch", "prepare_flush"]


@dataclass(frozen=True)
class RingConfig:
    slots: int       # number of per-twin rings (tracked-object capacity)
    capacity: int    # samples per ring; windows must fit inside it
    n: int           # state dim
    m: int           # input dim


class TelemetryRing:
    def __init__(self, cfg: RingConfig, *, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)

    # ------------------------------------------------------------------ #
    def init(self):
        cfg, dev = self.cfg, self.device
        return {
            "y": torch.zeros((cfg.slots, cfg.capacity, cfg.n), device=dev),
            "u": torch.zeros((cfg.slots, cfg.capacity, cfg.m), device=dev),
            "count": torch.zeros((cfg.slots,), dtype=torch.int32, device=dev),
        }

    # ------------------------------------------------------------------ #
    def ingest(self, state, slots, ys, us, counts):
        """Fused scatter of one telemetry chunk per slot, in place.

        slots [B] DISTINCT ring rows (padding rows may repeat the scratch
        row with count 0); ys [B, C, n], us [B, C, m] chunk buffers; counts
        [B] valid prefix per chunk.  Padded tail positions are written back
        with their current values, so duplicate padding rows all write the
        same thing.  Requires C <= capacity.
        """
        cap = self.cfg.capacity
        C = ys.shape[1]
        if C > cap:
            raise ValueError(f"chunk of {C} samples would lap the {cap}-sample "
                             "ring")
        slots = slots.long()
        offs = torch.arange(C, device=ys.device)[None, :]          # [1, C]
        cols = (state["count"][slots].long()[:, None] + offs) % cap
        valid = (offs < counts[:, None]).unsqueeze(-1)             # [B, C, 1]
        rows = slots[:, None].expand_as(cols)
        for key, new in (("y", ys), ("u", us)):
            buf = state[key]
            buf[rows, cols] = torch.where(valid, new, buf[rows, cols])
        state["count"].index_add_(0, slots, counts.to(torch.int32))
        return state

    # ------------------------------------------------------------------ #
    def latest(self, state, slots, length: int):
        """Newest `length+1` samples per slot, chronological: (ys [B,
        length+1, n], us [B, length, m]).  Requires count[slots] >=
        length+1 (host-checked by the server's readiness gate)."""
        return ring_latest(state["y"], state["u"], state["count"], slots,
                           length)

    def windows(self, state, slots, *, window: int, stride: int | None = None,
                length: int):
        """Sliding windows over the newest `length` steps of each slot:
        (y_win [B, N, k+1, n], u_win [B, N, k, m])."""
        return make_ring_windows(state["y"], state["u"], state["count"],
                                 slots, window=window, stride=stride,
                                 length=length)

    # ------------------------------------------------------------------ #
    @staticmethod
    def span(window: int, stride: int, n_windows: int) -> int:
        """Ring steps needed so `windows(..., length=span)` yields exactly
        `n_windows` windows."""
        return stride * (n_windows - 1) + window

    def clear(self, state, slot: int):
        """Logically empty one ring, in place."""
        state["count"][slot] = 0
        return state


# --------------------------------------------------------------------------- #
# Host-side staging: thread-safe chunk accumulation + fused-flush preparation
# --------------------------------------------------------------------------- #
class StagingOverflow(RuntimeError):
    """A bounded `StagingBuffer` cannot accept a chunk without exceeding its
    capacity; the caller decides the policy (retry, shed, raise)."""


class StagingBuffer:
    """Thread-safe host-side staging of telemetry chunks, keyed by ring row.

    Producers `append()` under the lock; the flusher `swap()`s the filled
    buffer for an empty one.  Chronological order per row is preserved
    across swaps.  With `capacity` set, `append` raises `StagingOverflow`
    once the backlog would exceed it, and `drop_oldest` sheds the globally
    oldest chunks.
    """

    def __init__(self, capacity: int | None = None):
        self._lock = threading.Lock()
        self._buf: dict[int, list] = {}
        self._order: deque[int] = deque()   # rows in chunk-append order
        self.capacity = capacity
        self.staged_samples = 0      # samples appended, monotonic
        self.swapped_samples = 0     # samples handed off via swap(), monotonic
        self.dropped_samples = 0     # samples shed by drop_oldest, monotonic

    def append(self, row: int, y: np.ndarray, u: np.ndarray, *,
               force: bool = False) -> None:
        """Stage one chunk.  Raises `StagingOverflow` when bounded and full;
        `force=True` bypasses the bound."""
        with self._lock:
            if (self.capacity is not None and not force
                    and self._pending_locked() + len(y) > self.capacity):
                raise StagingOverflow(
                    f"staging buffer full: {self._pending_locked()} pending "
                    f"+ {len(y)} new > capacity {self.capacity}")
            self._buf.setdefault(row, []).append((y, u))
            self._order.append(row)
            self.staged_samples += len(y)

    def drop_oldest(self, need: int) -> int:
        """Shed the globally oldest staged chunks until at least `need`
        samples are freed (or the buffer is empty); returns samples dropped."""
        dropped = 0
        with self._lock:
            while dropped < need and self._order:
                row = self._order.popleft()
                chunks = self._buf.get(row)
                if not chunks:       # row already consumed by a swap
                    continue
                y, _ = chunks.pop(0)
                dropped += len(y)
                if not chunks:
                    del self._buf[row]
            self.dropped_samples += dropped
        return dropped

    def swap(self) -> dict[int, list]:
        """Atomically take everything staged so far (may be empty)."""
        with self._lock:
            buf, self._buf = self._buf, {}
            self._order.clear()
            self.swapped_samples += sum(len(c[0]) for cs in buf.values()
                                        for c in cs)
            return buf

    def empty(self) -> bool:
        with self._lock:
            return not self._buf

    def _pending_locked(self) -> int:
        return (self.staged_samples - self.swapped_samples
                - self.dropped_samples)

    def pending_samples(self) -> int:
        """Samples staged but not yet handed to a flush."""
        with self._lock:
            return self._pending_locked()


@dataclass
class FlushBatch:
    """One prepared fused-ingest call: padded host operands plus the per-row
    raw sample counts (pre-truncation) for host accounting."""
    slots: np.ndarray        # [B] int32 ring rows (scratch-padded)
    ys: np.ndarray           # [B, C, n]
    us: np.ndarray           # [B, C, m]
    counts: np.ndarray       # [B] int32 valid prefix per row
    received: dict[int, int] # ring row -> raw samples staged (incl. truncated)
    dropped: int = 0         # backlog samples truncated


def prepare_flush(staged: dict[int, list], *, capacity: int, pad: int,
                  scratch: int, n: int, m: int) -> FlushBatch | None:
    """Merge staged chunks into one padded fused-ingest batch.

    Rows pad to a pow2 multiple of `pad` (scratch rows, zero counts) and
    columns to a multiple of `pad` capped at the ring capacity.  A backlog
    longer than the ring keeps its newest capacity-worth of samples and
    reports the rest in `dropped`.  A SINGLE chunk longer than the ring
    would lap the ring within one scatter and raises RuntimeError.
    """
    if not staged:
        return None
    merged = []
    received: dict[int, int] = {}
    dropped = 0
    for row, chunks in sorted(staged.items()):
        longest = max(len(c[0]) for c in chunks)
        if longest > capacity:
            raise RuntimeError(
                f"staged chunk of {longest} samples would lap the "
                f"{capacity}-sample ring mid-flush (row {row})")
        y = np.concatenate([c[0] for c in chunks], 0)
        u = np.concatenate([c[1] for c in chunks], 0)
        received[row] = len(y)
        if len(y) > capacity:
            dropped += len(y) - capacity
            y, u = y[-capacity:], u[-capacity:]
        merged.append((row, y, u))
    q = -(-len(merged) // pad)
    B = int(pad * (1 << (q - 1).bit_length()))
    C = min(int(-(-max(len(y) for _, y, _ in merged) // pad) * pad), capacity)
    ys = np.zeros((B, C, n), np.float32)
    us = np.zeros((B, C, m), np.float32)
    slots = np.full((B,), scratch, np.int32)
    counts = np.zeros((B,), np.int32)
    for i, (row, y, u) in enumerate(merged):
        ys[i, :len(y)] = y
        us[i, :len(y)] = u
        slots[i] = row
        counts[i] = len(y)
    return FlushBatch(slots=slots, ys=ys, us=us, counts=counts,
                      received=received, dropped=dropped)
