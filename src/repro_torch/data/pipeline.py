"""Window extraction from per-twin telemetry rings (the online path).

`ring_latest` unrolls a ring back into chronological order with gathers
only; `make_ring_windows` slices that trace into the overlapping windows the
refit step trains on.  Both are exact gathers, so windows come out bitwise
identical to the JAX package's.
"""
from __future__ import annotations

import torch

__all__ = ["ring_latest", "make_ring_windows"]


def _windows(ys, us, window: int, stride: int | None):
    """ys [B, T+1, n], us [B, T, m] -> (y_win [B, N, k+1, n],
    u_win [B, N, k, m]); u_win[t] is the input held over step t -> t+1."""
    stride = stride or max(1, window // 2)
    y_win = ys.unfold(1, window + 1, stride).transpose(-1, -2)
    u_win = us.unfold(1, window, stride).transpose(-1, -2)
    return y_win, u_win


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
