"""Windowing sampled traces into model-recovery batches.

`make_windows` slices traces into the overlapping windows the offline
trainers fit; `WindowDataset` iterates them in shuffled minibatches.  The
online path's `ring_latest` unrolls a telemetry ring back into time order
with gathers only, and `make_ring_windows` windows that trace per slot.
All of it is exact gathers, so windows come out bitwise identical to the
JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import torch

__all__ = ["make_windows", "WindowDataset", "ring_latest",
           "make_ring_windows"]


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
    def from_trace(ys, us, dt, window: int, stride: int | None = None):
        y_win, u_win = make_windows(ys, us, window, stride)
        return WindowDataset(y_win=y_win, u_win=u_win, dt=dt)
