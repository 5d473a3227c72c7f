"""Reading the profiler's trace of the traced segment.

The device events are read from the profiler's raw events, as
`chip_smoke.py::_device_events` does (the profiler's own `key_averages`
builds an object for every host event too, which is slow for hundreds of
thousands of launches).  One stream: kernels do not overlap, but busy time
is still taken as the union of the events' intervals.  A federated
server's workers trace themselves; `merge` adds their events, which share
the host's clock, so that busy time is the union over every process on
the card.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

ANNOTATION = "bench."          # the benchmark's own record_function ranges


def _start(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)


def _dur(e) -> int:
    return (e.duration_ns() if hasattr(e, "duration_ns")
            else int(e.duration_us() * 1e3))


@dataclass
class Trace:
    device: list = field(default_factory=list)    # (start_ns, dur_ns, name)
    host: list = field(default_factory=list)      # (start_ns, end_ns, name)
    ranges: list = field(default_factory=list)    # benchmark annotations
    window_s: float = 0.0
    ticks: int = 0
    shapes: dict = field(default_factory=dict)    # kernel -> [shape, ...]

    @staticmethod
    def read(prof, window_s: float, ticks: int, shapes: dict) -> "Trace":
        from torch.autograd import DeviceType
        t = Trace(window_s=window_s, ticks=ticks, shapes=shapes)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.name().startswith(ANNOTATION):   # range mirrors
                    t.device.append((_start(e), _dur(e), e.name()))
            else:
                s = _start(e)
                item = (s, s + _dur(e), e.name())
                (t.ranges if e.name().startswith(ANNOTATION)
                 else t.host).append(item)
        t.device.sort()
        t.host.sort()
        t.ranges.sort()
        return t

    def merge(self, parts: list) -> "Trace":
        """This trace with other processes' device and host events and
        kernel-entry shapes added (each part a dict of `device`, `host`,
        `shapes`, as `read` makes them)."""
        for part in parts:
            self.device.extend(part["device"])
            self.host.extend(part["host"])
            for name, shapes in part["shapes"].items():
                self.shapes.setdefault(name, []).extend(shapes)
        self.device.sort()
        self.host.sort()
        return self

    def span_s(self) -> float:
        """Seconds from the first device operation's start to the last's
        end."""
        if not self.device:
            return 0.0
        return (max(s + d for s, d, _ in self.device)
                - self.device[0][0]) / 1e9

    # ------------------------------------------------------------------ #
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, None
        for s, d, _ in self.device:
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    @staticmethod
    def is_kernel(name: str) -> bool:
        return not name.startswith(("Memcpy", "Memset"))

    def kernels(self, pattern: str | None = None) -> list:
        return [ev for ev in self.device if self.is_kernel(ev[2])
                and (pattern is None or pattern in ev[2])]

    def within(self, lo: int, hi: int) -> list:
        """Device events that start inside [lo, hi]."""
        i = bisect.bisect_left(self.device, (lo,))
        out = []
        while i < len(self.device) and self.device[i][0] <= hi:
            out.append(self.device[i])
            i += 1
        return out

    def named_ranges(self, name: str) -> list:
        return [(s, e) for s, e, n in self.ranges if n == name]

    # ------------------------------------------------------------------ #
    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for _, d, name in self.device:
            by[name] = by.get(name, 0) + d
        return [[k[:120], v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, labelled: int = 400) -> list:
        """Idle time between device operations, summed by what the host
        was doing: the benchmark's range and the innermost host operation
        at the middle of each gap, for the `labelled` longest gaps."""
        gaps, end = [], None
        for s, d, _ in self.device:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(reverse=True)
        starts = [h[0] for h in self.host]
        rstarts = [r[0] for r in self.ranges]
        by: dict = {}
        for length, lo, hi in gaps[:labelled]:
            mid = (lo + hi) // 2
            label = "outside the benchmark's ranges"
            j = bisect.bisect_right(rstarts, mid) - 1
            while j >= 0:
                if self.ranges[j][1] >= mid:
                    label = self.ranges[j][2]
                    break
                j -= 1
            inner = None
            i = bisect.bisect_right(starts, mid) - 1
            for k in range(i, max(i - 2000, -1), -1):
                if self.host[k][1] >= mid:
                    inner = self.host[k][2]
                    break
            key = f"{label} / {inner or 'python'}"[:120]
            by[key] = by.get(key, 0) + length
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]
