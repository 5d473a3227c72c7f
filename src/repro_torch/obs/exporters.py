"""Exporters: periodic JSON metric snapshots + trace file emission.

The Prometheus text exposition itself lives on the registry
(`MetricRegistry.expose()` — transport-free; serve it from any HTTP
handler).  This module covers the file-based paths an edge deployment
actually has available when there is no scrape infrastructure:

  * `SnapshotWriter` — writes `registry.snapshot()` (plus optional tracer
    health) to a JSON file at most once per `every_s` seconds.  Call
    `maybe_write()` opportunistically from the serving loop (cheap no-op
    between periods) or `write()` to force one — e.g. at benchmark end.
    Writes are atomic (tmp file + rename) so a scraping sidecar never
    reads a torn snapshot.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["SnapshotWriter"]


class SnapshotWriter:
    """Periodic JSON snapshot of a `MetricRegistry` (+ tracer health)."""

    def __init__(self, registry, path, *, every_s: float = 10.0,
                 tracer=None):
        self.registry = registry
        self.path = str(path)
        self.every_s = float(every_s)
        self.tracer = tracer
        self.writes = 0
        self._last = -float("inf")

    def maybe_write(self) -> bool:
        """Write if a full period elapsed since the last write."""
        now = time.monotonic()
        if now - self._last < self.every_s:
            return False
        self._last = now
        self.write()
        return True

    def write(self) -> None:
        snap = {"unix_time": time.time(),
                "metrics": self.registry.snapshot()}
        if self.tracer is not None:
            snap["trace"] = {"events": len(self.tracer),
                             "dropped_events": self.tracer.dropped_events,
                             "sample_every": self.tracer.sample_every,
                             "enabled": self.tracer.enabled}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1)
        os.replace(tmp, self.path)
        self.writes += 1
