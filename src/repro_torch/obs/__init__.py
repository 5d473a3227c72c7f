"""Observability for the twin-serving stack: metrics, tracing, exporters.

Dependency-free (stdlib only — no JAX, no numpy) so it can be imported from
any layer, including host-side threads that must never touch device state.

Modules
-------
registry.py   `MetricRegistry` — thread-safe counters / gauges / fixed-bucket
              log-spaced histograms with p50/p90/p99/max queries, grouped
              into label-keyed families.  `expose()` renders Prometheus text
              exposition; `snapshot()` a JSON-able dump.  Bounded memory:
              histograms are O(buckets) no matter how long the server runs.

tracing.py    `Tracer` — nested spans around the serving stages
              (tick -> flush/guard/schedule/refit, pump flushes, per-shard
              ticks), recorded into a ring-bounded buffer and exported as
              Chrome trace-event JSON loadable in Perfetto.  `sample_every`
              records every Nth root span's subtree; `enabled=False` makes
              spans no-op context managers (near-free).

exporters.py  `SnapshotWriter` — periodic (atomic) JSON snapshot file of the
              registry, for deployments without scrape infrastructure.

The serving integration (which metric names exist, the span hierarchy, how
to scrape) is catalogued in docs/OBSERVABILITY.md.
"""
from repro_torch.obs.exporters import SnapshotWriter
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricRegistry, DEFAULT_LATENCY_BUCKETS,
                                      DEFAULT_SCORE_BUCKETS, log_buckets)
from repro_torch.obs.tracing import NULL_SPAN, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "log_buckets",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SCORE_BUCKETS",
    "Tracer", "NULL_SPAN", "SnapshotWriter",
]
