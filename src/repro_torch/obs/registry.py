"""Thread-safe, dependency-free metrics registry for the twin-serving stack.

The serving loop used to prove its latency SLO with ad-hoc `perf_counter()`
pairs appended to unbounded Python lists — a memory leak in a long-running
service and invisible to operators.  This module is the replacement: a small
Prometheus-shaped registry with three instrument types, all bounded-memory
and safe to update from sensor/pump threads concurrently with the serving
tick:

  * `Counter`   — monotone float (events, samples, violations),
  * `Gauge`     — last-write-wins float (queue depth, tracked twins, grants),
  * `Histogram` — FIXED log-spaced buckets with p50/p90/p99/max queries.
    Memory is O(buckets) regardless of how many samples are observed; the
    per-bucket geometric spacing bounds the relative quantile error at one
    bucket ratio (`tests/test_obs.py` checks it against exact quantiles).

Instruments are grouped into FAMILIES by metric name (one help/type/unit per
name) with label-keyed children — `registry.counter("x_total",
labels={"shard": "3"})` returns the same child on every call, so layers can
re-resolve instruments cheaply instead of threading objects around.

Exposition: `registry.expose()` renders the standard Prometheus text format
(histograms as cumulative `_bucket{le=...}` series plus `_sum`/`_count`);
`registry.snapshot()` returns a JSON-able dict for the periodic snapshot
writer (obs/exporters.py).  Naming follows Prometheus conventions: counters
end in `_total`, units are in the name (`_seconds`), labels are flat strings.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "log_buckets", "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SCORE_BUCKETS"]


def log_buckets(lo: float, hi: float, per_decade: int = 30) -> tuple:
    """Geometric bucket upper edges from `lo` to >= `hi`.

    `per_decade` edges per power of ten; the relative width of each bucket
    (and so the worst-case relative quantile error) is 10**(1/per_decade)-1
    (~8% at the default 30).  An implicit +inf overflow bucket rides on top.
    """
    if not (0 < lo < hi):
        raise ValueError("need 0 < lo < hi")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


# serving latencies: 10 us .. 100 s covers a fused kernel dispatch through a
# badly-stalled sharded tick; 60/decade keeps the worst-case quantile
# quantization under 4% — tight enough that the tracing-overhead gate
# (p50 within 5%, bench_out/online_scale.csv) measures the tracer, not the
# histogram.  421 buckets = a few KB per child.
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-5, 100.0, 60)
# guard divergence scores: 1e-6 (tracking perfectly) .. 1e6 (_BLOWUP_SCORE)
DEFAULT_SCORE_BUCKETS = log_buckets(1e-6, 1e6, 6)


class _Metric:
    """Common identity: family name + sorted label pairs."""

    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels          # sorted ((key, value), ...) strings
        self._lock = threading.Lock()

    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return "{" + inner + "}"


class Counter(_Metric):
    """Monotone event/sample counter.  `inc()` is thread-safe."""

    __slots__ = ("_value",)

    def __init__(self, name: str, labels: tuple = ()):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        """Zero the counter (benchmark warmup resets, not production)."""
        with self._lock:
            self._value = 0.0


class Gauge(_Metric):
    """Last-write-wins instantaneous value.  Thread-safe."""

    __slots__ = ("_value",)

    def __init__(self, name: str, labels: tuple = ()):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram(_Metric):
    """Fixed-bucket histogram with quantile queries; memory is O(buckets).

    `bounds` are ascending upper edges (log-spaced for latency/score use);
    observations above the last edge land in an implicit +inf bucket whose
    quantile estimate is the tracked exact max.  `observe()` is thread-safe
    and O(log buckets) (bisect).  `quantile(q)` interpolates geometrically
    inside the winning bucket, so with `log_buckets(per_decade=k)` the
    relative error vs the exact quantile is bounded by one bucket ratio
    (10**(1/k) - 1).
    """

    __slots__ = ("bounds", "_counts", "_count", "_sum", "_max", "_min")

    def __init__(self, name: str, labels: tuple = (),
                 bounds: tuple = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, labels)
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(set(b)):
            raise ValueError("histogram bounds must be strictly ascending")
        self.bounds = b
        self._counts = [0] * (len(b) + 1)      # last = +inf overflow
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._min = math.inf

    # ------------------------------------------------------------------ #
    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            if v < self._min:
                self._min = v

    # ------------------------------------------------------------------ #
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1) from the bucket counts."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= rank:
                    # geometric interpolation inside bucket i; the bucket's
                    # lower edge is clamped to the observed min, its upper
                    # edge to the observed max (exact endpoints beat edges)
                    lo = self.bounds[i - 1] if i > 0 else self._min
                    hi = self.bounds[i] if i < len(self.bounds) else self._max
                    lo = max(min(lo, self._max), min(self._min, hi), 1e-300)
                    hi = min(max(hi, lo), self._max)
                    frac = (rank - cum) / c
                    return lo * (hi / lo) ** frac if hi > lo > 0 else hi
                cum += c
            return self._max

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._max = 0.0
            self._min = math.inf


class _Family:
    """One metric name: shared help/type/unit + label-keyed children."""

    __slots__ = ("name", "kind", "help", "unit", "bounds", "children")

    def __init__(self, name, kind, help, unit, bounds):
        self.name = name
        self.kind = kind            # "counter" | "gauge" | "histogram"
        self.help = help
        self.unit = unit
        self.bounds = bounds
        self.children: dict[tuple, _Metric] = {}


_CLS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Families of counters/gauges/histograms; see module docstring.

    All three accessors are GET-OR-CREATE on (name, labels): layers resolve
    their instruments at construction time and hold the child references on
    the hot path (dict lookups stay off the tick).  Re-registering a name
    with a different type raises — one name, one meaning.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # ------------------------------------------------------------------ #
    def _get(self, kind: str, name: str, help: str, unit: str,
             labels: dict | None, bounds: tuple | None):
        key = tuple(sorted((str(k), str(v))
                           for k, v in (labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, unit,
                              bounds or DEFAULT_LATENCY_BUCKETS)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.kind}, not {kind}")
            child = fam.children.get(key)
            if child is None:
                if kind == "histogram":
                    child = Histogram(name, key, bounds=fam.bounds)
                else:
                    child = _CLS[kind](name, key)
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", unit: str = "",
                labels: dict | None = None) -> Counter:
        return self._get("counter", name, help, unit, labels, None)

    def gauge(self, name: str, help: str = "", unit: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get("gauge", name, help, unit, labels, None)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  labels: dict | None = None,
                  bounds: tuple | None = None) -> Histogram:
        return self._get("histogram", name, help, unit, labels, bounds)

    # ------------------------------------------------------------------ #
    def families(self) -> list[_Family]:
        with self._lock:
            return list(self._families.values())

    def expose(self) -> str:
        """Prometheus text exposition of every family, labels included.

        Histograms render as cumulative `_bucket{le="..."}` series plus
        `_sum` and `_count` (the standard scrape shape; a Grafana
        `histogram_quantile()` works unmodified).  Scrape it from whatever
        HTTP handler the deployment runs — the registry itself is
        transport-free.
        """
        out: list[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for child in fam.children.values():
                if fam.kind == "histogram":
                    out.extend(_expose_histogram(child))
                else:
                    out.append(f"{fam.name}{child.label_str()} "
                               f"{_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able state dump: {name: {kind, help, unit, series: [...]}}.

        Histogram series carry count/sum/max and the derived p50/p90/p99 so
        a snapshot is directly plottable without re-deriving quantiles.
        """
        snap: dict = {}
        for fam in self.families():
            series = []
            for child in fam.children.values():
                entry: dict = {"labels": dict(child.labels)}
                if fam.kind == "histogram":
                    entry.update(count=child.count, sum=child.sum,
                                 max=child.max,
                                 p50=child.quantile(0.5),
                                 p90=child.quantile(0.9),
                                 p99=child.quantile(0.99))
                else:
                    entry["value"] = child.value
                series.append(entry)
            snap[fam.name] = {"kind": fam.kind, "help": fam.help,
                              "unit": fam.unit, "series": series}
        return snap


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(v) if v != int(v) else str(int(v))


def _expose_histogram(h: Histogram) -> list[str]:
    base = dict(h.labels)
    lines = []
    with h._lock:
        counts, bounds = list(h._counts), h.bounds
        total, s = h._count, h._sum
    cum = 0
    for edge, c in zip(tuple(bounds) + (math.inf,), counts):
        cum += c
        lab = dict(base)
        lab["le"] = "+Inf" if edge == math.inf else repr(edge)
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(lab.items()))
        lines.append(f"{h.name}_bucket{{{inner}}} {cum}")
    lines.append(f"{h.name}_sum{h.label_str()} {_fmt(s)}")
    lines.append(f"{h.name}_count{h.label_str()} {total}")
    return lines
