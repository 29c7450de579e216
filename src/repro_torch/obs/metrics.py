"""Counters, gauges, and log-bucketed latency histograms.

The single copy of every quantile computation in the repo. Two
conventions, both deliberate:

- **exact-rank (nearest-rank) quantiles** — ``exact_quantile(x, q)`` is
  ``sorted(x)[ceil(q * n) - 1]``: the q-quantile is an *observed*
  sample, never an interpolation between two samples. numpy's default
  linear interpolation reports a p99 *below* the worst observed latency
  for small n (``np.percentile([1, 3], 99) == 2.98``); nearest-rank
  reports 3.0 — the number an SLO is actually written against.
- **log-bucketed mergeable histograms** — :class:`Histogram` stores
  counts in geometrically-spaced buckets (``bucket_growth`` relative
  width per bucket, default 2%), so its state is O(occupied buckets),
  merging two histograms is count addition, and a quantile query walks
  the cumulative counts at the same exact-rank convention. The merge
  invariant the tests pin: ``merge(h1, h2)`` answers every quantile
  exactly as a single histogram fed the pooled samples would.

A histogram quantile is the *upper edge* of the rank's bucket, clamped
into ``[min, max]`` of the observed samples — so it is within one
bucket width (<= growth - 1, i.e. 2%) above the exact-rank sample
quantile, never below the observed minimum, and the top ranks are
*exact* (the clamp pins them to the true maximum). Mean is exact
(``sum / n``), not bucketed.

:class:`MetricsRegistry` is the named collection the scheduler /
executors / retrievers record into and ``obs.export`` serializes
(Prometheus text + JSON). Everything here is stdlib + numpy, a copy of
the JAX package's module: importing ``repro_torch.obs`` loads neither
torch nor the reference. ``aggregate_latencies`` (the reference keeps it in
``serve/scheduler.py``) lives here so that serving and the benchmarks share
one copy of the latency accounting.
"""
from __future__ import annotations

import math
import threading

import numpy as np


def exact_quantile(samples, q: float) -> float:
    """Nearest-rank quantile: ``sorted(x)[ceil(q * n) - 1]``.

    Non-finite entries (NaN in-flight markers, inf) are dropped; an
    empty or all-non-finite sample yields NaN. ``q`` is clamped to
    (0, 1]: every query answers an observed sample, so q=0 degrades to
    the minimum (rank 1) rather than an extrapolation.
    """
    x = np.asarray(samples, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    if x.size == 0:
        return math.nan
    rank = min(max(int(math.ceil(q * x.size)), 1), int(x.size))
    return float(np.sort(x)[rank - 1])


class Counter:
    """Monotonic counter. ``inc`` is locked: serving increments race
    across executor threads and a torn read-modify-write would drift
    the snapshot-consistency invariants."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def merge(self, other: "Counter") -> "Counter":
        self.inc(other.value)
        return self


class Gauge:
    """Last-write-wins instantaneous value (queue depth, generation)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed latency histogram with mergeable state.

    Bucket ``i`` covers ``(growth**i, growth**(i+1)]`` for positive
    values; non-positive values (zero-service cache hits clamp at 0)
    share one underflow bucket. State is ``{bucket_index: count}`` plus
    exact n / sum / min / max — merging is plain count addition, so
    per-thread or per-process histograms aggregate without losing
    quantile fidelity beyond the bucket width.
    """

    __slots__ = ("name", "growth", "_log_growth", "_buckets", "_nonpos",
                 "_n", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str = "", growth: float = 1.02):
        if growth <= 1.0:
            raise ValueError(f"bucket growth must be > 1, got {growth}")
        self.name = name
        self.growth = float(growth)
        self._log_growth = math.log(self.growth)
        self._buckets: dict[int, int] = {}
        self._nonpos = 0
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def record(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return
        with self._lock:
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if v <= 0.0:
                self._nonpos += 1
            else:
                i = math.floor(math.log(v) / self._log_growth)
                self._buckets[i] = self._buckets.get(i, 0) + 1

    def record_many(self, values) -> None:
        x = np.asarray(values, dtype=np.float64).ravel()
        x = x[np.isfinite(x)]
        if x.size == 0:
            return
        pos = x[x > 0.0]
        if pos.size:
            idx = np.floor(np.log(pos) / self._log_growth).astype(np.int64)
            uniq, counts = np.unique(idx, return_counts=True)
        else:
            uniq, counts = (), ()
        with self._lock:
            self._n += int(x.size)
            self._sum += float(x.sum())
            self._min = min(self._min, float(x.min()))
            self._max = max(self._max, float(x.max()))
            self._nonpos += int(x.size - pos.size)
            for i, c in zip(uniq, counts):
                i = int(i)
                self._buckets[i] = self._buckets.get(i, 0) + int(c)

    # -- merging -------------------------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s state in (count addition). Both histograms
        must share the bucket geometry, or the indices would alias."""
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with different bucket growth "
                f"({self.growth} vs {other.growth})")
        with other._lock:
            o_buckets = dict(other._buckets)
            o = (other._nonpos, other._n, other._sum, other._min,
                 other._max)
        with self._lock:
            for i, c in o_buckets.items():
                self._buckets[i] = self._buckets.get(i, 0) + c
            self._nonpos += o[0]
            self._n += o[1]
            self._sum += o[2]
            self._min = min(self._min, o[3])
            self._max = max(self._max, o[4])
        return self

    # -- queries -------------------------------------------------------------

    @property
    def n(self) -> int:
        with self._lock:
            return self._n

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._n if self._n else math.nan

    def quantile(self, q: float) -> float:
        """Exact-rank quantile at bucket resolution: the rank's bucket
        upper edge, clamped into [min, max] of the observed samples."""
        with self._lock:
            if self._n == 0:
                return math.nan
            rank = min(max(int(math.ceil(q * self._n)), 1), self._n)
            if rank <= self._nonpos:
                # all underflow samples are <= 0; min is the exact
                # representative when they are one repeated value (the
                # zero-service cache-hit case)
                return self._min
            seen = self._nonpos
            for i in sorted(self._buckets):
                seen += self._buckets[i]
                if rank <= seen:
                    edge = self.growth ** (i + 1)
                    return float(min(max(edge, self._min), self._max))
            return self._max  # unreachable: counts sum to n

    def summary(self, quantiles=(0.5, 0.9, 0.99)) -> dict:
        """JSON-able view. An empty histogram reports only ``n`` — no
        NaN fields, so summaries embed directly in the hardened bench
        JSON (``benchmarks.common.write_bench_json`` rejects NaN)."""
        if self.n == 0:
            return {"n": 0}
        with self._lock:
            out = {"n": self._n, "mean": self._sum / self._n,
                   "min": self._min, "max": self._max}
        for q in quantiles:
            out[f"p{int(q * 100)}"] = self.quantile(q)
        return out

    def state(self) -> dict:
        """Full serializable state (bucket counts included) — what a
        trace/metrics export ships so another process can merge it."""
        with self._lock:
            return {"growth": self.growth, "n": self._n, "sum": self._sum,
                    "min": self._min if self._n else None,
                    "max": self._max if self._n else None,
                    "nonpos": self._nonpos,
                    "buckets": {str(i): c
                                for i, c in sorted(self._buckets.items())}}

    @classmethod
    def from_state(cls, state: dict, name: str = "") -> "Histogram":
        h = cls(name, growth=state["growth"])
        h._n = int(state["n"])
        h._sum = float(state["sum"])
        h._min = math.inf if state["min"] is None else float(state["min"])
        h._max = -math.inf if state["max"] is None else float(state["max"])
        h._nonpos = int(state.get("nonpos", 0))
        h._buckets = {int(i): int(c)
                      for i, c in state.get("buckets", {}).items()}
        return h


class MetricsRegistry:
    """Named counters / gauges / histograms, created on first use.

    One registry per scheduler (or one shared across a process — names
    are the namespace). A name is permanently one metric kind; asking
    for it as another kind is a programming error and raises.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, not a "
                    f"{kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, growth: float = 1.02) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, growth=growth))

    def snapshot(self) -> dict:
        """Detached JSON-able view: {kind: {name: value-or-summary}}."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in: counters add, histograms merge,
        gauges take the other's (newer) value."""
        with other._lock:
            items = list(other._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                self.counter(name).merge(m)
            elif isinstance(m, Gauge):
                self.gauge(name).set(m.value)
            else:
                self.histogram(name, growth=m.growth).merge(m)
        return self


def aggregate_latencies(latencies_ms, wall_s: float,
                        histogram: Histogram | None = None) -> dict:
    """MRT/P50/P99/QPS over a served workload's per-request latencies.
    NaN entries (requests in flight) are dropped and zero-service cache
    completions clamp at 0, so neither poisons the aggregates. Quantiles
    are exact-rank (``exact_quantile``): the reported p99 is a latency
    some request experienced. Passing ``histogram`` also folds the samples
    into a registry histogram."""
    lat = np.asarray(latencies_ms, np.float64)
    lat = np.clip(lat[np.isfinite(lat)], 0.0, None)
    if histogram is not None:
        histogram.record_many(lat)
    if lat.size == 0:
        return {"n": 0, "mrt_ms": math.nan, "p50_ms": math.nan,
                "p99_ms": math.nan, "qps_achieved": 0.0}
    return {"n": int(lat.size), "mrt_ms": float(lat.mean()),
            "p50_ms": exact_quantile(lat, 0.50),
            "p99_ms": exact_quantile(lat, 0.99),
            "qps_achieved": lat.size / wall_s}
