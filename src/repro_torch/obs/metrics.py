"""Metrics: counters, gauges, fixed-bucket histograms, and the registry (a
host-only copy of ``repro/obs/metrics.py``).

Everything is plain host Python over floats — publishing a sample is a
dict lookup plus arithmetic, cheap enough for per-chunk (train) and
per-step (serve) cadences, and nothing here reaches the device.
`MetricsRegistry.snapshot()` returns a JSON-ready dict; ``to_json`` writes
it to a file with the run's provenance (`provenance.RunProvenance`).

Percentiles come in two forms, one implementation each:

* ``percentile``/``percentiles`` — exact, over a materialized sequence
  (numpy float64, linear interpolation); the serving load generator reports
  p50/p90/p99 through them (`serve.loadgen.summarize`).
* `Histogram.percentile` — streaming estimate from fixed log-spaced
  buckets (linear interpolation inside the bucket, exact min/max
  clamping).
"""
from __future__ import annotations

import json
import math
from typing import Optional, Sequence

import numpy as np


# ------------------------------------------------------------- percentiles ---
def percentile(xs: Sequence[float], q: float, empty: Optional[float] = -1.0
               ) -> float:
    """Exact q-th percentile (linear interpolation); ``empty`` on empty
    input.  The serving reports pass ``empty=None`` so an empty series
    serializes as JSON null instead of a fake -1.0 latency."""
    if not len(xs):
        return empty
    return float(np.percentile(np.asarray(xs, np.float64), q))


def percentiles(xs: Sequence[float], qs: Sequence[float] = (50, 90, 99),
                empty: Optional[float] = -1.0) -> dict:
    return {f"p{q:g}": percentile(xs, q, empty=empty) for q in qs}


# ------------------------------------------------------------- instruments ---
class Counter:
    """Monotonically increasing count (events, bytes, drops)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value (queue depth, resident bytes, version)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def snapshot(self):
        return self.value


def default_buckets(lo: float = 1e-6, hi: float = 1e6,
                    per_decade: int = 4) -> tuple:
    """Log-spaced bucket upper bounds covering [lo, hi] — wide enough for
    seconds-scale latencies and byte counts alike at ~19% resolution."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * (hi / lo) ** (i / n) for i in range(n + 1))


class Histogram:
    """Fixed-bucket histogram with streaming percentile estimates.

    ``bounds`` are ascending bucket *upper* edges; a sample lands in the
    first bucket whose bound is >= the sample, or the overflow bucket.
    Estimates interpolate linearly inside the winning bucket and clamp to
    the exact observed min/max, so for any data: ``count`` is exact,
    ``percentile`` is monotone in q, and every estimate lies in
    [min, max] (hypothesis-pinned)."""
    __slots__ = ("bounds", "counts", "overflow", "count", "total",
                 "vmin", "vmax")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds = tuple(sorted(bounds)) if bounds else default_buckets()
        if len(self.bounds) < 1:
            raise ValueError("need at least one bucket bound")
        self.counts = [0] * len(self.bounds)
        self.overflow = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        # bisect over a ~50-entry tuple: O(log n), no numpy round trip
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.bounds[mid] < x:
                lo = mid + 1
            else:
                hi = mid
        if lo == len(self.bounds):
            self.overflow += 1
        else:
            self.counts[lo] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]); -1.0 when empty."""
        if self.count == 0:
            return -1.0
        rank = q / 100.0 * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.vmin, 0.0)
                hi = self.bounds[i]
                frac = (rank - seen) / c
                est = lo + (hi - lo) * frac
                return float(min(max(est, self.vmin), self.vmax))
            seen += c
        return float(self.vmax)       # rank fell in the overflow bucket

    def snapshot(self) -> dict:
        out = {"count": self.count, "mean": self.mean,
               "min": self.vmin if self.count else None,
               "max": self.vmax if self.count else None,
               **{f"p{q}": self.percentile(q) for q in (50, 90, 99)}}
        # only the occupied buckets: snapshots stay readable for sparse data
        out["buckets"] = {f"le_{self.bounds[i]:g}": c
                         for i, c in enumerate(self.counts) if c}
        if self.overflow:
            out["buckets"][f"gt_{self.bounds[-1]:g}"] = self.overflow
        return out


# ---------------------------------------------------------------- registry ---
class MetricsRegistry:
    """Name -> instrument, get-or-create.  One registry per run; install
    it globally with ``obs.install_registry`` so library code can publish
    without threading a handle through every constructor."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, bounds)

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> dict:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def to_json(self, path: str, provenance: Optional[dict] = None) -> dict:
        """Write ``{"provenance": ..., "metrics": snapshot()}`` to ``path``
        and return it."""
        if provenance is None:
            from .provenance import RunProvenance
            provenance = RunProvenance.collect().asdict()
        doc = {"provenance": provenance, "metrics": self.snapshot()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, default=float)
        return doc
