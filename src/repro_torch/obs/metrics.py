"""Metrics registry: counters, gauges, fixed-bucket histograms (DESIGN.md 1j).

The unified runtime-telemetry substrate for the repo: the six registry
executors, both stream planners, the plan/jit/block caches, and
``serve.PairwiseService`` all publish here instead of (or in addition to)
their legacy hand-rolled stats dicts — one queryable place for dashboards,
``launch/obs_report.py``, and the async-serving roadmap item's p50/p99/QPS
inputs.

Design constraints (the overhead budget in DESIGN.md 1j):

* **Cheap enough for per-request use.**  A counter increment is one dict
  lookup plus an integer add; a histogram observation is a ``bisect`` over
  a fixed boundary list.  Nothing allocates on the hot path once a series
  exists, and the global kill switch (``repro_torch.obs.configure(enabled=False)``)
  turns every publish into a single attribute test.
* **Labeled series.**  A metric name plus a label mapping (executor /
  workload / tenant / cache / planner ...) identifies one series; all
  callers that share ``(name, labels)`` share the series, which is exactly
  how ``engine.fused_stats()`` aggregates every ``FusedExecutor`` instance
  into one view.
* **Snapshot / delta / reset.**  ``snapshot()`` is a plain nested dict
  (JSON-ready), ``delta(prev)`` subtracts two snapshots (counter and
  histogram counts; gauges report current), ``reset()`` zeroes in place so
  held series objects stay live.

Quantiles are estimated from fixed log-spaced buckets: p50/p90/p99 are
linearly interpolated inside the bucket containing the target rank, so the
estimate is within one bucket factor (default 1.25x) of the exact
order statistic — tests/test_obs.py pins this against numpy percentiles.

Zero dependencies beyond the stdlib (the obs layer must import in any
process, including the background re-plan daemon thread).
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_right
from typing import Optional

from . import _config

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "exponential_buckets",
]


def exponential_buckets(start: float, factor: float, count: int) -> tuple:
    """``count`` log-spaced bucket upper bounds from ``start``: the fixed
    boundary grid histograms bin into (values above the last bound land in
    the overflow bucket)."""
    assert start > 0 and factor > 1.0 and count >= 1
    return tuple(start * factor ** i for i in range(count))


# ~1 us .. ~80 s at 1.25x resolution: covers every latency this repo
# measures (per-edit p99s of ~100 ms, cold builds of a few seconds) and
# byte-ish magnitudes when a caller wants a distribution of sizes.
DEFAULT_BUCKETS = exponential_buckets(1e-6, 1.25, 82)


class Counter:
    """Monotonic counter (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, by: float = 1) -> None:
        if not _config.ENABLED:
            return
        self.value += by

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-value gauge (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        if not _config.ENABLED:
            return
        self.value = float(value)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram with p50/p90/p99 estimation.

    ``bounds`` are ascending bucket upper edges; observations above the
    last edge land in a final overflow bucket.  ``quantile(q)`` walks the
    cumulative counts to the bucket holding rank ``q * count`` and
    interpolates linearly inside it (the overflow bucket reports the max
    seen — exact, since we track it).
    """

    __slots__ = ("bounds", "counts", "count", "total", "min", "max")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        if not _config.ENABLED:
            return
        v = float(value)
        self.counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 < q <= 1); 0.0 when empty."""
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                if i >= len(self.bounds):        # overflow bucket
                    return self.max
                lo = self.bounds[i - 1] if i else 0.0
                lo = max(lo, self.min if self.min != math.inf else lo)
                hi = min(self.bounds[i], self.max)
                if hi <= lo:
                    return hi
                frac = (rank - prev) / c
                return lo + frac * (hi - lo)
        return self.max

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def summary(self) -> dict:
        out = {"count": self.count, "total": self.total, "mean": self.mean,
               "min": self.min if self.count else 0.0,
               "max": self.max if self.count else 0.0}
        out.update(self.percentiles())
        return out


def _series_key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _render_key(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Labeled metric series, keyed by ``(name, sorted(labels))``.

    ``counter`` / ``gauge`` / ``histogram`` create-or-return the series, so
    callers hold no registration state; creation takes a lock, subsequent
    publishes are lock-free (CPython dict reads + the GIL — the background
    re-plan thread and the serving thread may race an increment, which at
    worst drops a count, never corrupts).
    """

    def __init__(self):
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}
        self._lock = threading.Lock()

    def _get(self, store: dict, key: tuple, factory):
        s = store.get(key)
        if s is None:
            with self._lock:
                s = store.setdefault(key, factory())
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, _series_key(name, labels), Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, _series_key(name, labels), Gauge)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        return self._get(self._histograms, _series_key(name, labels),
                         lambda: Histogram(buckets or DEFAULT_BUCKETS))

    # ------------------------------------------------------------- queries
    def counter_total(self, name: str, **labels) -> float:
        """Sum of every counter series matching ``name`` and the given
        label *subset* — the aggregate view (e.g. all fused dispatches
        regardless of workload/tenant)."""
        want = set(labels.items())
        total = 0
        for (n, lbl), c in list(self._counters.items()):
            if n == name and want.issubset(lbl):
                total += c.value
        return total

    def reset_counters(self, name: str, **labels) -> None:
        """Zero every counter series matching ``name`` and the given label
        subset (the write-side companion of :meth:`counter_total`)."""
        want = set(labels.items())
        for (n, lbl), c in list(self._counters.items()):
            if n == name and want.issubset(lbl):
                c.reset()

    def snapshot(self) -> dict:
        """JSON-ready nested snapshot of every series."""
        return {
            "counters": {_render_key(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {_render_key(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {_render_key(k): h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Counter/histogram-count differences between two snapshots
        (gauges report the ``after`` value — they are not cumulative)."""
        d_ctr = {}
        for k, v in after["counters"].items():
            dv = v - before["counters"].get(k, 0)
            if dv:
                d_ctr[k] = dv
        d_hist = {}
        for k, v in after["histograms"].items():
            prev = before["histograms"].get(k, {"count": 0, "total": 0.0})
            dc = v["count"] - prev["count"]
            if dc:
                d_hist[k] = {"count": dc, "total": v["total"] - prev["total"]}
        return {"counters": d_ctr, "gauges": dict(after["gauges"]),
                "histograms": d_hist}

    def reset(self) -> None:
        """Zero every series in place (held series objects stay live)."""
        with self._lock:
            for c in self._counters.values():
                c.reset()
            for g in self._gauges.values():
                g.reset()
            for h in self._histograms.values():
                h.reset()


#: process-global registry — what the instrumented subsystems publish into.
REGISTRY = MetricsRegistry()
