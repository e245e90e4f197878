"""One metrics registry for the whole framework.

PRs 3-5 grew four separate ad-hoc instrument sets — the transfer wire
ledger, the ``Throughput`` stall/device split, ``PrefetchIterator.stats()``
and the fault event bus — with no shared names, reset semantics, or sink.
:class:`MetricsRegistry` is the one place they all report now:

* **Counter** — monotonically non-decreasing total.  Never reset; readers
  take deltas (the Prometheus convention, and the convention
  ``Transfer.traffic()`` documents).  ``set_total`` adapts an external
  cumulative total (a wire ledger) into the same monotonic contract.
* **Gauge** — last-write-wins scalar (queue depth, words/s).
* **Histogram** — fixed upper-bound buckets with count/sum, built for
  latency distributions; quantiles are interpolated from the buckets so
  a histogram never stores per-observation data.

Identity is ``name`` plus sorted ``labels`` (``phase_ms{phase=dispatch}``),
so per-backend / per-phase series coexist under one name.  All writes are
thread-safe — the input pipeline's producer thread and the consumer loop
both write concurrently (tests/test_telemetry.py exercises exactly that).

Cost model: the registry is created **disabled** and every instrument
write starts with one attribute check — telemetry off costs a branch, not
a lock (the measured-overhead test asserts this stays near zero).  When
enabled, writes take one small lock; instrument handles are cached by the
call sites so the hot path never rebuilds label keys.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

#: default histogram upper bounds, in ms: 50µs .. ~26s, x2 per bucket —
#: wide enough for a CPU-emulated dispatch and a chip-side phase alike
DEFAULT_BUCKETS_MS = tuple(0.05 * (2.0 ** i) for i in range(20))


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Canonical series id: ``name{k=v,...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`series_key` (used by the run analyzer)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for pair in rest.rstrip("}").split(","):
        if "=" in pair:
            k, _, v = pair.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    """Monotonic total.  ``inc`` adds; ``set_total`` merges an external
    cumulative total without ever going backwards."""

    __slots__ = ("_reg", "key", "value")

    def __init__(self, reg: "MetricsRegistry", key: str):
        self._reg = reg
        self.key = key
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self.value += n

    def set_total(self, total: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            if total > self.value:
                self.value = total


class Gauge:
    __slots__ = ("_reg", "key", "value")

    def __init__(self, reg: "MetricsRegistry", key: str):
        self._reg = reg
        self.key = key
        self.value = 0.0

    def set(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``bounds[i]`` is the inclusive upper edge
    of bucket i; the last bucket is the +inf overflow."""

    __slots__ = ("_reg", "key", "bounds", "counts", "count", "sum")

    def __init__(self, reg: "MetricsRegistry", key: str,
                 bounds: Tuple[float, ...]):
        self._reg = reg
        self.key = key
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        i = bisect_left(self.bounds, v)
        with reg._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v


def quantile_from_buckets(bounds, counts, q: float) -> float:
    """Linear-interpolated quantile from cumulative bucket counts; the
    overflow bucket clamps to the top finite edge (same convention as
    Prometheus ``histogram_quantile``)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c >= rank:
            if i >= len(bounds):          # overflow bucket
                return float(bounds[-1]) if bounds else 0.0
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (rank - seen) / c
            return lo + (hi - lo) * frac
        seen += c
    return float(bounds[-1]) if bounds else 0.0


class MetricsRegistry:
    """Thread-safe labeled instrument registry (see module docstring)."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- instrument handles (cached; cheap to hold, cheap when disabled) ---
    def counter(self, name: str, **labels) -> Counter:
        key = series_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(self, key))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = series_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(self, key))
        return g

    def histogram(self, name: str, buckets: Optional[Tuple[float, ...]]
                  = None, **labels) -> Histogram:
        key = series_key(name, labels)
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(
                    key, Histogram(self, key,
                                   tuple(buckets or DEFAULT_BUCKETS_MS)))
        return h

    # -- read side ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """Point-in-time copy of every series: ``{"counters": {key: v},
        "gauges": {key: v}, "hists": {key: {"count", "sum", "counts",
        "bounds"}}}``.  Taken under the write lock, so a snapshot is
        internally consistent even against concurrent producers."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "hists": {k: {"count": h.count, "sum": h.sum,
                              "counts": list(h.counts),
                              "bounds": h.bounds}
                          for k, h in self._hists.items()},
            }

    @staticmethod
    def delta(prev: Dict[str, Dict], cur: Dict[str, Dict]) -> Dict[str, Dict]:
        """Per-step view between two snapshots: counter deltas (only the
        series that moved), gauge current values, histogram bucket-count
        deltas.  The StepRecorder calls this once per recorded step."""
        counters = {}
        for k, v in cur["counters"].items():
            d = v - prev["counters"].get(k, 0.0)
            if d:
                counters[k] = d
        hists = {}
        for k, h in cur["hists"].items():
            p = prev["hists"].get(k)
            pc = p["counts"] if p else [0] * len(h["counts"])
            dc = [a - b for a, b in zip(h["counts"], pc)]
            n = h["count"] - (p["count"] if p else 0)
            if n:
                hists[k] = {"n": n,
                            "sum": h["sum"] - (p["sum"] if p else 0.0),
                            "counts": dc,
                            "bounds": h["bounds"]}
        return {"counters": counters, "gauges": dict(cur["gauges"]),
                "hists": hists}

    def quantile(self, name_or_key: str, q: float, **labels) -> float:
        key = series_key(name_or_key, labels) if labels else name_or_key
        h = self._hists.get(key)
        if h is None:
            return 0.0
        with self._lock:
            counts, bounds = list(h.counts), h.bounds
        return quantile_from_buckets(bounds, counts, q)

    def series_keys(self) -> List[str]:
        with self._lock:
            return (list(self._counters) + list(self._gauges)
                    + list(self._hists))
