"""Timing + metrics accumulation (counterpart of
``swiftmpi_tpu/utils/timers.py``; the meter's stall region is also the
telemetry plane's ``input_wait`` span).

``Timer`` mirrors the reference chrono stopwatch
(`/root/reference/src/utils/Timer.h:14-44`) including ``timeout()``; the rest
is the metrics system the reference lacks (SURVEY.md §5 "Metrics: No"):
``Error`` reproduces the loss accumulator used for per-iteration training
error (reference word2vec.h:442-457), and ``Meter``/``Throughput`` provide
the words/sec style counters the benchmarks report.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from swiftmpi_tpu_torch import obs


class Timer:
    def __init__(self, time_limit_s: float = 0.0):
        self._start = time.monotonic()
        self._limit = time_limit_s

    def restart(self) -> None:
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def timeout(self) -> bool:
        return self._limit > 0 and self.elapsed() > self._limit


class Error:
    """Running-mean loss accumulator (reference word2vec.h:442-457)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def accu(self, value: float, n: int = 1) -> None:
        with self._lock:
            self._sum += float(value)
            self._count += n

    def norm(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def reset(self) -> None:
        with self._lock:
            self._sum = 0.0
            self._count = 0


class Throughput:
    """Cumulative items/sec meter since construction or last reset().

    A single wall-clock rate hides WHICH side of the step loop is the
    bottleneck, so the meter also splits elapsed time into **host
    stall** (time the consumer spent waiting on input — rendering, H2D
    transfer, an empty prefetch queue; reported via ``add_stall`` /
    the ``stalling()`` context manager) and the **unstalled** rest
    (dispatch, the loop's own work, and any wait for the device: a host
    clock, not the device's time).  ``stats()`` packages the split for
    train metrics and bench detail fields.
    """

    def __init__(self):
        self._items = 0
        self._steps = 0
        self._stall_s = 0.0
        self._timer = Timer()

    def record(self, n: int, steps: int = 1) -> None:
        self._items += n
        self._steps += steps

    def add_stall(self, seconds: float) -> None:
        """Account ``seconds`` of host-side input stall."""
        self._stall_s += seconds

    def stalling(self):
        """Context manager timing a host-stall region::

            with meter.stalling():
                batch = next(batches)

        The region is also the ``input_wait`` span (``obs.span``), so a
        profiler's trace and the stall clock hold one interval."""
        return _StallScope(self)

    def rate(self) -> float:
        dt = self._timer.elapsed()
        return self._items / dt if dt > 0 else 0.0

    def host_stall_ms(self) -> float:
        return self._stall_s * 1e3

    def unstalled_ms(self) -> float:
        """Elapsed wall-clock minus host stall, in ms (clamped at 0)."""
        return max(0.0, self._timer.elapsed() - self._stall_s) * 1e3

    def stall_ms_per_step(self) -> float:
        return self.host_stall_ms() / self._steps if self._steps else 0.0

    def stats(self) -> Dict[str, float]:
        return {"items": float(self._items),
                "steps": float(self._steps),
                "rate": self.rate(),
                "host_stall_ms": self.host_stall_ms(),
                "unstalled_ms": self.unstalled_ms(),
                "stall_ms_per_step": self.stall_ms_per_step()}

    def reset(self) -> None:
        self._items = 0
        self._steps = 0
        self._stall_s = 0.0
        self._timer.restart()


class _StallScope:
    def __init__(self, meter: Throughput):
        self._meter = meter
        self._span = obs.span("input_wait")

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._meter.add_stall(time.monotonic() - self._t0)
        self._span.__exit__(*exc)


class Metrics:
    """Named scalar registry; the framework-wide metrics sink."""

    def __init__(self):
        self._values: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = float(value)

    def incr(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0.0) + delta

    def get(self, name: str, default: float = 0.0) -> float:
        return self._values.get(name, default)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def to_json(self) -> str:
        import json
        return json.dumps(self.snapshot(), sort_keys=True)

    def dump(self, path: str) -> None:
        """Structured metrics export (one JSON object), for scraping by
        external monitors — the observability surface the reference's
        log-line-only story lacks.  Written atomically (temp + rename) so
        a concurrent scrape never sees a partial document."""
        import os
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_json() + "\n")
        os.replace(tmp, path)
