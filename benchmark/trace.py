"""Reduce a ``torch.profiler`` trace of whole CUDA graph groups to what
the per-layer readers take: the steady sub-window, the device's busy
time (the union of its operations' intervals, so overlapping streams
count once), its operations by name, and its idle gaps named by what the
host was doing."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
GRAPH_LAUNCH = "cudaGraphLaunch"
#: host events longer than this (microseconds) are checked against every
#: gap; shorter ones only near it
_LONG_US = 1000.0


def chrome_events(prof) -> List[dict]:
    """The profile's complete events (``ph == "X"``), from its Chrome
    trace written to and read back from a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _merge(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Window:
    """The device's work from the first operation of graph launch
    ``first`` to the end of the last launch's: ``launches`` whole groups.
    Times in seconds."""

    def __init__(self, events: List[dict], first: int):
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        launches = sorted((e for e in events
                           if e.get("cat") == "cuda_runtime"
                           and GRAPH_LAUNCH in e["name"]),
                          key=lambda e: e["ts"])
        self.launches = max(len(launches) - first, 0)
        self.valid = self.launches > 0 and bool(dev)
        if not self.valid:
            return
        by_corr = defaultdict(list)
        for e in dev:
            by_corr[e.get("args", {}).get("correlation")].append(e)

        def span(launch):
            own = by_corr.get(launch.get("args", {}).get("correlation"), [])
            if not own:
                return None
            return (min(e["ts"] for e in own),
                    max(e["ts"] + e["dur"] for e in own))
        first_span, last_span = span(launches[first]), span(launches[-1])
        if first_span is None or last_span is None:
            self.valid = False
            return
        t0, t1 = first_span[0], last_span[1]
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) * 1e-6
        self.device_ops = [e for e in dev if t0 <= e["ts"] < t1]
        self.busy = _merge([(e["ts"], min(e["ts"] + e["dur"], t1))
                            for e in self.device_ops])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e["ts"] < t1 and e["ts"] + e["dur"] > t0]

    def op_seconds(self, substring: str) -> float:
        """Summed device seconds of the operations whose name holds
        ``substring``."""
        return sum(e["dur"] for e in self.device_ops
                   if substring in e["name"]) * 1e-6

    def count_ops(self) -> int:
        return len(self.device_ops)

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.device_ops:
            by[e["name"]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window, summed by the host
        activity that overlapped each gap most (``"(no host event)"``
        where none did): the ``n`` largest."""
        gaps, prev = [], self.t0
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        long = [e for e in host if e["dur"] > _LONG_US]
        by = defaultdict(float)
        for a, b in gaps:
            best, best_len = "(no host event)", 0.0
            lo = bisect.bisect_left(starts, a - _LONG_US)
            hi = bisect.bisect_left(starts, b)
            for e in host[lo:hi] + long:
                ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
                if ov > best_len:
                    best, best_len = e["name"], ov
            by[best] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def reduce(events: List[dict], first: int) -> Optional[Window]:
    """The steady window from launch ``first`` on, or None when the trace
    holds no graph launch with device operations (a CPU run)."""
    w = Window(events, first)
    return w if w.valid else None
