"""Profiling hooks (counterpart of ``swiftmpi_tpu/utils/profiler.py``).

Thin wrappers over ``torch.profiler``: ``trace(logdir)`` captures the
host and, on a CUDA device, the card's activity around a code block and
exports a chrome trace; ``annotate(name)`` labels a host span so steps
show up named in the trace (``torch.profiler.record_function``);
``StepTimer`` measures steady-state step latency with a device
synchronization, the number the profile apps report.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, List, Optional

import torch


def activities() -> list:
    """The profiler activities of this process: the CPU, and CUDA when a
    card is visible (asking for CUDA activity without one is refused by
    some builds)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def trace_filename(logdir: str) -> str:
    """``<logdir>/<host>.trace.json.gz``: the name the chrome-trace parser
    (``obs.profiler.parse_trace_dir``) globs for."""
    return os.path.join(logdir, f"{socket.gethostname()}.trace.json.gz")


def export_trace(prof, logdir: str) -> str:
    """Write ``prof``'s chrome trace gzip-compressed under ``logdir``;
    returns the path."""
    import gzip
    import shutil
    os.makedirs(logdir, exist_ok=True)
    path = trace_filename(logdir)
    raw = f"{path[:-3]}.tmp.{os.getpid()}"
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a host (and card) profile into ``logdir`` as a chrome
    trace (``chrome://tracing``, Perfetto)."""
    prof = torch.profiler.profile(activities=activities())
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        export_trace(prof, logdir)


def annotate(name: str):
    """Named span context for host-side phases
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock per-step stats with an explicit device barrier.

    Keeps every sample, so percentiles are exact order statistics, not
    bucket interpolations."""

    def __init__(self):
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_on) -> float:
        """End one sample; first wait for the devices of the tensors in
        ``sync_on`` (CUDA ones: ``torch.cuda.synchronize``; a CPU tensor
        is ready when its op returns)."""
        for dev in {t.device for t in sync_on
                    if isinstance(t, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        return dt

    def __len__(self) -> int:
        return len(self._times)

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def percentile(self, q: float) -> float:
        """Exact order-statistic percentile (``q`` in [0, 1]), linear
        interpolation between adjacent samples (numpy's default rule)."""
        if not self._times:
            return 0.0
        xs = sorted(self._times)
        if len(xs) == 1:
            return xs[0]
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p95(self) -> float:
        return self.percentile(0.95)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    def summary_ms(self) -> dict:
        """Mean/p50/p95/p99 in milliseconds."""
        return {"mean": self.mean * 1e3, "p50": self.p50 * 1e3,
                "p95": self.p95 * 1e3, "p99": self.p99 * 1e3}

    def publish(self, name: str = "step_ms", **labels) -> None:
        """Feed every recorded sample into the telemetry registry's
        ``<name>{labels}`` histogram (no-op when telemetry is off)."""
        from swiftmpi_tpu_torch import obs
        reg = obs.get_registry()
        if not reg.enabled:
            return
        h = reg.histogram(name, **labels)
        for dt in self._times:
            h.observe(dt * 1e3)
