"""Device health probing, the failure-detection half of resilience
(counterpart of ``swiftmpi_tpu/utils/health.py``).

Each device runs a tiny round trip under one deadline: a 16x16 float32
product, read back to the host and checked finite.  A device that errors
or misses the deadline is reported unhealthy, and the caller decides
(``io.resilience.train_with_resume``: restart from a checkpoint).
Devices are ``torch.device``s; with none given every visible CUDA card is
probed, and the CPU only when it is named.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)


class DeviceHangError(RuntimeError):
    """Training made no step progress within its watchdog deadline (see
    ``io.resilience.train_with_resume``'s ``hang_timeout_s``).
    ``recoverable`` says whether the stalled attempt acknowledged its
    cancellation (True: restart from a checkpoint in this process) or is
    wedged (False: only a process restart can recover)."""

    recoverable: bool = True


@dataclass
class DeviceHealth:
    device: str
    ok: bool
    latency_s: float
    error: Optional[str] = None


def _probe(device: torch.device) -> float:
    t0 = time.perf_counter()
    x = torch.arange(256, dtype=torch.float32, device=device).reshape(16, 16)
    z = float((x @ x).sum())                    # the read synchronizes
    if not np.isfinite(z):
        raise RuntimeError("non-finite probe result")
    return time.perf_counter() - t0


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def check_devices(devices: Optional[Sequence] = None,
                  timeout_s: float = 30.0) -> List[DeviceHealth]:
    """Run the probe on every device with one deadline for all.  Probes
    run on daemon threads, so a hung device is abandoned after
    ``timeout_s``: it blocks neither this call nor the interpreter's
    exit."""
    devices = [torch.device(d) for d in (
        _default_devices() if devices is None else devices)]
    results: List[Optional[DeviceHealth]] = [None] * len(devices)
    threads = []
    for i, d in enumerate(devices):
        def probe_one(i=i, d=d):
            try:
                results[i] = DeviceHealth(str(d), True, _probe(d))
            except Exception as e:  # noqa: BLE001 — any failure = unhealthy
                results[i] = DeviceHealth(str(d), False, 0.0, repr(e))
        t = threading.Thread(target=probe_one, daemon=True,
                             name=f"health-probe-{i}")
        t.start()
        threads.append(t)
    t_end = time.monotonic() + timeout_s   # one wall clock for all joins
    for t in threads:
        t.join(max(0.0, t_end - time.monotonic()))
    out = [r if r is not None
           else DeviceHealth(str(d), False, timeout_s, "probe timed out")
           for r, d in zip(results, devices)]
    from swiftmpi_tpu_torch import obs
    reg = obs.get_registry()
    if reg.enabled:
        for h in out:
            reg.counter("health/probe_ok" if h.ok
                        else "health/probe_fail").inc()
            if h.ok:
                reg.histogram("health/probe_ms").observe(h.latency_s * 1e3)
    bad = [(h.device, h.error) for h in out if not h.ok]
    if bad:
        log.warning("unhealthy devices: %s", bad)
    return out


def all_healthy(devices: Optional[Sequence] = None,
                timeout_s: float = 30.0) -> bool:
    return all(h.ok for h in check_devices(devices, timeout_s))
