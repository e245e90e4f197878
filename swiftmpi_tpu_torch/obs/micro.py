"""Telemetry emission for the kernel microbench scripts.

``scripts/gather_micro.py`` / ``scripts/scatter_micro.py`` print their
cells as free text — fine for a human in a tunnel window, invisible to
the diff tooling.  :class:`MicroTelemetry` gives those scripts the same
schema-versioned JSONL (``smtpu-telemetry/1``) every other producer
emits, so ``scripts/telemetry_report.py`` renders a microbench run's
phase table and ``scripts/check_traffic_budget.py`` can gate one run
against another exactly like bench cells:

    mt = MicroTelemetry(path, run="gather_micro")
    mt.cell("gather/cap17314_d100_fp32", ms)
    ...
    mt.close()

Each cell lands as one step record whose wall-ms is a
``phase_ms{phase=micro/<name>}`` histogram sample — the same series
shape ``obs.span`` gives the training phases, so ``phase_table`` picks
the cells up with zero new parsing.  The budget script additionally
folds every ``micro/...`` phase into its own pseudo-cell carrying a
``kernel_ms`` metric (see ``load_telemetry_cells``).
"""

from __future__ import annotations

from typing import Optional

from swiftmpi_tpu_torch.obs.recorder import StepRecorder
from swiftmpi_tpu_torch.obs.registry import MetricsRegistry


class MicroTelemetry:
    """Own-registry StepRecorder wrapper for microbench scripts (never
    touches the process-global registry — a microbench must not bleed
    series into a training run's telemetry)."""

    def __init__(self, path: str, run: str = "micro",
                 meta: Optional[dict] = None):
        self.registry = MetricsRegistry(enabled=True)
        self.recorder = StepRecorder(
            self.registry, path=path, run=run,
            meta={"micro": True, **(meta or {})})

    def cell(self, name: str, ms: float, **gauges) -> None:
        """Record one measured cell: ``ms`` wall-clock milliseconds as
        a ``phase_ms{phase=micro/<name>}`` sample, plus optional scalar
        context (shape sizes, GB/s) as ``micro_<k>{cell=<name>}``
        gauges."""
        self.registry.histogram("phase_ms",
                                phase=f"micro/{name}").observe(float(ms))
        for k, v in gauges.items():
            self.registry.gauge(f"micro_{k}", cell=name).set(float(v))
        self.recorder.on_steps(1)

    def close(self) -> None:
        self.recorder.close()
