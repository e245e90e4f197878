"""Unified telemetry plane (counterpart of ``swiftmpi_tpu/obs/``).

One :class:`~swiftmpi_tpu_torch.obs.registry.MetricsRegistry` for the
whole process — the transfer wire ledgers, the ``Throughput`` meter,
pipeline stats, fault events, checkpoint durations, and health probes
all report here.  A :class:`~swiftmpi_tpu_torch.obs.recorder.StepRecorder`
turns the registry into a per-step JSONL time-series (the JAX package's
``smtpu-telemetry/1`` lines); :func:`span` wraps host-side hot-path
phases in a ``torch.profiler.record_function`` range AND a ``phase_ms``
histogram under the same name, so the chrome trace and the JSONL agree;
:func:`named_scope` carries the same phase names into a profiled region
(``record_function``; inside a CUDA graph replay no range is replayed).

A host span times what the JAX package's does: the host side of an
asynchronous dispatch.  A CUDA step returns before the card finishes,
so ``phase_ms{phase=dispatch}`` is the enqueue; the card's time shows
only in a profiler's trace, where the span's range and the card's
kernels share one clock.  ``torch.profiler`` records the ranges of the
thread that started it: a span opened on another thread (the input
pipeline's producer) reaches the trace only under a profiler started
with ``profile_all_threads``.

The registry is gated by ``[worker] telemetry:`` (see :func:`configure`).
It is process-global and created **disabled**: with telemetry off, every
instrument write is a single branch, and ``span()`` is one flag read
unless a ``torch.profiler`` is recording, when it opens the range alone.

Module-level state exists because instruments are written from layers
with no config object in scope (transfer backends, the fault bus, the
health probes).  Tests get a clean slate via :func:`reset_for_tests`,
which also removes the recorder module's crash hooks; long-lived writers
fetch the registry through :func:`get_registry` each time.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from swiftmpi_tpu_torch.obs.identity import (ENV_FLEET_DIR, process_ident,
                                            process_rank)
from swiftmpi_tpu_torch.obs.recorder import SCHEMA, SCHEMA_V, StepRecorder
from swiftmpi_tpu_torch.obs.registry import (DEFAULT_BUCKETS_MS,
                                             MetricsRegistry,
                                             parse_series_key,
                                             quantile_from_buckets,
                                             series_key)
from swiftmpi_tpu_torch.obs.collector import (FLEET_SCHEMA, FleetCollector,
                                              SupervisorLog, stream_filename)
from swiftmpi_tpu_torch.obs import costs
from swiftmpi_tpu_torch.obs import profiler as profiler_mod
from swiftmpi_tpu_torch.obs.costs import CostCatalog, TrackedFn, get_catalog
# aliased import: a bare ``from ...utils import profiler`` would shadow
# the ``obs.profiler`` SUBMODULE attribute on this package
from swiftmpi_tpu_torch.utils import profiler as _host_profiler

__all__ = [
    "DEFAULT_BUCKETS_MS", "MetricsRegistry", "StepRecorder", "SCHEMA",
    "SCHEMA_V", "FLEET_SCHEMA", "FleetCollector", "SupervisorLog",
    "stream_filename", "series_key", "parse_series_key",
    "quantile_from_buckets", "process_ident", "process_rank",
    "get_registry", "set_enabled", "reset_for_tests", "span",
    "named_scope", "configure", "install_recorder", "uninstall_recorder",
    "get_recorder", "record_step", "CostCatalog", "TrackedFn",
    "get_catalog", "get_profiler", "install_profiler",
    "uninstall_profiler", "get_tracer", "install_tracer",
    "uninstall_tracer",
]

#: named range for a profiled region — same phase names as :func:`span`,
#: recorded in the trace without a host timing (JAX: ``jax.named_scope``)
named_scope = _host_profiler.annotate

_REGISTRY = MetricsRegistry(enabled=False)
_RECORDER: Optional[StepRecorder] = None
_PROFILER = None    # Optional[obs.profiler.ProfileSession]
_TRACER = None      # Optional[obs.trace.WindowTracer]


def get_registry() -> MetricsRegistry:
    """The process-global registry (disabled unless telemetry is on)."""
    return _REGISTRY


def set_enabled(on: bool) -> MetricsRegistry:
    _REGISTRY.enabled = bool(on)
    return _REGISTRY


def reset_for_tests() -> MetricsRegistry:
    """Swap in a fresh disabled registry, drop any installed recorder,
    profiler session and tracer, disarm the compile catalog and the
    numerics tap, and remove the crash hooks a recorder or tracer
    installed (atexit and signal handlers), so no test leaves them
    behind in its worker process.

    Cached instrument handles bound to the old registry keep working but
    write into the discarded object — hence writers re-check
    ``get_registry()`` identity."""
    global _REGISTRY, _RECORDER, _PROFILER, _TRACER
    from swiftmpi_tpu_torch.obs import recorder as recorder_mod
    from swiftmpi_tpu_torch.transfer import api as transfer_api
    _REGISTRY = MetricsRegistry(enabled=False)
    _RECORDER = None
    sess, _PROFILER = _PROFILER, None
    if sess is not None:
        sess.abort()
    uninstall_tracer()
    costs.reset_for_tests()
    transfer_api.clear_numerics_tap()
    recorder_mod.remove_crash_hooks()
    return _REGISTRY


# -- named spans ------------------------------------------------------------

class _NullSpan:
    """Returned when nothing records: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records now: the flag its start and
    stop set (one attribute read, where entering a ``record_function``
    range costs microseconds even with no profiler running), else the
    autograd profiler's own state."""
    flag = getattr(torch.autograd.profiler, "_is_profiler_enabled", None)
    if flag is None:
        return torch._C._autograd._profiler_enabled()
    return flag


class _Span:
    """Host span = ``record_function`` range + ``phase_ms{phase=<name>}``
    sample."""

    __slots__ = ("_hist", "_ann", "_t0")

    def __init__(self, hist, name: str):
        self._hist = hist
        self._ann = _host_profiler.annotate(name)

    def __enter__(self):
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        self._ann.__exit__(*exc)
        self._hist.observe(dt_ms)
        return False


def span(name: str):
    """Named host-phase span: ``with obs.span("render"): ...``.

    Telemetry on -> a ``torch.profiler.record_function`` range plus a
    sample in the ``phase_ms{phase=<name>}`` histogram, so the trace
    viewer and ``telemetry_report.py`` see the same phase under the same
    name.  Telemetry off while a ``torch.profiler`` records -> the range
    alone, on the profiler's clock beside the card's kernels.  Neither ->
    a shared no-op context (one flag read, no allocation).  Not inside a
    CUDA graph capture: use :func:`named_scope` there.
    """
    reg = _REGISTRY
    if reg.enabled:
        return _Span(reg.histogram("phase_ms", phase=name), name)
    if _profiling():
        return _host_profiler.annotate(name)
    return _NULL_SPAN


# -- recorder install point -------------------------------------------------

def install_recorder(rec: StepRecorder) -> StepRecorder:
    """Make ``rec`` the recorder :func:`record_step` feeds.  Layers with
    no config in scope (Trainer.step) report steps through the global."""
    global _RECORDER
    _RECORDER = rec
    return rec


def uninstall_recorder() -> Optional[StepRecorder]:
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    return rec


def get_recorder() -> Optional[StepRecorder]:
    return _RECORDER


def record_step(n: int = 1) -> None:
    """Account ``n`` consumed train steps on the installed recorder (a
    graphed group counts its whole length), the installed profiler
    session and the installed tracer.  No-op when none exists."""
    rec = _RECORDER
    if rec is not None:
        rec.on_steps(n)
    prof = _PROFILER
    if prof is not None:
        prof.on_step(n)
    tr = _TRACER
    if tr is not None:
        tr.on_step(n)


# -- profiler-session install point (obs/profiler.py) -----------------------

def install_profiler(sess):
    """Make ``sess`` the ProfileSession :func:`record_step` feeds."""
    global _PROFILER
    _PROFILER = sess
    return sess


def uninstall_profiler():
    global _PROFILER
    sess, _PROFILER = _PROFILER, None
    return sess


def get_profiler():
    return _PROFILER


# -- wire-tracer install point (obs/trace.py) -------------------------------

def install_tracer(tr, crash_flush: bool = True):
    """Make ``tr`` the WindowTracer the transfer ledgers and
    :func:`record_step` feed.  ``crash_flush`` enrolls it in the
    recorder module's atexit + fatal-signal hooks so a killed rank
    still leaves a flight-recorder dump behind."""
    global _TRACER
    _TRACER = tr
    if crash_flush:
        from swiftmpi_tpu_torch.obs import recorder as recorder_mod
        recorder_mod._CRASH_RECORDERS.add(tr)
        recorder_mod._install_crash_hooks()
    return tr


def uninstall_tracer():
    """Clean teardown: detach the tracer WITHOUT dumping (a crash dump
    from a normal exit would be noise) and drop its crash enrollment."""
    global _TRACER
    tr, _TRACER = _TRACER, None
    if tr is not None:
        from swiftmpi_tpu_torch.obs import recorder as recorder_mod
        recorder_mod._CRASH_RECORDERS.discard(tr)
    return tr


def get_tracer():
    return _TRACER


# -- config gate ------------------------------------------------------------

def configure(config, run: str = "run",
              meta: Optional[dict] = None) -> Optional[StepRecorder]:
    """Arm the telemetry plane from ``[worker]`` / ``[obs]`` config.

    Knobs under ``[worker]`` (the JAX package's, one for one):

    * ``telemetry: 1``        — master switch (default 0 = everything off)
    * ``telemetry_path:``     — JSONL sink (default ``telemetry.jsonl``;
      empty string = ring buffer only, no file)
    * ``telemetry_every: K``  — record every K consumed steps (default 1)
    * ``telemetry_ring: N``   — ring-buffer retention (default 1024)
    * ``telemetry_flush: N``  — JSONL write-buffer size (default 64)

    Fleet knobs under ``[obs]`` (ISSUE 12):

    * ``fleet_dir:`` — shared fleet-telemetry directory; the
      ``SMTPU_FLEET_DIR`` environment variable (set by
      ``launch.py -fleet-dir``) overrides it.  A fleet dir ARMS
      telemetry even when ``[worker] telemetry`` is off — a launcher
      asking for fleet observability must not be silently ignored by a
      worker config that never mentions telemetry — and redirects the
      JSONL sink to ``<fleet_dir>/telemetry_r<rank>_p<pid>.jsonl`` so
      every process life gets its own stream for the
      :class:`FleetCollector` to merge.
    * ``heartbeat_s: S`` — proof-of-life cadence (default 2.0 in fleet
      mode, 0 = off otherwise).

    Under every supervisor of ``launch.py`` (``-fleet-dir``, ``-elastic``,
    ``-serve``) the rank in the stream's name comes from
    ``SMTPU_PROCESS_ID``, which the launcher sets for each child.
    * ``crash_flush: 1`` — atexit + fatal-signal telemetry flush
      (default on; see recorder.py).

    Cost knobs under ``[obs]`` are armed here too, INDEPENDENTLY of the
    recorder — the compile catalog persists
    ``runs/compile_catalog.json`` and the profiler session captures
    traces even when the JSONL sink is off:

    * ``costs: 1`` / ``costs_path`` / ``costs_memory`` — the catalog of
      CUDA graph captures (obs/costs.py; ``SMTPU_COSTS=1`` overrides).
    * ``profile_at`` / ``profile_steps`` / ``profile_dir`` /
      ``profile_trigger`` / ``profile_on_anomaly`` — triggered profiler
      windows (obs/profiler.py; ``SMTPU_PROFILE_AT`` overrides).
    * ``trace`` and its ``trace_*`` knobs — the wire tracer
      (obs/trace.py).

    Returns the installed :class:`StepRecorder`, or ``None`` when
    telemetry is off.  The caller owns ``close()`` (or use it as a
    context manager); close appends the summary line and uninstalls
    nothing — :func:`uninstall_recorder` is explicit.
    """
    g = config.get_or
    fleet_dir = os.environ.get(ENV_FLEET_DIR) or \
        g("obs", "fleet_dir", "").to_string()
    cat = costs.configure_costs(config, run=run)
    prof = _configure_profiler(config, fleet_dir)
    tr = _configure_tracer(config, fleet_dir)
    if cat is not None or prof is not None or tr is not None:
        # instruments must record even without a JSONL sink — the
        # catalog artifact, the capture summaries and the trace ring
        # still read them
        set_enabled(True)
    if not g("worker", "telemetry", 0).to_bool() and not fleet_dir:
        return None
    set_enabled(True)
    path = g("worker", "telemetry_path", "telemetry.jsonl").to_string()
    if fleet_dir:
        os.makedirs(fleet_dir, exist_ok=True)
        path = os.path.join(
            fleet_dir, stream_filename(process_rank(), os.getpid()))
    rec = StepRecorder(
        _REGISTRY,
        path=path or None,
        run=run,
        ring=g("worker", "telemetry_ring", 1024).to_int32(),
        flush_every=g("worker", "telemetry_flush", 64).to_int32(),
        every=g("worker", "telemetry_every", 1).to_int32(),
        meta=meta,
        heartbeat_s=g("obs", "heartbeat_s",
                      2.0 if fleet_dir else 0.0).to_float(),
        crash_flush=g("obs", "crash_flush", 1).to_bool(),
    )
    if tr is not None:
        # hot-key attribution + last-window gauges ride the step series
        rec.add_sampler(tr.sampler)
    return install_recorder(rec)


def _configure_profiler(config, fleet_dir: str):
    """Install a ProfileSession when any trigger path is armed: the
    ``profile_at`` knob (or its launcher env override), the fleet-dir
    trigger file (on by default in fleet mode — polling is one stat per
    second), or the numerics-anomaly hook.  None of them armed (the
    default) installs nothing — ``record_step`` stays recorder-only."""
    g = config.get_or
    at = g("obs", "profile_at", -1).to_int32()
    env_at = os.environ.get(profiler_mod.ENV_PROFILE_AT, "")
    if env_at:
        at = int(env_at)
    steps = g("obs", "profile_steps", 5).to_int32()
    env_steps = os.environ.get(profiler_mod.ENV_PROFILE_STEPS, "")
    if env_steps:
        steps = int(env_steps)
    trigger = bool(fleet_dir) and g("obs", "profile_trigger",
                                    1).to_bool()
    on_anomaly = g("obs", "profile_on_anomaly", 0).to_bool()
    if at < 0 and not trigger and not on_anomaly:
        return None
    sess = profiler_mod.ProfileSession(
        profile_dir=g("obs", "profile_dir",
                      os.path.join("runs", "profiles")).to_string(),
        steps=steps, profile_at=at,
        fleet_dir=fleet_dir if trigger else None,
        capture_on_anomaly=on_anomaly)
    return install_profiler(sess)


def _configure_tracer(config, fleet_dir: str):
    """Install a WindowTracer when ``[obs] trace`` is armed (default off
    — the transfer ledger then never touches the trace plane, and no
    tap reads a value back, which is the bit-identity contract the
    ON-vs-OFF tests pin).  An armed tracer needs host values in program
    order, so the model runs its steps eagerly while one is installed
    (no CUDA graph)."""
    g = config.get_or
    if not g("obs", "trace", 0).to_bool():
        return None
    cur = get_tracer()
    if cur is not None:
        # repeated train() calls must not stack tracers: the old one
        # would stay enrolled in _CRASH_RECORDERS and dump a stale
        # "crash" ring at exit.  The installed instance follows the
        # run live; re-arming with different knobs needs an explicit
        # uninstall_tracer() first.
        return cur
    from swiftmpi_tpu_torch.obs import trace as trace_mod
    tr = trace_mod.WindowTracer(
        trace_dir=g("obs", "trace_dir", "runs").to_string(),
        ring=g("obs", "trace_ring", 256).to_int32(),
        sample=g("obs", "trace_sample", 1).to_int32(),
        keys=g("obs", "trace_keys", 64).to_int32(),
        topk=g("obs", "trace_topk", 8).to_int32(),
        fleet_dir=fleet_dir or None,
        dump_on_anomaly=g("obs", "trace_on_anomaly", 1).to_bool())
    return install_tracer(
        tr, crash_flush=g("obs", "crash_flush", 1).to_bool())
