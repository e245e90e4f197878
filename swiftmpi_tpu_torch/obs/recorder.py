"""Per-step telemetry time-series: registry deltas -> ring buffer -> JSONL
(the port's copy of ``swiftmpi_tpu/obs/recorder.py``: the same lines).

End-of-run scalars (``train_metrics``, ``Transfer.traffic()``) say *what*
a run cost; auto-placement and wire-format audits need *when* — a live,
queryable per-step series.  :class:`StepRecorder` snapshots the
:class:`~swiftmpi_tpu_torch.obs.registry.MetricsRegistry` once per recorded
step, keeps the per-step **deltas** in a bounded ring buffer (long runs
hold O(ring) memory, never O(steps)), and flushes every record to a
schema-versioned JSONL file (``telemetry.jsonl``) alongside the run's
other output.

Record schema (one JSON object per line, ``"v": 1`` on every line):

* ``kind: "meta"``   — first line: schema id, run name, rank/pid identity,
  caller-supplied metadata.
* ``kind: "step"``   — ``step`` (cumulative consumed steps), ``steps``
  (steps covered by this record — a fused scan group records once for L
  steps), ``t`` (seconds since recorder start), ``counters`` (deltas for
  the series that moved), ``gauges`` (current values), ``hists``
  (per-record bucket-count deltas; ``bounds`` ride along the first time a
  series appears).
* ``kind: "summary"`` — last line: cumulative counter totals, final
  gauges, and p50/p95/p99 per histogram — so one-shot consumers (the
  traffic-budget gate) never have to re-sum the deltas.
* ``kind: "heartbeat"`` — proof-of-life line with a wall-clock ``ts``,
  emitted inline from :meth:`on_steps` at the ``heartbeat_s`` cadence
  and flushed IMMEDIATELY (no buffering): a rank that stalls stops
  heartbeating, and the silence itself is the fleet-health signal a
  :class:`~swiftmpi_tpu_torch.obs.collector.FleetCollector` reads.  No
  background thread — a heartbeat that a hung consumer loop cannot emit
  would defeat the point.
* other kinds — out-of-band :meth:`StepRecorder.event` lines (the
  control plane's ``control/decision`` records): arbitrary payload
  stamped with the recorder's step/clock, same ``"v"`` versioning.

Writes happen only on the recording thread (the training loop's consumer
side); the registry itself is what the producer threads hit, and its
snapshot is lock-consistent.  ``telemetry_every: K`` thins recording to
every K-th step when per-step snapshots are too hot for a small step.

Flush-on-crash (ISSUE 12 satellite): a killed rank used to lose exactly
the buffered tail that explains the kill.  ``crash_flush=True`` enrolls
the recorder in a process-wide atexit + fatal-signal (SIGTERM/SIGINT/
SIGHUP) hook that closes every live recorder — summary line included —
then restores the previous handler and re-delivers the signal so the
launcher still sees the normalized 128+signum exit code.  SIGKILL is
uncatchable by design; the immediate heartbeat flush bounds that loss
to one flush interval.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

from swiftmpi_tpu_torch.obs.identity import process_ident, process_rank
from swiftmpi_tpu_torch.obs.registry import (MetricsRegistry,
                                       quantile_from_buckets)

SCHEMA = "smtpu-telemetry/1"
SCHEMA_V = 1

# -- crash-flush machinery ---------------------------------------------------
# Recorders enrolled for flush-on-crash.  A WeakSet so an abandoned
# recorder never outlives its owner just because it asked for crash
# safety; close() is idempotent so double-delivery (atexit after a
# handled signal) is harmless.
_CRASH_RECORDERS: "weakref.WeakSet[StepRecorder]" = weakref.WeakSet()
_CRASH_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)
_crash_hooks_installed = False
_prev_handlers: Dict[int, object] = {}


def _flush_all_recorders() -> None:
    for rec in list(_CRASH_RECORDERS):
        try:
            rec.close()
        except Exception:       # a broken sink must not mask the signal
            pass


def _crash_signal_handler(signum, frame) -> None:
    _flush_all_recorders()
    # Restore whatever was installed before us and re-deliver, so the
    # process still dies with the correct 128+signum status the
    # launcher's _normalize_rc expects (default disposition) — or the
    # application's own handler (e.g. KeyboardInterrupt) still runs.
    prev = _prev_handlers.get(signum, signal.SIG_DFL)
    if callable(prev):
        prev(signum, frame)
        return
    signal.signal(signum, signal.SIG_DFL if prev is None else prev)
    os.kill(os.getpid(), signum)


def _install_crash_hooks() -> None:
    """Idempotent; atexit covers normal interpreter teardown, the signal
    handlers cover supervisor SIGTERM teardown.  signal.signal only
    works on the main thread — off-thread enrollment keeps the atexit
    half and skips signals (ValueError guard)."""
    global _crash_hooks_installed
    if _crash_hooks_installed:
        return
    atexit.register(_flush_all_recorders)
    if threading.current_thread() is threading.main_thread():
        for sig in _CRASH_SIGNALS:
            try:
                prev = signal.getsignal(sig)
                signal.signal(sig, _crash_signal_handler)
                _prev_handlers[sig] = prev
            except (ValueError, OSError):
                pass
    _crash_hooks_installed = True


def remove_crash_hooks() -> None:
    """Undo :func:`_install_crash_hooks`: unregister the atexit flush,
    restore the signal handlers that were installed before ours (where
    ours is still the installed one), and forget every enrolled recorder.
    ``obs.reset_for_tests`` calls it, so a test leaves no handler behind
    in its worker process."""
    global _crash_hooks_installed
    _CRASH_RECORDERS.clear()
    if not _crash_hooks_installed:
        return
    atexit.unregister(_flush_all_recorders)
    if threading.current_thread() is threading.main_thread():
        for sig, prev in list(_prev_handlers.items()):
            try:
                if signal.getsignal(sig) is _crash_signal_handler:
                    signal.signal(sig, signal.SIG_DFL if prev is None
                                  else prev)
            except (ValueError, OSError):
                pass
    _prev_handlers.clear()
    _crash_hooks_installed = False


class StepRecorder:
    """Snapshot registry deltas per train step; flush JSONL.

    ``ring`` bounds in-memory retention (a deque of the last N records);
    ``flush_every`` bounds the write buffer; ``every`` thins recording.
    ``samplers`` are callables ``fn(registry)`` invoked right before each
    snapshot — the bridge for instruments that keep their own cumulative
    state (the ``Throughput`` meter, ``PrefetchIterator.stats()``): they
    ``set_total``/``gauge.set`` the registry from their internal counters
    so the delta machinery sees them like any native series.
    """

    def __init__(self, registry: MetricsRegistry, path: Optional[str] = None,
                 run: str = "run", ring: int = 1024, flush_every: int = 64,
                 every: int = 1, meta: Optional[dict] = None,
                 heartbeat_s: float = 0.0, crash_flush: bool = False):
        if ring < 1:
            raise ValueError(f"telemetry ring must be >= 1, got {ring}")
        if every < 1:
            raise ValueError(f"telemetry_every must be >= 1, got {every}")
        self.registry = registry
        self.path = path
        self.run = run
        self.every = int(every)
        self._ring: deque = deque(maxlen=int(ring))
        self._flush_every = max(1, int(flush_every))
        self._samplers: List[Callable[[MetricsRegistry], None]] = []
        self._buf: List[str] = []
        self._file = None
        self._closed = False
        self._step_total = 0
        self._steps_unrecorded = 0
        self._records_written = 0
        self._t0 = time.monotonic()
        self._prev = registry.snapshot()
        self._bounds_emitted = set()
        self._meta = {"v": SCHEMA_V, "kind": "meta", "schema": SCHEMA,
                      "run": run, "rank": process_rank(),
                      "pid": os.getpid(), "ident": process_ident(),
                      "ts": time.time(), **(meta or {})}
        self._buf.append(json.dumps(self._meta, sort_keys=True))
        self.heartbeat_s = float(heartbeat_s)
        self._last_hb = 0.0
        if crash_flush:
            _CRASH_RECORDERS.add(self)
            _install_crash_hooks()
        if self.heartbeat_s > 0:
            self.heartbeat()            # first proof of life ASAP

    # -- samplers ----------------------------------------------------------
    def add_sampler(self, fn: Callable[[MetricsRegistry], None]) -> None:
        """Register ``fn(registry)`` to run before every snapshot."""
        self._samplers.append(fn)

    # -- recording ---------------------------------------------------------
    def on_steps(self, n: int = 1) -> None:
        """Account ``n`` consumed train steps; records when the
        ``every`` cadence is due.  Call from the consumer thread."""
        if self._closed:
            return
        self._step_total += n
        self._steps_unrecorded += n
        if self._steps_unrecorded >= self.every:
            self._record()
        if self.heartbeat_s > 0 and \
                time.monotonic() - self._last_hb >= self.heartbeat_s:
            self.heartbeat()

    def heartbeat(self) -> Optional[dict]:
        """Write a proof-of-life line NOW and flush it — unlike every
        other record this must hit the disk immediately, because its
        absence is what a FleetCollector reads as a stall.  Carries the
        wall clock (``ts``) so cross-rank heartbeat ages are comparable
        without reconstructing from the meta line."""
        if self._closed:
            return None
        self._last_hb = time.monotonic()
        if self.registry.enabled:
            self.registry.counter("telemetry/heartbeats").inc()
        rec = {"v": SCHEMA_V, "kind": "heartbeat",
               "step": self._step_total,
               "t": self._last_hb - self._t0,
               "ts": time.time(),
               "rank": self._meta["rank"], "ident": self._meta["ident"]}
        if self.path:
            self._buf.append(json.dumps(rec, sort_keys=True))
            self.flush()
        return rec

    def _record(self) -> None:
        for fn in self._samplers:
            fn(self.registry)
        cur = self.registry.snapshot()
        d = MetricsRegistry.delta(self._prev, cur)
        self._prev = cur
        hists = {}
        for k, h in d["hists"].items():
            entry = {"n": h["n"], "sum": h["sum"], "counts": h["counts"]}
            if k not in self._bounds_emitted:
                entry["bounds"] = list(h["bounds"])
                self._bounds_emitted.add(k)
            hists[k] = entry
        rec = {"v": SCHEMA_V, "kind": "step",
               "step": self._step_total,
               "steps": self._steps_unrecorded,
               "t": time.monotonic() - self._t0,
               "rank": self._meta["rank"], "ident": self._meta["ident"],
               "counters": d["counters"], "gauges": d["gauges"],
               "hists": hists}
        self._steps_unrecorded = 0
        self._ring.append(rec)
        self._records_written += 1
        if self.path:
            self._buf.append(json.dumps(rec, sort_keys=True))
            if len(self._buf) >= self._flush_every:
                self.flush()

    def event(self, kind: str, payload: Optional[dict] = None) -> dict:
        """Append a schema-versioned out-of-band event line (e.g. the
        control plane's ``control/decision`` records).  Events carry the
        recorder's current step count and clock so they interleave with
        the step series on a shared axis; they ride the same ring/flush
        machinery as step records but never perturb the delta snapshots.
        Returns the record written."""
        if self._closed:
            return {}
        rec = {"v": SCHEMA_V, "kind": str(kind),
               "step": self._step_total,
               "t": time.monotonic() - self._t0,
               "rank": self._meta["rank"], "ident": self._meta["ident"],
               **(payload or {})}
        self._ring.append(rec)
        if self.path:
            self._buf.append(json.dumps(rec, sort_keys=True))
            if len(self._buf) >= self._flush_every:
                self.flush()
        return rec

    # -- read side ---------------------------------------------------------
    def records(self) -> List[dict]:
        """The ring buffer's current contents (most recent ``ring``
        step records, oldest first)."""
        return list(self._ring)

    @property
    def steps_recorded(self) -> int:
        return self._step_total

    # -- sinks -------------------------------------------------------------
    def flush(self) -> None:
        if not self.path or not self._buf:
            self._buf = self._buf if self.path else []
            return
        if self._file is None:
            self._file = open(self.path, "a")
        self._file.write("\n".join(self._buf) + "\n")
        self._file.flush()
        self._buf = []

    def close(self) -> None:
        """Record any unrecorded tail steps, append the summary line, and
        flush.  Idempotent."""
        if self._closed:
            return
        if self._steps_unrecorded:
            self._record()
        for fn in self._samplers:
            fn(self.registry)
        snap = self.registry.snapshot()
        summary = {"v": SCHEMA_V, "kind": "summary", "run": self.run,
                   "rank": self._meta["rank"], "ident": self._meta["ident"],
                   "steps": self._step_total,
                   "elapsed_s": time.monotonic() - self._t0,
                   "counters": snap["counters"], "gauges": snap["gauges"],
                   "quantiles": {
                       k: {"p50": quantile_from_buckets(
                               h["bounds"], h["counts"], 0.50),
                           "p95": quantile_from_buckets(
                               h["bounds"], h["counts"], 0.95),
                           "p99": quantile_from_buckets(
                               h["bounds"], h["counts"], 0.99),
                           "n": h["count"],
                           "mean_ms": h["sum"] / h["count"]
                           if h["count"] else 0.0}
                       for k, h in snap["hists"].items()}}
        self._closed = True
        _CRASH_RECORDERS.discard(self)
        if self.path:
            self._buf.append(json.dumps(summary, sort_keys=True))
            self.flush()
            if self._file is not None:
                self._file.close()
                self._file = None
        self.summary = summary

    def __enter__(self) -> "StepRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
