"""Wire-path tracing plane: per-window trace records + flight recorder
(the port's copy of ``swiftmpi_tpu/obs/trace.py``; the record schema and
the state machine are the JAX package's).

In the port the taps sit in ``transfer/api.py`` at the points where the
JAX package's host callbacks land: an armed tracer makes the model run
its steps eagerly (no CUDA graph), and the ledger reads each exchange's
count back to the host there, in program order.  With no tracer
installed no tap runs and nothing is read.

The telemetry stack answers *how much* (cumulative ledgers, per-step
deltas) but not *why this window*: once a push window's 4-way wire
decision, dedup ratio, EF drain, and encoded volume fold into counters,
the individual window is gone.  :class:`WindowTracer` keeps it — a
sampled, schema-versioned (``smtpu-trace/1``) record per coalesced push
window, assembled host-side from the SAME ``jax.debug.callback``
landing points the wire ledger already uses, so arming the tracer never
changes the traced program for the counter path (trajectories stay
bit-identical ON vs OFF; the optional key-reservoir tap adds pure reads
only).

One record per window carries:

* ``win`` — monotonic per-rank window id, assigned at callback time (a
  compiled window program executes many times; ids count executions).
  SPMD ranks run the same window sequence, so the id doubles as the
  cross-rank correlation key the
  :class:`~swiftmpi_tpu_torch.obs.collector.FleetCollector` merges on.
* ``step`` / ``steps`` — consumed-step position and the range since the
  previous record (fed from ``obs.record_step``; callbacks retire
  asynchronously, so attribution is one dispatch coarse).
* ``decision`` + ``prices`` — the wire-format decision WITH every
  losing candidate's modeled byte cost
  (``parameter.key_index.price_window_formats``): the "why".
* ``rows_in`` / ``rows_out`` — the window dedup's input/surviving rows,
  exactly the values the ``coalesced_rows_*`` ledger booked.
* ``enc_bytes`` — encoded exchange bytes, exactly the value the
  ``wire_bytes`` ledger booked for the window's exchange(s).
* ``ef_drained`` / ``ef_rebanked`` — |residual| mass drained into and
  re-banked out of the ``@ef`` planes by ``ef_quantize_window``
  (sparse_q windows; armed-only traced sums).
* ``keys`` + ``shard_rows`` / ``shard_bytes`` — a bounded strided
  reservoir of surviving slot ids and, where the backend knows its
  routing, surviving rows (hence encoded bytes) per destination shard.
* ``phase_ms`` — best-effort per-phase latency lift: the host
  ``phase_ms`` histogram sums plus the profiler's per-phase device
  attribution gauges (``window_dedup``/``wire_exchange``/``apply``)
  when a capture has run.

A bounded ring holds the last N records — the **flight recorder** — and
dumps them to ``<trace_dir>/trace_r<rank>_p<pid>.jsonl`` on crash-flush
(enrolled in the recorder module's atexit + fatal-signal hooks), on a
critical numerics anomaly (:func:`on_critical_anomaly`, called by
``AnomalyDetector``), or on an explicit fleet-dir trigger file
(``trace_trigger.json`` — the same monotonic-id replay-once pattern as
the profiler's ``profile_trigger.json``; :func:`request_trace` / the
``python -m swiftmpi_tpu_torch.obs.trace <fleet_dir>`` CLI writes it).

Hot-key attribution: every sampled window's key reservoir feeds bounded
touch/byte estimators (each sampled key stands for ``rows_out /
sample_n`` rows and ``enc_bytes / sample_n`` bytes); the control
plane's :class:`~swiftmpi_tpu_torch.control.sketch.DecayedSketch`, when
attached, replaces the touch *ranking* with its exact decayed counts.
Top-K keys publish as ``trace/hot_key_touches{key=}`` /
``trace/hot_key_bytes{key=}`` gauges via :meth:`WindowTracer.sampler`.

The record layout is deliberately the per-window tuple a TrafficPlan
interpreter would execute — (families, dedup, format, encoded volume,
destination split) — so the ROADMAP's compiler refactor can validate
its plans against this plane as ground truth.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from swiftmpi_tpu_torch.obs.identity import process_ident, process_rank

TRACE_SCHEMA = "smtpu-trace/1"
TRACE_SCHEMA_V = 1

#: fleet-dir trigger file: ``{"id": n}``; ids increase so every rank's
#: tracer replays each dump request exactly once (profiler pattern).
TRIGGER_FILENAME = "trace_trigger.json"

#: the named scopes whose latency the record lifts (see module doc).
TRACE_PHASES = ("window_dedup", "wire_exchange", "apply")

#: bound on the hot-key estimator tables; pruned to half when exceeded.
_HOT_TABLE_MAX = 4096


def request_trace(fleet_dir: str) -> dict:
    """Drop a flight-recorder dump request in ``fleet_dir`` for every
    rank's tracer.  Monotonic id = previous id + 1, atomic replace."""
    path = os.path.join(fleet_dir, TRIGGER_FILENAME)
    prev = 0
    try:
        with open(path) as f:
            prev = int(json.load(f).get("id", 0))
    except (OSError, ValueError):
        pass
    req = {"id": prev + 1, "ts": time.time()}
    os.makedirs(fleet_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(req, f)
    os.replace(tmp, path)
    return req


class WindowTracer:
    """One rank's per-window trace state machine.

    All mutation happens on host callback threads funneled through the
    ledger's ``jax.debug.callback`` landing points plus the trainer
    thread's ``obs.record_step`` — the same single-consumer discipline
    as the wire ledger itself, so no lock is taken on the hot path.
    """

    def __init__(self, trace_dir: str = "runs", ring: int = 256,
                 sample: int = 1, keys: int = 64, topk: int = 8,
                 fleet_dir: Optional[str] = None, poll_s: float = 1.0,
                 dump_on_anomaly: bool = True,
                 anomaly_min_gap_s: float = 5.0):
        if ring < 1:
            raise ValueError(f"trace ring must be >= 1, got {ring}")
        self.trace_dir = trace_dir
        self.sample = max(int(sample), 1)
        self.keys = max(int(keys), 0)
        self.topk = max(int(topk), 0)
        self.fleet_dir = fleet_dir or None
        self.poll_s = float(poll_s)
        self.dump_on_anomaly = bool(dump_on_anomaly)
        self.anomaly_min_gap_s = float(anomaly_min_gap_s)
        self._ring: deque = deque(maxlen=int(ring))
        self._win = 0                   # monotonic window id (1-based)
        self._records = 0               # sampled records assembled
        self._consumed = 0              # steps via on_step
        self._prev_step = 0             # step of the previous record
        self._open: Dict[str, dict] = {}      # backend -> open record
        self._staged: Dict[str, dict] = {}    # backend -> pending extras
        self._prices: Dict[tuple, dict] = {}  # (backend, decision) -> why
        self._touch: Dict[int, float] = {}    # slot -> est. touches
        self._bytes: Dict[int, float] = {}    # slot -> est. wire bytes
        self._sketch = None
        self.dumps: List[str] = []
        self._done_trigger_id = 0
        self._last_poll = 0.0
        self._last_anomaly_dump = 0.0
        self._closed = False
        self._t0 = time.monotonic()

    # -- feeds from the transfer layer (host callback side) ----------------
    def on_decision(self, backend: str, decision: str, prices: dict,
                    rows: int, capacity: int, row_bytes: int,
                    quant: str = "off") -> None:
        """Cache one wire-format pricing (host-side, once per build).
        The decision is baked into the compiled window program, so
        attaching the latest pricing for ``(backend, decision)`` to every
        runtime record with that decision is exact as long as the program
        in use is the one most recently priced — which the step-rebuild
        contract for format-affecting knobs guarantees."""
        self._prices[(backend, decision)] = {
            "prices": {k: float(v) for k, v in prices.items()},
            "rows": int(rows), "capacity": int(capacity),
            "row_bytes": int(row_bytes), "quant": quant}

    def stage(self, backend: str, **extras) -> None:
        """Park window extras (EF mass, key reservoir, shard rows) for
        the backend's next finalized record."""
        self._staged.setdefault(backend, {}).update(extras)

    def stage_ef(self, backend: str, drained, rebanked) -> None:
        self.stage(backend, ef_drained=float(drained),
                   ef_rebanked=float(rebanked))

    def stage_keys(self, backend: str, sample, shard_rows=None) -> None:
        sample = np.asarray(sample).ravel()
        extras = {"keys": sample[sample >= 0].astype(np.int64)}
        if shard_rows is not None:
            extras["shard_rows"] = np.asarray(shard_rows).ravel()
        self.stage(backend, **extras)

    def on_window(self, backend: str, decision: str, rows_in: int,
                  rows_out: int, family: str = "window") -> None:
        """A window dedup landed: assign the next window id and open a
        record (finalizing any predecessor still waiting for its
        exchange).  Called from the ledger's ``_accum_coalesce`` landing
        point, so it fires exactly once per compiled window execution."""
        if self._closed:
            return
        prev = self._open.pop(backend, None)
        if prev is not None:
            self._finish(prev)
        self._win += 1
        staged = self._staged.pop(backend, {})
        if self._win % self.sample != 0:
            self._count("trace/windows", 1)
            return
        rec = {"v": TRACE_SCHEMA_V, "schema": TRACE_SCHEMA,
               "kind": "trace/window", "win": self._win,
               "backend": backend, "decision": decision,
               "step": self._consumed,
               "steps": [self._prev_step, self._consumed],
               "t": time.monotonic() - self._t0,
               "families": {family: int(rows_in)},
               "rows_in": int(rows_in), "rows_out": int(rows_out),
               "enc_bytes": 0, "exchanges": 0}
        why = self._prices.get((backend, decision))
        if why is not None:
            rec.update(prices=why["prices"], capacity=why["capacity"],
                       row_bytes=why["row_bytes"], quant=why["quant"])
        self._attach(rec, staged)
        self._count("trace/windows", 1)
        self._open[backend] = rec

    def on_exchange(self, backend: str, rows: int, row_bytes: int,
                    base_bytes: int = 0,
                    decision: Optional[str] = None) -> None:
        """An exchange landed on the ledger.  Three cases: (a) a
        decision-less exchange while this backend's window record is
        open is the window's wire hop — book its encoded bytes and
        finalize; (b) an exchange CARRYING a decision is a dense window
        (the dense path never books a dedup) — it is a whole record by
        itself; (c) anything else (per-step pushes) is not a window and
        is ignored."""
        if self._closed:
            return
        nbytes = int(rows) * int(row_bytes) + int(base_bytes)
        rec = self._open.get(backend)
        if decision is not None:
            if rec is not None:
                self._finish(self._open.pop(backend))
            self._win += 1
            staged = self._staged.pop(backend, {})
            if self._win % self.sample != 0:
                self._count("trace/windows", 1)
                return
            rec = {"v": TRACE_SCHEMA_V, "schema": TRACE_SCHEMA,
                   "kind": "trace/window", "win": self._win,
                   "backend": backend, "decision": decision,
                   "step": self._consumed,
                   "steps": [self._prev_step, self._consumed],
                   "t": time.monotonic() - self._t0,
                   "families": {}, "rows_in": int(rows),
                   "rows_out": int(rows),
                   "enc_bytes": nbytes, "exchanges": 1,
                   "wire_row_bytes": int(row_bytes),
                   "base_bytes": int(base_bytes)}
            why = self._prices.get((backend, decision))
            if why is not None:
                rec.update(prices=why["prices"],
                           capacity=why["capacity"],
                           row_bytes=why["row_bytes"], quant=why["quant"])
            self._attach(rec, staged)
            self._count("trace/windows", 1)
            self._finish(rec)
            return
        if rec is None:
            return
        rec["enc_bytes"] += nbytes
        rec["exchanges"] += 1
        rec["wire_row_bytes"] = int(row_bytes)
        rec["base_bytes"] = int(base_bytes)
        self._finish(self._open.pop(backend))

    # -- record assembly ---------------------------------------------------
    @staticmethod
    def _attach(rec: dict, staged: dict) -> None:
        for k in ("ef_drained", "ef_rebanked"):
            if k in staged:
                rec[k] = float(staged[k])
        if "hot_rows" in staged:        # hybrid's replicated-head slice
            rec["hot_rows"] = int(staged["hot_rows"])
        if "keys" in staged:
            rec["keys"] = [int(v) for v in staged["keys"]]
        if "shard_rows" in staged:
            rec["shard_rows"] = [int(v) for v in staged["shard_rows"]]

    def _finish(self, rec: dict) -> None:
        """Seal one record: per-shard encoded bytes, phase lift, hot-key
        accounting, ring append, registry mirror, fleet event."""
        if rec.get("shard_rows") and rec.get("wire_row_bytes"):
            rb = rec["wire_row_bytes"]
            rec["shard_bytes"] = [int(r) * rb for r in rec["shard_rows"]]
        rec["phase_ms"] = self._lift_phases()
        self._hot_account(rec)
        self._ring.append(rec)
        self._records += 1
        self._prev_step = rec["step"]
        self._count("trace/records", 1)
        from swiftmpi_tpu_torch import obs
        r = obs.get_recorder()
        if r is not None and self.fleet_dir:
            r.event("trace/window",
                    {k: rec[k] for k in ("win", "backend", "decision",
                                         "rows_in", "rows_out",
                                         "enc_bytes")})

    @staticmethod
    def _lift_phases() -> dict:
        """Best-effort latency attribution for the window phases: the
        cumulative host ``phase_ms`` histogram sums plus, when a
        profiler capture has run, its per-phase device-ms gauges.
        Cumulative-by-design — consecutive records' deltas attribute a
        window interval, matching the ledger's no-reset contract."""
        from swiftmpi_tpu_torch import obs
        from swiftmpi_tpu_torch.obs.registry import series_key
        reg = obs.get_registry()
        if not reg.enabled:
            return {}
        snap = reg.snapshot()
        out = {}
        for ph in TRACE_PHASES:
            h = snap["hists"].get(series_key("phase_ms", {"phase": ph}))
            if h is not None and h["count"]:
                out[ph] = h["sum"]
            dev = snap["gauges"].get(
                series_key("profile/device_ms", {"phase": ph}))
            if dev:
                out[ph + "_device"] = dev
        return out

    def _count(self, name: str, n: int) -> None:
        from swiftmpi_tpu_torch import obs
        reg = obs.get_registry()
        if reg.enabled:
            reg.counter(name).inc(n)

    # -- hot-key attribution -----------------------------------------------
    def attach_sketch(self, sketch) -> None:
        """Use the control plane's DecayedSketch for touch ranking; the
        reservoir keeps supplying the byte attribution."""
        self._sketch = sketch

    def _hot_account(self, rec: dict) -> None:
        keys = rec.get("keys")
        if not keys:
            return
        n = len(keys)
        touch_share = float(rec.get("rows_out", 0)) / n
        byte_share = float(rec.get("enc_bytes", 0)) / n
        for k in keys:
            self._touch[k] = self._touch.get(k, 0.0) + touch_share
            self._bytes[k] = self._bytes.get(k, 0.0) + byte_share
        if len(self._touch) > _HOT_TABLE_MAX:
            keep = sorted(self._touch, key=self._touch.get,
                          reverse=True)[:_HOT_TABLE_MAX // 2]
            self._touch = {k: self._touch[k] for k in keep}
            self._bytes = {k: v for k, v in self._bytes.items()
                           if k in self._touch}

    def hot_keys(self, k: Optional[int] = None) -> List[dict]:
        """Top-K keys by touches (sketch-exact when attached, reservoir
        estimate otherwise), each with its attributed wire bytes."""
        k = self.topk if k is None else int(k)
        if k <= 0 or not self._touch:
            return []
        touch = dict(self._touch)
        if self._sketch is not None:
            try:
                counts = np.asarray(self._sketch.counts)
                for key in touch:
                    if 0 <= key < counts.size:
                        touch[key] = float(counts[key])
            except Exception:
                pass        # a mis-sized sketch must not kill tracing
        top = sorted(touch, key=touch.get, reverse=True)[:k]
        return [{"key": int(key), "touches": float(touch[key]),
                 "bytes": float(self._bytes.get(key, 0.0))}
                for key in top]

    def sampler(self, reg) -> None:
        """StepRecorder sampler: publish the hot-key attribution and the
        last traced window id as gauges before every snapshot."""
        if not reg.enabled:
            return
        reg.gauge("trace/last_window_id").set(float(self._win))
        for h in self.hot_keys():
            key = str(h["key"])
            reg.gauge("trace/hot_key_touches", key=key).set(h["touches"])
            reg.gauge("trace/hot_key_bytes", key=key).set(h["bytes"])

    # -- the step funnel + trigger poll ------------------------------------
    def on_step(self, n: int = 1) -> None:
        self._consumed += n
        if self.fleet_dir:
            self._poll_trigger()

    def _poll_trigger(self) -> None:
        now = time.monotonic()
        if now - self._last_poll < self.poll_s:
            return
        self._last_poll = now
        try:
            with open(os.path.join(self.fleet_dir,
                                   TRIGGER_FILENAME)) as f:
                req = json.load(f)
        except (OSError, ValueError):
            return
        tid = int(req.get("id", 0))
        if tid <= self._done_trigger_id:
            return
        self._done_trigger_id = tid
        self.dump(reason=f"trigger:{tid}")

    # -- flight recorder ---------------------------------------------------
    def records(self) -> List[dict]:
        """The ring's current contents (oldest first)."""
        return list(self._ring)

    @property
    def window_id(self) -> int:
        return self._win

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> Optional[str]:
        """Write the flight-recorder ring (meta line + last-N records)
        to ``trace_r<rank>_p<pid>.jsonl``; atomic replace so a reader
        never sees a half-written dump from a LIVE dump (a crash dump is
        best-effort by nature — the repair parser owns that case)."""
        rank = process_rank() or 0
        path = path or os.path.join(
            self.trace_dir, f"trace_r{rank}_p{os.getpid()}.jsonl")
        meta = {"v": TRACE_SCHEMA_V, "kind": "meta",
                "schema": TRACE_SCHEMA, "reason": reason,
                "ts": time.time(), "rank": rank, "pid": os.getpid(),
                "ident": process_ident(), "win": self._win,
                "step": self._consumed, "records": len(self._ring),
                "hot_keys": self.hot_keys()}
        try:
            os.makedirs(self.trace_dir or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(meta, sort_keys=True) + "\n")
                for rec in self._ring:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
            os.replace(tmp, path)
        except OSError:
            return None
        self.dumps.append(path)
        self._count("trace/dumps", 1)
        return path

    def close(self) -> None:
        """Crash-flush hook (recorder module's atexit/signal machinery
        calls ``close()`` on every enrolled object): seal any open
        record and dump the ring.  Idempotent; a clean teardown
        uninstalls the tracer instead of closing it, so normal exits
        leave no dump behind."""
        if self._closed:
            return
        for backend in list(self._open):
            self._finish(self._open.pop(backend))
        self._closed = True
        if self._ring:
            self.dump(reason="crash")


def on_critical_anomaly(anomaly: dict) -> None:
    """Numerics-plane hook: a critical anomaly freezes the evidence by
    dumping the flight recorder (throttled — a repeating anomaly must
    not turn the tracer into a disk flood).  No-op unless a tracer with
    ``dump_on_anomaly`` is installed."""
    from swiftmpi_tpu_torch import obs
    tr = obs.get_tracer()
    if tr is None or not tr.dump_on_anomaly or tr._closed:
        return
    now = time.monotonic()
    if now - tr._last_anomaly_dump < tr.anomaly_min_gap_s:
        return
    tr._last_anomaly_dump = now
    tr.dump(reason=f"anomaly:{anomaly.get('anomaly', '?')}")


def main(argv: Optional[list] = None) -> int:
    """``python -m swiftmpi_tpu_torch.obs.trace <fleet_dir>``: request a
    flight-recorder dump from every rank of a live fleet run."""
    import argparse
    ap = argparse.ArgumentParser(
        description="drop a trace-dump trigger in a fleet dir")
    ap.add_argument("fleet_dir", help="the run's [obs] fleet_dir")
    args = ap.parse_args(argv)
    req = request_trace(args.fleet_dir)
    print(f"trace trigger id={req['id']} written to "
          f"{os.path.join(args.fleet_dir, TRIGGER_FILENAME)}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
