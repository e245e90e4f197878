"""Triggered profiler windows: bounded ``torch.profiler`` captures on a
live run (counterpart of ``swiftmpi_tpu/obs/profiler.py``).

A :class:`ProfileSession` sits on the consumed-step funnel
(``obs.record_step``) and captures an N-step trace when any of three
triggers fires:

* the ``[obs] profile_at: <step>`` knob (one capture, at that step);
* a trigger file in the fleet directory — ``request_profile()`` / the
  ``python -m swiftmpi_tpu_torch.obs.profiler <fleet_dir>`` CLI writes
  ``profile_trigger.json`` and the session picks it up on its next
  (throttled) poll;
* :meth:`ProfileSession.request` — wired to the numerics plane so a
  critical anomaly captures the very steps that misbehaved
  (``[obs] profile_on_anomaly``).

A capture is a ``torch.profiler.profile`` over the host and, on a CUDA
device, the card.  Artifacts land under
``runs/profiles/profile_step<N>_r<rank>/``: the chrome trace as
``<host>.trace.json.gz`` plus a ``profile_summary.json`` (schema
``smtpu-profile/1``) from :func:`parse_trace_dir`, which attributes
duration to the ``span``/``named_scope`` phase names and splits device
from host.  Torch's chrome trace has no ``/device:`` process names, so
an event is a device event by its category: ``kernel``, ``gpu_memcpy``,
``gpu_memset`` and ``gpu_user_annotation``.  Inside a CUDA graph replay
the ``record_function`` ranges are not replayed, so the replayed
kernels' device time falls under ``other``; the host side still shows
the ``dispatch`` span around the replay.

Only one profiler runs at a time in a process.  A second capture (say,
inside ``w2v_profile -trace``) fails to start, and the session swallows
that as the JAX package does; a caller that needs a capture checks its
summary's event counts.

The same attribution lands in the registry as
``profile/{device_ms,host_ms,skew_ms}{phase=}`` gauges and
``profile/{sessions,steps}`` counters.  No session installed (the
default) means ``record_step`` never touches this module.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from swiftmpi_tpu_torch.obs.identity import process_rank

#: fleet-dir trigger file: ``{"id": n, "steps": k}``; ids increase so a
#: session replays each request exactly once.
TRIGGER_FILENAME = "profile_trigger.json"

#: per-capture summary schema (``profile_summary.json``).
PROFILE_SCHEMA = "smtpu-profile/1"

#: env pre-arm (a launcher sets them for every rank).
ENV_PROFILE_AT = "SMTPU_PROFILE_AT"
ENV_PROFILE_STEPS = "SMTPU_PROFILE_STEPS"

#: chrome-trace categories of the card's own events (torch.profiler)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset",
                     "gpu_user_annotation")
#: of those, the card's operations: its kernels and copies
DEVICE_OP_CATEGORIES = DEVICE_CATEGORIES[:3]

#: phase names the trace parser attributes duration to — the JAX
#: package's list, the host ``obs.span`` names and the ``named_scope``
#: names.  Substring match.
KNOWN_PHASES = (
    "window_dedup", "wire_exchange", "apply", "pallas_gather_stencil",
    "serve/topk", "render", "h2d", "input_wait", "dispatch",
    "checkpoint_save", "bound_wait", "step_hooks", "epoch_end",
)


def request_profile(fleet_dir: str, steps: int = 5) -> dict:
    """Drop a capture request in ``fleet_dir`` for every rank's session
    to pick up.  Monotonic id = previous id + 1 (a stale file from a
    finished run is superseded, not replayed)."""
    path = os.path.join(fleet_dir, TRIGGER_FILENAME)
    prev = 0
    try:
        with open(path) as f:
            prev = int(json.load(f).get("id", 0))
    except (OSError, ValueError):
        pass
    req = {"id": prev + 1, "steps": int(steps), "ts": time.time()}
    os.makedirs(fleet_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(req, f)
    os.replace(tmp, path)
    return req


# -- trace parsing ----------------------------------------------------------

def parse_trace_dir(root: str,
                    phases: Optional[tuple] = None) -> dict:
    """Best-effort phase attribution over every chrome-format trace
    (``*.trace.json.gz`` and the perfetto twin) under ``root``.

    Complete events (``ph == "X"``) are split device/host: by their
    process's ``process_name`` metadata (``/device:...``, the JAX
    package's traces) or by their category (:data:`DEVICE_CATEGORIES`,
    torch's), and their duration is credited to the first KNOWN phase
    whose name is a substring of the event name; the numbers are for
    *ranking* phases, not summing to wall clock.  Events matching no
    phase aggregate under ``"other"``."""
    phases = phases or KNOWN_PHASES
    device_ms: Dict[str, float] = {}
    host_ms: Dict[str, float] = {}
    files = sorted(
        set(glob.glob(os.path.join(root, "**", "*.trace.json.gz"),
                      recursive=True))
        | set(glob.glob(os.path.join(root, "**",
                                     "perfetto_trace.json.gz"),
                        recursive=True)))
    # the per-host trace and the perfetto export carry the same events;
    # parse only one of each basename flavor to avoid double counting
    if any(p.endswith(".trace.json.gz")
           and not p.endswith("perfetto_trace.json.gz") for p in files):
        files = [p for p in files
                 if not p.endswith("perfetto_trace.json.gz")]
    n_events = 0
    for path in files:
        try:
            with gzip.open(path, "rt") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        events = doc.get("traceEvents") or []
        procs: Dict[int, str] = {}
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                procs[ev.get("pid")] = str(
                    (ev.get("args") or {}).get("name", ""))
        for ev in events:
            if ev.get("ph") != "X":
                continue
            dur_ms = float(ev.get("dur", 0.0)) / 1e3   # trace dur is µs
            if dur_ms <= 0:
                continue
            name = str(ev.get("name", ""))
            if name.startswith("$"):        # python frame-trace noise
                continue
            n_events += 1
            device = ("/device:" in procs.get(ev.get("pid"), "")
                      or ev.get("cat") in DEVICE_CATEGORIES)
            side = device_ms if device else host_ms
            for ph in phases:
                if ph in name:
                    side[ph] = side.get(ph, 0.0) + dur_ms
                    break
            else:
                side["other"] = side.get("other", 0.0) + dur_ms
    skew_ms = {ph: host_ms.get(ph, 0.0) - device_ms.get(ph, 0.0)
               for ph in set(device_ms) | set(host_ms)}
    return {"schema": PROFILE_SCHEMA, "files": len(files),
            "events": n_events, "device_ms": device_ms,
            "host_ms": host_ms, "skew_ms": skew_ms}


def device_busy(prof) -> Tuple[float, Dict[str, float]]:
    """A finished ``torch.profiler`` capture's device busy time in ms, the
    union of its kernels' and copies' intervals (work that overlaps on
    two streams counts once), and the device ms summed by operation name
    (a breakdown: there each overlapping operation counts).  Read from
    the capture's chrome trace, where every operation has its interval."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = (doc.get("traceEvents") or []) if isinstance(doc, dict) \
        else doc
    intervals, by_name = [], {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_OP_CATEGORIES:
            continue
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0.0))
        intervals.append((a, b))
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, by_name


# -- the session ------------------------------------------------------------

class ProfileSession:
    """One rank's triggered-capture state machine.  Single-threaded by
    construction: every transition happens on the trainer thread inside
    ``obs.record_step`` (anomaly requests only park a flag)."""

    def __init__(self, profile_dir: str = os.path.join("runs",
                                                       "profiles"),
                 steps: int = 5, profile_at: int = -1,
                 fleet_dir: Optional[str] = None,
                 poll_s: float = 1.0,
                 capture_on_anomaly: bool = False):
        self.profile_dir = profile_dir
        self.steps = max(int(steps), 1)
        self.profile_at = int(profile_at)
        self.fleet_dir = fleet_dir or None
        self.poll_s = poll_s
        self.capture_on_anomaly = capture_on_anomaly
        self.captures: List[dict] = []
        self._consumed = 0
        self._active: Optional[dict] = None
        self._pending: Optional[dict] = None
        self._done_trigger_id = 0
        self._last_poll = 0.0

    # -- triggers ----------------------------------------------------------
    def request(self, steps: Optional[int] = None,
                reason: str = "manual") -> None:
        """Ask for a capture at the next consumed step.  Safe from any
        thread (it only parks a dict); ignored while one is already
        pending or active."""
        if self._active is None and self._pending is None:
            self._pending = {"steps": int(steps or self.steps),
                             "reason": reason}

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
        self.request(steps=int(req.get("steps", self.steps)),
                     reason=f"trigger:{tid}")

    # -- the step funnel ---------------------------------------------------
    def on_step(self, n: int = 1) -> None:
        """Account ``n`` consumed steps; start/stop captures at step
        granularity (a fused group of L steps counts as L — a capture
        window never splits a dispatch)."""
        self._consumed += n
        if self._active is not None:
            self._active["remaining"] -= n
            if self._active["remaining"] <= 0:
                self._stop()
            return
        if 0 <= self.profile_at <= self._consumed:
            self.profile_at = -1      # the knob fires once
            self._start(self.steps, "profile_at")
            return
        if self._pending is None and self.fleet_dir:
            self._poll_trigger()
        if self._pending is not None:
            p, self._pending = self._pending, None
            self._start(p["steps"], p["reason"])

    def close(self) -> None:
        """Finish an in-flight capture (end of training mid-window)."""
        if self._active is not None:
            self._stop()

    def abort(self) -> None:
        """Stop an in-flight capture without writing anything (test
        teardown)."""
        act, self._active = self._active, None
        if act is not None:
            try:
                act["prof"].__exit__(None, None, None)
            except Exception:
                pass

    # -- capture lifecycle -------------------------------------------------
    def _start(self, steps: int, reason: str) -> None:
        import torch
        from swiftmpi_tpu_torch.utils.profiler import activities
        out = os.path.join(
            self.profile_dir,
            f"profile_step{self._consumed}_r{process_rank() or 0}")
        try:
            os.makedirs(out, exist_ok=True)
            prof = torch.profiler.profile(activities=activities())
            prof.__enter__()
        except Exception:
            return   # a second profiler in the process must not kill train
        self._active = {"dir": out, "start_step": self._consumed,
                        "steps": steps, "remaining": steps,
                        "reason": reason, "t0": time.perf_counter(),
                        "prof": prof}
        from swiftmpi_tpu_torch import obs
        obs.get_registry().counter("profile/sessions").inc()

    def _stop(self) -> None:
        from swiftmpi_tpu_torch.utils.profiler import export_trace
        act, self._active = self._active, None
        try:
            act["prof"].__exit__(None, None, None)
            export_trace(act["prof"], act["dir"])
        except Exception:
            pass
        captured = act["steps"] - max(act["remaining"], 0)
        summary = parse_trace_dir(act["dir"])
        summary.update(
            run_dir=act["dir"], reason=act["reason"],
            start_step=act["start_step"],
            steps=captured, rank=process_rank() or 0,
            wall_ms=(time.perf_counter() - act["t0"]) * 1e3)
        try:
            with open(os.path.join(act["dir"],
                                   "profile_summary.json"), "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
        except OSError:
            pass
        from swiftmpi_tpu_torch import obs
        reg = obs.get_registry()
        reg.counter("profile/steps").inc(captured)
        for ph, v in summary["device_ms"].items():
            reg.gauge("profile/device_ms", phase=ph).set(v)
        for ph, v in summary["host_ms"].items():
            reg.gauge("profile/host_ms", phase=ph).set(v)
        for ph, v in summary["skew_ms"].items():
            reg.gauge("profile/skew_ms", phase=ph).set(v)
        rec = obs.get_recorder()
        if rec is not None:
            rec.event("profile/capture",
                      {k: summary[k] for k in
                       ("run_dir", "reason", "start_step", "steps",
                        "files", "events")})
        self.captures.append(summary)


def on_critical_anomaly(anomaly: dict) -> None:
    """Numerics-plane hook: a critical anomaly captures the very steps
    that misbehaved.  No-op unless a session with
    ``capture_on_anomaly`` is installed."""
    from swiftmpi_tpu_torch import obs
    sess = obs.get_profiler()
    if sess is not None and sess.capture_on_anomaly:
        sess.request(reason=f"anomaly:{anomaly.get('anomaly', '?')}")


def main(argv: Optional[list] = None) -> int:
    """``python -m swiftmpi_tpu_torch.obs.profiler <fleet_dir> [--steps N]``:
    request an N-step capture from every rank of a live fleet run."""
    import argparse
    ap = argparse.ArgumentParser(
        description="drop a profile trigger in a fleet dir")
    ap.add_argument("fleet_dir", help="the run's [obs] fleet_dir")
    ap.add_argument("--steps", type=int, default=5,
                    help="capture window length in consumed steps")
    args = ap.parse_args(argv)
    req = request_profile(args.fleet_dir, steps=args.steps)
    print(f"profile trigger id={req['id']} steps={req['steps']} "
          f"written to {os.path.join(args.fleet_dir, TRIGGER_FILENAME)}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
