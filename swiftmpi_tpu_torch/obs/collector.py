"""Fleet telemetry: merge per-rank streams into one cross-rank timeline
(the port's copy of ``swiftmpi_tpu/obs/collector.py``: host-only, the
same schemas; ``launch.py -fleet-dir`` fills a fleet directory from
every rank, and one process writes its stream there through
``[obs] fleet_dir``).

Every telemetry capability before this module observes exactly ONE
process — a :class:`~swiftmpi_tpu_torch.obs.recorder.StepRecorder` per rank,
one JSONL per rank.  The questions an N-process deployment actually
raises are *cross-rank*: which rank is the straggler, how skewed is the
wire load across shards, is any member stalled or dead.
:class:`FleetCollector` answers them by tailing the per-rank
``smtpu-telemetry/1`` streams (plus the supervisor's event log) in a
shared **fleet directory** and merging them into a schema-versioned
``smtpu-fleet/1`` timeline.

Fleet directory layout (the ``SMTPU_FLEET_DIR`` contract,
``obs/identity.py``):

* ``telemetry_r<rank>_p<pid>.jsonl`` — one stream per rank *life*: a
  supervisor restart keeps the rank and changes the pid, so pre- and
  post-restart streams coexist and the collector merges them into one
  member history (restart count = streams − 1).
* ``supervisor.jsonl`` — ``smtpu-fleet-sup/1`` events appended by
  ``launch.py``: spawn / exit (with normalized rc and whether the
  supervisor itself delivered the kill) / restart / world_start /
  world_exit.  These correlate a member's silence with *why* it went
  silent — a heartbeat gap WITH a supervisor exit event is a recorded
  death; a gap without one is an **unnoticed death**, which the budget
  gate treats as an observability failure.
* ``fleet.jsonl`` — the merged timeline :meth:`FleetCollector.
  write_timeline` emits (consumed by ``telemetry_report.py --fleet``
  and ``check_traffic_budget.py``).

Merge key: **consumed step**.  Per-rank wall clocks are reconstructed as
``meta.ts + record.t`` (the meta line carries ``time.time()`` at
recorder start; records carry monotonic seconds since start), so
cross-rank step alignment tolerates ragged process start times without
any clock-sync machinery — good to the NTP skew of one host, which is
exactly the supervised-local deployment this collector targets.

Health state machine (per member, evaluated at ``now`` = the newest
timestamp seen anywhere in the fleet, so post-hoc analysis of a
finished run does not read everything as dead):

``live`` --(no proof of life for stall_after_s)--> ``stalled``
--(proof resumes)--> ``live``; any state --(supervisor exit rc!=0 or
signal)--> ``dead``; any state --(exit rc==0)--> ``exited``; ``live``/
``stalled`` --(silence > dead_after_s, NO supervisor event)--> ``dead``
(flagged *unnoticed*).  Proof of life = any step record or heartbeat.

Skew metrics (see :meth:`FleetCollector.summary`):

* ``fleet/step_ms_skew`` — p50 over aligned steps of
  ``max(step_ms) − min(step_ms)`` across ranks; ``_pct`` normalizes by
  the fleet-median step time so gates survive hardware changes.
* ``fleet/wire_bytes_imbalance`` — ``max/mean − 1`` over per-rank
  cumulative wire bytes (0 = perfectly balanced), the per-parameter
  load-skew signal Parallax-style placement feeds on.
* straggler attribution — per aligned interval, the rank with the
  largest ``step_ms``; the fleet-level straggler is the rank with the
  largest *total* step time over the common range, flagged when it
  exceeds ``straggler_factor`` × the median rank's total.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

from swiftmpi_tpu_torch.obs.identity import ENV_FLEET_DIR  # noqa: F401
from swiftmpi_tpu_torch.obs.registry import parse_series_key

FLEET_SCHEMA = "smtpu-fleet/1"
FLEET_SCHEMA_V = 1
SUP_SCHEMA = "smtpu-fleet-sup/1"
SUPERVISOR_LOG = "supervisor.jsonl"
MERGED_TIMELINE = "fleet.jsonl"

_STREAM_GLOB = "telemetry_*.jsonl"
_STREAM_RE = re.compile(r"telemetry_(?:r(?P<rank>\d+)_)?p(?P<pid>\d+)\.jsonl$")


def stream_filename(rank: Optional[int], pid: int) -> str:
    """Per-life stream name: rank + pid together, so a restarted rank
    (same rank, new pid) opens a NEW file instead of interleaving with
    its previous life's tail."""
    if rank is None:
        return f"telemetry_p{pid}.jsonl"
    return f"telemetry_r{rank}_p{pid}.jsonl"


def repair_json_line(line: str) -> Optional[dict]:
    """Best-effort parse of a truncated JSON object line (a rank killed
    mid-``write``).  Balances any unterminated string and unclosed
    brackets, retrying progressively shorter prefixes until one parses;
    returns the dict (caller marks it ``repaired``) or None.  A twin of
    this function lives in scripts/telemetry_report.py, which must stay
    repo-import-free — keep the two in sync."""
    s = line.strip()
    if not s.startswith("{"):
        return None
    for cut in range(len(s), max(len(s) - 4096, 0), -1):
        prefix = s[:cut]
        stack: List[str] = []
        in_str = esc = False
        for ch in prefix:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = not in_str
            elif not in_str and ch in "{[":
                stack.append(ch)
            elif not in_str and ch in "}]":
                if not stack:
                    break
                stack.pop()
        else:
            if esc:
                continue
            closed = prefix + ('"' if in_str else "")
            for b in reversed(stack):
                closed += "}" if b == "{" else "]"
            try:
                obj = json.loads(closed)
            except ValueError:
                continue
            if isinstance(obj, dict):
                return obj
    return None


class SupervisorLog:
    """Append-only ``smtpu-fleet-sup/1`` event sink for ``launch.py``.

    One instance per *supervision* (it survives restart-the-world
    attempts); every event is flushed immediately — a supervisor that
    crashes must not take the crash evidence with it."""

    def __init__(self, fleet_dir: str):
        os.makedirs(fleet_dir, exist_ok=True)
        self.path = os.path.join(fleet_dir, SUPERVISOR_LOG)
        self._file = open(self.path, "a")

    def event(self, kind: str, **payload) -> dict:
        rec = {"v": FLEET_SCHEMA_V, "schema": SUP_SCHEMA,
               "kind": str(kind), "ts": time.time(), **payload}
        self._file.write(json.dumps(rec, sort_keys=True) + "\n")
        self._file.flush()
        return rec

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class _Stream:
    """Incremental tail state for one per-life telemetry JSONL."""

    def __init__(self, path: str):
        self.path = path
        self.pos = 0
        self.carry = b""
        self.meta: Optional[dict] = None
        self.rank: Optional[int] = None
        self.pid: Optional[int] = None
        self.ident: Optional[str] = None
        self.t0 = 0.0                       # wall clock at recorder start
        self.records: List[dict] = []       # step records, t_abs added
        self.events: List[dict] = []        # control/... out-of-band lines
        self.heartbeats: List[float] = []   # wall-clock ts
        self.summary: Optional[dict] = None
        self.first_seen: Optional[float] = None
        self.last_seen: Optional[float] = None
        self.dropped = 0
        self.recovered = 0
        m = _STREAM_RE.search(os.path.basename(path))
        if m:
            self.pid = int(m.group("pid"))
            if m.group("rank") is not None:
                self.rank = int(m.group("rank"))

    # -- tailing -----------------------------------------------------------
    def poll(self, final: bool = False) -> int:
        """Consume newly appended complete lines; with ``final`` also
        repair-parse a truncated trailing line.  Returns records read."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self.pos)
                chunk = f.read()
        except OSError:
            return 0
        self.pos += len(chunk)
        data = self.carry + chunk
        lines = data.split(b"\n")
        self.carry = lines.pop()            # incomplete tail (or b"")
        n = 0
        for raw in lines:
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                self.dropped += 1
                continue
            if isinstance(rec, dict):
                self._ingest(rec)
                n += 1
        if final and self.carry.strip():
            rec = repair_json_line(self.carry.decode("utf-8", "replace"))
            self.carry = b""
            if rec is not None:
                rec["repaired"] = True
                self._ingest(rec)
                self.recovered += 1
                n += 1
            else:
                self.dropped += 1
        return n

    def _mark_seen(self, t: float) -> None:
        if self.first_seen is None or t < self.first_seen:
            self.first_seen = t
        if self.last_seen is None or t > self.last_seen:
            self.last_seen = t

    def _ingest(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "meta":
            self.meta = rec
            self.t0 = float(rec.get("ts", 0.0))
            if rec.get("rank") is not None:
                self.rank = int(rec["rank"])
            if rec.get("pid") is not None:
                self.pid = int(rec["pid"])
            self.ident = rec.get("ident")
            self._mark_seen(self.t0)
        elif kind == "step":
            rec["t_abs"] = self.t0 + float(rec.get("t", 0.0))
            self.records.append(rec)
            self._mark_seen(rec["t_abs"])
        elif kind == "heartbeat":
            ts = float(rec.get("ts", self.t0 + float(rec.get("t", 0.0))))
            self.heartbeats.append(ts)
            self._mark_seen(ts)
        elif kind == "summary":
            self.summary = rec
            self._mark_seen(self.t0 + float(rec.get("elapsed_s", 0.0)))
        else:
            rec["t_abs"] = self.t0 + float(rec.get("t", 0.0))
            self.events.append(rec)
            self._mark_seen(rec["t_abs"])

    @property
    def member_key(self) -> str:
        """Merge key: the RANK (stable across restarts), falling back to
        the ident/pid for bare unlaunched processes."""
        if self.rank is not None:
            return str(self.rank)
        return self.ident or f"p{self.pid or 0}"


class FleetCollector:
    """Tail every stream in ``fleet_dir``; merge into one timeline.

    ``poll()`` is incremental and cheap — the live inspector calls it in
    a refresh loop; post-hoc consumers call ``poll(final=True)`` once to
    also repair-parse truncated tails.  All analysis methods
    (:meth:`members`, :meth:`health`, :meth:`aligned`, :meth:`summary`,
    :meth:`timeline`) are pure reads over the ingested state.
    """

    def __init__(self, fleet_dir: str, stall_after_s: float = 5.0,
                 dead_after_s: float = 15.0,
                 straggler_factor: float = 1.3):
        if dead_after_s < stall_after_s:
            raise ValueError("dead_after_s must be >= stall_after_s")
        self.dir = fleet_dir
        self.stall_after_s = float(stall_after_s)
        self.dead_after_s = float(dead_after_s)
        self.straggler_factor = float(straggler_factor)
        self._streams: Dict[str, _Stream] = {}
        self._sup = _Stream(os.path.join(fleet_dir, SUPERVISOR_LOG))
        self._sup_events: List[dict] = []
        self._polls = 0

    # -- ingest ------------------------------------------------------------
    def poll(self, final: bool = False) -> int:
        """Discover new streams, tail everything; returns records read."""
        self._polls += 1
        n = 0
        for path in sorted(glob.glob(os.path.join(self.dir,
                                                  _STREAM_GLOB))):
            if path not in self._streams:
                self._streams[path] = _Stream(path)
            n += self._streams[path].poll(final=final)
        n += self._poll_supervisor(final=final)
        return n

    def _poll_supervisor(self, final: bool = False) -> int:
        s = self._sup
        before = len(s.events)
        s.poll(final=final)
        # supervisor lines carry their own wall clock; _ingest routed
        # them into .events (no meta line in the supervisor log)
        new = s.events[before:]
        for rec in new:
            rec.pop("t_abs", None)
            self._sup_events.append(rec)
        return len(new)

    @property
    def supervisor_events(self) -> List[dict]:
        return list(self._sup_events)

    # -- membership --------------------------------------------------------
    def members(self) -> Dict[str, dict]:
        """Per-member merged history: streams ordered by start time, so
        a restarted rank's lives concatenate into one record.  Restart
        count is derived (streams − 1) and cross-checked against the
        supervisor's spawn events when present."""
        by_key: Dict[str, List[_Stream]] = {}
        for s in self._streams.values():
            if s.meta is None and not s.records and not s.heartbeats:
                continue                    # empty/unborn stream
            by_key.setdefault(s.member_key, []).append(s)
        out: Dict[str, dict] = {}
        for key, streams in by_key.items():
            streams.sort(key=lambda s: (s.first_seen or 0.0, s.path))
            steps = [r for s in streams for r in s.records]
            hb = sorted(t for s in streams for t in s.heartbeats)
            exits = self._exits_for(key, streams)
            out[key] = {
                "rank": streams[-1].rank,
                "ident": streams[-1].ident or key,
                "pids": [s.pid for s in streams],
                "streams": [s.path for s in streams],
                "restarts": len(streams) - 1,
                "records": len(steps),
                "heartbeats": len(hb),
                "first_step": min((int(r["step"]) for r in steps),
                                  default=None),
                "last_step": max((int(r["step"]) for r in steps),
                                 default=None),
                "first_seen": streams[0].first_seen,
                "last_seen": max((s.last_seen or 0.0) for s in streams),
                "clean_summary": streams[-1].summary is not None,
                "recovered": sum(s.recovered for s in streams),
                "dropped": sum(s.dropped for s in streams),
                "exits": exits,
                "_streams": streams,
            }
            out[key]["last_window"] = self._last_window(out[key])
        return out

    def _exits_for(self, key: str, streams: List[_Stream]) -> List[dict]:
        pids = {s.pid for s in streams if s.pid is not None}
        exits = []
        for ev in self._sup_events:
            if ev.get("kind") != "exit":
                continue
            if str(ev.get("rank")) == key or ev.get("pid") in pids:
                exits.append({"ts": ev.get("ts"), "pid": ev.get("pid"),
                              "rc": ev.get("rc"),
                              "by_supervisor":
                                  bool(ev.get("by_supervisor"))})
        exits.sort(key=lambda e: e["ts"] or 0.0)
        return exits

    # -- health ------------------------------------------------------------
    def now(self) -> float:
        """Evaluation instant: the newest timestamp seen anywhere — so
        analyzing a finished run judges members against the run's own
        end, not against the analyst's wall clock."""
        ts = [s.last_seen for s in self._streams.values()
              if s.last_seen is not None]
        ts += [ev.get("ts", 0.0) for ev in self._sup_events]
        return max(ts) if ts else time.time()

    @staticmethod
    def _proof_times(member: dict) -> List[float]:
        times: List[float] = []
        for s in member["_streams"]:
            times.extend(r["t_abs"] for r in s.records)
            times.extend(s.heartbeats)
            if s.first_seen is not None:
                times.append(s.first_seen)
        return sorted(times)

    def stall_episodes(self, member: dict) -> List[dict]:
        """INNER proof-of-life gaps longer than ``stall_after_s`` — the
        member went quiet and came back.  The trailing gap is death
        territory and handled by :meth:`health` instead."""
        times = self._proof_times(member)
        out = []
        for a, b in zip(times, times[1:]):
            if b - a > self.stall_after_s:
                out.append({"t0": a, "t1": b, "gap_s": b - a})
        return out

    def health(self, at: Optional[float] = None) -> Dict[str, str]:
        """``live`` / ``stalled`` / ``dead`` / ``exited`` per member (see
        module docstring for the state machine)."""
        at = self.now() if at is None else at
        out = {}
        for key, m in self.members().items():
            last_pid = next((p for p in reversed(m["pids"])
                             if p is not None), None)
            exit_ev = next((e for e in reversed(m["exits"])
                            if last_pid is None or e["pid"] == last_pid),
                           None)
            if exit_ev is not None:
                out[key] = "exited" if exit_ev["rc"] == 0 else "dead"
                continue
            age = at - m["last_seen"]
            if age > self.dead_after_s:
                out[key] = "dead"
            elif age > self.stall_after_s:
                out[key] = "stalled"
            else:
                out[key] = "live"
        return out

    def unnoticed_deaths(self, at: Optional[float] = None) -> List[str]:
        """Members whose heartbeat gap says dead but for which the
        supervisor recorded NO exit event — the fleet lost a rank and
        nothing noticed.  The budget gate fails the run on these."""
        at = self.now() if at is None else at
        health = self.health(at)
        return [key for key, m in self.members().items()
                if health[key] == "dead" and not m["exits"]]

    # -- cross-rank step alignment ----------------------------------------
    @staticmethod
    def _per_step(member: dict) -> Dict[int, Tuple[float, float, float]]:
        """step -> (t_abs, step_ms, cumulative wire bytes).  Later lives
        overwrite overlapping steps (a resumed rank re-runs them)."""
        out: Dict[int, Tuple[float, float, float]] = {}
        for s in member["_streams"]:
            prev_t: Optional[float] = None
            wire = 0.0
            for r in s.records:
                for ckey, delta in (r.get("counters") or {}).items():
                    name, _ = parse_series_key(ckey)
                    if name == "transfer/wire_bytes":
                        wire += float(delta)
                steps = max(int(r.get("steps", 1)), 1)
                t = r["t_abs"]
                ms = ((t - prev_t) / steps * 1e3
                      if prev_t is not None else 0.0)
                out[int(r["step"])] = (t, ms, wire)
                prev_t = t
        return out

    def aligned(self) -> List[dict]:
        """One row per consumed step present in >= 2 members: per-rank
        arrival time / step_ms / cumulative wire, plus the row's skew
        and slowest-rank attribution."""
        per = {key: self._per_step(m)
               for key, m in self.members().items()}
        counts: Dict[int, int] = {}
        for table in per.values():
            for step in table:
                counts[step] = counts.get(step, 0) + 1
        rows = []
        for step in sorted(s for s, c in counts.items() if c >= 2):
            t = {k: v[step][0] for k, v in per.items() if step in v}
            ms = {k: v[step][1] for k, v in per.items() if step in v}
            wire = {k: v[step][2] for k, v in per.items() if step in v}
            timed = {k: v for k, v in ms.items() if v > 0.0}
            row = {"step": step, "t": t, "step_ms": ms, "wire": wire}
            if timed:
                slowest = max(timed, key=timed.get)
                row["skew_ms"] = max(timed.values()) - min(timed.values())
                row["slowest"] = slowest
            rows.append(row)
        return rows

    # -- numerics health (obs/numerics.py, ISSUE 13) -----------------------
    @staticmethod
    def _member_anomalies(member: dict) -> Dict[str, int]:
        """``numerics/anomaly`` event counts by severity for one member
        (the stream ingest routes event lines into ``s.events``)."""
        out: Dict[str, int] = {}
        for s in member["_streams"]:
            for ev in s.events:
                if ev.get("kind") != "numerics/anomaly":
                    continue
                sev = str(ev.get("severity", "warning"))
                out[sev] = out.get(sev, 0) + 1
        return out

    @staticmethod
    def _grad_norms(member: dict) -> Dict[int, float]:
        """step -> latest ``numerics/grad_norm`` gauge; later lives
        overwrite overlapping steps, like :meth:`_per_step`."""
        out: Dict[int, float] = {}
        for s in member["_streams"]:
            for r in s.records:
                for gkey, v in (r.get("gauges") or {}).items():
                    name, _ = parse_series_key(gkey)
                    if name == "numerics/grad_norm":
                        out[int(r["step"])] = float(v)
        return out

    def numerics_divergence(self) -> List[dict]:
        """Cross-rank grad-norm divergence anomalies over the aligned
        steps — the fleet half of the numerics health plane."""
        from swiftmpi_tpu_torch.obs import numerics as obs_numerics
        per_step: Dict[int, Dict[str, float]] = {}
        for key, m in self.members().items():
            for step, v in self._grad_norms(m).items():
                per_step.setdefault(step, {})[key] = v
        return obs_numerics.cross_rank_divergence(per_step)

    # -- wire-trace correlation (obs/trace.py, ISSUE 15) -------------------
    @staticmethod
    def _member_trace_windows(member: dict) -> Dict[int, dict]:
        """win id -> latest ``trace/window`` event for one member (the
        tracer mirrors each finalized record onto the recorder's event
        stream when a fleet dir is armed); later lives overwrite."""
        out: Dict[int, dict] = {}
        for s in member["_streams"]:
            for ev in s.events:
                if ev.get("kind") != "trace/window":
                    continue
                try:
                    out[int(ev["win"])] = ev
                except (KeyError, TypeError, ValueError):
                    continue
        return out

    def window_correlation(self) -> List[dict]:
        """One row per window id traced by >= 2 members: per-rank
        arrival time / encoded bytes / surviving rows, the cross-rank
        arrival spread, and last-to-arrive attribution.  Window ids are
        per-rank monotonic over the same consumed-step sequence, so
        equal ids across ranks are the same logical exchange — the
        causal join key the per-rank ledgers cannot provide."""
        per = {key: self._member_trace_windows(m)
               for key, m in self.members().items()}
        counts: Dict[int, int] = {}
        for table in per.values():
            for win in table:
                counts[win] = counts.get(win, 0) + 1
        rows = []
        for win in sorted(w for w, c in counts.items() if c >= 2):
            evs = {k: v[win] for k, v in per.items() if win in v}
            t = {k: float(e.get("t_abs", 0.0)) for k, e in evs.items()}
            row = {
                "win": win,
                "step": max((int(e.get("step", 0))
                             for e in evs.values()), default=0),
                "backend": next(iter({str(e.get("backend"))
                                      for e in evs.values()}), None),
                "decision": sorted({str(e.get("decision"))
                                    for e in evs.values()}),
                "t": t,
                "enc_bytes": {k: int(e.get("enc_bytes", 0))
                              for k, e in evs.items()},
                "rows_out": {k: int(e.get("rows_out", 0))
                             for k, e in evs.items()},
            }
            if t:
                row["spread_ms"] = (max(t.values()) - min(t.values())) \
                    * 1e3
                row["last_rank"] = max(t, key=t.get)
            rows.append(row)
        return rows

    @staticmethod
    def _last_window(member: dict) -> Optional[dict]:
        """Most recent traced window for one member — smtpu_top's WIN
        column ({win, t_abs}), None when the member never traced."""
        table = FleetCollector._member_trace_windows(member)
        if not table:
            return None
        win = max(table)
        return {"win": win,
                "t_abs": float(table[win].get("t_abs", 0.0))}

    # -- elastic membership (cluster/membership.py, ISSUE 16) --------------
    @staticmethod
    def _member_epochs(member: dict) -> Dict[int, int]:
        """step -> adopted ``elastic/epoch`` gauge for one member; later
        lives overwrite overlapping steps, like :meth:`_per_step`."""
        out: Dict[int, int] = {}
        for s in member["_streams"]:
            for r in s.records:
                for gkey, v in (r.get("gauges") or {}).items():
                    name, _ = parse_series_key(gkey)
                    if name == "elastic/epoch":
                        out[int(r["step"])] = int(v)
        return out

    def elastic_view(self, at: Optional[float] = None) -> Optional[dict]:
        """Fleet digest of the elastic membership plane, or None when no
        member ever published ``elastic/epoch`` (a static world).

        * ``fleet_epoch`` — the highest epoch any member adopted.
        * ``fleet_reconverge_steps`` — over the members that reached
          ``fleet_epoch``, the spread between the first and the last
          member's first step at it: how long the world took to agree
          on the final membership.  None while a LIVE member still
          hasn't caught up (reconvergence not yet provable).
        * ``migration_bytes`` — total modeled delta traffic
          (``elastic/migration_bytes`` counter) across all members: the
          cost of every adoption and rejoin, priced by the same PR-10
          byte model as training traffic.
        """
        at = self.now() if at is None else at
        members = self.members()
        epochs = {k: self._member_epochs(m) for k, m in members.items()}
        if not any(epochs.values()):
            return None
        fleet_epoch = max(max(t.values()) for t in epochs.values() if t)
        first_at = {k: min(s for s, e in t.items() if e == fleet_epoch)
                    for k, t in epochs.items()
                    if t and fleet_epoch in t.values()}
        health = self.health(at)
        laggards = [k for k, t in epochs.items()
                    if t and k not in first_at
                    and health.get(k) in ("live", "stalled")]
        reconverge = (max(first_at.values()) - min(first_at.values())
                      if first_at and not laggards else None)
        mig = 0.0
        for m in members.values():
            for s in m["_streams"]:
                for r in s.records:
                    for ckey, delta in (r.get("counters") or {}).items():
                        name, _ = parse_series_key(ckey)
                        if name == "elastic/migration_bytes":
                            mig += float(delta)
        return {"fleet_epoch": fleet_epoch,
                "fleet_reconverge_steps": reconverge,
                "migration_bytes": int(mig),
                "epoch_first_step": first_at,
                "laggards": laggards}

    # -- serve fleet plane (serve/shipper.py, ISSUE 17) --------------------
    @staticmethod
    def _member_serve(member: dict) -> Optional[dict]:
        """One member's serving digest, or None when it never published
        a ``serve/*`` series.  Role comes from which side of the ship
        stream the member booked: ``serve/ship_version`` → trainer,
        ``serve/replica_version`` → replica."""
        gauges: Dict[str, float] = {}
        counters: Dict[str, float] = {}
        bounds = None
        hist_counts: Optional[List[int]] = None
        for s in member["_streams"]:
            for r in s.records:
                for gkey, v in (r.get("gauges") or {}).items():
                    name, _ = parse_series_key(gkey)
                    if name.startswith("serve/"):
                        gauges[name] = float(v)     # last write wins
                for ckey, delta in (r.get("counters") or {}).items():
                    name, _ = parse_series_key(ckey)
                    if name.startswith("serve/"):
                        counters[name] = (counters.get(name, 0.0)
                                          + float(delta))
                for hkey, h in (r.get("hists") or {}).items():
                    name, _ = parse_series_key(hkey)
                    if name != "serve/latency_ms":
                        continue
                    if h.get("bounds") is not None:
                        bounds = list(h["bounds"])
                    cs = h.get("counts") or []
                    if hist_counts is None:
                        hist_counts = list(cs)
                    else:
                        for i, c in enumerate(cs):
                            hist_counts[i] += c
        if not gauges and not counters:
            return None
        role = ("trainer" if "serve/ship_version" in gauges
                else "replica" if "serve/replica_version" in gauges
                or "serve/queries" in counters else None)
        span_s = max((member["last_seen"] or 0.0)
                     - (member["first_seen"] or 0.0), 1e-9)
        queries = counters.get("serve/queries", 0.0)
        hits = counters.get("serve/hits", 0.0)
        rows = counters.get("serve/rows_read", 0.0)
        p50 = p99 = None
        if bounds is not None and hist_counts:
            from swiftmpi_tpu_torch.obs.registry import quantile_from_buckets
            p50 = quantile_from_buckets(bounds, hist_counts, 0.50)
            p99 = quantile_from_buckets(bounds, hist_counts, 0.99)
        return {
            "role": role,
            "version": gauges.get("serve/replica_version",
                                  gauges.get("serve/ship_version")),
            "lag": gauges.get("serve/replica_lag"),
            "staleness_s": gauges.get("serve/staleness_s"),
            "queries": int(queries),
            "qps": queries / span_s,
            "p50_ms": p50, "p99_ms": p99,
            "hit_ratio": (hits / rows) if rows else None,
            "delta_publishes": int(
                counters.get("serve/delta_publishes", 0)),
            "full_publishes": int(
                counters.get("serve/full_publishes", 0)),
            "delta_bytes": int(counters.get("serve/delta_bytes", 0)),
            "full_bytes": int(counters.get("serve/full_bytes", 0)),
        }

    def serve_view(self, at: Optional[float] = None) -> Optional[dict]:
        """Fleet digest of the serve-fleet plane, or None when no member
        published ``serve/*`` (a training-only world).  Aggregate qps
        sums the replica readers; version/lag expose the delta-chain
        replay state the staleness bound rides on."""
        members = self.members()
        per = {k: v for k, m in members.items()
               if (v := self._member_serve(m)) is not None}
        if not per:
            return None
        replicas = [k for k, v in per.items() if v["role"] == "replica"]
        versions = [v["version"] for v in per.values()
                    if v["version"] is not None]
        lags = [v["lag"] for v in per.values() if v["lag"] is not None]
        stale = [v["staleness_s"] for v in per.values()
                 if v["staleness_s"] is not None]
        return {
            "members": per,
            "serve_replicas": len(replicas),
            "serve_qps_total": sum(
                per[k]["qps"] for k in replicas),
            "serve_version": max(versions) if versions else None,
            "serve_lag_max": max(lags) if lags else 0.0,
            "serve_staleness_max_s": max(stale) if stale else 0.0,
            "delta_publishes": sum(
                v["delta_publishes"] for v in per.values()),
            "full_publishes": sum(
                v["full_publishes"] for v in per.values()),
            "delta_bytes": sum(v["delta_bytes"] for v in per.values()),
            "full_bytes": sum(v["full_bytes"] for v in per.values()),
        }

    # -- fleet summary -----------------------------------------------------
    @staticmethod
    def _p50(vals: List[float]) -> float:
        if not vals:
            return 0.0
        vs = sorted(vals)
        return vs[len(vs) // 2]

    def summary(self, at: Optional[float] = None) -> dict:
        at = self.now() if at is None else at
        members = self.members()
        health = self.health(at)
        rows = self.aligned()
        skews = [r["skew_ms"] for r in rows if "skew_ms" in r]
        all_ms = [v for r in rows for v in r["step_ms"].values() if v > 0]
        skew_ms = self._p50(skews)
        med_ms = self._p50(all_ms)
        # Straggler attribution sums step time over the COMMON aligned
        # range only — rows where every reporting member is present.  A
        # killed rank has fewer rows than the survivors; comparing raw
        # totals over unequal ranges would crown whoever ran longest,
        # not whoever ran slowest.  (Falls back to all rows when the
        # members never fully overlap.)
        per_tables = {k: self._per_step(m) for k, m in members.items()}
        reporting = {k for k, t in per_tables.items() if t}
        common = [r for r in rows if set(r["t"]) >= reporting] or rows
        totals = {}                        # total step time per member
        for r in common:
            for k, v in r["step_ms"].items():
                totals[k] = totals.get(k, 0.0) + v
        straggler = None
        straggler_score = 0.0
        if len(totals) >= 2:
            worst = max(totals, key=totals.get)
            med_total = self._p50(list(totals.values()))
            if med_total > 0:
                straggler_score = totals[worst] / med_total
                if straggler_score >= self.straggler_factor:
                    straggler = worst
        wire_totals = {}
        for key, table in per_tables.items():
            wire_totals[key] = (max(v[2] for v in table.values())
                                if table else 0.0)
        imbalance = 0.0
        positive = [v for v in wire_totals.values()]
        if positive and max(positive) > 0:
            mean = sum(positive) / len(positive)
            if mean > 0:
                imbalance = max(positive) / mean - 1.0
        unnoticed = self.unnoticed_deaths(at)
        anomalies = {k: self._member_anomalies(m)
                     for k, m in members.items()}
        divergence = self.numerics_divergence()
        return {
            "v": FLEET_SCHEMA_V, "kind": "summary",
            "schema": FLEET_SCHEMA,
            "run": os.path.basename(os.path.normpath(self.dir)) or "fleet",
            "ranks": sorted(members),
            "at": at,
            "aligned_steps": len(rows),
            "last_step": {k: m["last_step"] for k, m in members.items()},
            "step_ms_p50": {k: self._p50(
                [v[1] for v in table.values() if v[1] > 0])
                for k, table in per_tables.items()},
            "fleet_step_ms_skew_ms": skew_ms,
            "fleet_step_ms_skew_pct": (100.0 * skew_ms / med_ms
                                       if med_ms > 0 else 0.0),
            "fleet_wire_bytes_imbalance": imbalance,
            "wire_bytes": wire_totals,
            "straggler_rank": straggler,
            "straggler_score": straggler_score,
            "health": health,
            "restarts": {k: m["restarts"] for k, m in members.items()},
            "heartbeats": {k: m["heartbeats"]
                           for k, m in members.items()},
            "recovered": sum(m["recovered"] for m in members.values()),
            "dropped": sum(m["dropped"] for m in members.values()),
            "unnoticed_deaths": unnoticed,
            # numerics health plane (obs/numerics.py)
            "numerics_anomalies": {k: v for k, v in anomalies.items()
                                   if v},
            "numerics_anomaly_total": sum(
                sum(v.values()) for v in anomalies.values()),
            "numerics_critical_total": sum(
                v.get("critical", 0) for v in anomalies.values()),
            "fleet_grad_norm_divergence": max(
                (d["ratio"] for d in divergence), default=0.0),
            "cross_rank_anomalies": len(divergence),
            # wire-trace plane (obs/trace.py): window records joined on
            # the per-rank-monotonic window id
            "trace_windows_correlated": len(self.window_correlation()),
            "last_window": {k: m["last_window"]
                            for k, m in members.items()},
        } | ({
            # elastic membership plane (ISSUE 16) — keys only appear
            # when some member published elastic/epoch, so static-world
            # summaries (and their goldens) are unchanged
            "fleet_epoch": ev["fleet_epoch"],
            "fleet_reconverge_steps": ev["fleet_reconverge_steps"],
            "migration_bytes": ev["migration_bytes"],
        } if (ev := self.elastic_view(at)) is not None else {}) | ({
            # serve-fleet plane (ISSUE 17) — same conditional-merge
            # contract: training-only summaries are byte-identical
            "serve_replicas": sv["serve_replicas"],
            "serve_qps_total": sv["serve_qps_total"],
            "serve_version": sv["serve_version"],
            "serve_lag_max": sv["serve_lag_max"],
            "serve_staleness_max_s": sv["serve_staleness_max_s"],
            "serve_delta_publishes": sv["delta_publishes"],
            "serve_full_publishes": sv["full_publishes"],
            "serve_delta_bytes": sv["delta_bytes"],
            "serve_full_bytes": sv["full_bytes"],
        } if (sv := self.serve_view(at)) is not None else {})

    # -- merged timeline ---------------------------------------------------
    def _health_transitions(self, at: float) -> List[dict]:
        """Reconstructed per-member health-transition events, correlated
        with the supervisor evidence: the ``live -> dead`` line for a
        killed rank carries its exit's rc/by_supervisor payload."""
        out = []
        health = self.health(at)
        for key, m in self.members().items():
            out.append({"v": FLEET_SCHEMA_V, "kind": "health",
                        "rank": key, "to": "live",
                        "t": m["first_seen"]})
            for ep in self.stall_episodes(m):
                out.append({"v": FLEET_SCHEMA_V, "kind": "health",
                            "rank": key, "to": "stalled", "t": ep["t0"],
                            "gap_s": ep["gap_s"]})
                out.append({"v": FLEET_SCHEMA_V, "kind": "health",
                            "rank": key, "to": "live", "t": ep["t1"]})
            state = health[key]
            if state in ("dead", "exited"):
                ev = m["exits"][-1] if m["exits"] else None
                out.append({
                    "v": FLEET_SCHEMA_V, "kind": "health", "rank": key,
                    "to": state,
                    "t": (ev["ts"] if ev else m["last_seen"]),
                    "exit": ev,
                    "unnoticed": ev is None and state == "dead"})
        out.sort(key=lambda e: e.get("t") or 0.0)
        return out

    def timeline(self, max_rows: Optional[int] = None) -> List[dict]:
        """The full merged ``smtpu-fleet/1`` record list: meta, member
        summaries, supervisor events, health transitions, per-step
        aligned rows (optionally capped to the LAST ``max_rows``), and
        the fleet summary."""
        at = self.now()
        members = self.members()
        meta = {"v": FLEET_SCHEMA_V, "kind": "meta",
                "schema": FLEET_SCHEMA,
                "run": os.path.basename(os.path.normpath(self.dir))
                or "fleet",
                "dir": self.dir, "generated_ts": time.time(),
                "ranks": sorted(members),
                "streams": sum(len(m["streams"])
                               for m in members.values())}
        recs: List[dict] = [meta]
        health = self.health(at)
        for key in sorted(members):
            m = members[key]
            recs.append({
                "v": FLEET_SCHEMA_V, "kind": "member", "rank": key,
                "ident": m["ident"], "pids": m["pids"],
                "restarts": m["restarts"], "records": m["records"],
                "heartbeats": m["heartbeats"],
                "first_step": m["first_step"],
                "last_step": m["last_step"],
                "health": health[key], "exits": m["exits"],
                "stall_episodes": self.stall_episodes(m),
                "anomalies": self._member_anomalies(m),
                "recovered": m["recovered"], "dropped": m["dropped"]})
        for ev in self._sup_events:
            recs.append({**ev, "kind": "sup/" + str(ev.get("kind"))})
        recs.extend(self._health_transitions(at))
        for d in self.numerics_divergence():
            recs.append({"v": FLEET_SCHEMA_V,
                         "kind": "numerics/cross_rank", **d})
        wrows = self.window_correlation()
        if max_rows is not None and len(wrows) > max_rows:
            wrows = wrows[-max_rows:]
        for row in wrows:
            recs.append({"v": FLEET_SCHEMA_V, "kind": "trace/window_corr",
                         **row})
        rows = self.aligned()
        if max_rows is not None and len(rows) > max_rows:
            rows = rows[-max_rows:]
        for row in rows:
            recs.append({"v": FLEET_SCHEMA_V, "kind": "fleet_step",
                         **row})
        recs.append(self.summary(at))
        return recs

    def write_timeline(self, path: Optional[str] = None,
                       max_rows: Optional[int] = None) -> str:
        path = path or os.path.join(self.dir, MERGED_TIMELINE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for rec in self.timeline(max_rows=max_rows):
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    # -- registry mirror ---------------------------------------------------
    def mirror_to_registry(self) -> None:
        """Publish the fleet gauges into this process's obs registry (one
        branch when telemetry is off) — the inspector process's own
        telemetry then carries the fleet view like any other series."""
        from swiftmpi_tpu_torch import obs
        reg = obs.get_registry()
        if not reg.enabled:
            return
        s = self.summary()
        reg.gauge("fleet/step_ms_skew").set(s["fleet_step_ms_skew_ms"])
        reg.gauge("fleet/wire_bytes_imbalance").set(
            s["fleet_wire_bytes_imbalance"])
        health = s["health"]
        reg.gauge("fleet/members_live").set(
            sum(1 for v in health.values() if v == "live"))
        reg.gauge("fleet/members_stalled").set(
            sum(1 for v in health.values() if v == "stalled"))
        reg.gauge("fleet/members_dead").set(
            sum(1 for v in health.values() if v == "dead"))
        reg.gauge("fleet/straggler_rank").set(
            float(s["straggler_rank"])
            if s["straggler_rank"] is not None and
            str(s["straggler_rank"]).isdigit() else -1.0)
        reg.gauge("fleet/grad_norm_divergence").set(
            s["fleet_grad_norm_divergence"])
        reg.gauge("fleet/anomalies").set(
            float(s["numerics_anomaly_total"]))
        if "fleet_epoch" in s:
            reg.gauge("fleet/epoch").set(float(s["fleet_epoch"]))
            reg.gauge("fleet/migration_bytes").set(
                float(s["migration_bytes"]))
            if s["fleet_reconverge_steps"] is not None:
                reg.gauge("fleet/reconverge_steps").set(
                    float(s["fleet_reconverge_steps"]))
        if "serve_replicas" in s:
            reg.gauge("fleet/serve_replicas").set(
                float(s["serve_replicas"]))
            reg.gauge("fleet/serve_qps").set(float(s["serve_qps_total"]))
            reg.gauge("fleet/serve_lag_max").set(
                float(s["serve_lag_max"]))
            if s["serve_version"] is not None:
                reg.gauge("fleet/serve_version").set(
                    float(s["serve_version"]))
