"""Cross-process snapshot shipping: delta-encoded serving replication
(counterpart of ``swiftmpi_tpu/serve/shipper.py``).

The publisher bounds read staleness *inside one process*; this module
moves the same versioned snapshots across process boundaries so
N replica readers can serve aggregate qps no single core can.  Two
halves:

* :class:`SnapshotShipper` — trainer side.  Takes the
  :class:`~swiftmpi_tpu_torch.serve.snapshot.TableSnapshot` the publisher
  already host-copied and persists it into a ship directory as a
  **version-chained stream**: a ``full`` base (raw planes + key map)
  followed by ``delta`` publishes carrying only the rows that changed
  since the previous publish, each plane priced through the shared
  row-delta codec (:mod:`swiftmpi_tpu_torch.transfer.delta` — sparse vs bitmap
  vs sparse_q over the touched-row set; the ``dense`` decision means
  "ship a fresh full base instead").  Fallback-to-full rules: first
  publish, any plane capacity / ``n_hot`` / field-set change (a
  ``grow()`` or repartition), a key→slot remap that is not a pure
  append, an over-crossover touched set, or the ``full_every`` chain
  cap.  Versions stay monotone across trainer restarts: a new shipper
  over a non-empty dir resumes after the manifest tail (forced full —
  the restarted trainer has no diff base).
* :class:`SnapshotReplica` — reader side.  Tails the manifest, replays
  base + deltas into a reconstructed host table, and exposes the
  publisher's reader surface (``latest`` / ``require`` /
  ``wait_for_version`` / ``train_step`` / ``staleness_steps``) so the
  existing :class:`~swiftmpi_tpu_torch.serve.reader.EmbeddingReader` — hot
  head materialized, tail behind ``LruTailFront`` — runs against it
  unchanged.  Each applied version builds a NEW immutable
  :class:`TableSnapshot` (copy-on-apply scatter), so query threads in
  the replica process never observe a torn row, exactly the in-process
  publisher's contract.

Deltas carry **absolute row images**, not additive diffs: a
``sparse_q`` publish leaves at most one quantization step of error on
a row, and the next touch of that row re-ships it losslessly-or-fresh
— error never accumulates along the chain.

Everything here is pure host (numpy + npz + a JSONL manifest), with no
``torch`` import (``tests/test_torch_isolation.py``): replicas never
touch the device.  File protocol: ``ship_v<version>.npz``
written with :func:`~swiftmpi_tpu_torch.transfer.delta.atomic_savez` BEFORE
its ``smtpu-ship/1`` manifest line is appended (O_APPEND + fsync), so
a reader that can parse a line can always open its payload; a torn
trailing line (trainer died mid-append) is ignored until complete.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.serve.snapshot import TableSnapshot
from swiftmpi_tpu_torch.transfer.delta import (atomic_savez, decode_delta,
                                               delta_wire_bytes,
                                               encode_delta)
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

MANIFEST = "ship_manifest.jsonl"
SHIP_SCHEMA = "smtpu-ship/1"

#: modeled bytes of one key→slot pair on the wire (u64 key + i32 slot)
_PAIR_BYTES = 12


def _payload_path(ship_dir: str, version: int) -> str:
    return os.path.join(ship_dir, f"ship_v{version}.npz")


def _full_model_bytes(state: Dict[str, np.ndarray], n_keys: int) -> int:
    """Byte model of a full snapshot: every plane dense (f32) plus the
    whole key map — the denominator of the delta-vs-full headline."""
    planes = sum(int(v.shape[0]) * int(v.shape[1]) * 4
                 for v in state.values())
    return planes + n_keys * _PAIR_BYTES


class SnapshotShipper:
    """Trainer-side writer of the version-chained ship stream.

    Single-threaded like the publisher it rides (``ship`` is called
    from the trainer thread, right after ``publish``); holds the last
    shipped snapshot's planes as its diff base.
    """

    def __init__(self, ship_dir: str, quant: str = "int8",
                 full_every: int = 0):
        self.ship_dir = ship_dir
        self.quant = quant
        #: force a fresh full base every N publishes (0 = only when the
        #: fallback rules demand one); bounds a late joiner's replay
        self.full_every = int(full_every)
        os.makedirs(ship_dir, exist_ok=True)
        self._last: Optional[TableSnapshot] = None
        self._version = 0
        self._since_full = 0
        self._resume()

    # -- restart resumption ------------------------------------------------
    def _resume(self) -> None:
        tail = read_manifest(self.ship_dir)
        if tail:
            # a restarted trainer continues the replicas' version stream
            # instead of rewinding it; with no in-memory diff base the
            # next publish is forcibly full
            self._version = int(tail[-1]["version"])
            log.info("shipper resuming after v%d in %s", self._version,
                     self.ship_dir)

    # -- publish -----------------------------------------------------------
    def ship(self, snap: TableSnapshot, touched=None) -> dict:
        """Persist one published snapshot; returns its manifest record.

        ``touched`` optionally narrows the diff to the given external
        keys (the trainer knows what it pushed); without it the shipper
        diffs every plane against the previous shipped base — the same
        O(capacity) scan the publisher's host copy already paid.
        """
        t0 = time.perf_counter()
        last = self._last
        kind = "delta"
        reason = ""
        if last is None:
            kind, reason = "full", "first"
        elif self.full_every and self._since_full >= self.full_every:
            kind, reason = "full", "chain_cap"
        elif (set(snap.state) != set(last.state)
              or snap.n_hot != last.n_hot
              or any(snap.state[f].shape != last.state[f].shape
                     for f in snap.state)):
            kind, reason = "full", "reshape"     # grow()/repartition
        elif len(snap.keys) < len(last.keys) or not np.array_equal(
                snap.slots[:len(last.slots)], last.slots):
            kind, reason = "full", "remap"       # not a pure append
        record: dict
        if kind == "delta":
            record = self._ship_delta(snap, touched)
            if record is None:                   # priced over crossover
                kind, reason = "full", "dense"
        if kind == "full":
            record = self._ship_full(snap, reason)
        record["ship_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        self._append_manifest(record)
        self._last = snap
        self._book(record)
        return record

    def _next_version(self) -> int:
        self._version += 1
        return self._version

    def _ship_full(self, snap: TableSnapshot, reason: str) -> dict:
        version = self._next_version()
        arrays = {f"plane::{f}": np.asarray(v, np.float32)
                  for f, v in snap.state.items()}
        arrays["keys"] = np.asarray(snap.keys, np.uint64)
        arrays["slots"] = np.asarray(snap.slots, np.int64)
        atomic_savez(_payload_path(self.ship_dir, version), **arrays)
        self._since_full = 0
        wire = _full_model_bytes(snap.state, len(snap.keys))
        return {
            "schema": SHIP_SCHEMA, "version": version, "kind": "full",
            "base": None, "reason": reason, "step": int(snap.step),
            "n_hot": int(snap.n_hot),
            "fields": sorted(snap.state),
            "capacity": {f: int(v.shape[0])
                         for f, v in snap.state.items()},
            "bytes": int(wire), "full_bytes": int(wire),
            "fmt": {f: "full" for f in snap.state},
            "touched": {f: int(v.shape[0])
                        for f, v in snap.state.items()},
            "n_keys": len(snap.keys), "keys_appended": len(snap.keys),
            "ts": time.time(),
        }

    def _ship_delta(self, snap: TableSnapshot,
                    touched) -> Optional[dict]:
        """Encode per-plane changed rows; None when any plane prices
        dense (the caller then ships a full base — cheaper than a
        "sparse" delta wider than the table)."""
        last = self._last
        narrowed = None
        if touched is not None and len(touched):
            # trainer-supplied touched keys -> unified slots; unknown
            # keys (raced a grow) just widen back to the full diff
            slots = snap.lookup(np.asarray(touched, np.uint64))
            if (slots >= 0).all():
                narrowed = np.unique(slots)
        arrays: Dict[str, np.ndarray] = {}
        fmt: Dict[str, str] = {}
        touched_rows: Dict[str, int] = {}
        wire = 0
        for f in sorted(snap.state):
            new, old = snap.state[f], last.state[f]
            cap = int(new.shape[0])
            if narrowed is not None:
                # unified slot space -> this plane's local index space
                if f.endswith("@hot"):
                    local = narrowed[narrowed < snap.n_hot]
                else:
                    local = (narrowed[narrowed >= snap.n_hot]
                             - snap.n_hot)
                cand = local[local < cap]
                changed = cand[np.any(new[cand] != old[cand], axis=1)]
            else:
                changed = np.flatnonzero(
                    np.any(new != old, axis=tuple(range(1, new.ndim))))
            enc = encode_delta(changed, new[changed], cap,
                               quant=self.quant, positions=changed)
            fmt[f] = str(np.asarray(enc["format"]))
            touched_rows[f] = int(len(changed))
            wire += delta_wire_bytes(enc)
            for k, v in enc.items():
                arrays[f"{f}::{k}"] = v
        # a delta as wide as the table is no delta: when the summed
        # plane encodings price at/past the full-snapshot byte model
        # the publish touched most rows — ship a fresh full base
        if wire >= _full_model_bytes(snap.state, len(snap.keys)):
            return None
        n_last = len(last.keys)
        arrays["keys_appended"] = np.asarray(snap.keys[n_last:],
                                             np.uint64)
        arrays["slots_appended"] = np.asarray(snap.slots[n_last:],
                                              np.int64)
        wire += len(arrays["keys_appended"]) * _PAIR_BYTES
        version = self._next_version()
        atomic_savez(_payload_path(self.ship_dir, version), **arrays)
        self._since_full += 1
        return {
            "schema": SHIP_SCHEMA, "version": version, "kind": "delta",
            "base": version - 1, "reason": "",
            "step": int(snap.step), "n_hot": int(snap.n_hot),
            "fields": sorted(snap.state),
            "capacity": {f: int(v.shape[0])
                         for f, v in snap.state.items()},
            "bytes": int(wire),
            "full_bytes": _full_model_bytes(snap.state, len(snap.keys)),
            "fmt": fmt, "touched": touched_rows,
            "n_keys": len(snap.keys),
            "keys_appended": int(len(arrays["keys_appended"])),
            "ts": time.time(),
        }

    # -- manifest + telemetry ----------------------------------------------
    def _append_manifest(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        fd = os.open(os.path.join(self.ship_dir, MANIFEST),
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode())
            os.fsync(fd)
        finally:
            os.close(fd)

    def _book(self, record: dict) -> None:
        reg = obs.get_registry()
        if not reg.enabled:
            return
        if record["kind"] == "delta":
            reg.counter("serve/delta_publishes").inc(1)
            reg.counter("serve/delta_bytes").inc(record["bytes"])
            for f, dec in record["fmt"].items():
                reg.counter("serve/delta_fmt", fmt=dec).inc(1)
        else:
            reg.counter("serve/full_publishes").inc(1)
            reg.counter("serve/full_bytes").inc(record["bytes"])
        reg.gauge("serve/ship_version").set(record["version"])

    @property
    def version(self) -> int:
        return self._version


def read_manifest(ship_dir: str) -> List[dict]:
    """All complete manifest records (torn trailing line skipped)."""
    path = os.path.join(ship_dir, MANIFEST)
    out: List[dict] = []
    try:
        with open(path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    break                       # torn tail: not yet ours
                try:
                    out.append(json.loads(raw))
                except ValueError:
                    break
    except OSError:
        pass
    return out


class SnapshotReplica:
    """Reader-side replay of the ship stream into live snapshots.

    Presents the publisher's reader surface, so
    ``EmbeddingReader(replica)`` works unchanged in the replica
    process.  ``poll()`` (same thread as the queries, or any one
    thread) ingests new manifest lines and applies them in version
    order; a late joiner replays the newest full base and every delta
    after it.  Version monotonicity is enforced: a manifest that
    rewinds raises — the tests assert replicas never silently
    accept a forked chain.
    """

    def __init__(self, ship_dir: str, poll_s: float = 0.05):
        self.ship_dir = ship_dir
        self.poll_s = float(poll_s)
        self._offset = 0           # manifest records consumed
        self._latest: Optional[TableSnapshot] = None
        self._applied_version = 0
        self._seen_version = 0     # manifest tail (may be > applied)
        self._last_step = 0        # trainer step at manifest tail
        self._applied_ts: Optional[float] = None
        self._pending: List[dict] = []
        rank = obs.process_rank()
        self._labels = ({"replica": obs.process_ident()}
                        if rank is not None else {})

    # -- ingestion ---------------------------------------------------------
    def poll(self) -> int:
        """Apply any newly shipped publishes; returns how many."""
        records = read_manifest(self.ship_dir)
        fresh = records[self._offset:]
        self._offset = len(records)
        self._pending.extend(fresh)
        applied = 0
        while self._pending:
            rec = self._pending[0]
            version = int(rec["version"])
            if version <= self._seen_version:
                raise RuntimeError(
                    f"ship stream rewound: v{version} after "
                    f"v{self._seen_version} — refusing a forked chain")
            self._seen_version = version
            self._last_step = int(rec["step"])
            if rec["kind"] == "full":
                self._apply_full(rec)
            elif self._latest is None:
                # delta before our first base (joined mid-chain with the
                # base line already consumed upstream of us): skip until
                # a full arrives — the shipper's full_every bounds this
                self._pending.pop(0)
                continue
            else:
                self._apply_delta(rec)
            self._pending.pop(0)
            applied += 1
        self._book()
        return applied

    def _load(self, version: int):
        return np.load(_payload_path(self.ship_dir, version),
                       allow_pickle=False)

    def _apply_full(self, rec: dict) -> None:
        with self._load(rec["version"]) as z:
            state = {k[len("plane::"):]: np.asarray(z[k], np.float32)
                     for k in z.files if k.startswith("plane::")}
            keys = np.asarray(z["keys"], np.uint64)
            slots = np.asarray(z["slots"], np.int64)
        self._install(rec, state, keys, slots)

    def _apply_delta(self, rec: dict) -> None:
        base = self._latest
        # copy-on-apply: query threads keep reading the previous
        # complete snapshot; the scatter lands on fresh arrays
        state = {f: v.copy() for f, v in base.state.items()}
        with self._load(rec["version"]) as z:
            for f in rec["fields"]:
                enc = {k.split("::", 1)[1]: z[k] for k in z.files
                       if k.startswith(f + "::")}
                if not enc:
                    continue
                pos, rows = decode_delta(enc)
                if len(pos):
                    state[f][pos] = rows.reshape(len(pos), -1)
            keys = np.concatenate(
                [base.keys, np.asarray(z["keys_appended"], np.uint64)])
            slots = np.concatenate(
                [base.slots, np.asarray(z["slots_appended"], np.int64)])
        self._install(rec, state, keys, slots)

    def _install(self, rec: dict, state, keys, slots) -> None:
        self._latest = TableSnapshot(
            int(rec["version"]), int(rec["step"]), state,
            keys=keys, slots=slots, n_hot=int(rec["n_hot"]))
        self._applied_version = int(rec["version"])
        self._applied_ts = float(rec.get("ts") or time.time())

    def _book(self) -> None:
        reg = obs.get_registry()
        if not reg.enabled:
            return
        reg.gauge("serve/replica_version",
                  **self._labels).set(self._applied_version)
        reg.gauge("serve/replica_lag", **self._labels).set(
            self._seen_version - self._applied_version)
        if self._applied_ts is not None:
            # wall-clock staleness: keeps rising when the trainer is
            # dead (step-based staleness cannot — steps stopped)
            reg.gauge("serve/staleness_s", **self._labels).set(
                round(time.time() - self._applied_ts, 3))

    # -- publisher-compatible reader surface -------------------------------
    def latest(self) -> Optional[TableSnapshot]:
        return self._latest

    def require(self) -> TableSnapshot:
        snap = self._latest
        if snap is None:
            from swiftmpi_tpu_torch.serve.snapshot import \
                SnapshotUnavailable
            raise SnapshotUnavailable(
                f"no snapshot replayed yet from {self.ship_dir}")
        return snap

    def wait_for_version(self, version: int,
                         timeout: Optional[float] = None
                         ) -> Optional[TableSnapshot]:
        """Cross-process bounded staleness: block (polling the ship
        dir) until a snapshot with ``version >= version`` is applied."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            self.poll()
            if self._applied_version >= version:
                return self._latest
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(self.poll_s)

    def staleness_steps(self) -> int:
        snap = self._latest
        return self._last_step - (snap.step if snap else 0)

    def staleness_s(self) -> float:
        """Seconds since the applied publish was shipped."""
        if self._applied_ts is None:
            return 0.0
        return max(time.time() - self._applied_ts, 0.0)

    @property
    def version(self) -> int:
        return self._applied_version

    @property
    def train_step(self) -> int:
        return self._last_step
