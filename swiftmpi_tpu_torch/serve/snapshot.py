"""Versioned, torn-read-free snapshots of the live table (counterpart
of ``swiftmpi_tpu/serve/snapshot.py``).

The port's steps update the table's tensors in place (the counterpart
of the JAX step donating its state), so a snapshot that aliased the
device tensors would be torn by the very next step or graph replay.
``publish`` instead takes ONE bounded **host** copy of the table per
publish, on the trainer thread, at a safe point between dispatches: a
synchronous device-to-host copy on the trainer's stream, which returns
only once every step enqueued before it has finished, so no reader can
see the copy before it completes.  Everything after that copy is
reference-sharing over plain numpy.  Host copies are load-bearing twice
over: reader threads must never launch device work (they share the
process, and the card, with the trainer), and serving load must not
steal device time from the trainer anyway.  The copy holds every plane
of the state (``@hot``, ``@ef``, ``@rowver`` included), a sharded table
in global row order and a bfloat16 field as ``ml_dtypes.bfloat16`` bits
(:func:`~swiftmpi_tpu_torch.parameter.sparse_table.state_to_numpy`).
The other mutable structures are the host-side ``KeyIndex`` (``grow``
and ``repartition`` remap slots in place) and the table handle itself,
so a snapshot captures the key→slot view it needs (``keys``/``slots``)
at publish time, on the trainer thread, where no grow can be mid-flight.

Concurrency contract:

* ``publish``/``on_steps`` are called from ONE thread (the trainer).
* ``latest()`` may be called from any number of reader threads.  It is
  a single attribute read of an immutable object — readers see either
  the previous complete snapshot or the next complete snapshot, never
  a mix.
* ``depth`` bounds how many published generations the publisher keeps
  referenced, so a heavy read load cannot hold the whole training
  history's host copies alive.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from swiftmpi_tpu_torch import obs


class SnapshotUnavailable(RuntimeError):
    """A read arrived before the first snapshot was published."""


def _is_hot_field(name: str) -> bool:
    # local copy of sparse_table.is_hot_field: this module stays free of
    # a module-level torch import (readers are host-side)
    return name.endswith("@hot")


def _copy_state(state):
    """Own every plane on the HOST: numpy planes (a params-only snapshot
    such as sent2vec's) are copied, table planes (a tensor, or a sharded
    field's shard list) come back in one synchronous device-to-host copy
    each, in global row order.  Any pytree of them (the transformer
    trainer's params: nested dicts, ``MoEParams``) keeps its structure."""
    from swiftmpi_tpu_torch.parameter.sparse_table import state_to_numpy
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, dict):
        return {f: _copy_state(v) for f, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_copy_state(v) for v in state))
    return state_to_numpy({"": state})[""]


class TableSnapshot:
    """One immutable published view: versioned state + key→slot map.

    ``state`` is a ``{field: array}`` dict of HOST replicas (readers
    gather with plain numpy); ``keys``/``slots`` are the
    parallel key→unified-slot arrays captured at publish time;
    ``n_hot`` splits the unified slot space exactly like the hybrid
    transfer does.  All attributes are frozen after construction —
    readers share snapshots freely across threads.
    """

    def __init__(self, version: int, step: int, state: Dict,
                 keys: Optional[np.ndarray] = None,
                 slots: Optional[np.ndarray] = None,
                 n_hot: int = 0, meta: Optional[dict] = None):
        self.version = int(version)
        #: trainer step count at publish (staleness is measured from it)
        self.step = int(step)
        self.published_s = time.monotonic()
        self.state = dict(state)
        self.keys = None if keys is None else np.asarray(keys, np.uint64)
        self.slots = None if slots is None else np.asarray(slots,
                                                           np.int64)
        self.n_hot = int(n_hot)
        self.meta = dict(meta or {})
        self._lock = threading.Lock()
        self._row_of: Optional[dict] = None
        self._hot_host: Dict[str, np.ndarray] = {}
        self._key_of_slot: Optional[np.ndarray] = None

    # -- key → slot -------------------------------------------------------
    def lookup(self, keys) -> np.ndarray:
        """Unified slots for external ``keys`` (-1 for unknown keys).

        The dict is built lazily on the first reader that needs it and
        cached — publishing stays O(1) on the trainer thread."""
        if self.keys is None or self.slots is None:
            raise SnapshotUnavailable(
                "snapshot carries no key map (published without "
                "keys/slots — a params-only snapshot)")
        row_of = self._row_of
        if row_of is None:
            with self._lock:
                row_of = self._row_of
                if row_of is None:
                    row_of = {int(k): int(s) for k, s in
                              zip(self.keys, self.slots)}
                    self._row_of = row_of
        out = np.fromiter(
            (row_of.get(int(k) & ((1 << 64) - 1), -1) for k in keys),
            dtype=np.int64, count=len(keys))
        return out

    def key_of_slot(self) -> np.ndarray:
        """Inverse map: unified slot → external key (0 where vacant)."""
        inv = self._key_of_slot
        if inv is None:
            with self._lock:
                inv = self._key_of_slot
                if inv is None:
                    inv = np.zeros(self.total_capacity, np.uint64)
                    inv[self.slots] = self.keys
                    self._key_of_slot = inv
        return inv

    # -- capacities -------------------------------------------------------
    @property
    def tail_capacity(self) -> int:
        for f, v in self.state.items():
            if not _is_hot_field(f):
                return int(v.shape[0])
        return 0

    @property
    def total_capacity(self) -> int:
        return self.n_hot + self.tail_capacity

    # -- field views ------------------------------------------------------
    def tail_array(self, field: str):
        return self.state[field]

    def hot_array(self, field: str):
        return self.state.get(field + "@hot")

    def hot_host(self, field: str) -> Optional[np.ndarray]:
        """Host copy of the replicated hot head for ``field`` (lazily
        materialized once per snapshot — hot reads are then pure local
        numpy hits, the hybrid placement's whole point)."""
        if not self.n_hot:
            return None
        cached = self._hot_host.get(field)
        if cached is None:
            with self._lock:
                cached = self._hot_host.get(field)
                if cached is None:
                    cached = np.asarray(self.hot_array(field))
                    self._hot_host[field] = cached
        return cached

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TableSnapshot(v{self.version}, step={self.step}, "
                f"fields={list(self.state)})")


class SnapshotPublisher:
    """Trainer-side publication point: ``on_steps`` every consumed step
    (or group), ``publish`` fires every ``every`` steps.

    ``depth`` old generations stay referenced (readers holding older
    versions keep them alive anyway via their own references — the
    deque only guarantees a floor for late attachers and debugging).
    """

    def __init__(self, every: int = 1, depth: int = 2):
        if every < 1:
            raise ValueError("[serve] every must be >= 1")
        if depth < 1:
            raise ValueError("[serve] depth must be >= 1")
        self.every = int(every)
        self.depth = int(depth)
        # reader-visible fields: query threads race the publish swap,
        # so every mutation outside __init__ holds the Condition
        self._latest: Optional[TableSnapshot] = None   # guarded-by: _cond
        self._history: deque = deque(maxlen=depth)     # guarded-by: _cond
        self._version = 0
        self._train_step = 0
        self._last_published_step = 0
        self._since = 0
        self._cond = threading.Condition()

    # -- trainer side -----------------------------------------------------
    @staticmethod
    def _capture(source):
        """(state, n_hot) from a SparseTable-like handle or a raw
        ``{field: plane}`` dict."""
        table = getattr(source, "table", source)
        state = getattr(table, "state", table)
        n_hot = 0
        ki = getattr(table, "key_index", None)
        if ki is not None:
            n_hot = int(getattr(ki, "n_hot", 0))
        return state, n_hot

    def on_steps(self, source, n: int = 1, keys=None, slots=None,
                 meta: Optional[dict] = None) -> Optional[TableSnapshot]:
        """Account ``n`` consumed train steps; publish when the bound is
        reached.  Returns the snapshot when one was published."""
        self._train_step += int(n)
        self._since += int(n)
        if self._since < self.every:
            return None
        return self.publish(source, keys=keys, slots=slots, meta=meta)

    def publish(self, source, keys=None, slots=None,
                meta: Optional[dict] = None) -> TableSnapshot:
        # keys/slots may be zero-arg callables, resolved only when a
        # publish actually fires — the per-step on_steps hook then never
        # pays the device->host copy of the slot map on non-publishing
        # steps
        if callable(keys):
            keys = keys()
        if callable(slots):
            slots = slots()
        state, n_hot = self._capture(source)
        # the one host copy per publish — taken HERE, on the trainer
        # thread: synchronous, so it completes before the next step can
        # write the tensors it reads
        state = _copy_state(state)
        self._version += 1
        snap = TableSnapshot(
            self._version, self._train_step, state,
            keys=keys, slots=slots, n_hot=n_hot, meta=meta)
        self._since = 0
        self._last_published_step = self._train_step
        with self._cond:
            self._history.append(snap)
            # the swap readers race against: one reference assignment
            self._latest = snap
            self._cond.notify_all()
        reg = obs.get_registry()
        if reg.enabled:
            reg.counter("serve/snapshots").inc(1)
            reg.gauge("serve/snapshot_version").set(self._version)
            reg.gauge("serve/staleness_steps").set(0)
        return snap

    # -- reader side ------------------------------------------------------
    def latest(self) -> Optional[TableSnapshot]:
        """Most recent complete snapshot (lock-free single read)."""
        return self._latest

    def require(self) -> TableSnapshot:
        snap = self._latest
        if snap is None:
            raise SnapshotUnavailable("no snapshot published yet")
        return snap

    def wait_for_version(self, version: int,
                         timeout: Optional[float] = None
                         ) -> Optional[TableSnapshot]:
        """Block until a snapshot with ``version >= version`` exists."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._latest is not None
                and self._latest.version >= version, timeout)
            return self._latest if ok else None

    # -- staleness --------------------------------------------------------
    def staleness_steps(self) -> int:
        """Trainer steps consumed since the last publish — bounded by
        ``every`` between publishes (the bound serving advertises)."""
        return self._train_step - self._last_published_step

    @property
    def version(self) -> int:
        return self._version

    @property
    def train_step(self) -> int:
        return self._train_step
