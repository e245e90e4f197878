"""Pull-only embedding read API over published snapshots (counterpart of
``swiftmpi_tpu/serve/reader.py``).

Read routing mirrors the hybrid transfer's placement logic, host-side:

* **hot** (``slot < n_hot``): the replicated ``@hot`` plane answers
  locally — a numpy ``take`` on the snapshot's host replica.  This is
  the serving counterpart of the training path's "hot rows answer
  locally at cache speed".
* **tail** (``slot >= n_hot``): an LRU front built on
  :class:`~swiftmpi_tpu_torch.parameter.cache.LocalParamCache`'s aligned
  arrays absorbs the Zipf head of the *query* distribution; misses are
  batched into ONE vectorized gather from the host replica per read
  call, then installed for the next hit.

Readers NEVER launch device work: snapshots are host replicas (see
:mod:`.snapshot`), so any number of query threads can read while the
trainer has the card to itself.  The module imports no ``torch``
(``tests/test_torch_isolation.py`` holds it to that).

The front is invalidated on snapshot version change — a cached row is
only ever served at the version it was fetched at, so bounded staleness
degrades to exactly the publisher's bound, never beyond it.

A reader instance is NOT thread-safe (the LRU order is mutable state);
give each query stream its own reader over the shared publisher — the
snapshots themselves are immutable and safely shared.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.parameter.cache import LocalParamCache
from swiftmpi_tpu_torch.serve.snapshot import (SnapshotPublisher,
                                              TableSnapshot)


class LruTailFront:
    """Fixed-capacity LRU row cache: external tail slot → aligned row.

    Storage is a :class:`LocalParamCache` initialized over the dense
    position range — the same aligned ``(n, d)`` block the worker-side
    pull cache uses, so rows live contiguous and the hit path is one
    vectorized ``take``.  The LRU order is an ``OrderedDict`` over the
    positions."""

    def __init__(self, field: str, dim: int, capacity: int):
        if capacity < 1:
            raise ValueError("LRU front capacity must be >= 1")
        self.field = field
        self.capacity = int(capacity)
        self._cache = LocalParamCache({field: int(dim)})
        self._cache.init_keys(range(self.capacity))
        self._pos: "OrderedDict[int, int]" = OrderedDict()  # slot -> pos
        self._free = list(range(self.capacity - 1, -1, -1))
        #: snapshot version the cached rows belong to
        self.version = -1

    def __len__(self) -> int:
        return len(self._pos)

    def sync_version(self, version: int) -> None:
        """Drop everything when the snapshot generation moved on."""
        if version != self.version:
            self._pos.clear()
            self._free = list(range(self.capacity - 1, -1, -1))
            self.version = version

    def get(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rows (B, d), hit mask (B,)) — missed rows are zeros."""
        B = len(slots)
        pos = np.zeros(B, np.int64)
        hit = np.zeros(B, bool)
        for i, s in enumerate(slots):
            p = self._pos.get(int(s))
            if p is not None:
                self._pos.move_to_end(int(s))
                pos[i] = p
                hit[i] = True
        rows = self._cache.params[self.field][pos].copy()
        rows[~hit] = 0.0
        return rows, hit

    def put(self, slots: np.ndarray, rows: np.ndarray) -> None:
        block = self._cache.params[self.field]
        for i, s in enumerate(slots):
            s = int(s)
            p = self._pos.get(s)
            if p is None:
                if self._free:
                    p = self._free.pop()
                else:
                    _, p = self._pos.popitem(last=False)   # evict LRU
                self._pos[s] = p
            else:
                self._pos.move_to_end(s)
            block[p] = rows[i]


class EmbeddingReader:
    """One query stream's read handle over a :class:`SnapshotPublisher`.

    ``read(keys)`` returns the requested rows at the latest snapshot;
    ``topk(keys, k)`` runs the batched host-side neighbor query.  Both
    record ``serve/*`` metrics (latency histogram, hit/miss counters,
    staleness gauge) into the obs registry when telemetry is on, and
    always-on plain-int ``stats`` for the bench cell."""

    def __init__(self, publisher: SnapshotPublisher,
                 field: str = "v", cache_rows: int = 4096):
        self.publisher = publisher
        self.field = field
        self.cache_rows = int(cache_rows)
        self._front: Optional[LruTailFront] = None
        self.stats: Dict[str, int] = {
            "queries": 0, "rows_read": 0, "hot_hits": 0,
            "front_hits": 0, "tail_misses": 0, "topk_queries": 0}
        self._lat_ms: list = []
        # Launched replicas (SMTPU_PROCESS_ID set) label every serve/*
        # series with their identity, so a FleetCollector merging the
        # fleet's streams can attribute per-replica p99/hit-ratio.  Bare
        # single-process runs keep the unlabeled series untouched.
        rank = obs.process_rank()
        self._labels: Dict[str, str] = (
            {"replica": obs.process_ident()} if rank is not None else {})

    # -- internals --------------------------------------------------------
    def _front_for(self, snap: TableSnapshot) -> LruTailFront:
        dim = int(snap.tail_array(self.field).shape[1])
        front = self._front
        if front is None or front._cache.params[self.field].shape[1] != dim:
            front = self._front = LruTailFront(
                self.field, dim, self.cache_rows)
        front.sync_version(snap.version)
        return front

    def _observe(self, dt_ms: float, snap: TableSnapshot) -> None:
        self._lat_ms.append(dt_ms)
        reg = obs.get_registry()
        if reg.enabled:
            reg.histogram("serve/latency_ms",
                          **self._labels).observe(dt_ms)
            reg.counter("serve/queries", **self._labels).inc(1)
            reg.gauge("serve/staleness_steps", **self._labels).set(
                self.publisher.train_step - snap.step)

    # -- the pull-only read path -----------------------------------------
    def read(self, keys: Sequence[int]) -> np.ndarray:
        """Rows for external ``keys`` at the latest snapshot.  Unknown
        keys read as zero rows (the transfer layer's ``slot == -1``
        semantics, surfaced to the serving edge)."""
        t0 = time.perf_counter()
        snap = self.publisher.require()
        slots = snap.lookup(keys)
        n_hot = snap.n_hot
        B = len(slots)
        valid = slots >= 0
        is_hot = valid & (slots < n_hot)
        is_tail = valid & ~is_hot
        dim = int(snap.tail_array(self.field).shape[1])
        out = np.zeros((B, dim), np.float32)
        # hot: local replica hit — numpy take on the per-version copy
        if is_hot.any():
            hot = snap.hot_host(self.field)
            out[is_hot] = hot[slots[is_hot]].astype(np.float32)
        front_hits = 0
        misses = 0
        if is_tail.any():
            front = self._front_for(snap)
            tslots = slots[is_tail] - n_hot
            rows, hit = front.get(tslots)
            misses = int((~hit).sum())
            front_hits = int(hit.sum())
            if misses:
                # ONE vectorized gather from the snapshot's host
                # replica for all misses — never a device launch: the
                # trainer owns the card
                miss_slots = tslots[~hit]
                fetched = np.asarray(
                    snap.tail_array(self.field)[miss_slots], np.float32)
                rows[~hit] = fetched
                front.put(miss_slots, fetched)
            out[is_tail] = rows.astype(np.float32)
        st = self.stats
        st["queries"] += 1
        st["rows_read"] += int(valid.sum())
        st["hot_hits"] += int(is_hot.sum())
        st["front_hits"] += front_hits
        st["tail_misses"] += misses
        reg = obs.get_registry()
        if reg.enabled:
            reg.counter("serve/rows_read",
                        **self._labels).inc(int(valid.sum()))
            reg.counter("serve/hits", **self._labels).inc(
                int(is_hot.sum()) + front_hits)
            reg.counter("serve/misses", **self._labels).inc(misses)
        self._observe((time.perf_counter() - t0) * 1e3, snap)
        return out

    # -- batched neighbor queries ----------------------------------------
    def topk(self, keys: Sequence[int], k: int = 10
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k cosine neighbors for each stored key in ONE batched
        matmul + partial sort over the snapshot's host replica (each
        query's own row excluded).  Returns ``(neighbor keys (Q, k),
        scores (Q, k))``; queries for unknown keys return all -inf
        scores."""
        from swiftmpi_tpu_torch.serve.query import snapshot_topk

        t0 = time.perf_counter()
        snap = self.publisher.require()
        slots = snap.lookup(keys)
        qvecs = self.read(keys)          # routes hot/front/tail as usual
        known = slots >= 0
        nkeys, _, scores = snapshot_topk(
            snap, qvecs, k=k, exclude_slots=slots)
        scores[~known] = -np.inf
        st = self.stats
        st["topk_queries"] += len(keys)
        reg = obs.get_registry()
        if reg.enabled:
            reg.counter("serve/topk_queries",
                        **self._labels).inc(len(keys))
        self._observe((time.perf_counter() - t0) * 1e3, snap)
        return nkeys, scores

    # -- derived metrics --------------------------------------------------
    def hit_ratio(self) -> float:
        st = self.stats
        served = st["hot_hits"] + st["front_hits"] + st["tail_misses"]
        if not served:
            return 1.0
        return (st["hot_hits"] + st["front_hits"]) / served

    def latency_quantiles(self, qs=(0.5, 0.99)) -> Dict[str, float]:
        """p-quantiles over this reader's recorded per-call latencies."""
        if not self._lat_ms:
            return {f"p{int(q * 100)}_ms": 0.0 for q in qs}
        arr = np.sort(np.asarray(self._lat_ms))
        return {f"p{int(q * 100)}_ms":
                float(arr[min(int(q * len(arr)), len(arr) - 1)])
                for q in qs}
