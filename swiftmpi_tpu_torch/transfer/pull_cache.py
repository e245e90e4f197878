"""Worker-side versioned pull cache (counterpart of
``swiftmpi_tpu/transfer/pull_cache.py``, numpy, the JAX package's).

The rows a worker pulls step after step are mostly rows that did not
change.  The table stamps every tail row with a per-shard monotonic
version at each apply (the ``@rowver`` plane, ``parameter/
sparse_table.py``); the worker keeps this bounded direct-mapped cache of
``(slot, version)`` tags and sends its per-row watermark with each pull;
the server ships values only for rows newer than the watermark plus a hit
bitmap, and the worker splices its cached rows for the rest.

A version-exact hit's cached row equals the server row bit for bit (the
version changed iff the row did), so the spliced result is the fresh
gather and only the ledger changes.  The pull interpreter
(``transfer/api.py``) therefore runs this cache as a host-side shadow fed
with each pull's slots and versions while the device keeps the plain
gather.  ``store_rows=True`` stores the row values too and checks cached
== fresh on every hit: the oracle that proves every apply path bumps its
rows.

Invalidation:

* a hit needs both the slot tag and the version to match the line; any
  apply bumps the row's version, so stale lines miss and refill;
* the cache keys on the table capacity: a ``grow`` re-strides tail rows,
  so a capacity change flushes everything;
* a restart or resume flushes (``Transfer.pull_shadow_flush``): a restore
  can rewind versions, after which a warm cache could hit falsely.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class PullCache:
    """Bounded direct-mapped ``slot -> version`` cache.

    ``lines`` bounds the footprint (one int64 tag + int64 version per
    line; ~16B/line).  Direct-mapped: slot ``s`` lives only at line
    ``s % lines``, so lookup and fill are one vectorized gather/scatter
    each — no LRU bookkeeping on the hot pull path, and conflict
    evictions are deterministic (last writer in batch order wins).
    """

    def __init__(self, lines: int, store_rows: bool = False):
        if lines <= 0:
            raise ValueError(f"PullCache: lines must be > 0, got {lines}")
        self.lines = int(lines)
        self.store_rows = bool(store_rows)
        self.capacity: Optional[int] = None
        self.tags = np.full(self.lines, -1, np.int64)
        self.vers = np.zeros(self.lines, np.int64)
        self._rows: Dict[int, dict] = {}
        # counters are cumulative over the cache's lifetime; the
        # transfer ledger books the per-interval view
        self.hits = 0
        self.misses = 0
        self.flushes = 0
        self.mismatches = 0

    def flush(self) -> None:
        self.tags.fill(-1)
        self.vers.fill(0)
        self._rows.clear()
        self.flushes += 1

    def lookup(self, slots, versions, capacity: int,
               rows: Optional[dict] = None) -> np.ndarray:
        """One pull's worth of watermark traffic: returns the boolean
        hit mask over ``slots`` (True = cached row is current, no value
        bytes needed), then fills every valid miss line with the fresh
        ``(slot, version)`` tag.

        Hits are decided against the PRE-request cache state, so
        duplicate slots in one batch hit or miss together — matching
        the ledger's existing per-occurrence booking.  ``rows`` (field
        -> (B, d) host array) is required in ``store_rows`` mode: hit
        lines are value-compared against the fresh rows and any
        mismatch (an apply path that forgot to bump) raises.
        """
        slots = np.asarray(slots, np.int64).ravel()
        versions = np.asarray(versions, np.int64).ravel()
        if int(capacity) != self.capacity:
            # grow re-strided the slot space (or first use): start cold
            if self.capacity is not None:
                self.flush()
            self.capacity = int(capacity)
        valid = slots >= 0
        line = np.where(valid, slots % self.lines, 0)
        hit = valid & (self.tags[line] == slots) \
            & (self.vers[line] == versions)
        if self.store_rows:
            if rows is None:
                raise ValueError("PullCache(store_rows=True) needs the "
                                 "fresh rows to verify hits against")
            self._verify_and_store(slots, line, hit, valid, rows)
        miss = valid & ~hit
        self.tags[line[miss]] = slots[miss]
        self.vers[line[miss]] = versions[miss]
        self.hits += int(hit.sum())
        self.misses += int(miss.sum())
        return hit

    def _verify_and_store(self, slots, line, hit, valid, rows) -> None:
        host = {f: np.asarray(v) for f, v in rows.items()}
        for i in np.flatnonzero(hit):
            cached = self._rows.get(int(line[i]))
            if cached is None or cached["slot"] != int(slots[i]):
                continue  # line stored before store_rows toggled on
            for f, v in cached.items():
                if f == "slot":
                    continue
                # equal_nan: an injected-NaN row (testing/faults.py
                # _poison_row) re-pulled at an unchanged version is a
                # legitimate hit, not a missed bump
                eq_nan = np.issubdtype(np.asarray(v).dtype, np.inexact)
                if not np.array_equal(host[f][i], v, equal_nan=eq_nan):
                    self.mismatches += 1
                    raise AssertionError(
                        f"PullCache oracle: slot {int(slots[i])} hit at "
                        f"an unchanged version but field {f!r} differs "
                        "from the server row — some apply path did not "
                        "bump the row version")
        for i in np.flatnonzero(valid & ~hit):
            entry = {"slot": int(slots[i])}
            for f in host:
                entry[f] = host[f][i].copy()
            self._rows[int(line[i])] = entry
