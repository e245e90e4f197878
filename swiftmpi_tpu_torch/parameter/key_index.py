"""Host-side key -> dense-slot index (counterpart of
``swiftmpi_tpu/parameter/key_index.py``).

Keys are arbitrary uint64 values.  A key's shard comes from the hashfrag
routing table; within its shard it gets the next free local row on first
touch, the lazy row creation of the reference's ``dense_hash_map``:

    slot = shard * capacity_per_shard + local

These are exactly the slots the JAX ``KeyIndex`` assigns (no hot head), so
a table state carries across the two frameworks row for row.  ``grow``
re-strides every slot to a larger per-shard capacity and ``restore``
rebuilds the index from a checkpoint's ``(key, slot)`` pairs, as in the
JAX package; the hot/cold partition and ``repartition`` are not ported
yet (ROADMAP A12).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from swiftmpi_tpu_torch.cluster.hashfrag import HashFrag


class CapacityError(RuntimeError):
    """A shard ran out of slots; raise rather than silently evict."""


class KeyIndex:
    def __init__(self, num_shards: int, capacity_per_shard: int,
                 hashfrag: Optional[HashFrag] = None):
        self.num_shards = int(num_shards)
        self.capacity_per_shard = int(capacity_per_shard)
        self.hashfrag = hashfrag or HashFrag(num_shards)
        if self.hashfrag.num_shards != self.num_shards:
            raise ValueError("hashfrag shard count mismatch")
        self._slot_of: Dict[int, int] = {}     # insertion (first-touch) order
        self._next_local = np.zeros(self.num_shards, dtype=np.int64)
        self._sorted_keys = np.empty(0, np.uint64)
        self._sorted_slots = np.empty(0, np.int64)

    def _find(self, flat: np.ndarray) -> np.ndarray:
        """Vectorized probe: slots for present keys, -1 for absent."""
        out = np.full(flat.shape, -1, np.int64)
        n = self._sorted_keys.size
        if n == 0 or flat.size == 0:
            return out
        pos = np.minimum(np.searchsorted(self._sorted_keys, flat), n - 1)
        hit = self._sorted_keys[pos] == flat
        out[hit] = self._sorted_slots[pos[hit]]
        return out

    def lookup(self, keys, create: bool = True) -> np.ndarray:
        """Map keys -> int32 slots; unknown keys get fresh slots in their
        owning shard when ``create`` (lazy init), else -1."""
        keys = np.asarray(keys, dtype=np.uint64)
        flat = keys.ravel()
        out = self._find(flat)
        if create:
            miss = np.flatnonzero(out < 0)
            if miss.size:
                out[miss] = self._create(flat[miss])
        return out.astype(np.int32).reshape(keys.shape)

    def _create(self, miss_keys: np.ndarray) -> np.ndarray:
        """Fresh slots for missing keys in first-touch order; returns the
        slot for every position (duplicates share one new slot)."""
        uniq_sorted, first, inv = np.unique(miss_keys, return_index=True,
                                            return_inverse=True)
        order = np.argsort(first, kind="stable")
        uniq = uniq_sorted[order]
        shards = self.hashfrag.to_shard_id(uniq).astype(np.int64)
        counts = np.bincount(shards, minlength=self.num_shards)
        over = self._next_local + counts > self.capacity_per_shard
        if over.any():
            s = int(np.flatnonzero(over)[0])
            raise CapacityError(
                f"shard {s} full ({self.capacity_per_shard} slots); raise "
                "capacity_per_shard")
        # local row = next_local[shard] + the key's occurrence index among
        # this call's keys of its shard (stable grouping keeps first-touch
        # order within a shard)
        by_shard = np.argsort(shards, kind="stable")
        group_start = np.zeros(self.num_shards, np.int64)
        group_start[1:] = np.cumsum(counts)[:-1]
        occ = np.empty(len(uniq), np.int64)
        occ[by_shard] = np.arange(len(uniq)) - group_start[shards[by_shard]]
        slots = shards * self.capacity_per_shard \
            + self._next_local[shards] + occ
        self._next_local += counts
        self._slot_of.update(zip(uniq.tolist(), slots.tolist()))
        self._sort(np.concatenate([self._sorted_keys, uniq]),
                   np.concatenate([self._sorted_slots, slots]))
        rank = np.empty(len(uniq), np.int64)
        rank[order] = np.arange(len(uniq))
        return slots[rank[inv.ravel()]]

    def _sort(self, keys: np.ndarray, slots: np.ndarray) -> None:
        """Install the probe arrays from unsorted ``(key, slot)`` pairs."""
        srt = np.argsort(keys, kind="stable")
        self._sorted_keys = keys[srt].astype(np.uint64)
        self._sorted_slots = slots[srt].astype(np.int64)

    def shard_of(self, keys) -> np.ndarray:
        return self.hashfrag.to_shard_id(keys)

    # -- introspection ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.num_shards * self.capacity_per_shard

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, key) -> bool:
        return int(key) in self._slot_of

    def slot(self, key: int) -> int:
        return self._slot_of[int(key)]

    def keys(self) -> Iterable[int]:
        """Keys in insertion order."""
        return self._slot_of.keys()

    def items(self) -> Iterable:
        """(key, slot) pairs in insertion order."""
        return self._slot_of.items()

    def shard_fill(self) -> np.ndarray:
        """Occupied slots per shard (load-balance introspection)."""
        return self._next_local.copy()

    # -- growth ------------------------------------------------------------
    def grow(self, new_capacity_per_shard: int) -> None:
        """Raise the per-shard capacity, remapping every assigned slot to
        ``shard * new_cap + local`` (locals, and so each shard's insertion
        order, kept).  The table's rows must move to match: use
        ``SparseTable.grow``, which calls this."""
        new = int(new_capacity_per_shard)
        old = self.capacity_per_shard
        if new <= old:
            raise ValueError(f"new capacity {new} must exceed {old}")
        self.capacity_per_shard = new
        keys = np.fromiter(self._slot_of.keys(), np.uint64,
                           len(self._slot_of))
        slots = np.fromiter(self._slot_of.values(), np.int64,
                            len(self._slot_of))
        slots = slots // old * new + slots % old
        self._slot_of = dict(zip(keys.tolist(), slots.tolist()))
        self._sort(keys, slots)

    # -- checkpoint restore ------------------------------------------------
    def restore(self, keys, slots) -> None:
        """Rebuild the index from saved ``(key, slot)`` pairs (insertion
        order = the pairs' order), keeping the ``slot = shard *
        capacity_per_shard + local`` layout: each shard's next free row
        follows its highest restored local row."""
        keys = np.asarray(keys, np.uint64).ravel()
        slots = np.asarray(slots, np.int64).ravel()
        shards, local = np.divmod(slots, self.capacity_per_shard)
        bad = (shards < 0) | (shards >= self.num_shards)
        if bad.any():
            raise ValueError(f"slot {int(slots[bad][0])} outside the table "
                             "layout")
        self._slot_of = dict(zip(keys.tolist(), slots.tolist()))
        self._next_local = np.zeros(self.num_shards, np.int64)
        np.maximum.at(self._next_local, shards, local + 1)
        self._sort(keys, slots)
