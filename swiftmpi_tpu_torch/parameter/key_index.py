"""Host-side key -> dense-slot index, single shard (counterpart of
``swiftmpi_tpu/parameter/key_index.py``).

Keys are arbitrary uint64 values; each gets a dense slot on first touch,
in first-touch order — the lazy row creation of the reference's
``dense_hash_map``.  With one shard this is exactly the slot the JAX
``KeyIndex`` assigns (``slot = shard * capacity_per_shard + local`` with
shard 0 and no hot head), so a table state carries across the two
frameworks as a plain copy.  Sharded layouts, the hot/cold partition,
growth and repartition are not ported yet (ROADMAP A11/A12).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


class CapacityError(RuntimeError):
    """The shard ran out of slots; raise rather than silently evict."""


class KeyIndex:
    def __init__(self, num_shards: int, capacity_per_shard: int):
        if int(num_shards) != 1:
            raise NotImplementedError(
                "KeyIndex: only one shard is ported ([cluster] server_num "
                "> 1 is ROADMAP A11)")
        self.num_shards = 1
        self.capacity_per_shard = int(capacity_per_shard)
        self._slot_of: Dict[int, int] = {}     # insertion (first-touch) order
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
        """Map keys -> int32 slots; unknown keys get fresh slots when
        ``create`` (lazy init), else -1."""
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
        start = len(self._slot_of)
        if start + len(uniq) > self.capacity_per_shard:
            raise CapacityError(
                f"shard 0 full ({self.capacity_per_shard} slots); raise "
                "capacity_per_shard")
        slots = start + np.arange(len(uniq), dtype=np.int64)
        self._slot_of.update(zip(uniq.tolist(), slots.tolist()))
        keys = np.concatenate([self._sorted_keys, uniq])
        vals = np.concatenate([self._sorted_slots, slots])
        srt = np.argsort(keys, kind="stable")
        self._sorted_keys, self._sorted_slots = keys[srt], vals[srt]
        rank = np.empty(len(uniq), np.int64)
        rank[order] = np.arange(len(uniq))
        return slots[rank[inv.ravel()]]

    # -- introspection ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.num_shards * self.capacity_per_shard

    def __len__(self) -> int:
        return len(self._slot_of)

    def slot(self, key: int) -> int:
        return self._slot_of[int(key)]

    def items(self) -> Iterable:
        """(key, slot) pairs in insertion order."""
        return self._slot_of.items()
