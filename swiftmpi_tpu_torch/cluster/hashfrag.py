"""Key -> shard routing table (counterpart of
``swiftmpi_tpu/cluster/hashfrag.py``, the reference's ``BasicHashFrag``,
hashfrag.h:15-119).

A key is hashed with the murmur64 finalizer, mapped to one of
``frag_num`` fragments, and fragments are assigned to shards in contiguous
blocks.  The indirection (key -> frag -> shard) is what lets a re-sharding
move fragments without rehashing keys.  Shard ids are 0-based rank
indices; ``to_node_id`` keeps the reference's 1-based server numbering.
Routing is vectorized over numpy key arrays on the host.
``split_route`` puts a hybrid table's frequency partition before the
hash rule; ``shard_load_histogram`` and ``expected_unique_rows`` size a
key stream's load.  ``serialize``/``deserialize`` wait for the binary
buffer (ROADMAP A13).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from swiftmpi_tpu_torch.utils.hashing import get_hash_code_np


class HashFrag:
    def __init__(self, num_shards: int, num_frags: Optional[int] = None):
        if num_shards <= 0:
            raise ValueError("num_shards must be positive")
        self.num_shards = int(num_shards)
        self.num_frags = int(num_frags if num_frags else max(
            1000, 100 * num_shards))
        if self.num_frags < self.num_shards:
            raise ValueError("num_frags must be >= num_shards")
        # contiguous block assignment (hashfrag.h:41-49):
        # frag i -> min(i // (num_frags // num_shards), num_shards - 1)
        per = self.num_frags // self.num_shards
        table = np.minimum(np.arange(self.num_frags) // per,
                           self.num_shards - 1)
        self._map_table = table.astype(np.int32)

    def to_shard_id(self, keys) -> np.ndarray:
        """Vectorized key -> 0-based shard id (hashfrag.h:51-55)."""
        keys = np.asarray(keys, dtype=np.uint64)
        frag = (get_hash_code_np(keys) % np.uint64(self.num_frags)).astype(
            np.int64)
        return self._map_table[frag]

    def to_node_id(self, keys) -> np.ndarray:
        """Reference-compatible 1-based server node id."""
        return self.to_shard_id(keys) + 1

    @property
    def map_table(self) -> np.ndarray:
        return self._map_table

    def __eq__(self, other) -> bool:
        return (isinstance(other, HashFrag)
                and self.num_shards == other.num_shards
                and self.num_frags == other.num_frags
                and np.array_equal(self._map_table, other._map_table))

    def __repr__(self) -> str:  # pragma: no cover
        return f"HashFrag(shards={self.num_shards}, frags={self.num_frags})"


def shard_load_histogram(hashfrag: HashFrag, keys,
                         weights=None) -> np.ndarray:
    """Per-shard request load of a key stream: how many of ``keys``
    (optionally weighted, e.g. by frequency counts) each shard owns."""
    shards = hashfrag.to_shard_id(keys)
    w = None if weights is None else np.asarray(weights, np.float64)
    return np.bincount(shards, weights=w, minlength=hashfrag.num_shards)


def expected_unique_rows(counts, rows: int) -> float:
    """Expected number of distinct keys among ``rows`` draws from the
    frequency histogram ``counts``: ``sum_k 1 - (1 - p_k)^rows``, through
    ``expm1``/``log1p`` so the Zipf head does not underflow."""
    c = np.asarray(counts, np.float64).ravel()
    total = c.sum()
    if total <= 0 or rows <= 0:
        return 0.0
    p = c / total
    return float(np.sum(-np.expm1(rows * np.log1p(-np.minimum(p, 1.0)))))


def split_route(hashfrag: HashFrag, partition, keys):
    """Hybrid hot/cold routing: each key resolves to a hot slot (the
    replicated head, no shard owner) or to its hash-owned shard.  Returns
    ``(hot_slots, shard_ids)``: a hot key has shard id -1, a tail key hot
    slot -1.  ``partition=None`` is pure hash routing."""
    keys = np.asarray(keys, dtype=np.uint64)
    shards = hashfrag.to_shard_id(keys).astype(np.int64)
    if partition is None:
        return np.full(keys.shape, -1, dtype=np.int64), shards
    hot = partition.hot_slot(keys)
    return hot, np.where(hot >= 0, -1, shards)
