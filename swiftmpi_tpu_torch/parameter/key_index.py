"""Host-side key -> dense-slot index (counterpart of
``swiftmpi_tpu/parameter/key_index.py``).

Keys are arbitrary uint64 values.  A key's shard comes from the hashfrag
routing table; within its shard it gets the next free local row on first
touch, the lazy row creation of the reference's ``dense_hash_map``:

    slot = shard * capacity_per_shard + local

The batch probe is the JAX module's vectorized open-addressing hash
(linear probing, a power-of-two size, grown at half load) over numpy
arrays; a dict keeps the insertion order for ``keys``/``items``.  The
slots are exactly the JAX ``KeyIndex``'s, so a table state carries
across the two frameworks row for row.

Hybrid hot/cold placement (``transfer: hybrid``): an optional
:class:`HotColdPartition` reserves the FIRST ``n_hot`` slots for the
frequency head, replicated on every device; tail keys keep the sharded
layout above, offset by ``n_hot``:

    slot < n_hot                  -> hot slot (the key's frequency rank)
    slot = n_hot + shard*cap + l  -> tail slot

Hot slots never move under ``grow`` (it re-strides the tail only), and
``restore`` refuses a hot pair the active partition does not map.  The
online ``repartition`` swaps the split in place and returns the
:class:`RepartitionPlan` the table replays: tail rows keep their
shard-local place, only the unified offset ``n_hot`` moves.  The elastic
ownership helpers name what a shard move ships: ``shard_rows`` (a shard's
keys and slots), ``adopt_owner_map`` (the member table's shard -> rank
map, epoch-guarded) and ``owner_moves`` (its diff).

The window wire-format pricers (``window_wire_format``,
``price_window_formats``, ``price_hot_collectives``) are the JAX
module's host math, whole: every rung of the ladder is priced as JAX
prices it, so a plan's decision and its evidence match field for field,
and the port executes every rung (``transfer/api.py``).
"""

from __future__ import annotations

from itertools import chain
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from swiftmpi_tpu_torch.cluster.hashfrag import HashFrag
from swiftmpi_tpu_torch.utils.hashing import get_hash_code_np


class CapacityError(RuntimeError):
    """A shard ran out of slots; raise rather than silently evict."""


def calibrate_hot_k(counts, mass_lo: float = 0.5, mass_hi: float = 0.8,
                    batch_rows: Optional[int] = None,
                    dense_ratio: float = 2.0) -> Tuple[int, float]:
    """The hot-head size K from a frequency histogram (sorted descending
    here if it is not): the band of K whose head holds ``mass_lo`` ..
    ``mass_hi`` of the token mass, and within it, given ``batch_rows``,
    the largest K with ``K <= dense_ratio * batch_rows * cdf[K-1]`` (a
    dense reconcile of K rows against the head hits a batch would route).
    Without ``batch_rows`` the band's floor.  Returns ``(K, cdf[K-1])``."""
    counts = np.asarray(counts, dtype=np.float64).ravel()
    if counts.size == 0:
        return 0, 0.0
    if np.any(np.diff(counts) > 0):
        counts = np.sort(counts)[::-1]
    total = counts.sum()
    if total <= 0:
        return 0, 0.0
    cdf = np.cumsum(counts) / total
    k_lo = int(np.searchsorted(cdf, mass_lo, side="left")) + 1
    k_hi = int(np.searchsorted(cdf, mass_hi, side="left")) + 1
    k_lo = max(1, min(k_lo, counts.size))
    k_hi = max(k_lo, min(k_hi, counts.size))
    k = k_lo
    if batch_rows:
        ks = np.arange(1, counts.size + 1, dtype=np.float64)
        ok = ((ks >= k_lo) & (ks <= k_hi)
              & (ks <= dense_ratio * float(batch_rows) * cdf))
        hits = np.flatnonzero(ok)
        if hits.size:
            k = int(hits[-1]) + 1
    return k, float(cdf[k - 1])



def window_wire_format(rows: int, capacity: int, row_bytes: int,
                       dense_ratio: float = 2.0,
                       expected_unique: Optional[float] = None,
                       quant: str = "off",
                       quant_row_bytes: Optional[int] = None,
                       quant_guard: float = 1.25,
                       sketch: bool = False) -> str:
    """Wire format for one coalesced push window: the decision of
    :func:`price_window_formats`."""
    decision, _ = price_window_formats(
        rows, capacity, row_bytes, dense_ratio=dense_ratio,
        expected_unique=expected_unique, quant=quant,
        quant_row_bytes=quant_row_bytes, quant_guard=quant_guard,
        sketch=sketch)
    return decision


def price_window_formats(rows: int, capacity: int, row_bytes: int,
                         dense_ratio: float = 2.0,
                         expected_unique: Optional[float] = None,
                         quant: str = "off",
                         quant_row_bytes: Optional[int] = None,
                         quant_guard: float = 1.25,
                         sketch: bool = False):
    """``(decision, prices)`` for one window: every format priced, mapped
    to its modeled byte volume, over ``eff = min(rows, capacity,
    expected_unique)`` effective rows (``expected_unique``: the rows the
    dedup leaves, from ``cluster.hashfrag.expected_unique_rows``).

      dense          ``capacity * row_bytes``
      sparse         ``eff * (4 + row_bytes)``
      bitmap         ``capacity / 8 + eff * (row_bytes - 4)``
      sparse_sketch  ``transfer.sketch.sketch_wire_bytes``
      sparse_q       ``eff * (4 + quant_row_bytes)``

    The window densifies once ``sparse * dense_ratio >= dense`` (SparCML,
    arXiv:1802.08021).  With ``quant`` off and ``sketch`` unset only the
    2-way pair is priced.  Past 2-way the sketch rung is always priced
    and wins only when ``sketch`` is armed; ``sparse_q`` wins only when
    its volume times ``quant_guard`` still beats the best lossless
    rung.  Host-static: a window bakes in one format."""
    eff = float(min(rows, capacity))
    if expected_unique is not None:
        eff = min(eff, float(expected_unique))
    sparse_vol = eff * (4.0 + row_bytes)
    dense_vol = float(capacity) * row_bytes
    prices = {"sparse": sparse_vol, "dense": dense_vol}
    if sparse_vol * dense_ratio >= dense_vol:
        return "dense", prices
    if quant == "off" and not sketch:
        return "sparse", prices
    value_bytes = max(float(row_bytes) - 4.0, 0.0)
    bitmap_vol = capacity / 8.0 + eff * value_bytes
    prices["bitmap"] = bitmap_vol
    from swiftmpi_tpu_torch.transfer.sketch import sketch_wire_bytes
    sketch_vol = sketch_wire_bytes(capacity, eff, value_bytes)
    prices["sparse_sketch"] = sketch_vol
    best, best_vol = "sparse", sparse_vol
    if bitmap_vol < best_vol:
        best, best_vol = "bitmap", bitmap_vol
    if sketch and sketch_vol < best_vol:
        best, best_vol = "sparse_sketch", sketch_vol
    if quant != "off" and quant_row_bytes is not None:
        q_vol = eff * (4.0 + float(quant_row_bytes))
        prices["sparse_q"] = q_vol
        if q_vol * quant_guard <= best_vol:
            return "sparse_q", prices
    return best, prices


def price_hot_collectives(capacity: int, width_bytes: int,
                          touched_fraction: Optional[float],
                          sparse_ar_ratio: float = 2.0):
    """``(decision, prices)`` of a capacity-shaped reconcile (the hybrid's
    hot plane, the window's dense rung): ``psum`` (``capacity *
    width_bytes``) against ``sparse_allreduce`` (``touched * (4 +
    width_bytes)``, ``touched = touched_fraction * capacity``), the byte
    models of ``transfer.sparse_allreduce``.  The dense psum wins while
    ``sparse * sparse_ar_ratio >= dense``, and always without a
    ``touched_fraction``."""
    from swiftmpi_tpu_torch.transfer.sparse_allreduce import (
        dense_psum_bytes, sparse_ar_bytes)
    dense_vol = dense_psum_bytes(capacity, width_bytes)
    if touched_fraction is None:
        return "psum", {"psum": dense_vol}
    frac = min(max(float(touched_fraction), 0.0), 1.0)
    sparse_vol = sparse_ar_bytes(frac * capacity, width_bytes)
    prices = {"psum": dense_vol, "sparse_allreduce": sparse_vol}
    if sparse_vol * sparse_ar_ratio >= dense_vol:
        return "psum", prices
    return "sparse_allreduce", prices


class HotColdPartition:
    """Frequency split of the key space: ``hot_keys[i]`` owns hot slot
    ``i`` (slot order is frequency rank); every other key is tail."""

    def __init__(self, hot_keys):
        hot = np.asarray(hot_keys, dtype=np.uint64).ravel()
        if np.unique(hot).size != hot.size:
            raise ValueError("hot_keys must be distinct")
        self.hot_keys = hot
        self.n_hot = int(hot.size)
        self.head_mass: Optional[float] = None
        self._order = np.argsort(hot, kind="stable")
        self._sorted = hot[self._order]

    @classmethod
    def from_counts(cls, keys, counts, mass_lo: float = 0.5,
                    mass_hi: float = 0.8,
                    batch_rows: Optional[int] = None) -> "HotColdPartition":
        """:func:`calibrate_hot_k` over the counts, then the top K keys by
        ``(-count, key)``: the key breaks ties, so the hot set depends on
        the histogram only, not on the input order."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        counts = np.asarray(counts, dtype=np.int64).ravel()
        if keys.shape != counts.shape:
            raise ValueError("keys/counts length mismatch")
        order = np.lexsort((keys, -counts))
        k, mass = calibrate_hot_k(counts[order], mass_lo, mass_hi,
                                  batch_rows)
        part = cls(keys[order][:k])
        part.head_mass = mass
        return part

    def hot_slot(self, keys) -> np.ndarray:
        """Vectorized key -> hot slot; -1 for tail keys."""
        arr = np.asarray(keys, dtype=np.uint64)
        flat = arr.ravel()
        out = np.full(flat.shape, -1, dtype=np.int64)
        if self.n_hot:
            pos = np.minimum(np.searchsorted(self._sorted, flat),
                             self.n_hot - 1)
            match = self._sorted[pos] == flat
            out[match] = self._order[pos[match]]
        return out.reshape(arr.shape)

    def is_hot(self, keys) -> np.ndarray:
        return self.hot_slot(keys) >= 0

    def items(self) -> Iterable:
        """(key, hot_slot) pairs in hot-slot (frequency-rank) order."""
        return zip(self.hot_keys.tolist(), range(self.n_hot))

    def __eq__(self, other) -> bool:
        return (isinstance(other, HotColdPartition)
                and np.array_equal(self.hot_keys, other.hot_keys))

    def __repr__(self) -> str:  # pragma: no cover
        mass = (f", head_mass={self.head_mass:.3f}"
                if self.head_mass is not None else "")
        return f"HotColdPartition(n_hot={self.n_hot}{mass})"


class RepartitionPlan:
    """Row-movement recipe produced by :meth:`KeyIndex.repartition`.

    All arrays are parallel src/dst index pairs in the NEW layout's
    coordinate frames (hot arrays indexed by frequency rank, tail arrays
    by their tail row ``shard * capacity_per_shard + local``; the tail
    frame is repartition-invariant, only the unified offset ``n_hot``
    moves):

    * ``demote_src``/``demote_dst``: old hot rank -> tail row, for keys
      leaving the hot head (their hot row is written back into the tail
      so no update is lost).
    * ``hot_from_hot_src``/``hot_from_hot_dst``: old rank -> new rank,
      for keys staying hot.
    * ``hot_from_tail_src``/``hot_from_tail_dst``: tail row -> new rank,
      for promoted keys that own a tail slot (its row seeds the new hot
      row; the tail slot stays allocated and goes dormant under the hot
      overlay).  Promoted keys without one start from a fresh init.
    """

    def __init__(self, old_n_hot: int, new_n_hot: int,
                 demote_src, demote_dst,
                 hot_from_hot_src, hot_from_hot_dst,
                 hot_from_tail_src, hot_from_tail_dst):
        self.old_n_hot = int(old_n_hot)
        self.new_n_hot = int(new_n_hot)
        self.demote_src = np.asarray(demote_src, np.int64)
        self.demote_dst = np.asarray(demote_dst, np.int64)
        self.hot_from_hot_src = np.asarray(hot_from_hot_src, np.int64)
        self.hot_from_hot_dst = np.asarray(hot_from_hot_dst, np.int64)
        self.hot_from_tail_src = np.asarray(hot_from_tail_src, np.int64)
        self.hot_from_tail_dst = np.asarray(hot_from_tail_dst, np.int64)

    @property
    def moved_rows(self) -> int:
        return int(self.demote_src.size + self.hot_from_hot_src.size
                   + self.hot_from_tail_src.size)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"RepartitionPlan({self.old_n_hot}->{self.new_n_hot} hot, "
                f"demote={self.demote_src.size}, "
                f"stay={self.hot_from_hot_src.size}, "
                f"promote={self.hot_from_tail_src.size})")


class KeyIndex:
    def __init__(self, num_shards: int, capacity_per_shard: int,
                 hashfrag: Optional[HashFrag] = None,
                 partition: Optional[HotColdPartition] = None):
        self.num_shards = int(num_shards)
        self.capacity_per_shard = int(capacity_per_shard)
        self.hashfrag = hashfrag or HashFrag(num_shards)
        if self.hashfrag.num_shards != self.num_shards:
            raise ValueError("hashfrag shard count mismatch")
        self.partition = partition
        self.n_hot = partition.n_hot if partition is not None else 0
        self._slot_of: Dict[int, int] = {}     # tail keys, first-touch order
        self._next_local = np.zeros(self.num_shards, dtype=np.int64)
        # the probe: open addressing over the tail keys, the dict's mirror
        self._ht_size = 0
        self._ht_keys = np.empty(0, np.uint64)
        self._ht_slots = np.empty(0, np.int64)

    # -- vectorized hash table --------------------------------------------
    def _ht_grow(self, min_items: int) -> None:
        """A table of at least twice ``min_items`` buckets, every dict
        pair re-inserted."""
        size = 1024
        while size < 2 * min_items:
            size *= 2
        self._ht_size = size
        self._ht_keys = np.zeros(size, np.uint64)
        self._ht_slots = np.full(size, -1, np.int64)
        if self._slot_of:
            keys = np.fromiter(self._slot_of.keys(), np.uint64,
                               len(self._slot_of))
            slots = np.fromiter(self._slot_of.values(), np.int64,
                                len(self._slot_of))
            self._ht_insert(keys, slots)

    def _ht_insert(self, keys: np.ndarray, slots: np.ndarray) -> None:
        """Insert DISTINCT keys in claim rounds: every pending key probes
        its bucket, one winner per free bucket writes, the rest advance
        one bucket."""
        mask = np.uint64(self._ht_size - 1)
        idx = get_hash_code_np(keys) & mask
        pending = np.arange(len(keys))
        while pending.size:
            cur = idx[pending].astype(np.int64)
            cand_pos = np.flatnonzero(self._ht_slots[cur] < 0)
            if cand_pos.size:
                buckets, first = np.unique(cur[cand_pos],
                                           return_index=True)
                winners = pending[cand_pos[first]]
                self._ht_keys[buckets] = keys[winners]
                self._ht_slots[buckets] = slots[winners]
                won = np.zeros(len(keys), bool)
                won[winners] = True
                pending = pending[~won[pending]]
                if not pending.size:
                    break
            idx[pending] = (idx[pending] + np.uint64(1)) & mask

    def _ht_find(self, flat: np.ndarray) -> np.ndarray:
        """Vectorized probe: slots for present keys, -1 for absent."""
        out = np.full(flat.shape, -1, np.int64)
        if self._ht_size == 0:
            return out
        mask = np.uint64(self._ht_size - 1)
        idx = get_hash_code_np(flat) & mask
        active = np.arange(flat.size)
        while active.size:
            cur = idx[active].astype(np.int64)
            slots_at = self._ht_slots[cur]
            empty = slots_at < 0
            match = (~empty) & (self._ht_keys[cur] == flat[active])
            out[active[match]] = slots_at[match]
            active = active[~(empty | match)]   # a different key's bucket
            if active.size:
                idx[active] = (idx[active] + np.uint64(1)) & mask
        return out

    # -- core -------------------------------------------------------------
    def lookup(self, keys, create: bool = True) -> np.ndarray:
        """Map keys -> int32 slots; unknown keys get fresh slots in their
        owning shard when ``create`` (lazy init), else -1.  A hot key's
        slot is its frequency rank, whatever the tail holds."""
        keys = np.asarray(keys, dtype=np.uint64)
        flat = keys.ravel()
        out = self._ht_find(flat)
        if self.partition is not None:
            hot = self.partition.hot_slot(flat)
            out = np.where(hot >= 0, hot, out)
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
        slots = self.n_hot + shards * self.capacity_per_shard \
            + self._next_local[shards] + occ
        self._next_local += counts
        self._slot_of.update(zip(uniq.tolist(), slots.tolist()))
        if 2 * len(self._slot_of) >= self._ht_size:
            self._ht_grow(len(self._slot_of))   # re-inserts everything
        else:
            self._ht_insert(uniq, slots)
        rank = np.empty(len(uniq), np.int64)
        rank[order] = np.arange(len(uniq))
        return slots[rank[inv.ravel()]]

    def shard_of(self, keys) -> np.ndarray:
        return self.hashfrag.to_shard_id(keys)

    # -- introspection ----------------------------------------------------
    @property
    def capacity(self) -> int:
        """Tail (sharded) capacity: the row count of the sharded fields."""
        return self.num_shards * self.capacity_per_shard

    @property
    def total_capacity(self) -> int:
        """Hot + tail: the size of the unified slot space."""
        return self.n_hot + self.capacity

    def __len__(self) -> int:
        return self.n_hot + len(self._slot_of)

    def _hot_slot(self, key) -> int:
        if self.partition is None:
            return -1
        return int(self.partition.hot_slot(np.uint64(key)))

    def __contains__(self, key) -> bool:
        return self._hot_slot(key) >= 0 or int(key) in self._slot_of

    def slot(self, key: int) -> int:
        hs = self._hot_slot(key)
        return hs if hs >= 0 else self._slot_of[int(key)]

    def keys(self) -> Iterable[int]:
        """Hot keys in frequency-rank order, then tail keys in insertion
        order."""
        if self.partition is None:
            return self._slot_of.keys()
        return chain(self.partition.hot_keys.tolist(), self._slot_of.keys())

    def items(self) -> Iterable:
        """(key, slot) pairs in :meth:`keys` order."""
        if self.partition is None:
            return self._slot_of.items()
        return chain(self.partition.items(), self._slot_of.items())

    def shard_fill(self) -> np.ndarray:
        """Occupied tail slots per shard (load-balance introspection)."""
        return self._next_local.copy()

    # -- growth ------------------------------------------------------------
    def grow(self, new_capacity_per_shard: int) -> None:
        """Raise the per-shard capacity, remapping every tail slot to
        ``n_hot + shard * new_cap + local`` (locals, and so each shard's
        insertion order, kept; hot slots never move).  The table's rows
        must move to match: use ``SparseTable.grow``, which calls this."""
        new = int(new_capacity_per_shard)
        old = self.capacity_per_shard
        if new <= old:
            raise ValueError(f"new capacity {new} must exceed {old}")
        self.capacity_per_shard = new
        keys = np.fromiter(self._slot_of.keys(), np.uint64,
                           len(self._slot_of))
        rows = np.fromiter(self._slot_of.values(), np.int64,
                           len(self._slot_of)) - self.n_hot
        slots = self.n_hot + rows // old * new + rows % old
        self._slot_of = dict(zip(keys.tolist(), slots.tolist()))
        self._ht_grow(max(len(self._slot_of), 1))   # slot values changed

    # -- online re-partition ----------------------------------------------
    def repartition(self, new_partition: Optional[HotColdPartition]
                    ) -> RepartitionPlan:
        """Swap the hot/cold split in place (JAX ``KeyIndex.repartition``),
        keeping every key: keys leaving the head get (or reuse) tail
        slots, keys entering it take their frequency-rank hot slot, and
        every tail slot keeps its shard-local row — only the unified
        offset ``n_hot`` moves.  Returns the :class:`RepartitionPlan`
        that ``SparseTable.repartition`` replays on the rows.

        All or nothing: the demoted keys' shard occupancy is checked
        BEFORE any change, so a :class:`CapacityError` leaves the index
        exactly as it was."""
        old = self.partition
        old_hot = (old.hot_keys if old is not None
                   else np.empty(0, np.uint64))
        new_hot = (new_partition.hot_keys if new_partition is not None
                   else np.empty(0, np.uint64))
        old_n_hot, new_n_hot = int(old_hot.size), int(new_hot.size)
        in_new = (np.zeros(old_hot.shape, bool) if new_partition is None
                  else new_partition.is_hot(old_hot))
        demoted = old_hot[~in_new]              # rank order kept
        demote_src = np.flatnonzero(~in_new)
        # capacity precheck for demoted keys with no tail slot yet,
        # before any state changes
        have = self._ht_find(demoted) if demoted.size else \
            np.empty(0, np.int64)
        missing = demoted[have < 0]
        if missing.size:
            shards = self.hashfrag.to_shard_id(missing).astype(np.int64)
            counts = np.bincount(shards, minlength=self.num_shards)
            over = self._next_local + counts > self.capacity_per_shard
            if over.any():
                s = int(np.flatnonzero(over)[0])
                raise CapacityError(
                    f"repartition needs {int(counts[s])} tail slots on "
                    f"full shard {s} ({self.capacity_per_shard} slots); "
                    "grow the table first")
        # -- the change: tail slots shift to the new hot offset
        delta = new_n_hot - old_n_hot
        if delta:
            self._slot_of = {k: v + delta for k, v in self._slot_of.items()}
        self.partition = new_partition
        self.n_hot = new_n_hot
        self._ht_grow(max(len(self._slot_of), 1))   # slot values changed
        # demoted keys: their tail slots, made for those without one (the
        # precheck guarantees _create has room)
        if demoted.size:
            demote_slots = self._ht_find(demoted)
            miss_pos = np.flatnonzero(demote_slots < 0)
            if miss_pos.size:
                demote_slots[miss_pos] = self._create(demoted[miss_pos])
            demote_dst = demote_slots - new_n_hot   # tail rows
        else:
            demote_dst = np.empty(0, np.int64)
        # keys staying hot: old rank -> new rank
        stayed_src = np.flatnonzero(in_new)
        stayed_dst = (new_partition.hot_slot(old_hot[in_new])
                      if stayed_src.size else np.empty(0, np.int64))
        # promoted keys with a tail slot: seeded from it
        if new_n_hot:
            was_hot = (old.is_hot(new_hot) if old is not None
                       else np.zeros(new_hot.shape, bool))
            promoted = new_hot[~was_hot]
            tail_slots = self._ht_find(promoted)
            seeded = tail_slots >= 0
            hot_from_tail_src = tail_slots[seeded] - new_n_hot
            hot_from_tail_dst = new_partition.hot_slot(promoted[seeded])
        else:
            hot_from_tail_src = np.empty(0, np.int64)
            hot_from_tail_dst = np.empty(0, np.int64)
        return RepartitionPlan(
            old_n_hot, new_n_hot, demote_src, demote_dst,
            stayed_src, stayed_dst, hot_from_tail_src, hot_from_tail_dst)

    # -- checkpoint restore ------------------------------------------------
    def restore(self, keys, slots) -> None:
        """Rebuild the index from saved ``(key, slot)`` pairs (insertion
        order = the pairs' order), keeping the ``n_hot + shard *
        capacity_per_shard + local`` layout: each shard's next free row
        follows its highest restored local row.  A hot pair must be the
        active partition's own (a checkpoint of another frequency split
        raises instead of scrambling rows)."""
        keys = np.asarray(keys, np.uint64).ravel()
        slots = np.asarray(slots, np.int64).ravel()
        hot = slots < self.n_hot
        if self.partition is not None and hot.any():
            wrong = self.partition.hot_slot(keys[hot]) != slots[hot]
        else:
            wrong = hot[hot]
        if wrong.any():
            i = int(np.flatnonzero(wrong)[0])
            raise ValueError(
                f"hot slot {int(slots[hot][i])} for key {int(keys[hot][i])} "
                "does not match the active HotColdPartition: rebuild the "
                "vocab (and its partition) before restoring")
        keys, slots = keys[~hot], slots[~hot]
        shards, local = np.divmod(slots - self.n_hot,
                                  self.capacity_per_shard)
        bad = shards >= self.num_shards
        if bad.any():
            raise ValueError(f"slot {int(slots[bad][0])} outside the table "
                             "layout")
        self._slot_of = dict(zip(keys.tolist(), slots.tolist()))
        self._next_local = np.zeros(self.num_shards, np.int64)
        np.maximum.at(self._next_local, shards, local + 1)
        self._ht_grow(max(len(self._slot_of), 1))

    # -- elastic ownership (cross-process repartition) ----------------------
    def shard_rows(self, shard: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(keys, slots)`` of every assigned tail key in ``shard``, in
        insertion order: the export manifest when the shard moves to
        another process.  Gather the table rows at ``slots``, encode them
        as a delta keyed by ``keys``, and the receiver re-creates the keys
        in its own layout (slot values are process-local and never cross
        the wire)."""
        shard, per = int(shard), self.capacity_per_shard
        pairs = [(k, v) for k, v in self._slot_of.items()
                 if (v - self.n_hot) // per == shard]
        keys = np.asarray([k for k, _ in pairs], np.int64)
        slots = np.asarray([v for _, v in pairs], np.int64)
        return keys, slots

    def adopt_owner_map(self, owner_of_shard, epoch: int) -> None:
        """Adopt an elastic member table's shard -> rank ownership
        (``cluster/membership.py``).  The map is advisory routing state:
        it moves no local rows itself (the elastic worker ships the
        deltas), but its epoch is guarded: adopting an older epoch than
        the one already applied means this process acts on a stale world
        view, the split-brain the epoch protocol exists to prevent."""
        from swiftmpi_tpu_torch.cluster.membership import StaleEpochError
        owner = tuple(int(r) for r in owner_of_shard)
        if len(owner) != self.num_shards:
            raise ValueError(
                f"owner map covers {len(owner)} shards; this index "
                f"routes {self.num_shards}")
        cur = getattr(self, "owner_epoch", -1)
        if int(epoch) < cur:
            raise StaleEpochError(
                f"adopt_owner_map: epoch {epoch} regressed below "
                f"adopted epoch {cur}")
        # epoch-guard: regression raises StaleEpochError above; the
        # ownership state below only ever moves forward in epoch
        self.shard_owner = owner
        self.owner_epoch = int(epoch)

    def owner_moves(self, new_owner, rank: int
                    ) -> Tuple[Dict[int, List[int]], List[int]]:
        """Diff the adopted owner map against ``new_owner`` from
        ``rank``'s seat: returns ``(outbound, inbound)`` where
        ``outbound`` maps destination rank -> the local shards to export
        there (each with :meth:`shard_rows`) and ``inbound`` is the shards
        arriving.  Raises if no map was adopted yet."""
        old = getattr(self, "shard_owner", None)
        if old is None:
            raise ValueError("owner_moves: no owner map adopted yet")
        new = tuple(int(r) for r in new_owner)
        if len(new) != len(old):
            raise ValueError(
                f"owner map length changed: {len(old)} -> {len(new)}")
        outbound: Dict[int, List[int]] = {}
        inbound: List[int] = []
        for s, (o, n) in enumerate(zip(old, new)):
            if o == n:
                continue
            if o == rank:
                outbound.setdefault(n, []).append(s)
            elif n == rank:
                inbound.append(s)
        return outbound, inbound
