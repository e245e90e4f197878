"""``hybrid`` transfer backend: the frequency head in hot planes, the
tail sharded (counterpart of ``swiftmpi_tpu/transfer/hybrid.py``).

Zipf traffic puts most of a step's rows on a small frequency head.  The
hybrid backend splits the unified slot space a ``HotColdPartition``
defines (``parameter/key_index.py``):

* **hot** (``slot < n_hot``): the rows live in the ``f@hot`` planes, one
  replica per device (``parameter/sparse_table.py``).  A pull reads them
  with the gather kernel at 0 wire bytes.  A push sums every rank's hot
  rows into an ``(n_hot, W)`` accumulator with one scatter-add launch a
  family (the counts from the same launch), which on one card is the
  whole reconcile, the JAX package's per-device scatter plus ``psum``;
  then the AdaGrad kernel updates the whole hot plane, the mean's
  reciprocal inside it (an untouched row sees a zero gradient, as in
  JAX).  Only the summation order differs from JAX.
* **tail** (``slot >= n_hot``): re-based by ``-n_hot`` and routed by the
  :class:`~swiftmpi_tpu_torch.transfer.sharded.ShardedTransfer` over the
  same rank layout.

Batches are padded to a multiple of the rank count with ``-1`` slots and
zero grads (stencil spans are B + 2W rows) and sliced back.  A state with
no hot planes (``n_hot = 0``: LR, GloVe, a table built without a
partition) takes the tail path alone: bit for bit ``tpu``.

The window push is the interpreter's ``hot_split`` placement
(``Transfer._interpret_window_hot_split``): the padded window is
deduplicated once in the unified slot space (the tail's per-rank pass
over ``n_hot + cap_tail`` slots), the hot slice goes through
:meth:`_hot_push` with the deduplicated counts, and the tail slice runs
its own window plan on the ``tpu`` tail, already deduplicated (the tail's
encoded rungs and their ``@ef`` drain included: the ``@ef`` and
``@rowver`` planes are tail-shaped and go with the tail in
``_split_state``; hot rows are never quantized and carry no versions).
The hot plan picks the hot reconcile's collective: ``psum``
(:meth:`_hot_push`) or ``sparse_allreduce`` (:meth:`_hot_push_sparse`).
With ``n_hot == 0`` the whole window goes to the tail.  The window and
pull knobs (``window_expected_unique``, ``wire_quant``, ``wire_sketch``,
the dense ratios, ``collective_mode``, ``pull_quant``, ``pull_cache``
...) live on the tail, which prices the window and the tail's pulls; the
hot plan reads them through this backend.

The data axis (a run of ``dp`` processes, JAX's ``(data, shard)``
mesh): every process holds the hot planes and the tail over its own
``n`` ranks, and pads its own batch to a multiple of ``n``.  The tail
reconciles as ``tpu`` does; the hot push scatters this process's hot
rows and counts (B3), sums the ``(n_hot, W)`` accumulators and the
counts over the processes in process order (``Transfer._dp_psum``, the
JAX package's psum over ``(data, shard)``, in the grads' float32), and
only then applies (B1), so every replica applies the same bits.  The
sparse-allreduce rung sums the same planes: in JAX its buckets are
psum'd over ``dp`` between the reduce-scatter and the all-gather, which
on one program per process is the same sum.

``traffic()`` reports ``routed_rows`` (the tail's), ``hot_rows`` (hot
hits of pulls and pushes), ``psum_bytes`` (``n_hot x`` (grad row bytes
+ 4) a dense hot push, the touched rows' bytes a sparse one, plus the
bytes sent to other processes under ``dp > 1``, the tail's included),
``overflow_dropped`` and the ledger keys, the tail's and the hot
exchanges' summed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
from swiftmpi_tpu_torch.parameter.sparse_table import (base_field, hot_name,
                                                       is_hot_field)
from swiftmpi_tpu_torch.transfer.api import WIRE_KEYS, Transfer
from swiftmpi_tpu_torch.transfer.sharded import ShardedTransfer


class HybridTransfer(Transfer):
    name = "hybrid"

    def __init__(self, mesh, bucket_capacity: Optional[int] = None,
                 debug_overflow: bool = False, data_plane: str = "auto"):
        self.tail = ShardedTransfer(mesh, bucket_capacity, debug_overflow,
                                    data_plane=data_plane)
        super().__init__()
        # one Counter for both: the tail's routed paths and the hot ones
        self.push_paths = self.tail.push_paths

    # -- attributes of the tail --------------------------------------------
    @property
    def count_traffic(self) -> bool:
        return self.tail.count_traffic

    @count_traffic.setter
    def count_traffic(self, flag: bool):
        self.tail.count_traffic = bool(flag)

    @property
    def n(self) -> int:
        return self.tail.n

    @property
    def mesh(self):
        return self.tail.mesh

    @property
    def metrics(self):
        """The tail's ``utils.timers.Metrics`` (or None): the tail's
        gauges and :meth:`traffic`'s ``transfer_hot_rows`` and
        ``transfer_psum_bytes``."""
        return self.tail.metrics

    @metrics.setter
    def metrics(self, m):
        self.tail.metrics = m

    @property
    def bucket_capacity(self) -> Optional[int]:
        return self.tail.bucket_capacity

    def set_data_axis(self, dp: int, rank: int) -> None:
        super().set_data_axis(dp, rank)
        self.tail.set_data_axis(dp, rank)

    def wire_dense_ratio(self, family=None) -> float:
        return self.tail.wire_dense_ratio(family)

    def set_wire_dense_ratio(self, ratio, family=None) -> None:
        self.tail.set_wire_dense_ratio(ratio, family)

    def overflow_count(self) -> int:
        return self.tail.overflow_count()

    # -- hot/tail split ----------------------------------------------------
    @staticmethod
    def _n_hot(state) -> int:
        for f, v in state.items():
            if is_hot_field(f):
                return int(v.shape[0])
        return 0

    @staticmethod
    def _split_state(state):
        tail = {f: v for f, v in state.items() if not is_hot_field(f)}
        hot = {base_field(f): v for f, v in state.items()
               if is_hot_field(f)}
        return tail, hot

    def _pad_batch(self, slots, grads=None, counts=None):
        """Pad the batch to a multiple of the rank count with ``-1``
        slots, zero grad rows and zero counts.  Returns ``(slots, grads,
        counts, B)``, B the length before padding."""
        B = slots.shape[0]
        pad = (-B) % self.n
        if pad == 0:
            return slots, grads, counts, B
        slots = torch.cat([slots, slots.new_full((pad,), -1)])
        if grads is not None:
            grads = {f: torch.cat([g, g.new_zeros((pad, g.shape[1]))])
                     for f, g in grads.items()}
        if counts is not None:
            counts = torch.cat([counts.float(), counts.new_zeros(
                pad, dtype=torch.float32)])
        return slots, grads, counts, B

    # -- traffic accounting ------------------------------------------------
    def _record_hot(self, rows, psum_bytes) -> None:
        self._book(rows, hot_rows=rows, psum_bytes=psum_bytes)

    def _record_hot_sparse(self, rows, row_bytes: int) -> None:
        """The sparse hot reconcile's rows and bytes: the touched rows at
        ``row_bytes`` each, not the whole head."""
        self._record_hot(rows, rows * int(row_bytes))

    def pull_shadow_flush(self) -> None:
        # the tail runs the live cache shadow; flush both
        self.tail.pull_shadow_flush()
        super().pull_shadow_flush()

    def _ledger_owners(self) -> list:
        return [self, self.tail]

    def traffic(self) -> Dict[str, int]:
        """``routed_rows``, ``hot_rows``, ``psum_bytes``,
        ``overflow_dropped`` and the ledger keys, the tail's ledger and
        this backend's own (the hot reads and exchanges) summed."""
        t = self.tail.traffic()
        w = self.wire_traffic()
        out = {"routed_rows": t["routed_rows"],
               "hot_rows": self._count("hot_rows"),
               "psum_bytes": self._count("psum_bytes") + t["psum_bytes"],
               "overflow_dropped": t["overflow_dropped"]}
        out.update({k: t[k] + w[k] for k in WIRE_KEYS})
        if self.metrics is not None:
            self.metrics.set("transfer_hot_rows", out["hot_rows"])
            self.metrics.set("transfer_psum_bytes", out["psum_bytes"])
        return out

    # the pull is the base interpreter's hot_split placement
    # (``Transfer._interpret_pull_hot_split``)

    # -- push --------------------------------------------------------------
    def push(self, state, slots, grads, access, mean: bool = False,
             counts=None):
        """The tail through the sharded push with re-based slots, the hot
        rows through :meth:`_hot_push`; ``counts`` marks a span family
        (``push_span``)."""
        slots, grads, counts, _ = self._pad_batch(slots.to(torch.int32),
                                                  grads, counts)
        tail_state, hot_state = self._split_state(state)
        n_hot = self._n_hot(state)
        if n_hot == 0:
            self.tail.push(tail_state, slots, grads, access, mean=mean,
                           counts=counts)
            return state
        is_hot = (slots >= 0) & (slots < n_hot)
        tail_slots = torch.where(slots >= n_hot, slots - n_hot, -1)
        self.tail.push(tail_state, tail_slots, grads, access, mean=mean,
                       counts=counts)
        if self.count_traffic:
            # grad row bytes + the float32 counts column, the whole head
            width = sum(g.element_size() * g.shape[1]
                        for g in grads.values()) + 4
            n = is_hot.sum()
            self._record_hot(n, n_hot * width)
            self._record_exchange(n_hot, width, on=n)
        self._hot_push(hot_state, slots, is_hot, grads, access, mean,
                       counts)
        return state

    def push_span(self, state, slots, grads, counts, access,
                  mean: bool = False):
        """Span push: rows carry summed contributions with their data
        counts; both planes divide by the summed counts."""
        return self.push(state, slots, grads, access, mean=mean,
                         counts=counts)

    def _hot_push(self, hot_state, slots, is_hot, grads, access, mean,
                  counts, path: str = "hot") -> None:
        """Sum the hot rows of every rank into ``(n_hot, W)`` per family
        (the scatter-add kernel, invalid and tail rows dropped) and apply
        the access rule over the whole hot plane in place (the AdaGrad
        kernel, the mean's reciprocal inside it)."""
        n_hot = next(iter(hot_state.values())).shape[0]
        families = ",".join(sorted(grads))
        self.push_paths[f"{families}:"
                        f"{path + '_span' if counts is not None else path}"
                        ] += 1
        acc, csum = {}, None
        for f in sorted(grads):
            # a mean push without data counts takes them from its first
            # family's launch
            take = mean and counts is None and csum is None
            res = masked_scatter_add(slots, is_hot, grads[f].contiguous(),
                                     n_hot, counts=take)
            if take:
                res, csum = res
            acc[f] = res
        if mean and counts is not None:
            csum = masked_scatter_add(slots, is_hot,
                                      counts.reshape(-1, 1).contiguous(),
                                      n_hot)[:, 0]
        if self.dp > 1:
            # JAX's psum over (data, shard): every process's planes and
            # counts, summed in process order before the one apply
            names = sorted(acc)
            summed = self._dp_psum([acc[f] for f in names]
                                   + ([csum] if mean else []))
            acc = dict(zip(names, summed))
            if mean:
                csum = summed[-1]
        inv = 1.0 / csum.clamp(min=1.0) if mean else None
        access.apply_push(hot_state, acc, mul=inv)

    def _hot_push_sparse(self, hot_state, slots, is_hot, grads, access, mean,
                         counts) -> None:
        """The hot reconcile as a sparse allreduce (JAX ``_hot_push_sparse``).
        In JAX each rank scatters its touched hot rows into a plane permuted
        by row-hash bucket (row ``r`` to bucket ``r % n``), a reduce-scatter
        sums the buckets across ranks and an all-gather hands the reduced rows
        back.  With every rank on one card that is one sum of all ranks' hot
        rows: one scatter-add launch a family onto the unpermuted ``(n_hot,
        W)`` plane (the bucket permutation only relabels rows, so the plane
        is not permuted: a permuted scatter would be followed by an
        unpermuting copy that moves the head once more for nothing), then the
        AdaGrad kernel over the plane.  It equals the dense reconcile up to
        the order of float sums, as in JAX; only the push path
        (``<families>:hot_sparse``) and the ledger differ."""
        self._hot_push(hot_state, slots, is_hot, grads, access, mean, counts,
                       path="hot_sparse")


def _tail_knob(name: str) -> property:
    def get(self):
        return getattr(self.tail, name)

    def set(self, value):
        setattr(self.tail, name, value)
    return property(get, set, doc=f"``{name}`` of the tail, which prices "
                    "the window")


for _knob in ("window_expected_unique", "wire_quant", "wire_quant_guard",
              "wire_sketch", "collective_mode", "hot_touched_fraction",
              "sparse_ar_ratio", "pull_quant", "pull_quant_guard",
              "pull_cache", "pull_cache_oracle"):
    setattr(HybridTransfer, _knob, _tail_knob(_knob))
