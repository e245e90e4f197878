"""Single-device transfer backend (counterpart of
``swiftmpi_tpu/transfer/xla.py``; keeps ``name = "xla"`` so
``[cluster] transfer: xla`` selects it).

* ``pull`` is the masked row gather kernel (``kernels/gather.py``).
* the dense push scatters the whole batch into a capacity-shaped
  accumulator with the scatter-add kernel (``kernels/scatter.py``), one
  launch per family — for ``mean=True`` the first family's launch also
  returns the per-slot counts — and runs the AdaGrad kernel
  (``kernels/adagrad.py``) over the whole table, the mean's division by
  the counts inside it.  Untouched rows see zero gradient and are exact
  no-ops.
* the sparse push sorts the batch so duplicates are adjacent and
  segment-sums them; the row-indexed AdaGrad kernel then updates the one
  representative slot of each segment in place, over all B segment rows
  with a mask ``arange(B) < n_real`` made on the device, so the push reads
  nothing back to the host (an all-padding push updates nothing through
  the mask).  Like the JAX package, which leaves this path to XLA, the
  sort and the sums stay in torch index ops.
* ``push_span`` (stencil rendering, ``xla.py::push_span``) dedups a
  position-indexed span without a sort: a scatter-min of span positions
  into a ``(capacity,)`` plane names each slot's owner row, rows and
  counts fold into their owners with a span-local ``index_add_``, and the
  row-indexed AdaGrad kernel updates the owners' slots in place (the
  ``is_owner`` rows of JAX, distinct by construction).  No host read.

All three pushes update the table tensors in place, with shapes fixed by
the batch, and none reads the host: a step can be captured in a CUDA
graph.  Each stamps the slots it applies to in the ``@rowver`` plane, when
the state has one (``api.bump_row_versions``: the plane's max + 1).  The
window's sparse allreduce (``[cluster] collective``) is the base class's
one-program merge and full-table apply.  With ``count_traffic`` the base class books the ledger as
``XlaTransfer`` does, on the device's counters: a pull its valid rows, a
dense push every row without the index, a sparse push its valid rows, a
span push its valid rows with the counts column.

Across ``dp`` processes (the data axis, each process a full replica with
its own batch) every push is reconciled before the one update every
replica applies, one exchange a push: the dense push's per-family planes
and counts are summed over the processes in process order
(``Transfer._dp_psum``), so the AdaGrad kernel runs on identical sums
everywhere; the sparse and span pushes fold each process's rows per slot
with the scatter-add kernel, gather the folded rows, and sum them in
process order (``Transfer._dp_reconcile_rows``) before the row-indexed
AdaGrad kernel.  The mean divides by the counts summed the same way.
One global step over the concatenated batches, in another summation
order than one process's atomics.  An encoded window (``wire_quant``,
``wire_sketch``) is deduplicated over the whole global window, as the
JAX package's one program does it: the dedup primitive reconciles, and
the error feedback and the apply then run on the same global rows in
every process with no further exchange.
"""

from __future__ import annotations

from typing import Optional

import torch

from swiftmpi_tpu_torch.kernels.gather import masked_gather
from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
from swiftmpi_tpu_torch.parameter.sparse_table import ROWVER_KEY, ef_name
from swiftmpi_tpu_torch.transfer.api import (Transfer, _state_capacity,
                                             bump_row_versions,
                                             ef_quantize_window,
                                             grad_row_bytes, touched_rows)


class SingleTransfer(Transfer):
    name = "xla"

    def __init__(self, dense_apply: Optional[bool] = None):
        """``dense_apply``: True forces the dense full-table push, False
        the sparse push, None (the default) picks per call at the
        crossover (:meth:`Transfer.push`), as JAX's ``XlaTransfer``."""
        super().__init__()
        self.dense_apply = dense_apply

    def _push_is_dense(self, slots, capacity):
        if self.dense_apply is not None:
            return bool(self.dense_apply)
        return super()._push_is_dense(slots, capacity)

    def _prim_pull(self, state, slots, fields):
        valid = slots >= 0
        return {f: masked_gather(state[f], slots, valid) for f in fields}

    def _push_dense(self, state, slots, grads, access, mean=False):
        capacity = next(iter(state.values())).shape[0]
        valid = slots >= 0
        versions = ROWVER_KEY in state
        dense_grads, counts = {}, None
        for f, g in grads.items():
            # a mean push (or a versioned table's push, which stamps the
            # touched rows) takes the contribution counts from its first
            # family's scatter: one launch per family, no count pass
            if (mean or versions) and counts is None:
                acc, counts = masked_scatter_add(slots, valid, g.contiguous(),
                                                 capacity, counts=True)
            else:
                acc = masked_scatter_add(slots, valid, g.contiguous(),
                                         capacity)
            dense_grads[f] = acc
        if self.dp > 1:
            # the planes (and counts) of every process, summed in process
            # order: every replica applies the same bits
            names = sorted(dense_grads)
            summed = self._dp_psum([dense_grads[f] for f in names]
                                   + ([counts] if counts is not None
                                      else []))
            dense_grads = dict(zip(names, summed))
            if counts is not None:
                counts = summed[-1]
        scale = {}
        if mean:
            div = counts.clamp(min=1.0)
            # as the JAX package rounds: one family divides by its fused
            # count column, several multiply by the reciprocal; either
            # inside the AdaGrad launch
            scale = ({"div": div} if len(dense_grads) == 1
                     else {"mul": 1.0 / div})
        # in place over the whole table (JAX: donated state)
        access.apply_push(state, dense_grads, **scale)
        if versions:
            bump_row_versions(state[ROWVER_KEY], counts > 0)
        return state

    def _reconcile(self, slots, grads, counts, capacity):
        """``slots`` ``(B,)`` rows reconciled over the processes
        (:meth:`Transfer._dp_reconcile_rows`): ``(rep, grads, counts)``,
        the same ``dp * B`` rows on every process, distinct slots at the
        first positions and ``-1`` elsewhere."""
        rep, combined, cnt = self._dp_reconcile_rows(
            slots.to(torch.int32)[None],
            {f: g.contiguous()[None] for f, g in grads.items()},
            None if counts is None else counts.to(torch.float32)[None],
            capacity)
        return rep[0], {f: g[0] for f, g in combined.items()}, cnt[0]

    def _apply_rows(self, state, rep, grads, cnt, access, mean, capacity):
        """The row-indexed AdaGrad kernel at the distinct slots ``rep``
        (``-1`` skipped), the mean's reciprocal of the counts inside it;
        the rows' versions bumped."""
        keep = rep >= 0
        inv = 1.0 / cnt.clamp(min=1.0) if mean else None
        access.apply_push_rows(state, rep, keep, grads, mul=inv)
        if ROWVER_KEY in state:
            bump_row_versions(state[ROWVER_KEY],
                              touched_rows(rep, keep, capacity))
        return state

    def _apply_reconciled(self, state, slots, grads, counts, access, mean,
                          capacity):
        """The data axis's sparse and span pushes: the rows reconciled
        over the processes, then applied at their distinct slots."""
        rep, combined, cnt = self._reconcile(slots, grads, counts, capacity)
        return self._apply_rows(state, rep, combined, cnt, access, mean,
                                capacity)

    # -- the window under dp > 1 ----------------------------------------------
    # The JAX package's XlaTransfer deduplicates the global window on one
    # program, so its encoded rungs quantize each slot's sum over every
    # process's rows.  Here the dedup primitive reconciles: each process
    # folds its window (B3) and the folded rows are summed over the
    # processes in process order, every process then holds the same
    # global deduplicated window, drains its error feedback with no
    # further exchange, and applies it with none.
    def _prim_window_dedup(self, flat, fgrads, fcounts, capacity):
        if self.dp == 1:
            return super()._prim_window_dedup(flat, fgrads, fcounts,
                                              capacity)
        return self._reconcile(flat, fgrads, fcounts, capacity)

    def _prim_ef_drain(self, state, ded_slots, ded_grads, capacity, quant):
        if self.dp == 1:
            return super()._prim_ef_drain(state, ded_slots, ded_grads,
                                          capacity, quant)
        planes = {f: state[ef_name(f)] for f in ded_grads
                  if ef_name(f) in state}
        return state, ef_quantize_window(planes, ded_slots, ded_grads,
                                         capacity, quant,
                                         trace_backend=self.name)

    def _prim_window_exchange(self, state, ded_slots, ded_grads, ded_counts,
                              access, mean, need_counts, wire):
        if self.dp == 1:
            return super()._prim_window_exchange(
                state, ded_slots, ded_grads, ded_counts, access, mean,
                need_counts, wire)
        self.push_paths[f"{','.join(ded_grads)}:span"] += 1
        if self.count_traffic:
            rb, bb = (wire if wire is not None
                      else (grad_row_bytes(ded_grads, with_counts=True), 0))
            self._record_exchange((ded_slots >= 0).sum(), rb, base_bytes=bb)
        return self._apply_rows(state, ded_slots, ded_grads, ded_counts,
                                access, mean, _state_capacity(state))

    def _push_sparse(self, state, slots, grads, access, mean=False):
        capacity = next(iter(state.values())).shape[0]
        B = slots.shape[0]
        if self.dp > 1:
            return self._apply_reconciled(state, slots, grads, None, access,
                                          mean, capacity)
        if B == 0:
            return state
        valid = slots >= 0
        # sort so duplicates are adjacent; padding (-1 -> capacity) sorts
        # last into at most one trailing segment
        sort_keys = torch.where(valid, slots, capacity)
        sorted_slots, order = torch.sort(sort_keys, stable=True)
        new_seg = torch.ones(B, dtype=torch.int64, device=slots.device)
        new_seg[1:] = (sorted_slots[1:] != sorted_slots[:-1]).long()
        seg_ids = torch.cumsum(new_seg, 0) - 1
        # segments that hold a real slot, on the device: all of them but a
        # trailing padding segment
        n_real = seg_ids[-1] + 1 - (sorted_slots[-1] == capacity).long()
        keep = torch.arange(B, device=slots.device) < n_real
        # one representative slot per segment (every writer of a segment
        # writes the same value); rows past the last segment stay -1
        rep = torch.full((B,), -1, dtype=torch.int32, device=slots.device)
        rep.scatter_(0, seg_ids, sorted_slots)

        inv = None
        if mean:
            seg_counts = torch.zeros(B, dtype=torch.float32,
                                     device=slots.device)
            seg_counts.index_add_(0, seg_ids, valid[order].float())
            inv = 1.0 / seg_counts.clamp(min=1.0)
        combined = {}
        for f, g in grads.items():
            acc = torch.zeros((B, g.shape[1]), dtype=g.dtype,
                              device=g.device)
            acc.index_add_(0, seg_ids, g[order])
            combined[f] = acc
        # in place on the table at the representatives the mask keeps,
        # distinct slots; the mean's reciprocal inside the launch
        access.apply_push_rows(state, rep, keep, combined, mul=inv)
        if ROWVER_KEY in state:
            bump_row_versions(state[ROWVER_KEY],
                              touched_rows(rep, keep, capacity))
        return state

    def _push_span(self, state, slots, grads, counts, access, mean=False):
        capacity = next(iter(state.values())).shape[0]
        S = slots.shape[0]
        if self.dp > 1:
            return self._apply_reconciled(state, slots, grads, counts,
                                          access, mean, capacity)
        if S == 0:
            return state
        dev = slots.device
        valid = slots >= 0
        safe = torch.where(valid, slots, 0).long()
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        # rep[k]: the lowest span position holding slot k (scatter-min)
        rep = torch.full((capacity,), S, dtype=torch.int32, device=dev)
        rep.scatter_reduce_(0, safe, torch.where(valid, pos, S), "amin")
        owner = torch.where(valid, rep[safe].long(), S)   # S: dropped
        # fold rows (and their counts) into owner rows: a span-local sum
        # with drop row S, not a capacity scatter
        inv = None
        if mean:
            cnt = torch.zeros(S + 1, dtype=torch.float32, device=dev)
            cnt.index_add_(0, owner, counts.float())
            inv = (1.0 / cnt.clamp(min=1.0))[:S]
        combined = {}
        for f, g in grads.items():
            acc = torch.zeros((S + 1, g.shape[1]), dtype=g.dtype, device=dev)
            acc.index_add_(0, owner, g)
            combined[f] = acc[:S]
        # the owner rows (JAX is_owner) hold distinct slots: each updates
        # its slot in place, the mean's reciprocal inside the launch
        is_owner = valid & (owner == pos)
        access.apply_push_rows(state, slots, is_owner, combined, mul=inv)
        if ROWVER_KEY in state:
            bump_row_versions(state[ROWVER_KEY],
                              touched_rows(slots, is_owner, capacity))
        return state
