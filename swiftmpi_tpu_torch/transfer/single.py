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
  representative slot of each segment in place.  Like the JAX package,
  which leaves this path to XLA, the sort and the sums stay in torch
  index ops.
* ``push_span`` (stencil rendering, ``xla.py::push_span``) dedups a
  position-indexed span without a sort: a scatter-min of span positions
  into a ``(capacity,)`` plane names each slot's owner row, rows and
  counts fold into their owners with a span-local ``index_add_``, and the
  row-indexed AdaGrad kernel updates the owners' slots in place (the
  ``is_owner`` rows of JAX, distinct by construction).  No host read.

All three pushes update the table tensors in place.
"""

from __future__ import annotations

import torch

from swiftmpi_tpu_torch.kernels.gather import masked_gather
from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
from swiftmpi_tpu_torch.transfer.api import Transfer


class SingleTransfer(Transfer):
    name = "xla"

    def _prim_pull(self, state, slots, fields):
        valid = slots >= 0
        return {f: masked_gather(state[f], slots, valid) for f in fields}

    def _push_dense(self, state, slots, grads, access, mean=False):
        capacity = next(iter(state.values())).shape[0]
        valid = slots >= 0
        dense_grads, counts = {}, None
        for f, g in grads.items():
            # a mean push takes the contribution counts from its first
            # family's scatter: one launch per family, no count pass
            if mean and counts is None:
                acc, counts = masked_scatter_add(slots, valid, g.contiguous(),
                                                 capacity, counts=True)
            else:
                acc = masked_scatter_add(slots, valid, g.contiguous(),
                                         capacity)
            dense_grads[f] = acc
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
        return state

    def _push_sparse(self, state, slots, grads, access, mean=False):
        capacity = next(iter(state.values())).shape[0]
        B = slots.shape[0]
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
        # the one host read of the push: how many segments hold a real slot
        n_seg, last = torch.stack(
            [seg_ids[-1] + 1, sorted_slots[-1].long()]).tolist()
        n_real = n_seg - int(last == capacity)
        if n_real == 0:
            return state
        # one representative slot per segment (every writer of a segment
        # writes the same value)
        rep_slots = torch.empty(B, dtype=torch.int32, device=slots.device)
        rep_slots.scatter_(0, seg_ids, sorted_slots)
        rep = rep_slots[:n_real]

        inv = None
        if mean:
            seg_counts = torch.zeros(B, dtype=torch.float32,
                                     device=slots.device)
            seg_counts.index_add_(0, seg_ids, valid[order].float())
            inv = (1.0 / seg_counts.clamp(min=1.0))[:n_real]
        combined = {}
        for f, g in grads.items():
            acc = torch.zeros((B, g.shape[1]), dtype=g.dtype,
                              device=g.device)
            acc.index_add_(0, seg_ids, g[order])
            combined[f] = acc[:n_real]
        # in place on the table at the representatives, distinct slots; the
        # mean's reciprocal inside the launch
        access.apply_push_rows(state, rep, None, combined, mul=inv)
        return state

    def _push_span(self, state, slots, grads, counts, access, mean=False):
        capacity = next(iter(state.values())).shape[0]
        S = slots.shape[0]
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
        return state
