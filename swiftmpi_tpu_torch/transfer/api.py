"""Transfer interface (counterpart of ``swiftmpi_tpu/transfer/api.py``).

A transfer moves rows between workers and the table: ``pull`` gathers
rows at slots, ``push`` combines gradient rows by slot and applies the
access method's update rule to the table, in place.  Two backends are
ported: the single-device one (``transfer/single.py``, ``xla``) and the
sharded parameter server (``transfer/sharded.py``, ``tpu``); the wire
ledger, the pull-plan interpreter and the window push are not (ROADMAP
A12).
``push_span`` is the sort-free push of the stencil rendering's span
family.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from swiftmpi_tpu_torch.parameter.access import AccessMethod

TableState = Dict[str, torch.Tensor]

#: seed dense/sparse crossover ratio: a push goes dense once its batch is
#: at least ``capacity / ratio`` rows (``int(cap / 2.0) == cap // 2``)
DENSE_RATIO = 2.0


class PushSpec:
    """One gradient-family push ``(slots, grads, mean)``.  A span family
    (stencil rendering) also carries ``counts``: rows indexed by span
    position, each the sum of ``counts[i]`` contributions, pushed through
    :meth:`Transfer.push_span`."""

    def __init__(self, slots, grads, mean: bool = False, counts=None):
        self.slots = slots
        self.grads = grads
        self.mean = bool(mean)
        self.counts = counts


class Transfer:
    """Backend interface: pull through ``_prim_pull``, push through the
    dense or sparse apply by the per-call crossover."""

    name: str = "?"

    def __init__(self):
        #: pushes per (grad families, path) — e.g. ``{"h:dense": 20}``
        self.push_paths: Counter = Counter()

    def pull(self, state: TableState, slots: torch.Tensor,
             access: AccessMethod, fields=None) -> TableState:
        """Rows of ``fields`` (default: the access method's pull fields) at
        int32 ``slots``; ``-1`` yields zero rows."""
        fields = tuple(fields or access.pull_fields)
        return self._prim_pull(state, slots, fields)

    def push(self, state: TableState, slots: torch.Tensor, grads,
             access: AccessMethod, mean: bool = False) -> TableState:
        """Combine ``grads`` rows by int32 ``slots`` (``-1`` = padding),
        optionally mean-normalized per slot, and apply them to ``state``
        in place.  Dense once the batch reaches ``int(capacity / 2.0)``
        rows, exactly the JAX ``XlaTransfer.push`` rule."""
        capacity = next(iter(state.values())).shape[0]
        dense = slots.shape[0] >= int(capacity / DENSE_RATIO)
        self.push_paths[f"{','.join(grads)}:"
                        f"{'dense' if dense else 'sparse'}"] += 1
        if dense:
            return self._push_dense(state, slots, grads, access, mean)
        return self._push_sparse(state, slots, grads, access, mean)

    def push_span(self, state: TableState, slots: torch.Tensor, grads,
                  counts: torch.Tensor, access: AccessMethod,
                  mean: bool = False) -> TableState:
        """Push a position-indexed span family: row ``i`` of ``grads`` is
        the sum of ``counts[i]`` contributions to slot ``slots[i]``
        (``-1`` = padding); duplicate slots are combined without a sort and
        ``mean=True`` divides by the summed counts.  The JAX package's
        ``XlaTransfer.push_span``."""
        self.push_paths[f"{','.join(grads)}:span"] += 1
        return self._push_span(state, slots, grads, counts, access, mean)

    def _prim_pull(self, state: TableState, slots, fields) -> TableState:
        raise NotImplementedError

    def _push_span(self, state, slots, grads, counts, access, mean=False):
        raise NotImplementedError

    def _push_dense(self, state, slots, grads, access, mean=False):
        raise NotImplementedError

    def _push_sparse(self, state, slots, grads, access, mean=False):
        raise NotImplementedError


def get_transfer(name: str, **kwargs) -> Transfer:
    """Backend by its ``[cluster] transfer`` name; ``tpu`` takes the rank
    layout as ``mesh=`` (and ``bucket_capacity``, ``debug_overflow``,
    ``data_plane``)."""
    if name == "xla":
        from swiftmpi_tpu_torch.transfer.single import SingleTransfer
        return SingleTransfer(**kwargs)
    if name == "tpu":
        from swiftmpi_tpu_torch.transfer.sharded import ShardedTransfer
        return ShardedTransfer(**kwargs)
    raise NotImplementedError(
        f"[cluster] transfer: {name} is not ported yet (only xla and tpu; "
        "hybrid and local are ROADMAP A12)")
