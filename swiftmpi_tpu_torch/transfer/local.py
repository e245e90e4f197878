"""``local`` transfer backend: the numpy oracle (counterpart of
``swiftmpi_tpu/transfer/local.py``).

A single-process reference of the transfer semantics in ``api.py``,
written with ``np.unique`` and ``np.add.at`` and independent of the
device backends' code paths, to hold them against.  Like the JAX oracle
it is functional: ``push`` and ``push_span`` return new arrays and leave
``state`` alone.  The access rule runs on CPU tensors of the touched rows
(the AdaGrad kernel's plain version).  It has no wire: with
``count_traffic`` its ledger books the notional payload the same
exchange would ship (valid rows x ``grad_row_bytes``), as host integers.

It is a host oracle by design: it takes numpy arrays or CPU tensors and
returns numpy arrays, and it raises on a tensor on the card rather than
copying a table there to the host behind the caller's back.  Its window
push (``Transfer.push_window``) takes numpy too: with every compression
knob off a window flattens into ``push``/``push_span``; the compacting
dedup the encoded rungs need is ROADMAP A12d.
"""

from __future__ import annotations

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.sparse_table import tensor_to_numpy
from swiftmpi_tpu_torch.transfer.api import Transfer, grad_row_bytes


def _host(x, what: str) -> np.ndarray:
    """``x`` as a numpy array; a tensor must live on the CPU."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"the local transfer is the host oracle: its {what} must be "
                f"numpy arrays or CPU tensors, got a tensor on {x.device}; "
                "copy it to the host first")
        return tensor_to_numpy(x)
    return np.asarray(x)


def _host_state(state) -> dict:
    return {f: _host(v, "table state") for f, v in state.items()}


class LocalTransfer(Transfer):
    name = "local"

    def pull(self, state, slots, access, fields=None):
        return super().pull(_host_state(state), _host(slots, "slots"),
                            access, fields)

    def _prim_pull(self, state, slots, fields):
        slots = np.asarray(slots, np.int64)
        valid = slots >= 0
        out = {}
        for f in fields:
            rows = np.asarray(state[f])[np.where(valid, slots, 0)]
            rows[~valid] = 0
            out[f] = rows
        return out

    def _apply(self, state, uniq, combined, access):
        """New arrays: ``state`` with the access rule applied at the
        distinct rows ``uniq`` from their combined grads."""
        current = {f: torch.from_numpy(np.array(state[f][uniq]))
                   for f in access.touched_fields(combined)}
        access.apply_push(current, {f: torch.from_numpy(g)
                                    for f, g in combined.items()})
        out = {f: np.array(state[f], copy=True) for f in state}
        for f, rows in current.items():
            out[f][uniq] = rows.numpy()
        return out

    def push(self, state, slots, grads, access, mean: bool = False):
        state = _host_state(state)
        slots = _host(slots, "slots").astype(np.int64)
        grads = {f: _host(g, "grads") for f, g in grads.items()}
        valid = slots >= 0
        self._record_exchange(int(valid.sum()), grad_row_bytes(grads))
        uniq, counts = np.unique(slots[valid], return_counts=True)
        pos = np.searchsorted(uniq, slots[valid])
        combined = {}
        for f, g in grads.items():
            g = np.asarray(g, np.float32)
            acc = np.zeros((len(uniq), g.shape[1]), np.float32)
            np.add.at(acc, pos, g[valid])
            if mean:
                acc /= np.maximum(counts, 1)[:, None]
            combined[f] = acc
        return self._apply(state, uniq, combined, access)

    def push_span(self, state, slots, grads, counts, access,
                  mean: bool = False):
        """Span-family oracle: rows carry summed contributions with their
        data counts; ``mean`` divides each distinct slot's sum by its
        summed counts, as ``XlaTransfer.push_span``."""
        state = _host_state(state)
        slots = _host(slots, "slots").astype(np.int64)
        counts = _host(counts, "counts").astype(np.float32)
        grads = {f: _host(g, "grads") for f, g in grads.items()}
        valid = slots >= 0
        self._record_exchange(int(valid.sum()),
                              grad_row_bytes(grads, with_counts=True))
        uniq = np.unique(slots[valid])
        pos = np.searchsorted(uniq, slots[valid])
        csum = np.zeros((len(uniq),), np.float32)
        np.add.at(csum, pos, counts[valid])
        combined = {}
        for f, g in grads.items():
            g = np.asarray(g, np.float32)
            acc = np.zeros((len(uniq), g.shape[1]), np.float32)
            np.add.at(acc, pos, g[valid])
            if mean:
                acc /= np.maximum(csum, 1.0)[:, None]
            combined[f] = acc
        return self._apply(state, uniq, combined, access)

    def _prim_window_dedup(self, flat, fgrads, fcounts, capacity):
        raise NotImplementedError(
            "the oracle's compacting window dedup (the encoded wire rungs) "
            "is not ported yet (ROADMAP A12d)")
