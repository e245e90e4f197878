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
knob off a window flattens into ``push``/``push_span``; an armed window
runs the oracle's primitives: the compacting dedup (``np.unique``),
the error-feedback drain and the sparse allreduce, in numpy.  Every push
stamps its rows in the ``@rowver`` plane, when the state has one, with
the plane's max + 1.
"""

from __future__ import annotations

import numpy as np
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.parameter.sparse_table import (ROWVER_KEY, ef_name,
                                                       tensor_to_numpy)
from swiftmpi_tpu_torch.transfer.api import (Transfer, grad_row_bytes,
                                             numerics_quant_err,
                                             quantize_dequantize)


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


def _bump_versions(out, rows) -> None:
    """Stamp ``rows`` of the ``@rowver`` plane, when ``out`` has one, with
    the plane's max + 1: the numpy twin of the device backends' bump."""
    if ROWVER_KEY in out:
        ver = out[ROWVER_KEY]
        ver[np.asarray(rows, np.int64)] = np.int32(ver.max() + 1)


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
        _bump_versions(out, uniq)
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
                  mean: bool = False, _wire=None):
        """Span-family oracle: rows carry summed contributions with their
        data counts; ``mean`` divides each distinct slot's sum by its
        summed counts, as ``XlaTransfer.push_span``.  ``_wire``: an
        encoded window's ``(row_bytes, base_bytes)``."""
        state = _host_state(state)
        slots = _host(slots, "slots").astype(np.int64)
        counts = _host(counts, "counts").astype(np.float32)
        grads = {f: _host(g, "grads") for f, g in grads.items()}
        valid = slots >= 0
        rb, bb = (_wire if _wire is not None
                  else (grad_row_bytes(grads, with_counts=True), 0))
        self._record_exchange(int(valid.sum()), rb, base_bytes=bb)
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

    # -- the window primitives (numpy) ------------------------------------
    def _prim_window_dedup(self, flat, fgrads, fcounts, capacity):
        """The compacting dedup: the window's sorted distinct slots with
        their summed grads and counts."""
        valid = flat >= 0
        uniq = np.unique(flat[valid])
        pos = np.searchsorted(uniq, flat[valid])
        csum = np.zeros((len(uniq),), np.float32)
        np.add.at(csum, pos, fcounts[valid])
        sums = {}
        for f, g in fgrads.items():
            acc = np.zeros((len(uniq), g.shape[1]), np.float32)
            np.add.at(acc, pos, g[valid])
            sums[f] = acc
        return uniq, sums, csum

    def _prim_sparse_allreduce(self, state, flat, fgrads, access, mean,
                               fcounts):
        """On the oracle's one-shard world the split-and-exchange is the
        merge of duplicate slots and one apply of the touched rows."""
        state = _host_state(state)
        flat = np.asarray(flat, np.int64)
        capacity = next(iter(state.values())).shape[0]
        valid = (flat >= 0) & (flat < capacity)
        uniq = np.unique(flat[valid])
        pos = np.searchsorted(uniq, flat[valid])
        counts = (np.asarray(fcounts, np.float32) if fcounts is not None
                  else np.ones(flat.shape, np.float32))
        csum = np.zeros((len(uniq),), np.float32)
        np.add.at(csum, pos, counts[valid])
        combined = {}
        for f, g in fgrads.items():
            acc = np.zeros((len(uniq), g.shape[1]), np.float32)
            np.add.at(acc, pos, np.asarray(g, np.float32)[valid])
            if mean:
                acc /= np.maximum(csum, 1.0)[:, None]
            combined[f] = acc
        return self._apply(state, uniq, combined, access)

    def _prim_ef_drain(self, state, uniq, sums, capacity, quant):
        """The drain in numpy: the residual into the sum, the sum
        quantized, the new error banked, as ``api.ef_quantize_window``
        orders it."""
        state, sums = dict(state), dict(sums)
        err_sq = drained = rebanked = 0.0
        banked = False
        for f in list(sums):
            efk = ef_name(f)
            if efk not in state:
                continue
            ef = np.asarray(state[efk], np.float32).copy()
            tot = sums[f] + ef[uniq]
            drained += float(np.sum(np.abs(ef[uniq])))
            deq = quantize_dequantize(tot, quant)
            ef[uniq] = tot - deq
            state[efk] = ef
            sums[f] = deq
            err_sq += float(np.sum((tot - deq) ** 2))
            rebanked += float(np.sum(np.abs(tot - deq)))
            banked = True
        if banked:
            numerics_quant_err(err_sq)
            tracer = obs.get_tracer()
            if tracer is not None:
                tracer.stage_ef(self.name, drained, rebanked)
        return state, sums
