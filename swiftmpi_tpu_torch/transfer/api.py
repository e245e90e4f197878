"""Transfer interface (counterpart of ``swiftmpi_tpu/transfer/api.py``).

A transfer moves rows between workers and the table: ``pull`` gathers
rows at slots, ``push`` combines gradient rows by slot and applies the
access method's update rule to the table.  Four backends:

* ``xla`` (``transfer/single.py``): one device, in place;
* ``tpu`` (``transfer/sharded.py``): the sharded parameter server, in
  place;
* ``hybrid`` (``transfer/hybrid.py``): the frequency head in hot planes,
  reconciled by one dense sum a push, the tail through ``tpu``;
* ``local`` (``transfer/local.py``): the numpy oracle, functional.

``pull`` is the pull interpreter: it dispatches on the backend's
:func:`~swiftmpi_tpu_torch.transfer.plan.pull_route` placement, books
the pull ledger and calls the backend's one primitive, ``_prim_pull``.
``push_span`` is the sort-free push of the stencil rendering's span
family.  The window push and the wire formats are ROADMAP A12c/d.

The wire ledger (off until ``count_traffic`` is set) keeps the JAX
package's keys and contract: totals that never decrease, no reset,
intervals by :meth:`Transfer.traffic_delta`.  Keys only the window push
and the wire formats move stay 0.  A count the step computes on the
device is added in place to an int64 counter vector on that device (one
per device the backend booked on), together with the static quantities
booked with it, so a replayed CUDA graph books exactly what the eager
steps book and a step reads nothing back; only :meth:`Transfer.traffic`
reads the counters to the host.  The host oracle's counts are host
integers.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.access import AccessMethod

TableState = Dict[str, torch.Tensor]

#: seed dense/sparse crossover ratio: a push goes dense once its batch is
#: at least ``capacity / ratio`` rows (``int(cap / 2.0) == cap // 2``)
DENSE_RATIO = 2.0

#: the wire ledger's keys, named and ordered as the JAX package's
#: ``Transfer._wire_state``
WIRE_KEYS = (
    "wire_bytes", "dispatches",
    "window_sparse", "window_dense",
    "window_fmt_dense", "window_fmt_sparse", "window_fmt_q",
    "window_fmt_bitmap", "window_fmt_sketch",
    "collective_psum", "collective_sparse_ar", "hot_psum_bytes_saved",
    "plan_compiles", "plan_cache_hits",
    "coalesced_rows_in", "coalesced_rows_out",
    "pull_bytes", "pull_rows", "pull_hot_rows",
    "pull_cache_hits", "pull_delta_rows", "pull_bytes_saved",
    "pull_fmt_full", "pull_fmt_bf16", "pull_fmt_q")

#: routing counters of the sharded and hybrid backends, kept beside the
#: wire keys
ROUTE_KEYS = ("routed_rows", "hot_rows", "psum_bytes")

_INDEX = {k: i for i, k in enumerate(WIRE_KEYS + ROUTE_KEYS)}


def _width_bytes(x) -> int:
    """Bytes of one row of ``x`` (a tensor, a numpy array, or a sharded
    field's list of shard tensors): the last dimension at the dtype."""
    if isinstance(x, (list, tuple)):
        x = x[0]
    if isinstance(x, torch.Tensor):
        return x.element_size() * int(x.shape[-1])
    x = np.asarray(x)
    return x.dtype.itemsize * int(x.shape[-1])


def grad_row_bytes(grads, with_index: bool = True,
                   with_counts: bool = False) -> int:
    """Wire bytes per pushed row: the grad fields' widths at their dtypes,
    plus an int32 index in the sparse representation and a float32
    counts column when a span family ships data counts."""
    total = 4 if with_index else 0
    total += sum(_width_bytes(g) for g in grads.values())
    return total + (4 if with_counts else 0)


def pull_row_bytes(state, fields) -> int:
    """Wire bytes per pulled row: an int32 request index plus the pulled
    fields' widths at the table's stored dtypes."""
    return 4 + sum(_width_bytes(state[f]) for f in fields)


class PushSpec:
    """One gradient-family push ``(slots, grads, mean)``.  A span family
    (stencil rendering) also carries ``counts``: rows indexed by span
    position, each the sum of ``counts[i]`` contributions, pushed through
    :meth:`Transfer.push_span`.  A ``dense`` family (the dense-logits
    rendering) has no slots: its grads are capacity-shaped and already
    normalized, and the access method applies them to the whole table."""

    def __init__(self, slots, grads, mean: bool = False, counts=None,
                 dense: bool = False):
        self.slots = slots
        self.grads = grads
        self.mean = bool(mean)
        self.counts = counts
        self.dense = bool(dense)


class Transfer:
    """Backend interface: pull through the interpreter and
    ``_prim_pull``, push through the dense or sparse apply by the
    per-call crossover."""

    name: str = "?"
    #: book the wire ledger (off by default, as in the JAX package)
    count_traffic: bool = False

    def __init__(self):
        #: pushes per (grad families, path) — e.g. ``{"h:dense": 20}``
        self.push_paths: Counter = Counter()
        self._host_ledger = np.zeros(len(_INDEX), np.int64)
        self._ledgers: Dict[torch.device, torch.Tensor] = {}

    # -- the wire ledger ---------------------------------------------------
    def _ledger(self, device: torch.device) -> torch.Tensor:
        """The counter vector on ``device``, made on first use.  It must
        exist before a CUDA graph that books on it is captured: made
        during a capture, its zero fill would be replayed."""
        led = self._ledgers.get(device)
        if led is None:
            if device.type == "cuda" \
                    and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the traffic ledger has no counters on "
                    f"{device} yet: run a step eagerly with count_traffic "
                    "set before capturing a CUDA graph")
            led = self._ledgers[device] = torch.zeros(
                len(_INDEX), dtype=torch.int64, device=device)
        return led

    def _book(self, on, **counts) -> None:
        """Add ``counts`` (device scalars or ints) to the ledger: in place
        on the counters of ``on``'s device when ``on`` is a tensor, else
        on the host.  A no-op unless ``count_traffic`` (callers that
        compute a count on the device check it first)."""
        if not self.count_traffic:
            return
        if isinstance(on, torch.Tensor):
            led = self._ledger(on.device)
            for k, n in counts.items():
                led[_INDEX[k]].add_(n)
        else:
            for k, n in counts.items():
                self._host_ledger[_INDEX[k]] += int(n)

    def _record_exchange(self, rows, row_bytes: int, base_bytes: int = 0,
                         on=None) -> None:
        """One push exchange of ``rows`` rows at ``row_bytes`` each, plus
        ``base_bytes`` of per-exchange overhead; ``on`` (default
        ``rows``) names the device whose counters book it."""
        self._book(rows if on is None else on,
                   wire_bytes=rows * int(row_bytes) + int(base_bytes),
                   dispatches=1)

    def _record_pull(self, rows, row_bytes: int) -> None:
        """One pull of ``rows`` rows at ``row_bytes`` each; ``row_bytes``
        0 still counts the rows (the hybrid's hot hits ship nothing)."""
        self._book(rows, pull_bytes=rows * int(row_bytes), pull_rows=rows)

    def _record_pull_hot(self, rows) -> None:
        """``rows`` pull hits answered by the local hot plane (also in
        ``pull_rows``, at 0 bytes)."""
        self._book(rows, pull_hot_rows=rows)

    def _counts(self) -> np.ndarray:
        """Host copy of the ledger: the host counters plus every device's
        (one read a device)."""
        total = self._host_ledger.copy()
        for led in self._ledgers.values():
            total += led.cpu().numpy()
        return total

    def _count(self, key: str) -> int:
        return int(self._counts()[_INDEX[key]])

    def wire_traffic(self) -> Dict[str, int]:
        """The cumulative wire ledger: ``wire_bytes`` and ``dispatches``
        of the push exchanges, ``pull_bytes``/``pull_rows``/
        ``pull_hot_rows`` of the pulls, and the keys of the window push
        and wire formats (ROADMAP A12c/d), 0 here.  Every value is a total
        that never decreases; there is no reset (see
        :meth:`traffic_delta`)."""
        c = self._counts()
        return {k: int(c[_INDEX[k]]) for k in WIRE_KEYS}

    def traffic(self) -> Dict[str, int]:
        """Cumulative traffic counters: the wire ledger, extended by the
        backends with routed and hot paths.  Same contract as
        :meth:`wire_traffic`."""
        return self.wire_traffic()

    def traffic_delta(self, since: Optional[Dict[str, int]] = None
                      ) -> Dict[str, int]:
        """:meth:`traffic` minus an earlier snapshot ``since`` (itself a
        ``traffic()`` value); a key absent from ``since`` subtracts 0."""
        cur = self.traffic()
        if not since:
            return cur
        return {k: v - since.get(k, 0) for k, v in cur.items()}

    # -- pull: the interpreter ---------------------------------------------
    def pull(self, state: TableState, slots, access: AccessMethod,
             fields=None) -> TableState:
        """Rows of ``fields`` (default: the access method's pull fields) at
        int32 ``slots``; ``-1`` yields zero rows.  Dispatches on the
        backend's pull route and books the pull ledger here; backends
        keep only ``_prim_pull``."""
        from swiftmpi_tpu_torch.transfer.plan import pull_route
        fields = tuple(fields or access.pull_fields)
        if pull_route(self.name).placement == "hot_split":
            return self._interpret_pull_hot_split(state, slots, access,
                                                  fields)
        return self._interpret_pull_flat(state, slots, fields)

    def _interpret_pull_flat(self, state: TableState, slots,
                             fields) -> TableState:
        """One gather over the whole slot space through ``_prim_pull``."""
        from swiftmpi_tpu_torch.transfer.plan import pull_route
        if self.count_traffic:
            rows = (int((np.asarray(slots) >= 0).sum())
                    if pull_route(self.name).eager else (slots >= 0).sum())
            self._record_pull(rows, pull_row_bytes(state, fields))
        return self._prim_pull(state, slots, fields)

    def _interpret_pull_hot_split(self, state: TableState, slots, access,
                                  fields) -> TableState:
        """The ``hot_split`` placement (hybrid): tail slots re-based by
        ``-n_hot`` and pulled through the tail backend (whose ledger books
        them), hot hits read from the hot planes by the gather kernel at 0
        wire bytes, the two merged by a select, not a sum (``-0.0`` rows
        keep their sign).  Uses the hybrid backend's ``_pad_batch``,
        ``_split_state`` and ``_n_hot``."""
        from swiftmpi_tpu_torch.kernels.gather import masked_gather
        slots = slots.to(torch.int32)
        slots, _, _, B = self._pad_batch(slots)
        tail_state, hot_state = self._split_state(state)
        n_hot = self._n_hot(state)
        if n_hot == 0:
            out = self.tail.pull(tail_state, slots, access, fields=fields)
            return {f: v[:B] for f, v in out.items()}
        is_hot = (slots >= 0) & (slots < n_hot)
        tail_slots = torch.where(slots >= n_hot, slots - n_hot, -1)
        out = self.tail.pull(tail_state, tail_slots, access, fields=fields)
        if self.count_traffic:
            n = is_hot.sum()
            self._record_hot(n, 0)
            self._record_pull(n, 0)
            self._record_pull_hot(n)
        return {f: torch.where(is_hot[:, None],
                               masked_gather(hot_state[f], slots, is_hot),
                               out[f])[:B]
                for f in fields}

    # -- push -----------------------------------------------------------------
    def push(self, state: TableState, slots: torch.Tensor, grads,
             access: AccessMethod, mean: bool = False) -> TableState:
        """Combine ``grads`` rows by int32 ``slots`` (``-1`` = padding),
        optionally mean-normalized per slot, and apply them to ``state``
        in place.  Dense once the batch reaches ``int(capacity / 2.0)``
        rows, exactly the JAX ``XlaTransfer.push`` rule; the ledger books
        a dense push as every row without the index, a sparse one as its
        valid rows."""
        capacity = next(iter(state.values())).shape[0]
        dense = slots.shape[0] >= int(capacity / DENSE_RATIO)
        self.push_paths[f"{','.join(grads)}:"
                        f"{'dense' if dense else 'sparse'}"] += 1
        if self.count_traffic:
            if dense:
                self._record_exchange(
                    capacity, grad_row_bytes(grads, with_index=False),
                    on=slots)
            else:
                self._record_exchange((slots >= 0).sum(),
                                      grad_row_bytes(grads))
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
        if self.count_traffic:
            self._record_exchange((slots >= 0).sum(),
                                  grad_row_bytes(grads, with_counts=True))
        return self._push_span(state, slots, grads, counts, access, mean)

    def _prim_pull(self, state: TableState, slots, fields) -> TableState:
        """Masked row gather of ``fields`` at ``slots`` (``-1``: zero
        rows), no ledger."""
        raise NotImplementedError

    def _push_span(self, state, slots, grads, counts, access, mean=False):
        raise NotImplementedError

    def _push_dense(self, state, slots, grads, access, mean=False):
        raise NotImplementedError

    def _push_sparse(self, state, slots, grads, access, mean=False):
        raise NotImplementedError


def get_transfer(name: str, **kwargs) -> Transfer:
    """Backend by its ``[cluster] transfer`` name; ``tpu`` and ``hybrid``
    take the rank layout as ``mesh=`` (and ``bucket_capacity``,
    ``debug_overflow``, ``data_plane``)."""
    if name == "xla":
        from swiftmpi_tpu_torch.transfer.single import SingleTransfer
        return SingleTransfer(**kwargs)
    if name == "tpu":
        from swiftmpi_tpu_torch.transfer.sharded import ShardedTransfer
        return ShardedTransfer(**kwargs)
    if name == "hybrid":
        from swiftmpi_tpu_torch.transfer.hybrid import HybridTransfer
        return HybridTransfer(**kwargs)
    if name == "local":
        from swiftmpi_tpu_torch.transfer.local import LocalTransfer
        return LocalTransfer(**kwargs)
    raise ValueError(f"unknown transfer backend {name!r} "
                     "(expected xla|tpu|hybrid|local)")
