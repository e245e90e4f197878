"""Byte models of the sparse-allreduce collective (counterpart of
``swiftmpi_tpu/transfer/sparse_allreduce.py``, its byte models only).

The hybrid's hot reconcile and the window's dense rung reconcile a
capacity-shaped buffer with one dense reduction.  The sparse allreduce
(Ok-Topk's split-and-exchange) would ship only the touched (index,
value) rows.  ``price_hot_collectives`` (``parameter/key_index.py``) and
the window interpreter's bookings read the two byte models here, so the
port prices the crossover exactly as the JAX package does.  The
collective itself (``bucket_layout``, ``bucket_permute``,
``bucket_unpermute``, ``merge_rows``, ``merge_counts``) and ``[cluster]
collective`` are ROADMAP A12d.
"""

from __future__ import annotations

#: one int32 row id per touched row on the sparse wire
ROW_ID_BYTES = 4

#: collective decisions the hot-plane pricer can return
HOT_COLLECTIVES = ("psum", "sparse_allreduce")


def sparse_ar_bytes(touched_rows: float, width_bytes: int) -> float:
    """Modeled wire volume of one sparse allreduce: ``touched_rows``
    (index, value) rows."""
    return float(touched_rows) * (ROW_ID_BYTES + float(width_bytes))


def dense_psum_bytes(capacity: int, width_bytes: int) -> float:
    """Modeled wire volume of the dense reconcile it replaces: the whole
    capacity-shaped buffer, no index stream."""
    return float(capacity) * float(width_bytes)
