"""The sparse-allreduce collective of the dense and hot planes
(counterpart of ``swiftmpi_tpu/transfer/sparse_allreduce.py``).

The hybrid's hot reconcile and the window's dense rung reconcile a
capacity-shaped buffer with one dense reduction.  The sparse allreduce
(Ok-Topk's split-and-exchange) ships only the touched (index, value)
rows: each rank's touched rows are merged by a scatter-add, a balanced
reduce-scatter over row-hash buckets sums them across ranks and an
all-gather hands the reduced rows back.  ``price_hot_collectives``
(``parameter/key_index.py``) and the window interpreter's bookings read
the two byte models here, so the port prices the crossover and books the
wire exactly as the JAX package does.

* :func:`merge_rows` / :func:`merge_counts`: the merge, duplicates summed,
  padding and out-of-range rows dropped.  On a CUDA tensor each is one
  launch of the scatter-add kernel (``kernels/scatter.py``), on the CPU
  its plain version.
* :func:`bucket_layout` / :func:`bucket_permute` / :func:`bucket_unpermute`:
  row ``r`` goes to bucket ``r % n``, so the frequency-ranked hot head
  spreads evenly over the ranks.  With every rank on one card the
  reduce-scatter and the all-gather are one sum (``transfer/hybrid.py``,
  ``_hot_push_sparse``), which needs no permutation.
"""

from __future__ import annotations

from typing import Tuple

import torch

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


def bucket_layout(n_rows: int, n_shards: int) -> Tuple[int, int]:
    """``(cap_bucket, n_padded)`` of the row-hash bucketing of ``n_rows``
    rows over ``n_shards`` buckets: ``ceil(n_rows / n_shards)`` rows a
    bucket, the row space padded to ``n_shards * cap_bucket``."""
    n_shards = max(int(n_shards), 1)
    cap_bucket = -(-int(n_rows) // n_shards) if n_rows else 0
    return cap_bucket, n_shards * cap_bucket


def bucket_permute(dense: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``(n_padded, ...)`` rows in bucket-major order: row ``r`` to bucket
    ``r % n_shards`` at index ``r // n_shards``."""
    n_pad = dense.shape[0]
    rest = tuple(dense.shape[1:])
    return dense.reshape((n_pad // int(n_shards), int(n_shards)) + rest
                         ).transpose(0, 1).reshape((n_pad,) + rest)


def bucket_unpermute(bucketed: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The inverse of :func:`bucket_permute`."""
    n_pad = bucketed.shape[0]
    rest = tuple(bucketed.shape[1:])
    return bucketed.reshape((int(n_shards), n_pad // int(n_shards)) + rest
                            ).transpose(0, 1).reshape((n_pad,) + rest)


def merge_rows(slots: torch.Tensor, values: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """``(capacity, width)``: every ``values[i]`` summed into row
    ``slots[i]``, ``slot < 0`` and ``slot >= capacity`` dropped; one
    scatter-add launch on the card."""
    from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
    slots = slots.to(torch.int32).contiguous()
    valid = (slots >= 0) & (slots < capacity)
    return masked_scatter_add(slots, valid,
                              values.to(torch.float32).contiguous(),
                              int(capacity))


def merge_counts(slots: torch.Tensor, counts: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """The ``(capacity,)`` count plane :func:`merge_rows` merges the
    contribution counts into (a width-1 launch)."""
    return merge_rows(slots, counts.to(torch.float32).reshape(-1, 1),
                      capacity)[:, 0]
