"""Byte models of the ``sparse_sketch`` wire rung (counterpart of
``swiftmpi_tpu/transfer/sketch.py``, its byte models only).

The rung replaces a sparse exchange's index stream by a counting sketch:
the slot space is cut into buckets of :data:`BUCKET_WIDTH` slots, one
uint16 occupancy count a bucket, and each surviving row ships a uint8
in-bucket offset beside its values.  The window pricer
(``parameter/key_index.py``, ``price_window_formats``) prices the rung
whenever the ladder passes 2-way, so its byte model is here.  The codec
itself (``encode``, ``decode``) and the rung's execution are ROADMAP
A12d.
"""

from __future__ import annotations

#: consecutive slots per sketch bucket (the in-bucket offset fits a uint8)
BUCKET_WIDTH = 256

#: per-row index cost of the format: one uint8 in-bucket offset
OFFSET_BYTES = 1

#: per-bucket cost of the counting sketch: one uint16 occupancy count
COUNT_BYTES = 2


def n_buckets(capacity: int) -> int:
    return -(-int(capacity) // BUCKET_WIDTH)


def sketch_base_bytes(capacity: int) -> int:
    """Row-count-independent bytes of one encoded exchange: the uint16
    counting-sketch plane."""
    return COUNT_BYTES * n_buckets(capacity)


def sketch_wire_bytes(capacity: int, rows: float, value_bytes: float
                      ) -> float:
    """Modeled encoded bytes of one window of ``rows`` rows of
    ``value_bytes`` each."""
    return (float(sketch_base_bytes(capacity))
            + float(rows) * (OFFSET_BYTES + float(value_bytes)))
