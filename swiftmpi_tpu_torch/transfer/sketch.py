"""The ``sparse_sketch`` wire rung: its byte models and its codec
(counterpart of ``swiftmpi_tpu/transfer/sketch.py``).

The rung replaces a sparse exchange's index stream by a counting sketch:
the slot space is cut into buckets of :data:`BUCKET_WIDTH` slots, one
uint16 occupancy count a bucket, and each surviving row ships a uint8
in-bucket offset beside its values.  The window pricer
(``parameter/key_index.py``, ``price_window_formats``) prices the rung
with :func:`sketch_wire_bytes` and the window interpreter books a
sketch window at that size (``transfer/plan.py``, ``WireFormatSpec.
wire``); the values themselves travel through the routed push as with the
``sparse`` rung.  :func:`encode` / :func:`decode` are the byte-exact codec
of one deduplicated window, numpy, the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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


def encode_index(slots, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct slots in ``[0, capacity)`` as ``(counts, offsets)``: the
    uint16 occupancy count a bucket and the slot-sorted uint8 in-bucket
    offsets.  ``-1`` padding is dropped."""
    slots = np.asarray(slots).reshape(-1)
    slots = np.sort(slots[slots >= 0]).astype(np.int64)
    if slots.size and int(slots[-1]) >= int(capacity):
        raise ValueError(
            f"sketch.encode_index: slot {int(slots[-1])} out of range "
            f"for capacity {capacity}")
    if slots.size != np.unique(slots).size:
        raise ValueError("sketch.encode_index: slots must be distinct "
                         "(encode AFTER the window dedup)")
    counts = np.bincount(slots // BUCKET_WIDTH,
                         minlength=n_buckets(capacity)).astype(np.uint16)
    offsets = (slots % BUCKET_WIDTH).astype(np.uint8)
    return counts, offsets


def decode_index(counts, offsets) -> np.ndarray:
    """The inverse of :func:`encode_index`: slot-sorted int64 slots."""
    counts = np.asarray(counts, np.int64)
    offsets = np.asarray(offsets, np.int64)
    if int(counts.sum()) != offsets.size:
        raise ValueError("sketch.decode_index: counts/offsets mismatch "
                         f"({int(counts.sum())} != {offsets.size})")
    base = np.repeat(np.arange(counts.size, dtype=np.int64),
                     counts) * BUCKET_WIDTH
    return base + offsets


def encode(slots, values: Dict[str, np.ndarray], capacity: int) -> bytes:
    """Byte-exact encoding of one deduplicated window: the counting
    sketch, the offsets, then each field's rows in slot order (fields in
    sorted name order; their widths and dtypes are the receiver's static
    metadata, not shipped)."""
    raw = np.asarray(slots).reshape(-1)
    keep = raw >= 0
    order = np.argsort(raw[keep], kind="stable")
    counts, offsets = encode_index(raw[keep], capacity)
    parts = [counts.tobytes(), offsets.tobytes()]
    for f in sorted(values):
        v = np.ascontiguousarray(np.asarray(values[f])[keep][order])
        parts.append(v.tobytes())
    return b"".join(parts)


def decode(payload: bytes, capacity: int,
           fields: Dict[str, Tuple[int, np.dtype]]
           ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The inverse of :func:`encode` given ``{name: (width, dtype)}``:
    slot-sorted ``(slots, values)``."""
    m = n_buckets(capacity)
    counts = np.frombuffer(payload[:COUNT_BYTES * m], np.uint16)
    rows = int(counts.sum())
    pos = COUNT_BYTES * m
    offsets = np.frombuffer(payload[pos:pos + rows], np.uint8)
    pos += rows
    slots = decode_index(counts, offsets)
    out: Dict[str, np.ndarray] = {}
    for f in sorted(fields):
        width, dtype = fields[f]
        nbytes = rows * width * np.dtype(dtype).itemsize
        out[f] = np.frombuffer(payload[pos:pos + nbytes],
                               dtype).reshape(rows, width)
        pos += nbytes
    if pos != len(payload):
        raise ValueError(f"sketch.decode: {len(payload) - pos} trailing "
                         "bytes (field metadata mismatch?)")
    return slots, out
