"""The row-delta wire codec (counterpart of ``swiftmpi_tpu/transfer/
delta.py``, numpy, the JAX package's): one ``(keys, rows)`` set encoded
as one npz payload, its format chosen by the window push's own pricer
(:func:`~swiftmpi_tpu_torch.parameter.key_index.price_window_formats`).

Formats (the payload's ``format`` scalar):

* ``sparse``: float32 ``(key, row)`` pairs, lossless;
  ``eff * (4 + 4 + 4d)`` wire bytes.
* ``bitmap``: a packed occupancy mask over a dense position space and
  float32 values; ``capacity / 8 + eff * 4d``, offered only when the
  caller gives dense ``positions`` (< capacity), e.g. table slots.
* ``sparse_q``: int8 values and a float32 scale a row, lossy, behind
  the pricer's ``quant_guard``; ``eff * (4 + 4 + d + 4)``.
* ``dense`` never ships: a delta leaves the untouched rows out, so the
  dense decision becomes ``sparse``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from swiftmpi_tpu_torch.parameter.key_index import price_window_formats

__all__ = ["encode_delta", "decode_delta", "delta_wire_bytes",
           "atomic_savez"]


def encode_delta(keys, values, capacity: int, quant: str = "int8",
                 positions=None) -> Dict[str, np.ndarray]:
    """Encode a (keys, rows) delta for the wire, choosing the format
    with the SAME crossover pricing as the window push
    (key_index.price_window_formats): ``sparse`` (f32 pairs, lossless),
    ``bitmap`` (occupancy mask + packed values — only offered when the
    caller supplies dense ``positions`` < capacity), or ``sparse_q``
    (int8 values + per-row scale, lossy, guarded).  Returns the npz
    payload dict; ``wire_bytes`` is the modeled encoded size booked
    into the migration/shipping ledger."""
    keys = np.asarray(keys, np.int64).ravel()
    values = np.asarray(values, np.float32)
    if len(keys):
        values = values.reshape(len(keys), -1)
    else:
        # empty delta (a rank mid-rejoin owns nothing yet): keep the
        # trailing dim if the caller shaped one, else 1 — reshape(0, -1)
        # is ambiguous on size-0 arrays
        values = values.reshape(
            0, values.shape[-1] if values.ndim >= 2 else 1)
    d = values.shape[1]
    row_bytes = 4 + d * 4
    quant_row_bytes = 4 + d + 4 if quant == "int8" else 4 + 2 * d
    decision, prices = price_window_formats(
        len(keys), int(capacity), row_bytes,
        quant=quant if quant in ("int8", "bf16") else "off",
        quant_row_bytes=quant_row_bytes if quant != "off" else None)
    if decision == "bitmap" and positions is None:
        decision = "sparse"      # no dense position space to mask over
    if decision == "dense":
        decision = "sparse"      # deltas never ship the whole table
    enc: Dict[str, np.ndarray] = {
        "format": np.array(decision), "keys": keys,
        "capacity": np.array(int(capacity)),
    }
    if decision == "sparse_q":
        scale = np.max(np.abs(values), axis=1, keepdims=True) / 127.0
        safe = np.where(scale > 0, scale, 1.0)
        q = np.clip(np.round(values / safe), -127, 127).astype(np.int8)
        enc["q"] = q
        enc["scale"] = np.where(scale > 0, scale, 0.0).astype(np.float32)
        wire = len(keys) * (4.0 + quant_row_bytes)
    elif decision == "bitmap":
        mask = np.zeros(int(capacity), np.bool_)
        mask[np.asarray(positions, np.int64)] = True
        enc["mask"] = np.packbits(mask)
        enc["positions"] = np.asarray(positions, np.int64)
        enc["values"] = values
        wire = capacity / 8.0 + len(keys) * (row_bytes - 4)
    else:
        enc["values"] = values
        wire = len(keys) * (4.0 + row_bytes)
    return {**enc, "wire_bytes": np.array(int(round(wire)))}


def decode_delta(enc) -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct ``(keys, rows_f32)`` from an :func:`encode_delta`
    payload (an open npz or a dict).  ``sparse_q`` round-trips through
    the int8 scale — the receiver sees exactly what the wire carried,
    quantization error included."""
    fmt = str(np.asarray(enc["format"]))
    keys = np.asarray(enc["keys"], np.int64)
    if fmt == "sparse_q":
        values = (np.asarray(enc["q"], np.float32)
                  * np.asarray(enc["scale"], np.float32))
    else:
        values = np.asarray(enc["values"], np.float32)
    return keys, values


def delta_wire_bytes(enc) -> int:
    return int(np.asarray(enc["wire_bytes"]))


def atomic_savez(path: str, **arrays) -> None:
    """Write an npz so readers never observe a torn file: pid-unique
    tmp (concurrent writers of the same target must never clobber each
    other's in-flight tmp), fsync, then ``os.replace`` — last replace
    wins whole."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
