"""Masked row gather — the pull path's data plane.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_gather.py``
``vmem_gather`` / ``masked_vmem_gather`` (drop-in body of
``transfer/xla.py::_masked_gather``): ``table[clip(slots)]`` with zero
rows where ``valid`` is false.  Two forms: a ``(cap, d)`` table with
``(N,)`` slots, and the shards of the ranks that share a card, a ``(R,
cap, d)`` block with ``(R, N)`` slots, rank ``r`` reading only slice ``r``
of the table — ``masked_vmem_gather``'s contract rank by rank, in one
launch.

The CUDA kernel (``csrc/gather.cu``) gives each warp a group of rows (5 at
d = 100), loads their slots once, issues every row load before any store,
reads the table with an L2 evict-last policy and writes with streaming
stores; widths that are no multiple of 4, or unaligned rows, take a
scalar form with a warp a row.  Bound on the card: bytes — each distinct
valid row read once and every output row written once, over 3.35 TB/s.
Times beside the bound are in PERF.md (``chip_smoke.py``,
``apps/gather_sweep.py``).

The table is float32 or bfloat16 (``[server] dtype: bfloat16``), or int32
(the ``(cap, 1)`` ``@rowver`` version plane the pull cache gathers beside
the rows: the kernel's named int32 form, the float32 path's 4-byte moves
under its own type, never a float view of the plane); rows come back in
the table's dtype, their bits moved, not converted: callers upcast.  A
bfloat16 row of d = 100 is 200 bytes, not a multiple of 16, so its vector
form moves four elements (8 bytes) a lane.  A width of 1 takes a column
form, a thread a row.

``masked_gather`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on what the kernel does not take (a
float32 or bfloat16 table whose rows are contiguous, int32 slots, bool
valid).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

#: table dtypes the kernel moves, each with its form code in the C call
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_FORMS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p]


def masked_gather_plain(table: torch.Tensor, slots: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clip keeps invalid and out-of-range slots
    defined, then invalid rows are zeroed; a ``(R, cap, d)`` table is
    read rank by rank through one index over its ``R * cap`` rows."""
    cap = table.shape[-2]
    safe = torch.where(valid, slots, 0).clamp(0, cap - 1).long()
    if table.dim() == 3:
        safe = safe + torch.arange(table.shape[0], device=slots.device
                                   )[:, None] * cap
    rows = table.reshape(-1, table.shape[-1]).index_select(
        0, safe.reshape(-1)).view(*slots.shape, table.shape[-1])
    return torch.where(valid[..., None], rows, 0)


def _check(table, slots, valid):
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"masked_gather kernel takes a float32 or bfloat16 "
                        f"table, or the int32 version plane, got "
                        f"{table.dtype}")
    d = table.shape[-1]
    if table.stride(-1) != 1 or (table.shape[-2] > 1
                                 and table.stride(-2) != d) \
            or (table.dim() == 2 and not table.is_contiguous()):
        raise ValueError("masked_gather needs a (cap, d) table or (R, cap, "
                         "d) block whose rows are contiguous")
    if slots.dtype != torch.int32 or not slots.is_contiguous():
        raise TypeError("masked_gather needs contiguous int32 slots")
    if valid.dtype != torch.bool or valid.shape != slots.shape \
            or not valid.is_contiguous():
        raise TypeError("masked_gather needs a contiguous bool valid mask "
                        "shaped like slots")
    if slots.device != table.device or valid.device != table.device:
        raise ValueError("masked_gather operands must share one device")
    if table.shape[-2] == 0 and slots.numel():
        raise ValueError("masked_gather: the table has no rows")


def masked_gather(table: torch.Tensor, slots: torch.Tensor,
                  valid: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N, d)`` rows of a ``(cap, d)`` table at ``(N,)`` slots, or
    ``(R, N, d)`` rows of a ``(R, cap, d)`` block at ``(R, N)`` slots
    (rank ``r`` from ``table[r]``); slots are clipped into ``[0, cap)``
    and rows are zero where ``valid`` is false.  Written into ``out`` (a
    contiguous tensor of that shape, the table's dtype and device) when
    given."""
    global launches
    if table.dim() != slots.dim() + 1 or table.dim() not in (2, 3) \
            or (table.dim() == 3 and slots.shape[0] != table.shape[0]):
        raise ValueError(f"masked_gather takes a (cap, d) table with (N,) "
                         f"slots or an (R, cap, d) block with (R, N) slots, "
                         f"got {tuple(table.shape)} and {tuple(slots.shape)}")
    shape = (*slots.shape, table.shape[-1])
    if out is not None and (out.shape != shape or out.dtype != table.dtype
                            or out.device != table.device
                            or not out.is_contiguous()):
        raise ValueError(f"masked_gather: out must be a contiguous {shape} "
                         f"tensor of the table's dtype and device")
    if table.device.type == "cpu":
        rows = masked_gather_plain(table, slots, valid)
        return rows if out is None else out.copy_(rows)
    if table.device.type != "cuda":
        raise ValueError(f"masked_gather: unsupported device {table.device}")
    _check(table, slots, valid)
    if out is None:
        out = torch.empty(shape, dtype=table.dtype, device=table.device)
    if slots.numel() == 0:
        return out
    R = table.shape[0] if table.dim() == 3 else 1
    rank_stride = table.stride(0) if table.dim() == 3 else 0
    d = table.shape[-1]
    # a group of four elements a lane: 16 bytes of float32 or int32, 8 of
    # bfloat16
    group = 4 * table.element_size()
    vec4 = int(d % 4 == 0 and rank_stride % 4 == 0
               and table.data_ptr() % group == 0
               and out.data_ptr() % group == 0)
    fn = build.function("gather", "smtpu_masked_gather", _ARGTYPES)
    rc = fn(table.data_ptr(), _FORMS[table.dtype], rank_stride,
            slots.data_ptr(), valid.data_ptr(), out.data_ptr(), R,
            slots.shape[-1], d, table.shape[-2], vec4,
            build.stream_of(table))
    build.check_launch("masked_gather", rc)
    launches += 1
    return out
