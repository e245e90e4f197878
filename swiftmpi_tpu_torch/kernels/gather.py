"""Masked row gather — the pull path's data plane.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_gather.py``
``vmem_gather`` / ``masked_vmem_gather`` (drop-in body of
``transfer/xla.py::_masked_gather``): ``table[clip(slots)]`` with zero
rows where ``valid`` is false.  The CUDA kernel (``csrc/gather.cu``) gives
each output row one warp, lanes striding along d with float4 copies when
``d % 4 == 0`` and rows are 16-byte aligned.  Bound on the card: bytes —
each distinct valid row read once and every output row written once, over
3.35 TB/s.  At the word2vec h pull (105,000 rows of d = 100 from a
90,516-row table) that is 0.0157 ms; the kernel takes 0.0381 ms on an
NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``; PERF.md).

``masked_gather`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on what the kernel does not take
(anything but a contiguous float32 table, int32 slots, bool valid).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def masked_gather_plain(table: torch.Tensor, slots: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clip keeps invalid and out-of-range slots
    defined, then invalid rows are zeroed."""
    safe = torch.where(valid, slots, 0).clamp(0, table.shape[0] - 1)
    rows = table.index_select(0, safe.long())
    return torch.where(valid[:, None], rows, 0)


def _check(table, slots, valid):
    if table.dtype != torch.float32:
        raise TypeError(f"masked_gather kernel takes a float32 table, got "
                        f"{table.dtype} (bf16 tables are not ported yet)")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("masked_gather needs a contiguous (cap, d) table")
    if slots.dtype != torch.int32 or slots.dim() != 1 \
            or not slots.is_contiguous():
        raise TypeError("masked_gather needs contiguous 1-D int32 slots")
    if valid.dtype != torch.bool or valid.shape != slots.shape \
            or not valid.is_contiguous():
        raise TypeError("masked_gather needs a contiguous bool valid mask "
                        "shaped like slots")
    if slots.device != table.device or valid.device != table.device:
        raise ValueError("masked_gather operands must share one device")


def masked_gather(table: torch.Tensor, slots: torch.Tensor,
                  valid: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N, d)`` rows of ``table`` at ``slots`` (clipped into range),
    zero where ``valid`` is false; written into ``out`` (a contiguous
    ``(N, d)`` tensor of the table's dtype and device) when given."""
    global launches
    n, d = slots.shape[0], table.shape[1]
    if out is not None and (out.shape != (n, d) or out.dtype != table.dtype
                            or out.device != table.device
                            or not out.is_contiguous()):
        raise ValueError("masked_gather: out must be a contiguous (N, d) "
                         "tensor of the table's dtype and device")
    if table.device.type == "cpu":
        rows = masked_gather_plain(table, slots, valid)
        return rows if out is None else out.copy_(rows)
    if table.device.type != "cuda":
        raise ValueError(f"masked_gather: unsupported device {table.device}")
    _check(table, slots, valid)
    if out is None:
        out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    fn = build.function("gather", "smtpu_masked_gather_f32", _ARGTYPES)
    rc = fn(table.data_ptr(), slots.data_ptr(), valid.data_ptr(),
            out.data_ptr(), n, d, table.shape[0], vec4,
            build.stream_of(table))
    build.check_launch("masked_gather", rc)
    launches += 1
    return out
