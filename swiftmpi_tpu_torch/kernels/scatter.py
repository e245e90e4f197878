"""Masked scatter-add — the dense push's data plane.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_scatter.py``
``vmem_scatter_add`` / ``masked_vmem_scatter_add`` (drop-in body of
``transfer/xla.py::_push_dense._scatter``):
``zeros((cap+1, W)).at[idx].add(grads)[:cap]`` with invalid and
out-of-range rows routed to the dump row ``cap``.  The CUDA kernel
(``csrc/scatter.cu``) gives each gradient row one warp and adds it with
per-element float atomics, so duplicate slots are summed in no fixed
order: results agree with the plain version to a tolerance, not to bits.
It skips the rows the dump row would take (the result never shows that
row), which matters when most rows are padding, as in a stencil batch's
h push.
Bound on the card: bytes — grads and indices read once, the accumulator
written once, over 3.35 TB/s.  At the word2vec h push (105,000 rows of
W = 101 into 90,517 rows) that is 0.0237 ms; the wrapper and kernel take
0.1148 ms on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``;
PERF.md).

``masked_scatter_add`` runs the plain version for CPU tensors and the
kernel for CUDA tensors, raising on what the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p]


def masked_scatter_add_plain(slots: torch.Tensor, valid: torch.Tensor,
                             grads: torch.Tensor,
                             capacity: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` into a dump-row
    accumulator, sliced back to ``(capacity, W)``."""
    ok = valid & (slots >= 0) & (slots < capacity)
    safe = torch.where(ok, slots, capacity).long()
    acc = torch.zeros((capacity + 1, grads.shape[1]), dtype=grads.dtype,
                      device=grads.device)
    acc.index_add_(0, safe, grads)
    return acc[:capacity]


def _check(slots, valid, grads):
    if grads.dtype != torch.float32 or grads.dim() != 2 \
            or not grads.is_contiguous():
        raise TypeError("masked_scatter_add needs contiguous (N, W) "
                        "float32 grads")
    if slots.dtype != torch.int32 or slots.shape != grads.shape[:1] \
            or not slots.is_contiguous():
        raise TypeError("masked_scatter_add needs contiguous int32 slots, "
                        "one per grad row")
    if valid.dtype != torch.bool or valid.shape != slots.shape \
            or not valid.is_contiguous():
        raise TypeError("masked_scatter_add needs a contiguous bool valid "
                        "mask shaped like slots")
    if slots.device != grads.device or valid.device != grads.device:
        raise ValueError("masked_scatter_add operands must share one "
                         "device")


def masked_scatter_add(slots: torch.Tensor, valid: torch.Tensor,
                       grads: torch.Tensor, capacity: int) -> torch.Tensor:
    """``(capacity, W)`` sums of ``grads`` rows by slot; invalid and
    out-of-range rows land in the dropped dump row."""
    global launches
    if grads.device.type == "cpu":
        return masked_scatter_add_plain(slots, valid, grads, capacity)
    if grads.device.type != "cuda":
        raise ValueError(
            f"masked_scatter_add: unsupported device {grads.device}")
    _check(slots, valid, grads)
    n, w = grads.shape
    acc = torch.zeros((capacity + 1, w), dtype=grads.dtype,
                      device=grads.device)
    if n == 0:
        return acc[:capacity]
    fn = build.function("scatter", "smtpu_masked_scatter_add_f32",
                        _ARGTYPES)
    rc = fn(slots.data_ptr(), valid.data_ptr(), grads.data_ptr(),
            acc.data_ptr(), n, w, int(capacity), build.stream_of(grads))
    build.check_launch("masked_scatter_add", rc)
    launches += 1
    return acc[:capacity]
