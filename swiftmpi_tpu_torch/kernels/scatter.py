"""Masked scatter-add — the dense push's data plane.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_scatter.py``
``vmem_scatter_add`` / ``masked_vmem_scatter_add`` (drop-in body of
``transfer/xla.py::_push_dense._scatter``):
``zeros((cap+1, W)).at[idx].add(grads)[:cap]`` with invalid and
out-of-range rows routed to the dump row ``cap``, which the result never
shows.  The port's form takes a rank dimension, so the ranks that share a
card sum in one launch, and can return the per-slot contribution counts
from the same launch (what the JAX package gets from a fused count column
or a second scatter of ones).

The CUDA kernel (``csrc/scatter.cu``) skips the rows the dump row would
take, gives each gradient row one thread where W <= 4, and otherwise sums
the rows that share a slot within a tile of 128 rows in shared memory
before one float reduction per element (a vector ``red.global.add.v4.f32``
for 16-byte-aligned rows whose width is a multiple of 4): hot slots, not
bytes, bound it.  Duplicate slots are summed in no fixed order: results
agree with the plain version to a tolerance, not to bits; counts are
exact.
Bound on the card: bytes — slots, valid and the landing grads read once,
the accumulator and counts written once, over 3.35 TB/s (times in
PERF.md, from ``chip_smoke.py``).

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
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]


def masked_scatter_add_plain(slots: torch.Tensor, valid: torch.Tensor,
                             grads: torch.Tensor, capacity: int,
                             counts: bool = False):
    """Plain PyTorch version: one ``index_add_`` into a dump-row
    accumulator per rank (``(R, cap + 1, W)``), sliced back to ``(R, cap,
    W)``; the counts the same way with ones."""
    if slots.dim() == 1:
        out = masked_scatter_add_plain(slots[None], valid[None], grads[None],
                                       capacity, counts)
        return tuple(t[0] for t in out) if counts else out[0]
    (R, N), W = slots.shape, grads.shape[-1]
    ok = valid & (slots >= 0) & (slots < capacity)
    rank = torch.arange(R, device=slots.device)[:, None] * (capacity + 1)
    safe = (rank + torch.where(ok, slots, capacity)).reshape(-1)
    acc = torch.zeros((R * (capacity + 1), W), dtype=grads.dtype,
                      device=grads.device)
    acc.index_add_(0, safe, grads.reshape(R * N, W))
    acc = acc.view(R, capacity + 1, W)[:, :capacity]
    if not counts:
        return acc
    cnt = torch.zeros(R * (capacity + 1), dtype=torch.float32,
                      device=grads.device)
    cnt.index_add_(0, safe, torch.ones(R * N, dtype=torch.float32,
                                       device=grads.device))
    return acc, cnt.view(R, capacity + 1)[:, :capacity]


def _check(slots, valid, grads):
    if grads.dtype != torch.float32 or grads.dim() != slots.dim() + 1 \
            or not grads.is_contiguous():
        raise TypeError("masked_scatter_add needs contiguous (N, W) or "
                        "(R, N, W) float32 grads")
    if slots.dtype != torch.int32 or slots.shape != grads.shape[:-1] \
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
                       grads: torch.Tensor, capacity: int,
                       counts: bool = False):
    """Sums of ``grads`` rows by slot.  ``slots``/``valid`` ``(N,)`` and
    ``grads`` ``(N, W)`` give ``(capacity, W)``; ``(R, N)`` and ``(R, N,
    W)`` give ``(R, capacity, W)``, rank by rank.  Invalid and
    out-of-range rows land nowhere.  ``counts``: also return the number of
    rows that landed on each slot, float32 ``(capacity,)`` or ``(R,
    capacity)``, from the same launch."""
    global launches
    if grads.device.type == "cpu":
        return masked_scatter_add_plain(slots, valid, grads, capacity,
                                        counts)
    if grads.device.type != "cuda":
        raise ValueError(
            f"masked_scatter_add: unsupported device {grads.device}")
    if slots.dim() not in (1, 2):
        raise TypeError("masked_scatter_add needs (N,) or (R, N) slots")
    _check(slots, valid, grads)
    lead, (n, w) = slots.shape[:-1], grads.shape[-2:]
    R = slots.shape[0] if slots.dim() == 2 else 1
    # sums and counts in one zeroed buffer: one fill
    size = R * capacity * w
    buf = torch.zeros(size + (R * capacity if counts else 0),
                      dtype=torch.float32, device=grads.device)
    acc = buf[:size].view(*lead, capacity, w)
    cnt = buf[size:].view(*lead, capacity) if counts else None
    if n and R and capacity:
        fn = build.function("scatter", "smtpu_masked_scatter_add_f32",
                            _ARGTYPES)
        rc = fn(slots.data_ptr(), valid.data_ptr(), grads.data_ptr(),
                acc.data_ptr(), cnt.data_ptr() if counts else None, R, n, w,
                int(capacity), build.stream_of(grads))
        build.check_launch("masked_scatter_add", rc)
        launches += 1
    return (acc, cnt) if counts else acc
