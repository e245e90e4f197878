"""Fused stencil gather — the stencil rendering's context sum.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_stencil.py``
``fused_stencil_gather``: for each center ``b`` of a stream-span batch,

    neu1[b] = sum_k wmask[b, k] * table[clip(slots[lo[b] + k])]

over the ``K = 2W + 1`` span rows of its window, as one kernel over the raw
table (pull, span gather and masked sum in one pass).  ``lo`` and
``wmask`` come from :func:`stencil_window_inputs`, the torch counterpart of
the JAX function of the same name.  The CUDA kernel (``csrc/stencil.cu``)
gives each center one warp: the window's slots and weights come in with
one coalesced load, every lane then has all of the window's row loads in
flight at once (neighbouring centers share rows through L1/L2), and sums
them in k order; a padded center writes a zero row.  Bound on the card:
bytes — the distinct table rows the windows reach, read once, plus neu1
written once; at the word2vec reference shape that is under a
microsecond, so the kernel is launch- and latency-sized.  The JAX
package's VMEM gate (``fits_vmem`` / ``use_fused_stencil``) has no
counterpart: the kernel keeps no span on chip, so every span size routes
through it.

The plain version sums in the same order with each product and sum rounded
on its own, as the kernel does, so on the card the two agree bit for bit.
The Pallas kernel reduces by a matmul, so the CPU tests hold the plain
version against it at ``rtol 1e-5, atol 1e-5``.

``fused_stencil_gather`` runs the plain version for CPU tensors and the
kernel for CUDA tensors; on either it raises on what the kernel does not
take (anything but a contiguous float32 table, int32 slots and ``lo``, a
contiguous float32 ``(B, K)`` mask, and a span of at least ``K`` rows).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


def stencil_window_inputs(sent_id: torch.Tensor, center_pos: torch.Tensor,
                          half: torch.Tensor, window: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-frame inputs ``(lo, wmask)`` of the kernel from a stencil
    batch: ``lo[b] = clip(cp - W, 0, S - K)`` anchors a fixed ``K``-row
    window in the span, and ``wmask[b, k]`` is 1 iff span position
    ``lo[b] + k`` is a true context of center ``b`` (same sentence,
    ``0 < |off| <= half[b]``, real center).  ``lo`` int32, ``wmask``
    float32 ``(B, K)``."""
    S = sent_id.shape[0]
    K = 2 * window + 1
    row_valid = center_pos >= 0
    cp = center_pos.long().clamp(0, S - 1)
    lo = (cp - window).clamp(0, max(S - K, 0))
    j = lo[:, None] + torch.arange(K, device=lo.device)[None, :]  # span pos
    off = j - cp[:, None]
    same = (j < S) & (sent_id[j.clamp(max=S - 1)] == sent_id[cp][:, None])
    wmask = ((off != 0) & (off.abs() <= half.long()[:, None]) & same
             & row_valid[:, None])
    return lo.to(torch.int32), wmask.to(torch.float32)


def fused_stencil_gather_plain(table: torch.Tensor, slots: torch.Tensor,
                               lo: torch.Tensor,
                               wmask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather every window row, then a sequential
    sum over k of ``wmask[:, k] * rows[:, k]`` from zero."""
    B, K = wmask.shape
    cap, d = table.shape
    lo_c = lo.long().clamp(0, slots.shape[0] - K)
    pos = lo_c[:, None] + torch.arange(K, device=lo.device)[None, :]
    src = slots.long().clamp(0, cap - 1)[pos]                    # (B, K)
    rows = table.index_select(0, src.reshape(-1)).reshape(B, K, d)
    out = torch.zeros((B, d), dtype=torch.float32, device=table.device)
    for k in range(K):
        out = out + wmask[:, k, None] * rows[:, k, :]
    return out


def _check(table, slots, lo, wmask):
    if table.dtype != torch.float32:
        raise TypeError(f"fused_stencil_gather takes a float32 table, got "
                        f"{table.dtype} (bf16 tables are not ported yet: "
                        f"ROADMAP 'bf16 tables for B1/B2')")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("fused_stencil_gather needs a contiguous (cap, d) "
                         "table")
    if slots.dtype != torch.int32 or slots.dim() != 1 \
            or not slots.is_contiguous():
        raise TypeError("fused_stencil_gather needs contiguous 1-D int32 "
                        "span slots")
    if lo.dtype != torch.int32 or lo.dim() != 1 or not lo.is_contiguous():
        raise TypeError("fused_stencil_gather needs contiguous 1-D int32 lo")
    if wmask.dtype != torch.float32 or wmask.dim() != 2 \
            or wmask.shape[0] != lo.shape[0] or not wmask.is_contiguous():
        raise TypeError("fused_stencil_gather needs a contiguous float32 "
                        "(B, 2W+1) wmask with one row per lo entry")
    if wmask.shape[1] % 2 != 1 or slots.shape[0] < wmask.shape[1]:
        raise ValueError(
            f"fused_stencil_gather needs an odd window K = 2W+1 <= span S; "
            f"got K = {wmask.shape[1]}, S = {slots.shape[0]}")
    if len({t.device for t in (table, slots, lo, wmask)}) != 1:
        raise ValueError("fused_stencil_gather operands must share one "
                         "device")


def fused_stencil_gather(table: torch.Tensor, slots: torch.Tensor,
                         lo: torch.Tensor,
                         wmask: torch.Tensor) -> torch.Tensor:
    """``(B, d)`` float32 context sums ``neu1`` of a stencil batch."""
    global launches
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_stencil_gather: unsupported device {table.device}")
    _check(table, slots, lo, wmask)
    if table.device.type == "cpu":
        return fused_stencil_gather_plain(table, slots, lo, wmask)
    B, K = wmask.shape
    d = table.shape[1]
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    if B == 0 or d == 0:
        return out
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    fn = build.function("stencil", "smtpu_stencil_gather_f32", _ARGTYPES)
    rc = fn(table.data_ptr(), slots.data_ptr(), lo.data_ptr(),
            wmask.data_ptr(), out.data_ptr(), B, slots.shape[0], K, d,
            table.shape[0], vec4, build.stream_of(table))
    build.check_launch("fused_stencil_gather", rc)
    launches += 1
    return out
