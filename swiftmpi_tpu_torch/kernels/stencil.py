"""Stencil context sum — the stencil rendering's ``neu1``.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_stencil.py``
``fused_stencil_gather`` together with the XLA ops of its
``stencil_window_inputs``: for each center ``b`` of a stream-span batch,

    neu1[b] = sum_k wmask[b, k] * table[clip(slots[lo[b] + k])]

over the ``K = 2W + 1`` span rows of its window, where ``lo`` and the
window mask ``wmask`` follow from the batch (``sent_id``, ``center_pos``,
``half``) by the rule of :func:`stencil_window_inputs`.
:func:`stencil_context_sum` is one launch of ``csrc/stencil.cu`` that
takes the batch itself and computes ``lo`` and the mask in registers, so a
stencil step launches one kernel where it launched the window inputs'
~20 small torch ops and the first kernel over their ``(B, K)`` mask.  The
table is float32 or bfloat16 (``[server] dtype``); rows are upcast
exactly and summed in float32, in k order.

The CUDA kernel gives each center one warp (lanes along d): lanes test a
window row each against the rule and load its slot, then every lane issues
the window's row loads before it sums them; a padded center writes a zero
row.  A form that staged a tile of centers' rows in shared memory first
was slower at every batch timed (PERF.md; ``apps/stencil_sweep.py`` at
the commit that brought both).  Bound on the card: bytes — the four index
arrays, the distinct table rows the windows reach, read once, and neu1
written once; at the word2vec reference shape that is under a
microsecond, so the kernel is launch- and latency-sized.  The JAX package's VMEM gate (``fits_vmem`` /
``use_fused_stencil``) has no counterpart: the kernel keeps no span on
chip, so every span size routes through it.

The plain version is :func:`stencil_window_inputs` followed by
:func:`fused_stencil_gather_plain` (rows upcast first), which sums in the
kernel's order with each product and sum rounded on its own, so on the
card the two agree bit for bit.  The Pallas kernel reduces by a matmul, so
the CPU tests hold the plain version against it at ``rtol 1e-5, atol
1e-5``.

``stencil_context_sum`` runs the plain version for CPU tensors and the
kernel for CUDA tensors; on either it raises on what the kernel does not
take (a table that is not a contiguous float32 or bfloat16 ``(cap, d)``
tensor, index arrays of other types or shapes, a span shorter than ``K``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

#: table dtypes the kernel reads
TABLE_DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def stencil_window_inputs(sent_id: torch.Tensor, center_pos: torch.Tensor,
                          half: torch.Tensor, window: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-frame inputs ``(lo, wmask)`` of a stencil batch:
    ``lo[b] = clip(cp - W, 0, S - K)`` anchors a fixed ``K``-row window in
    the span, and ``wmask[b, k]`` is 1 iff span position ``lo[b] + k`` is
    a true context of center ``b`` (same sentence, ``0 < |off| <=
    half[b]``, real center).  ``lo`` int32, ``wmask`` float32 ``(B,
    K)``."""
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
    """The sum from ``(lo, wmask)`` (the Pallas kernel's operands): gather
    every window row, upcast it to float32, then a sequential sum over k
    of ``wmask[:, k] * rows[:, k]`` from zero."""
    B, K = wmask.shape
    cap, d = table.shape
    lo_c = lo.long().clamp(0, slots.shape[0] - K)
    pos = lo_c[:, None] + torch.arange(K, device=lo.device)[None, :]
    src = slots.long().clamp(0, cap - 1)[pos]                    # (B, K)
    rows = table.index_select(0, src.reshape(-1)).float().reshape(B, K, d)
    out = torch.zeros((B, d), dtype=torch.float32, device=table.device)
    for k in range(K):
        out = out + wmask[:, k, None] * rows[:, k, :]
    return out


def stencil_context_sum_plain(table: torch.Tensor, slots: torch.Tensor,
                              sent_id: torch.Tensor,
                              center_pos: torch.Tensor, half: torch.Tensor,
                              window: int) -> torch.Tensor:
    """Plain PyTorch version: :func:`stencil_window_inputs`, then
    :func:`fused_stencil_gather_plain`."""
    lo, wmask = stencil_window_inputs(sent_id, center_pos, half, window)
    return fused_stencil_gather_plain(table, slots, lo, wmask)


def _check(table, slots, sent_id, center_pos, half, window):
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"stencil_context_sum takes a float32 or bfloat16 "
                        f"table, got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("stencil_context_sum needs a contiguous (cap, d) "
                         "table")
    S = slots.shape[0]
    for name, t, dtype, n in (("slots", slots, torch.int32, S),
                              ("sent_id", sent_id, torch.int32, S),
                              ("center_pos", center_pos, torch.int64,
                               center_pos.shape[0]),
                              ("half", half, torch.int32,
                               center_pos.shape[0])):
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise TypeError(
                f"stencil_context_sum needs contiguous 1-D "
                f"{str(dtype).rsplit('.', 1)[-1]} {name} of length {n} (the "
                f"span's for slots and sent_id, the batch's for center_pos "
                f"and half), got {t.dtype} {tuple(t.shape)}")
    K = 2 * int(window) + 1
    if window < 0 or S < K:
        raise ValueError(f"stencil_context_sum needs a window K = 2W+1 <= "
                         f"span S; got K = {K}, S = {S}")
    if len({t.device for t in (table, slots, sent_id, center_pos,
                               half)}) != 1:
        raise ValueError("stencil_context_sum operands must share one "
                         "device")


def stencil_context_sum(table: torch.Tensor, slots: torch.Tensor,
                        sent_id: torch.Tensor, center_pos: torch.Tensor,
                        half: torch.Tensor, window: int) -> torch.Tensor:
    """``(B, d)`` float32 context sums ``neu1`` of a stencil batch:
    ``table`` ``(cap, d)`` float32 or bfloat16, the span's ``slots`` and
    ``sent_id`` (int32, ``-1`` padding), the batch's ``center_pos``
    (int64, ``-1`` for a padded center) and ``half`` (int32), the
    window ``W``."""
    global launches
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"stencil_context_sum: unsupported device {table.device}")
    _check(table, slots, sent_id, center_pos, half, window)
    if table.device.type == "cpu":
        return stencil_context_sum_plain(table, slots, sent_id, center_pos,
                                         half, window)
    B, d = center_pos.shape[0], table.shape[1]
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    if B == 0 or d == 0:
        return out
    align = 16 if table.dtype == torch.float32 else 8
    vec4 = int(d % 4 == 0 and table.data_ptr() % align == 0
               and out.data_ptr() % 16 == 0)
    fn = build.function("stencil", "smtpu_stencil_context_sum", _ARGTYPES)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            slots.data_ptr(), sent_id.data_ptr(), center_pos.data_ptr(),
            half.data_ptr(), out.data_ptr(), B, slots.shape[0], int(window),
            d, table.shape[0], vec4, build.stream_of(table))
    build.check_launch("stencil_context_sum", rc)
    launches += 1
    return out

