"""In-place AdaGrad — the server-side apply.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_kernels.py``
``adagrad_update`` (body of ``PallasAdaGradAccess.apply_push``):

    accum += g^2
    param += lr * g * rsqrt(accum + fudge)

in float32, written straight into ``param`` and ``accum`` — the
counterpart of the TPU kernel's input/output aliasing under the step's
donated state.  ``param`` is float32, or bfloat16 (``[server] dtype:
bfloat16``: the mixed form, the JAX rule of ``parameter/access.py``
``AdaGradAccess.apply_push``): upcast exactly, the same float32 math, one
round-to-nearest-even on store; ``accum`` and ``grad`` are float32 either
way.  Two forms, both one launch of ``csrc/adagrad.cu`` (four-element
chunks where ``d % 4 == 0`` and rows are aligned):

* :func:`adagrad_update_`, dense: a ``(cap, d)`` table, or the shards of
  the ranks that share a card as one ``(R, cap, d)`` block, with grads of
  the same shape;
* :func:`adagrad_update_rows_`, row-indexed: grad row ``i`` updates
  table row ``slots[i]`` in place, for the rows ``mask`` keeps, with no
  gather copy of the rows and no write-back.

Either takes an optional per-row operand applied to the grad first:
``mul`` (the mean's reciprocal) or ``div`` (its divisor), rounded as the
callers rounded their separate scale pass.  Bound on the card: bytes —
20 bytes an element (three reads, two writes; 16 with a bfloat16 param)
over 3.35 TB/s, plus the per-row operands; times in PERF.md
(``chip_smoke.py``).  The kernel rounds each op as the plain version
does, and on the card the two agree bit for bit.

The wrappers run the plain version for CPU tensors and the kernel for
CUDA tensors, raising on what the kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

#: param dtypes the kernel updates (accum and grad are float32)
PARAM_DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _scaled(grad, mul, div):
    g = grad.float()
    if mul is not None:
        return g * mul[..., None]
    if div is not None:
        return g / div[..., None]
    return g


def adagrad_update_plain_(param: torch.Tensor, accum: torch.Tensor,
                          grad: torch.Tensor, lr: float,
                          fudge: float = 1e-6, *,
                          mul: Optional[torch.Tensor] = None,
                          div: Optional[torch.Tensor] = None):
    """Plain PyTorch version, in place: f32 math, one rounding on store
    (to nearest even into a bfloat16 param); the grad row times ``mul``
    or over ``div`` first."""
    g = _scaled(grad, mul, div)
    accum.copy_(accum + g * g)
    param.copy_(param.float() + lr * g * torch.rsqrt(accum + fudge))
    return param, accum


def adagrad_update_rows_plain_(param: torch.Tensor, accum: torch.Tensor,
                               slots: torch.Tensor,
                               mask: Optional[torch.Tensor],
                               grad: torch.Tensor, lr: float,
                               fudge: float = 1e-6, *,
                               mul: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the row-indexed form: ``index_select`` of
    the kept rows, the update, ``index_copy_`` back."""
    keep = (slots >= 0) & (slots < param.shape[0])
    if mask is not None:
        keep &= mask
    rows = keep.nonzero().view(-1)
    tgt = slots[rows].long()
    p, a = param.index_select(0, tgt), accum.index_select(0, tgt)
    adagrad_update_plain_(p, a, grad[rows], lr, fudge,
                          mul=None if mul is None else mul[rows])
    param.index_copy_(0, tgt, p)
    accum.index_copy_(0, tgt, a)
    return param, accum


def _check_f32(name, t, shape, device):
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise TypeError(f"adagrad_update_ needs contiguous float32 {name}, "
                        f"got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"adagrad_update_: {name} shape {tuple(t.shape)} "
                         f"!= {tuple(shape)}")
    if t.device != device:
        raise ValueError("adagrad_update_ operands must share one device")


def _check_table(param, accum):
    """param (float32 or bfloat16) and accum (float32): ``(cap, d)``
    tables, or ``(R, cap, d)`` blocks of contiguous rank slices at one
    rank stride."""
    if param.dtype not in PARAM_DTYPES:
        raise TypeError(f"adagrad_update_ needs float32 or bfloat16 param, "
                        f"got {param.dtype}")
    if accum.dtype != torch.float32:
        raise TypeError(f"adagrad_update_ needs float32 accum, got "
                        f"{accum.dtype}")
    for name, t in (("param", param), ("accum", accum)):
        if t.dim() == 3:
            ok = t.shape[0] <= 1 or t.stride(0) >= t[0].numel()
            ok = ok and (t.shape[0] == 0 or t[0].is_contiguous())
        else:
            ok = t.dim() == 2 and t.is_contiguous()
        if not ok:
            raise TypeError(f"adagrad_update_ needs a contiguous (cap, d) "
                            f"{name} or an (R, cap, d) block of contiguous, "
                            f"disjoint slices")
    if accum.shape != param.shape or accum.stride() != param.stride() \
            or accum.device != param.device:
        raise ValueError(f"adagrad_update_: accum {tuple(accum.shape)} "
                         f"{accum.stride()} does not match param "
                         f"{tuple(param.shape)} {param.stride()}")


def _launch(param, accum, rank_stride, grad, slots, mask, scale, mode, R,
            rows, d, cap, lr, fudge):
    global launches
    if rows * d >= 2 ** 31:
        raise ValueError("adagrad_update_: more than 2**31 elements a rank")
    # four elements a chunk: 16 bytes of float32, 8 of a bfloat16 param
    vec4 = int(d % 4 == 0 and rank_stride % 4 == 0
               and param.data_ptr() % (4 * param.element_size()) == 0
               and all(t.data_ptr() % 16 == 0 for t in (accum, grad)))
    fn = build.function("adagrad", "smtpu_adagrad_update", _ARGTYPES)
    rc = fn(param.data_ptr(), int(param.dtype == torch.bfloat16),
            accum.data_ptr(), rank_stride,
            grad.data_ptr(), None if slots is None else slots.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if scale is None else scale.data_ptr(), mode, R, rows, d,
            cap, float(lr), float(fudge), vec4, build.stream_of(param))
    build.check_launch("adagrad_update_", rc)
    launches += 1


def adagrad_update_(param: torch.Tensor, accum: torch.Tensor,
                    grad: torch.Tensor, lr: float, fudge: float = 1e-6, *,
                    mul: Optional[torch.Tensor] = None,
                    div: Optional[torch.Tensor] = None):
    """Update ``param`` and ``accum`` in place; returns them.  ``param``
    and ``accum``: ``(cap, d)``, or ``(R, cap, d)`` blocks (every rank
    slice contiguous, one rank stride); ``grad`` contiguous, same shape;
    ``mul`` or ``div`` (not both): a float32 operand per row, shape
    ``param.shape[:-1]``, that multiplies or divides the grad row."""
    if mul is not None and div is not None:
        raise ValueError("adagrad_update_ takes mul or div, not both")
    if param.device.type == "cpu":
        return adagrad_update_plain_(param, accum, grad, lr, fudge, mul=mul,
                                     div=div)
    if param.device.type != "cuda":
        raise ValueError(
            f"adagrad_update_: unsupported device {param.device}")
    _check_table(param, accum)
    _check_f32("grad", grad, param.shape, param.device)
    scale = mul if mul is not None else div
    if scale is not None:
        _check_f32("mul" if mul is not None else "div", scale,
                   param.shape[:-1], param.device)
    R = param.shape[0] if param.dim() == 3 else 1
    if param.numel() == 0:
        return param, accum
    _launch(param, accum, param.stride(0) if param.dim() == 3 else 0, grad,
            None, None, scale, 0 if scale is None else
            (1 if mul is not None else 2), R, param.shape[-2],
            param.shape[-1], param.shape[-2], lr, fudge)
    return param, accum


def adagrad_update_rows_(param: torch.Tensor, accum: torch.Tensor,
                         slots: torch.Tensor, mask: Optional[torch.Tensor],
                         grad: torch.Tensor, lr: float, fudge: float = 1e-6,
                         *, mul: Optional[torch.Tensor] = None):
    """Row-indexed update in place: for each ``i`` that ``mask`` (bool
    ``(M,)``, or None for all) keeps and whose ``slots[i]`` (int32
    ``(M,)``) lies in ``[0, cap)``, update ``param[slots[i]]`` and
    ``accum[slots[i]]`` with grad row ``i`` (``(M, d)``), times ``mul[i]``
    when given.  The kept slots must be distinct: two kept rows with one
    slot race on the card.  ``param``/``accum``: contiguous ``(cap, d)``.
    Returns them."""
    if param.device.type == "cpu":
        return adagrad_update_rows_plain_(param, accum, slots, mask, grad,
                                          lr, fudge, mul=mul)
    if param.device.type != "cuda":
        raise ValueError(
            f"adagrad_update_rows_: unsupported device {param.device}")
    _check_table(param, accum)
    if param.dim() != 2:
        raise ValueError("adagrad_update_rows_ takes a (cap, d) table")
    M, d = slots.shape[0], param.shape[1]
    if slots.dtype != torch.int32 or slots.dim() != 1 \
            or not slots.is_contiguous() or slots.device != param.device:
        raise TypeError("adagrad_update_rows_ needs contiguous 1-D int32 "
                        "slots on the table's device")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != slots.shape
                             or not mask.is_contiguous()
                             or mask.device != param.device):
        raise TypeError("adagrad_update_rows_ needs a contiguous bool mask "
                        "shaped like slots")
    _check_f32("grad", grad, (M, d), param.device)
    if mul is not None:
        _check_f32("mul", mul, (M,), param.device)
    if M == 0 or param.numel() == 0:
        return param, accum
    _launch(param, accum, 0, grad, slots, mask, mul,
            0 if mul is None else 1, 1, M, d, param.shape[0], lr, fudge)
    return param, accum
