"""In-place AdaGrad — the server-side apply.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_kernels.py``
``adagrad_update`` (body of ``PallasAdaGradAccess.apply_push``):

    accum += g^2
    param += lr * g * rsqrt(accum + fudge)

in float32, written straight into ``param`` and ``accum`` — the
counterpart of the TPU kernel's input/output aliasing under the step's
donated state.  The CUDA kernel (``csrc/adagrad.cu``) is a grid-stride
elementwise pass.  Bound on the card: bytes — 20 bytes an element (three
reads, two writes) over 3.35 TB/s: 0.0540 ms for the word2vec table
(90,516 × 100), which the kernel runs in 0.0675 ms on an NVIDIA H100 80GB
HBM3 at 700 W (``chip_smoke.py``; PERF.md).  It rounds each op as the
plain version does, and on that card the two agree bit for bit; the
stated tolerance is ``rtol 2e-6`` (2 ulp of ``rsqrtf``).

``adagrad_update_`` runs the plain version for CPU tensors and the kernel
for CUDA tensors, raising on what the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]


def adagrad_update_plain_(param: torch.Tensor, accum: torch.Tensor,
                          grad: torch.Tensor, lr: float,
                          fudge: float = 1e-6):
    """Plain PyTorch version, in place: f32 math, one rounding on store."""
    g = grad.float()
    accum.copy_(accum + g * g)
    param.copy_(param.float() + lr * g * torch.rsqrt(accum + fudge))
    return param, accum


def _check(param, accum, grad):
    for name, t in (("param", param), ("accum", accum), ("grad", grad)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"adagrad_update_ needs contiguous float32 "
                            f"{name}, got {t.dtype}")
        if t.shape != param.shape:
            raise ValueError(f"adagrad_update_: {name} shape {tuple(t.shape)}"
                             f" != param shape {tuple(param.shape)}")
        if t.device != param.device:
            raise ValueError("adagrad_update_ operands must share one device")


def adagrad_update_(param: torch.Tensor, accum: torch.Tensor,
                    grad: torch.Tensor, lr: float, fudge: float = 1e-6):
    """Update ``param`` and ``accum`` in place; returns them."""
    global launches
    if param.device.type == "cpu":
        return adagrad_update_plain_(param, accum, grad, lr, fudge)
    if param.device.type != "cuda":
        raise ValueError(
            f"adagrad_update_: unsupported device {param.device}")
    _check(param, accum, grad)
    n = param.numel()
    if n == 0:
        return param, accum
    fn = build.function("adagrad", "smtpu_adagrad_update_f32", _ARGTYPES)
    rc = fn(param.data_ptr(), accum.data_ptr(), grad.data_ptr(), n,
            float(lr), float(fudge), build.stream_of(param))
    build.check_launch("adagrad_update_", rc)
    launches += 1
    return param, accum
