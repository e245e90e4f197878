"""Ring exchange between the ranks of the sharded parameter server — the
wire of every routed pull and push.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_ring.py``
``ring_exchange``, the drop-in for ``jax.lax.all_to_all(x, axis, 0, 0,
tiled=True)`` between the n shards of the ``tpu`` transfer: each rank holds
an ``(n, C, ...)`` operand whose block ``j`` goes to rank ``j``, and block
``j`` of its result is the block it received from rank ``j``.

Two forms: :func:`ring_exchange_stacked` takes the n ranks' operands as one
``(n, n, C, ...)`` tensor (each rank's slice contiguous, any stride between
them; the transfer's buckets are such slices) and returns their results as
one tensor; :func:`ring_exchange` takes and returns lists, and on the card
stacks the list first (a copy; for tests and callers that hold lists).

The CUDA kernel (``csrc/ring.cu``) is two launches per exchange on a card.
``ring_send``, one launch for all the ranks of the card, copies block
``(me + s) % n`` of every sender into slot ``me`` of rank ``(me + s) %
n``'s output for s = 0..n-1 and publishes a per-step flag at the receiver
(a system-scope fence, then a release store of a growing epoch).
``ring_wait`` (one thread per peer, acquire loads, one thread block per
rank of the card) is enqueued after the sends, the ``start()`` ...
``wait()`` split of the Pallas kernel, so a waiter never holds the card
against a sender that is not scheduled yet.  Here the n ranks are logical
and share one card and one stream, so the waits find their flags set; the
same kernels work across peer-mapped cards, which is not run yet (ROADMAP
A11).  Sources and outputs go to the kernel as base + stride, so an
exchange uploads nothing and allocates no host tensor.  Blocks are copied
16 bytes at a time, through TMA bulk copies where source and destination
share their alignment.  Bound on the card: bytes — every operand byte read
once and written once, over 3.35 TB/s (times in PERF.md, from
``chip_smoke.py`` and ``apps/ring_sweep.py``).

The kernel copies 4-byte words: float32 and int32 operands go as they
are, bfloat16 ones (the pulled rows of a ``[server] dtype: bfloat16``
table) as the same bytes read as 4-byte words, so a block of C rows of
d = 100 is C * 50 words; an operand whose blocks are not a whole number of
words, or that does not start on a word, is refused.

Both forms run the plain version for CPU tensors and launch the kernel for
CUDA tensors, raising on what the kernel does not take; there is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Sequence

import torch

from swiftmpi_tpu_torch.kernels import build

#: exchanges launched on a card since the last reset: each is one launch
#: of the send kernel and one of the wait kernel, from one C call
launches = 0
#: bytes of the operands the launches exchanged (every rank's ``(n, C,
#: ...)`` blocks, its own block included) since the process began
operand_bytes = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
             ctypes.c_longlong, ctypes.c_void_p]

#: polls (100 ns apart) after which a waiter gives up and counts a timeout
_MAX_POLLS = 20_000_000

#: operand dtypes: the kernel's own 4-byte words, and bfloat16 viewed as
#: such words
DTYPES = (torch.float32, torch.int32, torch.bfloat16)


def _check_dtype(dtype) -> None:
    if dtype not in DTYPES:
        raise TypeError(f"ring_exchange kernel takes float32 or int32 "
                        f"operands (bfloat16 ones as int32 words), got "
                        f"{dtype}")


def _check_shapes(operands: Sequence[torch.Tensor]) -> int:
    n = len(operands)
    if n == 0:
        raise ValueError("ring_exchange needs at least one operand")
    first = operands[0]
    for r, x in enumerate(operands):
        if x.dim() < 1 or x.shape[0] != n:
            raise ValueError(
                f"ring_exchange: leading dim "
                f"{x.shape[0] if x.dim() else None} of rank {r}'s operand "
                f"!= axis size {n}")
        if x.shape != first.shape or x.dtype != first.dtype:
            raise ValueError("ring_exchange: every rank's operand must "
                             "have one shape and dtype")
    return n


def ring_exchange_plain(operands: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Plain PyTorch version, block by block: block ``j`` of rank ``r``'s
    result is block ``r`` of rank ``j``'s operand."""
    n = _check_shapes(operands)
    return [torch.stack([operands[j][r].to(operands[r].device)
                         for j in range(n)]) for r in range(n)]


def ring_exchange_stacked_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the stacked form: ``out[r, j] = x[j, r]``."""
    _check_stacked(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return out.copy_(x.transpose(0, 1))


class _Ring:
    """The persistent half of an n-rank exchange on one device: every
    rank's flag array (n epochs + a timeout count), the arrival counters of
    the (sender, step) pairs, the device array of flag pointers, the
    resolved kernel entry point and the epoch."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self.flags = torch.zeros((n, n + 1), dtype=torch.int64,
                                 device=device)
        self.done = torch.zeros(n * n, dtype=torch.int32, device=device)
        self.flag_ptrs = torch.tensor(
            [self.flags.data_ptr() + r * (n + 1) * 8 for r in range(n)],
            dtype=torch.int64).to(device)
        self.flag_ptrs_ptr = self.flag_ptrs.data_ptr()
        self.done_ptr = self.done.data_ptr()
        self.epoch = 0
        self.exchange = build.function("ring", "smtpu_ring_exchange",
                                       _ARGTYPES)


_rings: Dict[tuple, _Ring] = {}


def timeouts() -> int:
    """Waits that gave up since the process began (reads the card; for
    tests and smoke runs, not for the training loop)."""
    return int(sum(int(ring.flags[:, -1].sum()) for ring in _rings.values()))


def _check_stacked(x: torch.Tensor) -> int:
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"ring_exchange_stacked needs an (n, n, ...) "
                         f"tensor, got {tuple(x.shape)}")
    return x.shape[0]


def _slices_contiguous(x: torch.Tensor) -> bool:
    """Whether each ``x[r]`` is contiguous (the stride between them is
    free)."""
    if x.numel() == 0:
        return True
    want = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def ring_exchange_stacked(x: torch.Tensor) -> torch.Tensor:
    """``x[r]``: rank ``r``'s ``(n, C, ...)`` operand, block ``j`` bound
    for rank ``j``; every slice contiguous, the ranks at any one stride.
    Returns the n results as one contiguous ``(n, n, C, ...)`` tensor:
    ``result[r, j] = x[j, r]``."""
    global launches, operand_bytes
    n = _check_stacked(x)
    kind = x.device.type
    if kind == "cpu":
        return ring_exchange_stacked_plain(x)
    if kind != "cuda":
        raise ValueError(f"ring_exchange: unsupported device {x.device}")
    _check_dtype(x.dtype)
    if not _slices_contiguous(x):
        raise TypeError("ring_exchange needs contiguous operands")
    if n > 1024:
        raise ValueError("ring_exchange: at most 1024 ranks")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    es = x.element_size()
    block_bytes = math.prod(x.shape[2:]) * es
    if block_bytes % 4:
        raise ValueError(f"ring_exchange: a block of {tuple(x.shape[2:])} "
                         f"{x.dtype} is {block_bytes} bytes, not a whole "
                         f"number of 4-byte words")
    if x.data_ptr() % 4 or x.stride(0) * es % 4:
        raise ValueError("ring_exchange: the operand does not start on a "
                         "4-byte word")
    if block_bytes == 0:
        return out
    ring = _rings.get((n, x.device))
    if ring is None:
        ring = _rings[(n, x.device)] = _Ring(n, x.device)
    ring.epoch += 1
    # all n ranks share this card: one send launch, then one wait launch,
    # both enqueued by one call
    rc = ring.exchange(n, n, 0, 1, block_bytes, x.data_ptr(),
                       x.stride(0) * es, out.data_ptr(), out.stride(0) * es,
                       None, ring.flag_ptrs_ptr, ring.done_ptr, ring.epoch,
                       _MAX_POLLS,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("ring_exchange", rc)
    launches += 1
    operand_bytes += x.numel() * es
    return out


def ring_exchange(operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``operands[r]``: rank ``r``'s ``(n, C, ...)`` operand, block ``j``
    bound for rank ``j``.  Returns the n results: block ``j`` of
    ``result[r]`` is ``operands[j][r]``."""
    _check_shapes(operands)
    kind = operands[0].device.type
    if kind == "cpu":
        return ring_exchange_plain(operands)
    if kind != "cuda":
        raise ValueError(f"ring_exchange: unsupported device "
                         f"{operands[0].device}")
    dev = operands[0].device
    for x in operands:
        if x.device != dev:
            raise NotImplementedError(
                "ring_exchange: ranks on different devices need peer "
                "mappings, which are not ported yet (ROADMAP A11)")
        _check_dtype(x.dtype)
        if not x.is_contiguous():
            raise TypeError("ring_exchange needs contiguous operands")
    return list(ring_exchange_stacked(torch.stack(list(operands))).unbind(0))
