"""Ring exchange between the ranks of the sharded parameter server — the
wire of every routed pull and push.

Replaces the Pallas kernel ``swiftmpi_tpu/ops/pallas_ring.py``
``ring_exchange``, the drop-in for ``jax.lax.all_to_all(x, axis, 0, 0,
tiled=True)`` between the n shards of the ``tpu`` transfer: each rank holds
an ``(n, C, ...)`` operand whose block ``j`` goes to rank ``j``, and block
``j`` of its result is the block it received from rank ``j``.

The CUDA kernel (``csrc/ring.cu``) is launched once per rank with raw
pointers to every rank's output buffer and flag array.  Its send half
copies block ``(me + s) % n`` into slot ``me`` of rank ``(me + s) % n``'s
output for s = 0..n-1 and publishes a per-step flag at the receiver (a
system-scope fence, then a release store of a growing epoch).  Its wait
half (one thread per peer, acquire loads) is enqueued only after all n
sends are enqueued, the ``start()`` ... ``wait()`` split of the Pallas
kernel, so a waiter never holds the card against a sender that is not
scheduled yet; the waits of the ranks of one card go in one launch, one
thread block per rank.  Here the n ranks are logical and share one card and one
stream, so the waits find their flags set; the same kernel works across
peer-mapped cards, which is not run yet (ROADMAP A11).  Bound on the
card: bytes — every operand byte read once and written once, over 3.35
TB/s (times in PERF.md, from ``chip_smoke.py``).

``ring_exchange`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, raising on what the kernel does not take; there
is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from swiftmpi_tpu_torch.kernels import build

#: launches of the send kernel since the last reset: one per rank per
#: exchange (each exchange ends with one launch of the wait kernel)
launches = 0

_SEND_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
                  ctypes.c_void_p]
_WAIT_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_void_p]

#: bytes one thread block of a step copies before the step gets another
_BYTES_PER_BLOCK = 32 * 1024
#: thread blocks of one rank's send across all its steps
_MAX_BLOCKS = 1024
#: polls (100 ns apart) after which a waiter gives up and counts a timeout
_MAX_POLLS = 20_000_000


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


class _Ring:
    """The persistent half of an n-rank exchange on one device: every
    rank's flag array (n epochs + a timeout count) and arrival counters,
    the device array of flag pointers, and the epoch."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self.flags = [torch.zeros(n + 1, dtype=torch.int64, device=device)
                      for _ in range(n)]
        self.done = [torch.zeros(n, dtype=torch.int32, device=device)
                     for _ in range(n)]
        self.done_ptrs = [d.data_ptr() for d in self.done]
        self.flag_ptrs = torch.tensor([f.data_ptr() for f in self.flags],
                                      dtype=torch.int64).to(device)
        self.epoch = 0
        #: (first output's address, bytes between outputs) -> the device
        #: array of the n output pointers.  The allocator hands a training
        #: loop the same blocks step after step, so most exchanges find
        #: their array here and upload nothing.
        self._out_ptrs: Dict[tuple, torch.Tensor] = {}

    def out_ptrs(self, out: torch.Tensor) -> torch.Tensor:
        """Device array of the addresses of ``out``'s n slices."""
        stride = out.stride(0) * out.element_size()
        key = (out.data_ptr(), stride)
        ptrs = self._out_ptrs.get(key)
        if ptrs is None:
            if len(self._out_ptrs) >= 256:
                self._out_ptrs.clear()
            # pinned, so the upload is enqueued without a stream
            # synchronize
            ptrs = self._out_ptrs[key] = torch.tensor(
                [key[0] + r * stride for r in range(self.n)],
                dtype=torch.int64, pin_memory=True).to(self.device,
                                                       non_blocking=True)
        return ptrs


_rings: Dict[tuple, _Ring] = {}


def timeouts() -> int:
    """Waits that gave up since the process began (reads the card; for
    tests and smoke runs, not for the training loop)."""
    return int(sum(int(f[-1]) for ring in _rings.values()
                   for f in ring.flags))


def _check(operands: Sequence[torch.Tensor]) -> None:
    dev = operands[0].device
    for x in operands:
        if x.device != dev:
            raise NotImplementedError(
                "ring_exchange: ranks on different devices need peer "
                "mappings, which are not ported yet (ROADMAP A11)")
        if x.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"ring_exchange kernel takes float32 or int32 "
                            f"operands, got {x.dtype}")
        if not x.is_contiguous():
            raise TypeError("ring_exchange needs contiguous operands")
    if len(operands) > 1024:
        raise ValueError("ring_exchange: at most 1024 ranks")


def ring_exchange(operands: Sequence[torch.Tensor],
                  out: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``operands[r]``: rank ``r``'s ``(n, C, ...)`` operand, block ``j``
    bound for rank ``j``.  Returns the n results: block ``j`` of
    ``result[r]`` is ``operands[j][r]``.  ``out``, an ``(n, n, C, ...)``
    tensor, takes the results of ranks that share a device as its n
    slices (the caller can then work on all of them at once)."""
    global launches
    n = _check_shapes(operands)
    kind = operands[0].device.type
    if out is not None and (out.shape != (n, *operands[0].shape)
                            or out.dtype != operands[0].dtype
                            or out.device != operands[0].device
                            or not out.is_contiguous()):
        raise ValueError("ring_exchange: out must be a contiguous (n, "
                         "*operand shape) tensor of the operands' dtype "
                         "and device")
    if kind == "cpu":
        res = ring_exchange_plain(operands)
        if out is None:
            return res
        for r, t in enumerate(res):
            out[r].copy_(t)
        return list(out.unbind(0))
    if kind != "cuda":
        raise ValueError(f"ring_exchange: unsupported device "
                         f"{operands[0].device}")
    _check(operands)
    dev = operands[0].device
    if out is None:
        out = torch.empty((n, *operands[0].shape), dtype=operands[0].dtype,
                          device=dev)
    outs = list(out.unbind(0))
    block_bytes = operands[0].numel() // n * operands[0].element_size()
    if block_bytes == 0:
        return outs
    ring = _rings.get((n, dev))
    if ring is None:
        ring = _rings[(n, dev)] = _Ring(n, dev)
    ring.epoch += 1
    out_ptrs = ring.out_ptrs(out).data_ptr()
    flag_ptrs = ring.flag_ptrs.data_ptr()
    per_step = max(1, min(-(-block_bytes // _BYTES_PER_BLOCK),
                          _MAX_BLOCKS // n))
    send = build.function("ring", "smtpu_ring_send", _SEND_ARGTYPES)
    wait = build.function("ring", "smtpu_ring_wait", _WAIT_ARGTYPES)
    stream = build.stream_of(operands[0])
    # every send is enqueued before any wait
    for me, x in enumerate(operands):
        rc = send(me, n, block_bytes, x.data_ptr(), out_ptrs, flag_ptrs,
                  ring.done_ptrs[me], ring.epoch, per_step, stream)
        build.check_launch("ring_exchange (send)", rc)
        launches += 1
    # all n ranks share this card: their waits go in one launch
    rc = wait(n, n, flag_ptrs, ring.epoch, _MAX_POLLS, stream)
    build.check_launch("ring_exchange (wait)", rc)
    return outs
