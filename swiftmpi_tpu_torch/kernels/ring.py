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
:class:`RingExchange` is the stacked form with its gradient (the same
exchange of the gradient), for the rank axes of the transformer family:
the all-to-alls of Ulysses attention and of expert-parallel MoE
(``parallel/collectives.py`` ``rank_all_to_all``).

The CUDA kernel (``csrc/ring.cu``) is two launches per exchange on a card.
``ring_send``, one launch for all the ranks of the card, copies block
``(me + s) % n`` of every sender into slot ``me`` of rank ``(me + s) %
n``'s output for s = 0..n-1 and publishes a per-step flag at the receiver
(a system-scope fence, then a release store of a growing epoch).
``ring_wait`` (one thread per peer, acquire loads, one thread block per
rank of the card) is enqueued after the sends, the ``start()`` ...
``wait()`` split of the Pallas kernel, so a waiter never holds the card
against a sender that is not scheduled yet.  Here the n ranks are logical
and share one card and one stream, so the waits find their flags set.  Sources and outputs go to the kernel as base + stride, so an
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

**Across processes** (the data axis of a multi-process run,
:class:`ProcessRing`): the same launches, one pair per exchange with
``senders = 1`` and ``first = dp_rank``, between the ``dp``
processes that share the card.  Each process allocates its receive
buffers and its ``(dp + 1)`` flag array once, shares them through CUDA
IPC (``torch.multiprocessing.reductions.reduce_tensor``, the handles
traded through the process group's store) and maps its peers' with
``rebuild_cuda_tensor``; the device arrays ``outs`` (every process's
receive buffer, peers' mapped pointers included) and ``flags`` give the
kernel every address.  The receive buffers are two, used by the
exchange's epoch parity, and each exchange copies its result out on the
stream right after its wait: a peer's send of exchange e + 2 into a
buffer waits, through its own wait of e + 1, for this process's send of
e + 1, which the stream runs after the copy out of e.  Two forms:
:func:`process_all_to_all` (block j of the ``(dp, C, ...)`` operand goes
to process j) and :func:`process_all_gather` (every process's tensor to
every process), whose send addresses every block at the one tensor (the
entry point's block stride ``x_block`` 0, where the all-to-all passes
the block's length).  Two processes on one card time-slice their kernels
(no MPS is required): a waiter can spin until the peer's send is
scheduled, bounded by ``_MAX_POLLS`` like every wait; a wait that gives
up counts in :func:`timeouts`, which ``Word2Vec.train`` reads once an
epoch and fails the run on.  The plain version is ``torch.distributed``'s
``all_to_all_single`` and ``all_gather`` over gloo on CPU tensors; a
CUDA tensor goes through the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import math
import pickle
from typing import Dict, List, Optional, Sequence

import torch

from swiftmpi_tpu_torch.kernels import build

#: exchanges launched on a card since the last reset: each is one launch
#: of the send kernel and one of the wait kernel, from one C call
launches = 0
#: bytes of the operands the launches exchanged (every rank's ``(n, C,
#: ...)`` blocks, its own block included) since the process began
operand_bytes = 0
#: exchanges across processes (:class:`ProcessRing`) launched since the
#: last reset: one send launch and one wait launch each
process_launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p,
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
    """Waits that gave up since the process began, in this process's
    in-process and cross-process exchanges (reads the card; for tests and
    smoke runs, not for the training loop)."""
    return int(sum(int(ring.flags[:, -1].sum()) for ring in _rings.values())
               + sum(int(pr.flags[-1]) for pr in _process_rings.values()))


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
                       x.stride(0) * es, block_bytes, out.data_ptr(),
                       out.stride(0) * es,
                       None, ring.flag_ptrs_ptr, ring.done_ptr, ring.epoch,
                       _MAX_POLLS,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("ring_exchange", rc)
    launches += 1
    operand_bytes += x.numel() * es
    return out


class RingExchange(torch.autograd.Function):
    """:func:`ring_exchange_stacked` with its gradient, for the rank axes
    of the transformer family (Ulysses attention, expert-parallel MoE).
    The exchange ``result[r, j] = x[j, r]`` is its own inverse, so its
    backward is the same exchange of the incoming gradient, made
    contiguous first: on the card both directions launch the kernel."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return ring_exchange_stacked(x.contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return ring_exchange_stacked(grad.contiguous())


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
                "mappings, which are not ported yet (ROADMAP A11d)")
        _check_dtype(x.dtype)
        if not x.is_contiguous():
            raise TypeError("ring_exchange needs contiguous operands")
    return list(ring_exchange_stacked(torch.stack(list(operands))).unbind(0))


# -- across processes ---------------------------------------------------------

class ProcessRing:
    """The persistent half of the exchange between the ``dp`` processes of
    one card: this process's flag array (``dp`` epochs + a timeout count)
    and two receive buffers, its peers' mapped through CUDA IPC, the
    device arrays of their addresses, the arrival counters and the
    epoch.  The receive buffers grow (in every process at the same
    exchange, since every process exchanges the same shapes) by trading
    new handles."""

    def __init__(self, dp: int, rank: int, store, device: torch.device):
        if torch.cuda.get_allocator_backend() != "native":
            raise RuntimeError("the cross-process exchange shares its "
                               "buffers through CUDA IPC, which needs the "
                               "native caching allocator")
        self.dp, self.rank, self.store = dp, rank, store
        self.device = torch.device(device)
        self.exchange = build.function("ring", "smtpu_ring_exchange",
                                       _ARGTYPES)
        self.epoch = 0
        self.generation = 0
        self.flags = torch.zeros(dp + 1, dtype=torch.int64, device=device)
        self.done = torch.zeros(dp, dtype=torch.int32, device=device)
        # the peers' mappings stay referenced: a dropped one is unmapped
        self._peer_flags = self._share("flags", self.flags)
        self.flag_ptrs = torch.tensor(
            [t.data_ptr() for t in self._peer_flags],
            dtype=torch.int64).to(device)
        self.capacity = 0          # bytes of one receive buffer
        self.recv: Optional[torch.Tensor] = None

    def _share(self, name: str, t: torch.Tensor) -> List[torch.Tensor]:
        """Publish ``t``'s IPC handle under ``name`` and map every peer's:
        the dp tensors in process order, this process's own ``t``."""
        from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                      reduce_tensor)
        key = f"smtpu/ring/{name}/{self.generation}"
        self.store.set(f"{key}/{self.rank}",
                       pickle.dumps(reduce_tensor(t)[1]))
        out = []
        for r in range(self.dp):
            if r == self.rank:
                out.append(t)
                continue
            out.append(rebuild_cuda_tensor(
                *pickle.loads(self.store.get(f"{key}/{r}"))))
        return out

    def _ensure(self, nbytes: int) -> None:
        """Receive buffers of at least ``nbytes`` each."""
        if nbytes <= self.capacity:
            return
        cap = max(nbytes, 2 * self.capacity, 1 << 20)
        cap = -(-cap // 256) * 256
        self.generation += 1
        torch.cuda.synchronize(self.device)   # the old buffers are done
        self.recv = torch.empty(2 * cap // 4, dtype=torch.int32,
                                device=self.device)
        peers = self._share("recv", self.recv)
        self.outs = [torch.tensor([p.data_ptr() + parity * cap
                                   for p in peers],
                                  dtype=torch.int64).to(self.device)
                     for parity in (0, 1)]
        self._peer_recv = peers
        self.capacity = cap

    def _check(self, x: torch.Tensor, block_shape) -> int:
        """The bytes of one block of ``x``, checked for the kernel."""
        _check_dtype(x.dtype)
        if not x.is_contiguous():
            raise TypeError("process exchange needs a contiguous operand")
        if x.device != self.device:
            raise ValueError(f"process exchange: operand on {x.device}, "
                             f"the ring on {self.device}")
        block_bytes = math.prod(block_shape) * x.element_size()
        if block_bytes % 4 or x.data_ptr() % 4:
            raise ValueError(f"process exchange: a block of "
                             f"{tuple(block_shape)} {x.dtype} is not whole "
                             "4-byte words")
        return block_bytes

    def _run(self, x: torch.Tensor, block_bytes: int, x_block: int,
             shape) -> torch.Tensor:
        """One exchange: this process's send of its dp blocks (block j at
        ``j * x_block`` from ``x``) and its wait, then the copy out of the
        ``shape`` blocks received."""
        global process_launches
        if block_bytes == 0:
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        nbytes = self.dp * block_bytes
        self._ensure(nbytes)
        self.epoch += 1
        parity = self.epoch % 2
        rc = self.exchange(self.dp, 1, self.rank, 1, block_bytes,
                           x.data_ptr(), 0, x_block, None, 0,
                           self.outs[parity].data_ptr(),
                           self.flag_ptrs.data_ptr(), self.done.data_ptr(),
                           self.epoch, _MAX_POLLS,
                           torch.cuda.current_stream(
                               self.device).cuda_stream)
        build.check_launch("process ring_exchange", rc)
        process_launches += 1
        got = self.recv.view(torch.uint8)[parity * self.capacity:
                                          parity * self.capacity + nbytes]
        # the copy out, on the stream before this process's next send
        return got.view(x.dtype).view(shape).clone()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: this process's ``(dp, C, ...)`` operand, block j bound
        for process j; returns the ``(dp, C, ...)`` blocks received, block
        j from process j, as a new tensor."""
        if x.dim() < 1 or x.shape[0] != self.dp:
            raise ValueError(f"process exchange: leading dim of "
                             f"{tuple(x.shape)} != {self.dp} processes")
        block_bytes = self._check(x, x.shape[1:])
        return self._run(x, block_bytes, block_bytes, x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``x`` (one shape everywhere), stacked ``(dp,
        ...)`` in process order, as a new tensor: every block of the send
        is ``x`` itself (a block stride of 0)."""
        block_bytes = self._check(x, x.shape)
        return self._run(x, block_bytes, 0, (self.dp, *x.shape))


_process_rings: Dict[torch.device, ProcessRing] = {}


def process_ring(device) -> ProcessRing:
    """This process's :class:`ProcessRing` on ``device``, made at first use
    (by every process at the same exchange) from the process group."""
    from swiftmpi_tpu_torch.cluster import bootstrap
    device = torch.device(device)
    ring = _process_rings.get(device)
    if ring is None:
        if bootstrap.store() is None:
            raise RuntimeError("the cross-process exchange needs the "
                               "process group (launch the program with "
                               "swiftmpi_tpu_torch.launch)")
        ring = _process_rings[device] = ProcessRing(
            bootstrap.process_count(), bootstrap.process_index(),
            bootstrap.store(), device)
    return ring


def close_process_rings() -> None:
    """Drop the cross-process rings and their mappings (at shutdown)."""
    if _process_rings:
        torch.cuda.synchronize()
    _process_rings.clear()


def _group_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size()


def process_all_to_all_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version over gloo: ``x`` a CPU ``(dp, C, ...)`` tensor."""
    import torch.distributed as dist
    if x.shape[0] != _group_size():
        raise ValueError(f"process exchange: leading dim of "
                         f"{tuple(x.shape)} != {_group_size()} processes")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


def process_all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version over gloo: every process's CPU tensor, stacked in
    process order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(_group_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


def process_all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``x``: this process's ``(dp, C, ...)`` operand, block j bound for
    process j.  Returns the ``(dp, C, ...)`` blocks received, block j from
    process j: gloo for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return process_all_to_all_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"process exchange: unsupported device {x.device}")
    return process_ring(x.device).all_to_all(x)


def process_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (one shape everywhere), stacked ``(dp, ...)``
    in process order: gloo for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return process_all_gather_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"process exchange: unsupported device {x.device}")
    return process_ring(x.device).all_gather(x.contiguous())
