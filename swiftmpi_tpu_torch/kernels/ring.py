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
:class:`ProcessRing`): one send launch per exchange (``senders = 1``,
``first = dp_rank``) between the ``dp`` processes that share the card,
and a wait that is no kernel.  Two processes on one card are two contexts,
which the card time-slices (no MPS is required), and a waiter kernel keeps
its context runnable: the peer's send ran only once the waiter's timeslice
expired, so every exchange cost a timeslice, 2.1-2.3 ms at any size on
an H100 (PERF.md).  So one C call (``smtpu_ring_process_exchange``)
enqueues the send, an event ``sent``, one stream memory operation a peer
(``cuStreamWaitValue64(flag[j] >= epoch)``, which the card's front end
holds) and an event ``waited``; a waiting process holds no SM and leaves
its context nothing to run.  The card must offer 64-bit stream memory
operations: the ring refuses to start otherwise.

Each process's flag array (``dp`` epochs + a timeout count) lies in one
page of System V shared memory that every process attaches and pins for
the card, its id traded through the process group's store; the peers'
send kernels publish into it as before.  The receive buffers (device
memory) are shared through CUDA IPC (``torch.multiprocessing.reductions.
reduce_tensor``, the handles traded through the store) and mapped with
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
the block's length).

A stream wait has no deadline of its own, so a :class:`WaitWatchdog`
thread gives it one: ``_MAX_POLLS`` polls of the in-process wait kernel
(``_POLL_S`` each) after its ``sent`` event ran.  A wait still pending
then is released from the host, never by queueing work behind the
blocked stream: its peers' slots are raised to the epoch in the pinned
page and a timeout is counted there.  :func:`timeouts` reads the count,
and ``Word2Vec.train`` reads it once an epoch and fails the run on it.
A dead peer thus holds a stream at most the deadline.  The plain version
is ``torch.distributed``'s ``all_to_all_single`` and ``all_gather`` over
gloo on CPU tensors; a CUDA tensor goes through the kernel or the call
raises.
"""

from __future__ import annotations

import collections
import ctypes
import math
import os
import pickle
import threading
import time
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
#: last reset: one send launch and one stream wait a peer each
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
               + sum(pr.timeouts() for pr in _process_rings.values()))


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

#: entry points of the cross-process form: its exchange, set-up, release
#: and events (``csrc/ring.cu``)
_PROCESS_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p]
_PROCESS_ENTRIES = {
    "exchange": ("smtpu_ring_process_exchange", _PROCESS_ARGTYPES),
    "init": ("smtpu_ring_process_init", [ctypes.c_int]),
    "release": ("smtpu_ring_release", [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_ulonglong]),
    "register": ("smtpu_ring_host_register",
                 [ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.POINTER(ctypes.c_void_p)]),
    "unregister": ("smtpu_ring_host_unregister", [ctypes.c_void_p]),
    "event_create": ("smtpu_ring_event_create",
                     [ctypes.POINTER(ctypes.c_void_p)]),
    "event_query": ("smtpu_ring_event_query", [ctypes.c_void_p]),
    "event_destroy": ("smtpu_ring_event_destroy", [ctypes.c_void_p]),
}

#: seconds one poll of the in-process wait kernel takes on the card (a
#: 100 ns sleep and a system-scope load; 2.49e-7 to 2.52e-7 s on an H100,
#: ``apps/process_ring_sweep.py``'s ``poll_s``): a cross-process wait's
#: deadline is ``_MAX_POLLS`` such polls after its send ran (5 s)
_POLL_S = 2.5e-7

#: cudaErrorNotReady: an event whose work has not run yet
_NOT_READY = 600

#: bytes of each process's flag segment (dp epochs + a timeout count)
_FLAG_BYTES = 4096


def _libc():
    """The C library's System V shared memory calls."""
    lib = ctypes.CDLL(None, use_errno=True)
    lib.shmget.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int]
    lib.shmget.restype = ctypes.c_int
    lib.shmat.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.shmat.restype = ctypes.c_void_p
    lib.shmdt.argtypes = [ctypes.c_void_p]
    lib.shmdt.restype = ctypes.c_int
    lib.shmctl.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.shmctl.restype = ctypes.c_int
    return lib


def _shm_failed(what: str):
    err = ctypes.get_errno()
    return OSError(err, f"{what}: {os.strerror(err)}")


def shm_create(nbytes: int):
    """A new zeroed System V segment of ``nbytes``, attached here and
    already marked for removal (it goes when its last process detaches, so
    a crash leaks nothing; Linux lets peers attach it until then):
    ``(id, address)``."""
    lib = _libc()
    shmid = lib.shmget(0, nbytes, 0o1000 | 0o600)     # IPC_PRIVATE, IPC_CREAT
    if shmid < 0:
        raise _shm_failed("shmget")
    addr = shm_attach(shmid)
    if lib.shmctl(shmid, 0, None) != 0:               # IPC_RMID
        err = _shm_failed("shmctl")
        lib.shmdt(addr)
        raise err
    return shmid, addr


def shm_attach(shmid: int) -> int:
    """Attach the segment ``shmid``: its address in this process."""
    addr = _libc().shmat(shmid, None, 0)
    if addr is None or addr == ctypes.c_void_p(-1).value:
        raise _shm_failed(f"shmat of segment {shmid}")
    return addr


def shm_detach(addr: int) -> None:
    _libc().shmdt(addr)


class _Pending:
    """One exchange the watchdog follows: its epoch, its two events, its
    deadline, when its wait was seen to begin and whether it was
    released."""
    __slots__ = ("epoch", "sent", "waited", "deadline_s", "since",
                 "released")

    def __init__(self, epoch, sent, waited, deadline_s):
        self.epoch, self.sent, self.waited = epoch, sent, waited
        self.deadline_s = deadline_s
        self.since = None
        self.released = False


class WaitWatchdog:
    """Bounds the cross-process waits, which the card's front end holds
    with no deadline of their own.  Each exchange hands it its epoch, the
    event recorded after its send (``sent``), the one after its waits
    (``waited``) and its deadline.  :meth:`poll` retires the exchanges in
    stream order once ``waited`` has run; the first one whose ``sent`` has
    run but whose ``waited`` has not ``deadline_s`` after that was seen is
    released, once: ``release(epoch)`` raises the peers' flag slots to the
    epoch and counts a timeout.  A daemon thread polls while exchanges are
    pending, a quarter of the head's deadline apart (within
    ``MIN_POLL_S``..``MAX_POLL_S``), and sleeps on a condition while none
    is.  The events are recycled.

    ``query(event)`` is True once the event's work has run;
    ``create()`` makes an event; ``clock`` gives seconds.  ``thread=False``
    leaves polling to the caller (tests)."""

    MIN_POLL_S = 1e-3
    MAX_POLL_S = 0.05

    def __init__(self, query, release, create, clock=time.monotonic,
                 device=None, thread: bool = True):
        self._query, self._release, self._create = query, release, create
        self._clock = clock
        self._device = device
        self._threaded = thread
        self._pending: collections.deque = collections.deque()
        self._free: list = []
        self._made: list = []
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: what stopped the thread (a failed event query), raised to the
        #: next exchange
        self.error: Optional[BaseException] = None

    def events(self):
        """Two events for the next exchange: recycled or new."""
        with self._cv:
            if self.error is not None:
                raise RuntimeError("the cross-process wait watchdog "
                                   "failed") from self.error
            if len(self._free) >= 2:
                return self._free.pop(), self._free.pop()
        pair = self._create(), self._create()
        with self._cv:
            self._made += pair
        return pair

    def add(self, epoch: int, sent, waited, deadline_s: float) -> None:
        with self._cv:
            idle = not self._pending
            self._pending.append(_Pending(epoch, sent, waited, deadline_s))
            if self._threaded and self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="smtpu-ring-watchdog",
                    daemon=True)
                self._thread.start()
            if idle:
                self._cv.notify()

    def _interval(self, p: _Pending) -> float:
        return min(max(p.deadline_s / 4, self.MIN_POLL_S), self.MAX_POLL_S)

    def poll(self, now: float) -> Optional[float]:
        """Retire the finished exchanges and release the head if its wait
        outlived its deadline.  Returns the seconds until the next poll is
        due, None when nothing is pending."""
        while True:
            with self._cv:
                if not self._pending:
                    return None
                p = self._pending[0]
            if self._query(p.waited):
                with self._cv:
                    self._pending.popleft()
                    self._free += (p.sent, p.waited)
                continue
            if p.since is None:
                if not self._query(p.sent):
                    return self._interval(p)   # its wait has not begun
                p.since = now
            if not p.released and now - p.since > p.deadline_s:
                self._release(p.epoch)
                p.released = True
            return self._interval(p)

    def _loop(self) -> None:
        if self._device is not None:
            torch.cuda.set_device(self._device)
        while not self._stop.is_set():
            with self._cv:
                while not self._pending and not self._stop.is_set():
                    self._cv.wait()
            if self._stop.is_set():
                return
            try:
                wait = self.poll(self._clock())
            except Exception as e:     # raised to the next exchange
                with self._cv:
                    self.error = e
                return
            if wait is not None:
                self._stop.wait(wait)

    def close(self) -> list:
        """Stop the thread; returns every event it made (to destroy)."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return list(self._made)


_ring_serial = 0


class ProcessRing:
    """The persistent half of the exchange between the ``dp`` processes of
    one card: the flag segments (each process's ``dp`` epochs + a timeout
    count, in pinned host memory every process maps), two receive buffers
    a process, its peers' mapped through CUDA IPC, the device arrays of
    their addresses, the arrival counters, the epoch and the wait
    watchdog.  The receive buffers grow (in every process at the same
    exchange, since every process exchanges the same shapes) by trading
    new handles."""

    def __init__(self, dp: int, rank: int, store, device: torch.device):
        global _ring_serial
        if torch.cuda.get_allocator_backend() != "native":
            raise RuntimeError("the cross-process exchange shares its "
                               "buffers through CUDA IPC, which needs the "
                               "native caching allocator")
        self.dp, self.rank, self.store = dp, rank, store
        self.device = torch.device(device)
        self.fn = {k: build.function("ring", sym, argtypes)
                   for k, (sym, argtypes) in _PROCESS_ENTRIES.items()}
        index = self.device.index
        if index is None:
            index = torch.cuda.current_device()
        build.check_launch(
            "process ring_exchange: the cross-process wait needs the "
            "card's 64-bit stream memory operations "
            "(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS)",
            self.fn["init"](index))
        _ring_serial += 1
        self.serial = _ring_serial
        self.epoch = 0
        self.generation = 0
        self._segments: List[int] = []
        self._registered: List[int] = []
        self.flag_addrs, flag_devs = self._share_flags()
        #: this process's flags on the host: dp epochs + the timeout count
        self.flags = torch.frombuffer(
            (ctypes.c_int64 * (dp + 1)).from_address(
                self.flag_addrs[rank]), dtype=torch.int64)
        self.own_flags = flag_devs[rank]
        self.flag_ptrs = torch.tensor(flag_devs,
                                      dtype=torch.int64).to(device)
        self.done = torch.zeros(dp, dtype=torch.int32, device=device)
        self.capacity = 0          # bytes of one receive buffer
        self.recv: Optional[torch.Tensor] = None
        self.watchdog = WaitWatchdog(self._query, self._release,
                                     self._event, device=self.device)

    def _share_flags(self):
        """Each process's flag segment: made here (this process's) or
        attached by the id its owner published, then pinned for the card.
        Returns the host addresses and the device addresses, in process
        order."""
        key = f"smtpu/ring/{self.serial}/flags"
        shmid, own = shm_create(_FLAG_BYTES)
        self._segments.append(own)
        self.store.set(f"{key}/{self.rank}", str(shmid))
        addrs = []
        for r in range(self.dp):
            if r == self.rank:
                addrs.append(own)
                continue
            addr = shm_attach(int(self.store.get(f"{key}/{r}")))
            self._segments.append(addr)
            addrs.append(addr)
        devs = []
        for addr in addrs:
            dev = ctypes.c_void_p()
            build.check_launch("process ring_exchange: pinning the flags",
                               self.fn["register"](addr, _FLAG_BYTES,
                                                   ctypes.byref(dev)))
            self._registered.append(addr)
            devs.append(dev.value)
        return addrs, devs

    def _event(self) -> int:
        ev = ctypes.c_void_p()
        build.check_launch("process ring_exchange: an event",
                           self.fn["event_create"](ctypes.byref(ev)))
        return ev.value

    def _query(self, ev) -> bool:
        rc = self.fn["event_query"](ev)
        if rc == _NOT_READY:
            return False
        build.check_launch("process ring_exchange: an event query", rc)
        return True

    def _release(self, epoch: int) -> None:
        """A wait of ``epoch`` outlived its deadline: raise the peers'
        slots of this process's flags to it (the stream goes on, its
        results stale) and count a timeout."""
        self.fn["release"](self.flag_addrs[self.rank], self.dp, self.rank,
                           epoch)

    def _share(self, name: str, t: torch.Tensor) -> List[torch.Tensor]:
        """Publish ``t``'s IPC handle under ``name`` and map every peer's:
        the dp tensors in process order, this process's own ``t``."""
        from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                      reduce_tensor)
        key = f"smtpu/ring/{self.serial}/{name}/{self.generation}"
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
        ``j * x_block`` from ``x``) and its waits, then the copy out of the
        ``shape`` blocks received."""
        global process_launches
        if block_bytes == 0:
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        nbytes = self.dp * block_bytes
        self._ensure(nbytes)
        self.epoch += 1
        parity = self.epoch % 2
        sent, waited = self.watchdog.events()
        rc = self.fn["exchange"](
            self.dp, self.rank, block_bytes, x.data_ptr(), x_block,
            self.outs[parity].data_ptr(), self.flag_ptrs.data_ptr(),
            self.done.data_ptr(), self.own_flags, self.epoch, sent, waited,
            torch.cuda.current_stream(self.device).cuda_stream)
        build.check_launch("process ring_exchange", rc)
        self.watchdog.add(self.epoch, sent, waited, _MAX_POLLS * _POLL_S)
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

    def timeouts(self) -> int:
        """Waits released at their deadline since the ring began (a host
        read)."""
        return int(self.flags[-1])

    def close(self) -> None:
        """Stop the watchdog and drop the events, pins and segments (the
        card's work on them done first)."""
        for ev in self.watchdog.close():
            self.fn["event_destroy"](ev)
        # the peers' buffers unmapped now, as a dropped ring would be (the
        # watchdog's bound methods keep this object alive until collected)
        self._peer_recv, self.outs, self.recv = [], [], None
        for addr in self._registered:
            self.fn["unregister"](addr)
        self._registered = []
        self.flags = self.flags.clone()    # the count outlives the segment
        for addr in self._segments:
            shm_detach(addr)
        self._segments = []


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
    for pr in _process_rings.values():
        pr.close()
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
