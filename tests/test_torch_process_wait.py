"""B5's cross-process wait on the CPU: what runs without a card.

The wait itself is a stream memory operation on the card
(``smtpu_ring_process_exchange`` in ``csrc/ring.cu``; held on the card by
``tests/test_torch_cuda.py``).  Here, with ``build.function`` stubbed by a
recorder: the arguments ``ProcessRing`` hands that entry point (the
epoch's receive buffer, the flag pages, the events, the stream), the flag
pages in System V shared memory (made, traded through a store, attached,
pinned), the watchdog's deadline and timeout bookkeeping under a fake
clock and fake events, and that the in-process forms still call
``smtpu_ring_exchange`` with the wait kernel's poll bound as before.
"""

import math
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from swiftmpi_tpu_torch.kernels import build, ring


class _Calls:
    """``build.function`` stand-in: every entry point records its calls
    and returns 0 (or what ``results`` says)."""

    def __init__(self, results=None, effects=None):
        self.calls = []
        self.results = results or {}
        self.effects = effects or {}
        self.events = 0

    def function(self, lib, symbol, argtypes):
        assert lib == "ring"

        def call(*args):
            self.calls.append((symbol, args))
            if symbol == "smtpu_ring_event_create":
                self.events += 1
                args[0]._obj.value = 0xE000 + self.events
            elif symbol == "smtpu_ring_host_register":
                args[2]._obj.value = args[0] + (1 << 40)
            if symbol in self.effects:
                self.effects[symbol](*args)
            return self.results.get(symbol, 0)
        call.argtypes = list(argtypes)
        return call

    def of(self, symbol):
        return [a for s, a in self.calls if s == symbol]


class _Store:
    def __init__(self):
        self.kv = {}

    def set(self, k, v):
        self.kv[k] = v if isinstance(v, bytes) else str(v).encode()

    def get(self, k):
        return self.kv[k]


@pytest.fixture
def calls(monkeypatch):
    c = _Calls()
    monkeypatch.setattr(build, "function", c.function)
    return c


def _ring_on_cpu(monkeypatch, calls, dp=2, rank=0):
    """A ProcessRing with its card calls stubbed and its tensors on the
    CPU: the peers' flag pages are real System V segments made here and
    published in the store; the peers' receive buffers CPU tensors."""
    monkeypatch.setattr(torch.cuda, "get_allocator_backend",
                        lambda: "native")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0x5700))
    monkeypatch.setattr(
        ring.ProcessRing, "_share",
        lambda self, name, t: [t if r == self.rank else torch.zeros_like(t)
                               for r in range(self.dp)])
    store = _Store()
    serial = ring._ring_serial + 1
    peers = {}
    for r in range(dp):
        if r != rank:
            shmid, addr = ring.shm_create(ring._FLAG_BYTES)
            peers[r] = addr
            store.set(f"smtpu/ring/{serial}/flags/{r}", shmid)
    pr = ring.ProcessRing(dp, rank, store, torch.device("cpu"))
    pr.watchdog = ring.WaitWatchdog(pr._query, pr._release, pr._event,
                                    thread=False)
    return pr, store, peers


def _close(pr, peers):
    pr.close()
    for addr in peers.values():
        ring.shm_detach(addr)


def test_process_ring_refuses_a_card_without_stream_memory_ops(
        monkeypatch):
    """The ring checks the card once, at its start, and raises: no other
    wait stands behind the stream wait."""
    c = _Calls(results={"smtpu_ring_process_init": 801})
    monkeypatch.setattr(build, "function", c.function)
    monkeypatch.setattr(torch.cuda, "get_allocator_backend",
                        lambda: "native")
    with pytest.raises(RuntimeError, match="64-bit stream memory"):
        ring.ProcessRing(2, 0, _Store(), torch.device("cuda", 3))
    assert c.of("smtpu_ring_process_init") == [(3,)]
    assert not c.of("smtpu_ring_process_exchange")


@pytest.mark.parametrize("rank", [0, 1])
def test_flag_pages_are_shared_and_pinned(monkeypatch, calls, rank):
    """Each process's flag page is a System V segment: this process's made
    here and its id published, the peer's attached by the id in the
    store; every page pinned for the card (its device address into
    ``flag_ptrs`` in process order); a write to this process's page by
    another mapping reads back as ``timeouts()``'s count."""
    pr, store, peers = _ring_on_cpu(monkeypatch, calls, rank=rank)
    try:
        own_id = int(store.get(f"smtpu/ring/{pr.serial}/flags/{rank}"))
        regs = calls.of("smtpu_ring_host_register")
        assert [a[1] for a in regs] == [ring._FLAG_BYTES] * 2
        assert sorted(a[0] for a in regs) == sorted(pr.flag_addrs)
        want = [a + (1 << 40) for a in pr.flag_addrs]
        assert pr.flag_ptrs.tolist() == want
        assert pr.own_flags == want[rank]
        # the peer's page, through the peer's mapping and the ring's
        mine = (ring.ctypes.c_int64 * 3).from_address(peers[1 - rank])
        theirs = (ring.ctypes.c_int64 * 3).from_address(
            pr.flag_addrs[1 - rank])
        mine[rank] = 9
        assert list(theirs) == [9 if j == rank else 0 for j in range(3)]
        other = ring.shm_attach(own_id)       # as a peer maps it
        try:
            view = torch.frombuffer(
                (ring.ctypes.c_int64 * 3).from_address(other),
                dtype=torch.int64)
            view[2] = 5
            assert pr.timeouts() == 5 and pr.flags.tolist() == [0, 0, 5]
        finally:
            ring.shm_detach(other)
    finally:
        _close(pr, peers)
    assert pr.timeouts() == 5       # the count outlives the page
    assert len(calls.of("smtpu_ring_host_unregister")) == 2


@pytest.mark.parametrize("form", ["all_gather", "all_to_all"])
def test_exchange_hands_the_entry_point_its_ring(monkeypatch, calls, form):
    """One call of ``smtpu_ring_process_exchange`` an exchange: dp, rank,
    the block's bytes, the operand and its block stride (0 for the
    all-gather), the epoch parity's receive-buffer array, the flag
    pointers, the arrival counters, this process's flag page, the epoch,
    two events and the current stream; the watchdog gets the epoch, the
    events and ``_MAX_POLLS`` polls of ``_POLL_S`` as its deadline; the
    result is the parity's half of the receive buffer."""
    pr, _, peers = _ring_on_cpu(monkeypatch, calls)
    try:
        def deliver(n, me, block, x, x_block, outs, flags, done, own,
                    epoch, sent, waited, stream):
            # the peers' sends: epoch e's received blocks, words of e
            half = pr.recv.view(torch.uint8)[
                (epoch % 2) * pr.capacity:][:n * block]
            half.view(torch.int32).fill_(epoch)
        calls.effects["smtpu_ring_process_exchange"] = deliver
        x = torch.arange(2 * 6, dtype=torch.float32).view(2, 6)
        for epoch in (1, 2, 3):
            if form == "all_gather":
                got = pr.all_gather(x[0].contiguous())
                want_shape, x_block = (2, 6), 0
            else:
                got = pr.all_to_all(x)
                want_shape, x_block = (2, 6), 24
            assert got.shape == want_shape
            assert torch.equal(got.view(torch.int32),
                               torch.full(want_shape, epoch,
                                          dtype=torch.int32))
            args = calls.of("smtpu_ring_process_exchange")[-1]
            assert args[:3] == (2, 0, 24)
            assert args[4] == x_block
            assert args[5] == pr.outs[epoch % 2].data_ptr()
            assert args[6:10] == (pr.flag_ptrs.data_ptr(),
                                  pr.done.data_ptr(), pr.own_flags, epoch)
            assert args[12] == 0x5700
            p = pr.watchdog._pending[-1]
            assert (p.epoch, p.sent, p.waited) == (epoch, args[10], args[11])
            assert p.deadline_s == ring._MAX_POLLS * ring._POLL_S
        assert pr.epoch == 3 and len(pr.watchdog._pending) == 3
        assert pr.outs[0].data_ptr() != pr.outs[1].data_ptr()
        assert pr.outs[1].tolist()[0] == pr.recv.data_ptr() + pr.capacity
        # no kernel of the wait: the in-process entry point is not called
        assert not calls.of("smtpu_ring_exchange")
    finally:
        _close(pr, peers)
    assert len(calls.of("smtpu_ring_event_destroy")) == 6


def test_release_raises_this_processs_flag_page(monkeypatch, calls):
    """A release hands the C side this process's page, dp, rank and the
    epoch (the peers' slots go up to it and the count by one there)."""
    pr, _, peers = _ring_on_cpu(monkeypatch, calls, dp=2, rank=1)
    try:
        pr._release(7)
        assert calls.of("smtpu_ring_release") == [
            (pr.flag_addrs[1], 2, 1, 7)]
    finally:
        _close(pr, peers)


class _Events:
    """Fake events: each one has run once the test says so."""

    def __init__(self):
        self.n = 0
        self.ran = set()

    def create(self):
        self.n += 1
        return self.n

    def query(self, ev):
        return ev in self.ran


def _watchdog():
    ev = _Events()
    rel = []
    return ring.WaitWatchdog(ev.query, rel.append, ev.create,
                             thread=False), ev, rel


def test_watchdog_retires_waits_that_end_in_time():
    w, ev, rel = _watchdog()
    pairs = [w.events() for _ in range(3)]
    for e, (s, d) in enumerate(pairs, 1):
        w.add(e, s, d, 0.5)
    assert w.poll(0.0) == 0.05         # a quarter of 0.5, capped at 0.05
    for s, d in pairs[:2]:
        ev.ran |= {s, d}
    assert w.poll(10.0) is not None and len(w._pending) == 1
    ev.ran |= set(pairs[2])
    assert w.poll(20.0) is None and len(w._pending) == 0
    assert rel == []
    # the six events come back for the next exchanges
    assert sorted(w.events() + w.events() + w.events()) == list(range(1, 7))
    assert ev.n == 6


def test_watchdog_never_releases_a_wait_that_has_not_begun():
    """The deadline runs from the moment the send was seen done: a wait
    queued behind other work is not released however long the host has
    waited for it."""
    w, ev, rel = _watchdog()
    s, d = w.events()
    w.add(1, s, d, 0.01)
    for t in (0.0, 1.0, 100.0):
        w.poll(t)
    assert rel == []
    ev.ran.add(s)
    w.poll(100.0)                     # seen begun at 100
    w.poll(100.005)
    assert rel == []
    w.poll(100.02)
    assert rel == [1]


def test_watchdog_releases_once_then_follows_the_next_exchange():
    w, ev, rel = _watchdog()
    (s1, d1), (s2, d2) = w.events(), w.events()
    w.add(1, s1, d1, 1.0)
    w.add(2, s2, d2, 1.0)
    ev.ran.add(s1)
    w.poll(0.0)
    for t in (1.5, 2.0, 3.0):
        w.poll(t)
    assert rel == [1]                 # released once, still pending
    assert len(w._pending) == 2
    ev.ran |= {d1, s2}                # the release let the stream go on
    w.poll(4.0)
    assert len(w._pending) == 1
    w.poll(4.5)
    assert rel == [1]
    w.poll(5.1)
    assert rel == [1, 2]


@pytest.mark.parametrize("polls,interval", [
    (20_000_000, 0.05),               # the default: 5 s, polled at the cap
    (800_000, 0.05),                  # the dead-peer drill's 0.2 s
    (100_000, 0.00625),               # 25 ms: a quarter
    (100, 1e-3)])                     # the stall drill's: at the floor
def test_the_poll_bound_maps_onto_the_deadline(polls, interval):
    w, ev, _ = _watchdog()
    s, d = w.events()
    w.add(1, s, d, polls * ring._POLL_S)
    assert w.poll(0.0) == pytest.approx(interval)


def test_watchdog_thread_releases_a_stuck_wait_and_stops():
    """The daemon thread polls while an exchange is pending: a wait whose
    send ran and whose waits never end is released within its deadline
    plus a poll; ``close`` stops the thread and returns every event."""
    ev = _Events()
    rel = []
    got = threading.Event()

    def release(epoch):
        rel.append(epoch)
        got.set()
    w = ring.WaitWatchdog(ev.query, release, ev.create)
    s, d = w.events()
    ev.ran.add(s)
    t0 = time.monotonic()
    w.add(4, s, d, 0.01)
    assert got.wait(2.0), "the watchdog released nothing"
    assert rel == [4] and time.monotonic() - t0 >= 0.01
    ev.ran.add(d)
    deadline = time.monotonic() + 2.0
    while len(w._pending) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(w._pending) == 0
    assert sorted(w.close()) == [1, 2]
    assert not w._thread.is_alive()


def test_watchdog_reports_a_failed_query_to_the_next_exchange():
    def query(ev):
        raise RuntimeError("event query failed with error 700")
    w = ring.WaitWatchdog(query, lambda e: None, iter(range(9)).__next__,
                          thread=False)
    s, d = w.events()
    w.add(1, s, d, 1.0)
    with pytest.raises(RuntimeError, match="error 700"):
        w.poll(0.0)
    threaded = ring.WaitWatchdog(query, lambda e: None,
                                 iter(range(9)).__next__)
    s, d = threaded.events()
    threaded.add(1, s, d, 1.0)
    threaded._thread.join(2.0)
    with pytest.raises(RuntimeError, match="watchdog failed"):
        threaded.events()
    threaded.close()


def test_timeouts_sum_the_process_rings_host_counts(monkeypatch):
    """``timeouts()`` adds each process ring's count from its host page
    (no card read) to the in-process rings' device counts."""
    fake = SimpleNamespace(timeouts=lambda: 3)
    monkeypatch.setattr(ring, "_process_rings", {"cuda:0": fake})
    monkeypatch.setattr(ring, "_rings", {})
    assert ring.timeouts() == 3


# -- the in-process forms keep their kernel wait --------------------------------

class _OnCard:
    """A stand-in for a CUDA tensor: shape, dtype, contiguous strides and
    an address (nothing is read or written)."""
    _next = [1 << 20]

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size((shape,) if isinstance(shape, int)
                                else shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self._ptr = _OnCard._next[0]
        _OnCard._next[0] += 1 << 24

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def stride(self, i=None):
        out, acc = [], 1
        for n in reversed(self.shape):
            out.append(acc)
            acc *= n
        out = tuple(reversed(out))
        return out if i is None else out[i]

    def data_ptr(self):
        return self._ptr

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def to(self, *a, **k):
        return self

    def unbind(self, dim):
        return [_OnCard(self.shape[1:], self.dtype)
                for _ in range(self.shape[0])]


class _TorchOnCard:
    """``torch`` as the ring module sees it on a card: allocations give
    stand-ins, the current stream a fixed handle."""

    def __init__(self):
        self.cuda = SimpleNamespace(
            current_stream=lambda *a: SimpleNamespace(cuda_stream=0xCAFE))

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(shape, dtype=torch.float32, device=None):
        return _OnCard(shape, dtype)

    zeros = empty

    @staticmethod
    def tensor(data, dtype=None):
        return _OnCard((len(data),), dtype or torch.int64)

    @staticmethod
    def stack(ts):
        return _OnCard((len(ts), *ts[0].shape), ts[0].dtype)


@pytest.mark.parametrize("form", ["stacked", "autograd", "list"])
def test_in_process_forms_still_launch_the_wait_kernel(monkeypatch, calls,
                                                       form):
    """The n ranks of one card: one ``smtpu_ring_exchange`` call an
    exchange, as before this form's wait moved off the card for processes:
    n senders from rank 0 at step 1, the stacked operand's base and rank
    stride, the block stride, the output's, the flag and counter arrays,
    the epoch and ``_MAX_POLLS`` for the wait kernel, the stream."""
    monkeypatch.setattr(ring, "torch", _TorchOnCard())
    monkeypatch.setattr(ring, "_rings", {})
    monkeypatch.setattr(ring, "launches", 0)
    n, C, d = 4, 3, 5
    for epoch in (1, 2):
        if form == "list":
            ring.ring_exchange([_OnCard((n, C, d)) for _ in range(n)])
        else:
            x = _OnCard((n, n, C, d))
            if form == "stacked":
                ring.ring_exchange_stacked(x)
            else:
                ring.RingExchange.forward(SimpleNamespace(), x)
        args = calls.of("smtpu_ring_exchange")[-1]
        block = C * d * 4
        assert args[:5] == (n, n, 0, 1, block)
        assert args[6:8] == (n * block, block)
        assert args[9] == n * block and args[10] is None
        r = ring._rings[(n, torch.device("cuda", 0))]
        assert args[11:13] == (r.flag_ptrs_ptr, r.done_ptr)
        assert args[13:] == (epoch, ring._MAX_POLLS, 0xCAFE)
    assert ring.launches == 2
    assert not calls.of("smtpu_ring_process_exchange")
