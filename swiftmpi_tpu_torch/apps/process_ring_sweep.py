"""Time B5's cross-process form between the processes of one card.

    python -m swiftmpi_tpu_torch.launch -np 2 -- \\
        python -m swiftmpi_tpu_torch.apps.process_ring_sweep [-out FILE] \\
        [-rounds 3]

Process 0 prints (and with ``-out`` writes) one JSON object:

* ``shapes``: the all-gather at the main paths' shapes across processes
  (the hot plane's ``(222, 101)`` words of ``hybrid@4``, the v fold's
  ``(20,000, 102)`` of ``xla@dp2``, ``xla``'s ``(90,516, 101)`` plane and
  the transformer trainer's 10,488,065 packed grad words), each with its
  time from CUDA events over 20 back-to-back exchanges, its byte
  bound, gloo on CPU tensors (the plain version) and the host route
  (device -> host, gloo, host -> device), from the test children's
  ``_time_shapes``;
* ``progress``: whether a waiting process holds the card (:func:`progress`);
* ``poll_s``: the seconds one poll of the in-process wait kernel takes
  (:func:`poll_seconds`), the unit of ``kernels.ring._MAX_POLLS``;
* the card's name and power limit, the processes, the launches and
  ``timeouts()``.

It uses only the exchange's public functions, so the same file times an
earlier version of the package copied beside it.
"""

from __future__ import annotations

import json
import sys

import torch

from swiftmpi_tpu_torch.cluster import bootstrap
from swiftmpi_tpu_torch.kernels import build, ring
from swiftmpi_tpu_torch.utils import CMDLine

#: (label, (rows, 4-byte words a row)) of the main paths' all-gathers
SHAPES = (("hot_plane", (222, 101)), ("v_fold", (20_000, 102)),
          ("xla_plane", (90_516, 101)), ("grads_packed", (10_488_065, 1)))
#: chained (4096, 4096) float32 products in the fixed work of
#: :func:`progress` (~0.1 s on an H100)
WORK_PRODUCTS = 40


def _work(a: torch.Tensor) -> None:
    b = a
    for _ in range(WORK_PRODUCTS):
        b = torch.mm(a, b)


def progress(device, rounds: int = 3) -> dict:
    """Whether a process that waits in an exchange holds the card: process
    1 runs a fixed amount of work (chained float32 products) alone, then
    again while process 0 waits in an all-gather whose send process 1
    enqueues after the work.  The work's device ms both times (CUDA
    events, every round), process 0's wait ms, and whether each
    exchange's result is the expected copy.  A wait that keeps its
    context runnable makes the card time-slice the two contexts, so the
    work takes about twice as long; a wait that leaves its context
    nothing to run does not slow it."""
    dp, me = bootstrap.process_count(), bootstrap.process_index()
    gen = torch.Generator().manual_seed(5)
    a = (torch.randn(4096, 4096, generator=gen) / 64).to(device)
    x = torch.full((1000, 8), float(me), device=device)
    want = torch.arange(dp, dtype=torch.float32)[:, None, None].expand(
        dp, 1000, 8)
    _work(a)
    torch.cuda.synchronize()
    alone, during, waits, exact = [], [], [], True
    for _ in range(rounds):
        bootstrap.barrier()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        if me == 1:
            s.record()
            _work(a)
            e.record()
        torch.cuda.synchronize()
        if me == 1:
            alone.append(s.elapsed_time(e))
        bootstrap.barrier()
        s.record()
        if me == 1:
            _work(a)
            e.record()
            got = ring.process_all_gather(x)
        else:
            got = ring.process_all_gather(x)
            e.record()
        torch.cuda.synchronize()
        (during if me == 1 else waits).append(s.elapsed_time(e))
        exact = exact and torch.equal(got.cpu(), want)
    return {"rank": me, "work_alone_ms": alone, "work_during_wait_ms":
            during, "wait_ms": waits, "exact": exact}


def poll_seconds(device, polls=(100_000, 1_000_000)) -> float:
    """Seconds a poll of the in-process wait kernel takes: one send of
    rank 0 of 2 logical ranks (rank 1 never sends), so rank 0's wait
    polls its ``max_polls`` and gives up; the slope of its device time
    between the two poll counts (CUDA events)."""
    fn = build.function("ring", "smtpu_ring_exchange", ring._ARGTYPES)
    x = torch.zeros((2, 64), dtype=torch.int32, device=device)
    out = torch.zeros((2, 2, 64), dtype=torch.int32, device=device)
    ms = []
    for epoch, p in enumerate(polls, 1):
        flags = torch.zeros((2, 3), dtype=torch.int64, device=device)
        ptrs = torch.tensor([flags.data_ptr(), flags.data_ptr() + 24],
                            dtype=torch.int64).to(device)
        done = torch.zeros(2, dtype=torch.int32, device=device)
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream(device).cuda_stream
        s.record()
        rc = fn(2, 1, 0, 1, 256, x.data_ptr(), 0, 256, out.data_ptr(),
                out.stride(0) * 4, None, ptrs.data_ptr(), done.data_ptr(),
                epoch, p, stream)
        build.check_launch("ring_exchange (poll probe)", rc)
        e.record()
        torch.cuda.synchronize()
        if int(flags[0, 2]) != 1:
            raise AssertionError("the poll probe's wait did not give up")
        ms.append(s.elapsed_time(e))
    return (ms[1] - ms[0]) / 1e3 / (polls[1] - polls[0])


def main(argv=None) -> int:
    from swiftmpi_tpu_torch.apps.w2v_profile import card_line
    from swiftmpi_tpu_torch.testing.mp_child import _time_shapes
    cmd = CMDLine(["process_ring_sweep"] + list(
        sys.argv[1:] if argv is None else argv))
    rounds = int(cmd.get_value("rounds", "3"))
    if not torch.cuda.is_available():
        print("process_ring_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    bootstrap.init_distributed()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        poll = poll_seconds(dev) if bootstrap.process_index() == 0 else None
        bootstrap.barrier()
        ring.process_launches = 0
        shapes = _time_shapes(list(SHAPES), dev)
        launches = ring.process_launches
        prog = progress(dev, rounds)
        parts = [None] * bootstrap.process_count()
        import torch.distributed as dist
        dist.all_gather_object(parts, prog)
        out = {"card": card_line(), "processes": bootstrap.process_count(),
               "shapes": shapes, "launches": launches,
               "progress": parts, "poll_s": poll,
               "timeouts": ring.timeouts()}
        if bootstrap.process_index() == 0:
            line = json.dumps(out)
            print(line, flush=True)
            path = cmd.get_value("out", "")
            if path:
                with open(path, "w") as f:
                    f.write(line + "\n")
        return 0
    finally:
        bootstrap.shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
