"""Time the ring-exchange kernel on the card.

    python -m swiftmpi_tpu_torch.apps.ring_sweep [-n 8] [-c 13125]

For the three operand shapes of the sharded word2vec h family at the
reference configuration (``(n, C, 100)`` and ``(n, C, 101)`` float32,
``(n, C)`` int32), stacked as the transfer hands them to the kernel, it
prints one JSON line each: the byte bound; the median time of an exchange
(one send launch and one wait launch) from CUDA events with the L2
flushed before each (as ``chip_smoke.py`` times it), taken before and
after the plain version's and one library call's
(``x.transpose(0, 1).contiguous()``); then, for back-to-back exchanges
with nothing flushed, the host's time to enqueue one exchange and the time
per exchange once the queue drains.  The first say how far the kernel is
from the byte bound and from PyTorch's own copy, the last two whether the
host or the card bounds a run of exchanges.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from swiftmpi_tpu_torch.apps.w2v_profile import card_line
from swiftmpi_tpu_torch.kernels import ring
from swiftmpi_tpu_torch.utils import CMDLine

RUNS = 25
BACK_TO_BACK = 50
#: published H100 SXM HBM bytes/s
PEAK_BYTES_S = 3.35e12


def _median_ms(fn, flush: torch.Tensor) -> float:
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS)]
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def sweep(n: int, C: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep measures the card; no CUDA device is "
                           "available")
    dev = torch.device("cuda")
    card = card_line()
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    for tail, dtype in (((C, 100), torch.float32), ((C, 101), torch.float32),
                        ((C,), torch.int32)):
        x = (torch.rand((n, n, *tail), device=dev) * 1000).to(dtype)
        nbytes = 2 * x.numel() * 4
        row = {"card": card, "ranks": n, "operand": [n, *tail],
               "dtype": str(dtype), "bytes_moved": nbytes,
               "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
        if not torch.equal(ring.ring_exchange_stacked(x),
                           ring.ring_exchange_stacked_plain(x)):
            raise AssertionError("ring_exchange != plain")
        row["ms"] = [_median_ms(lambda: ring.ring_exchange_stacked(x),
                                flush)]
        row["plain_ms"] = _median_ms(
            lambda: ring.ring_exchange_stacked_plain(x), flush)
        row["library_ms"] = _median_ms(
            lambda: x.transpose(0, 1).contiguous(), flush)
        row["ms"].append(_median_ms(lambda: ring.ring_exchange_stacked(x),
                                    flush))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BACK_TO_BACK):
            ring.ring_exchange_stacked(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        row["host_enqueue_ms"] = (t1 - t0) / BACK_TO_BACK * 1e3
        row["back_to_back_ms"] = (t2 - t0) / BACK_TO_BACK * 1e3
        row["wait_timeouts"] = ring.timeouts()
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("n", "ranks (default 8)")
    cmd.registerParameter("c", "bucket capacity per destination (default "
                          "13125)")
    sweep(int(cmd.getValue("n", "8")), int(cmd.getValue("c", "13125")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
