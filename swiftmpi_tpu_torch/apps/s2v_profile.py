"""Time and profile sent2vec inference of the port on the card at
bench.py's shape (``_bench_s2v``): 1,024 sentences of 64 words drawn over
the reference vocabulary (``synthetic_corpus(1024, 70_000, 64,
seed=21)``), one batch of 1,024, 10 passes, over a word model of the
reference configuration (demo.conf on the text8-shaped corpus; its
initial table: the timing does not depend on the values).

    python -m swiftmpi_tpu_torch.apps.s2v_profile [-repeat 5] \\
        [-trace build/s2v_trace.json]

* ``seconds``: host clock around each of ``repeat`` calls of
  ``Sent2Vec.infer_sentences`` (tokenizing, the batch's arrays, the
  draws, the passes, the read back), after one warm-up call;
  ``sents_per_sec`` from their median;
* ``device_ms_per_batch``: the card's busy time (the union of its
  kernels' and copies' intervals) in one profiled call
  (``torch.profiler``), and ``idle_share`` ``1 - device_ms / median
  seconds``;
* ``by_kernel_ms_per_batch``: its device time by kernel name, largest
  first; ``host_ops_per_batch`` the operators called, and
  ``by_host_op_ms_per_batch`` their host self time (the twelve largest);
* ``b2_launches_per_batch``: the gather kernel's launches in one call.

Prints one JSON object; ``-trace`` also writes the profiled call's Chrome
trace.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps.w2v_profile import (DEMO_CONF, TEXT8_CORPUS,
                                                 _device_busy,
                                                 _host_by_op, card_line)
from swiftmpi_tpu_torch.data.text import (build_vocab, synthetic_corpus,
                                          synthetic_corpus_bulk)
from swiftmpi_tpu_torch.models.sent2vec import Sent2Vec
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser

#: bench.py's sent2vec shape
SENTS, LENGTH, NITERS = 1024, 64, 10


def profile(repeat: int = 5, trace: str = "") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("s2v_profile measures the card; no CUDA device "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    vocab = build_vocab(synthetic_corpus_bulk(**TEXT8_CORPUS))
    model = Word2Vec(config=ConfigParser().update(DEMO_CONF),
                     device="cuda").build_from_vocab(vocab)
    s2v = Sent2Vec(model, seed=1)
    s2v.batchsize = SENTS
    lines = [" ".join(map(str, s))
             for s in synthetic_corpus(SENTS, 70_000, LENGTH, seed=21)]

    def run():
        return s2v.infer_sentences(lines, niters=NITERS)

    out = run()
    times = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    kernels.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    busy_ms, by_kernel = _device_busy(prof)
    host_by_op, host_calls = _host_by_op(prof)
    if trace:
        prof.export_chrome_trace(trace)
    med = statistics.median(times)
    return {
        "card": card_line(), "sentences": len(out), "length": LENGTH,
        "niters": NITERS, "batch": SENTS, "vocab": len(vocab),
        "capacity": model.table.capacity, "seconds": times,
        "sents_per_sec": len(out) / med,
        "profiled_seconds": window_s,
        "device_ms_per_batch": busy_ms if busy_ms else "not measured",
        "idle_share": (1 - busy_ms / (med * 1e3)) if busy_ms
        else "not measured",
        "by_kernel_ms_per_batch": by_kernel,
        "by_host_op_ms_per_batch": host_by_op,
        "host_ops_per_batch": host_calls,
        "b2_launches_per_batch": launches["gather"],
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("repeat", "timed calls after the warm-up "
                          "(default 5)")
    cmd.registerParameter("trace", "write the profiled call's Chrome trace "
                          "here")
    out = profile(int(cmd.getValue("repeat", "5")), cmd.getValue("trace", ""))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
