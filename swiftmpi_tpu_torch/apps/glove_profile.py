"""Time and profile GloVe training of the port on the card, through
``GloVe.train``, at bench.py's shape (``_bench_glove``):
``synthetic_corpus(600, 30_000, 500, seed=11)``, ``len_vec`` 100, window
8, minibatch 8,192, ``[worker] inner_steps: 8`` (one CUDA graph replay a
group on ``transfer: xla``) and ``pipeline: 4``.  The table is 17,314 rows
of 404 floats (w, wt, b, bt and their sums); 8,192 slots a batch are
below half of it, so every push is sparse.

    python -m swiftmpi_tpu_torch.apps.glove_profile [-inner 8] \\
        [-pipeline 4] [-shards 8] [-epochs 5] [-trace build/glove.json]

One untimed epoch first (the graph captures; ``first_epoch_s``), then:

* ``cells_per_sec``: co-occurrence cells trained (padded cells included,
  as the loss counts them) over the host clock of ``train(niters =
  epochs)``, which ends in a synchronize;
* ``device_ms_per_step``: the card's busy time (the union of its kernels'
  and copies' intervals) in one more profiled epoch (``torch.profiler``),
  per step; ``idle_share`` ``1 - busy time / the timed run's time per
  epoch``;
* ``by_kernel_ms_per_step``, ``host_ops_per_step`` and
  ``by_host_op_ms_per_step`` as ``w2v_profile.py`` gives them;
* ``stall_ms_per_step``, the input wait of the timed run, and
  ``peak_device_mib`` over it; ``table_mib``.

Prints one JSON object; ``-trace`` also writes the profiled epoch's Chrome
trace.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps.w2v_profile import (_device_busy,
                                                 _host_by_op, card_line)
from swiftmpi_tpu_torch.data.text import synthetic_corpus
from swiftmpi_tpu_torch.models.glove import GloVe
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser

#: bench.py's GloVe corpus (its SENTENCES, VOCAB and SENT_LEN)
GLOVE_CORPUS = dict(n_sentences=600, vocab_size=30_000, length=500,
                    seed=11)
#: bench.py's GloVe settings
GLOVE_CONF = {
    "cluster": {"transfer": "xla", "server_num": 1},
    "glove": {"len_vec": 100, "window": 8, "learning_rate": 0.05,
              "minibatch": 8_192},
    "server": {"frag_num": 1000},
}


def glove_model(inner: int = 8, pipeline: int = 4, shards: int = 0,
                device="cuda") -> GloVe:
    """The model of bench.py's shape, built over its corpus."""
    conf = ConfigParser().update(GLOVE_CONF)
    conf.update({"worker": {"inner_steps": inner, "pipeline": pipeline}})
    if shards:
        conf.update({"cluster": {"transfer": "tpu", "server_num": shards}})
    return GloVe(config=conf, device=device).build(
        synthetic_corpus(**GLOVE_CORPUS))


def profile(inner: int = 8, pipeline: int = 4, shards: int = 0,
            epochs: int = 5, trace: str = "") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("glove_profile measures the card; no CUDA "
                           "device is available")
    t0 = time.perf_counter()
    model = glove_model(inner, pipeline, shards)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.train(niters=1)
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = model.train(niters=epochs)
    m = model.train_metrics
    launches = kernels.launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model.train(niters=1)
    steps = model.train_metrics["steps"]
    busy_ms, by_kernel = _device_busy(prof)
    host_by_op, host_calls = _host_by_op(prof)
    if trace:
        prof.export_chrome_trace(trace)
    epoch_ms = m["seconds"] / epochs * 1e3
    return {
        "card": card_line(), "inner_steps": inner, "pipeline": pipeline,
        "fused": m["fused"], "shards": model.cluster.n_servers,
        "vocab": len(model.vocab), "cells": len(model._coo[2]),
        "capacity": model.table.capacity, "minibatch": model.minibatch,
        "epochs": epochs, "steps_per_epoch": steps,
        "build_seconds": build_s, "first_epoch_s": first_s,
        "seconds": m["seconds"], "cells_per_sec": m["cells_per_sec"],
        "epoch_ms": epoch_ms, "graph_replays": m["graph_replays"],
        "stall_ms_per_step": m["stall_ms_per_step"], "loss": losses,
        "push_paths": m["push_paths"],
        "launches_per_step": {k: v / m["steps"]
                              for k, v in launches.items()},
        "device_ms_per_step": busy_ms / steps if busy_ms
        else "not measured",
        "idle_share": (1 - busy_ms / epoch_ms) if busy_ms
        else "not measured",
        "by_kernel_ms_per_step": {k: v / steps for k, v in by_kernel.items()},
        "by_host_op_ms_per_step": {k: v / steps
                                   for k, v in host_by_op.items()},
        "host_ops_per_step": host_calls / steps,
        "table_mib": sum(t.numel() * t.element_size()
                         for v in model.table.state.values()
                         for t in (v if isinstance(v, list) else [v]))
        / 2 ** 20,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("inner", "[worker] inner_steps (default 8)")
    cmd.registerParameter("pipeline", "[worker] pipeline (default 4)")
    cmd.registerParameter("shards", "n: the sharded parameter server with "
                          "n ranks on the card")
    cmd.registerParameter("epochs", "timed epochs (default 5)")
    cmd.registerParameter("trace", "write the profiled epoch's Chrome "
                          "trace here")
    out = profile(int(cmd.getValue("inner", "8")),
                  int(cmd.getValue("pipeline", "4")),
                  int(cmd.getValue("shards", "0")),
                  int(cmd.getValue("epochs", "5")),
                  cmd.getValue("trace", ""))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
