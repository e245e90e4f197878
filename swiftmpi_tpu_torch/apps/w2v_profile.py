"""Time and profile word2vec CBOW sync steps of the port on the card, at
the full width of the reference configuration (demo.conf on the
text8-shaped synthetic corpus, the configuration ``chip_smoke.py`` runs).

    python -m swiftmpi_tpu_torch.apps.w2v_profile [-steps 40] \\
        [-stencil 1] [-shared 1] [-shards 8] [-dtype bfloat16] \\
        [-trace build/w2v_step_trace.json]

``-stencil 1`` / ``-shared 1`` set ``[word2vec] stencil`` /
``shared_negatives`` (the ``stencil``, ``shared`` and ``stencil_shared``
renderings); the default is the gather rendering.  ``-shards n`` runs the
sharded parameter server (``[cluster] transfer: tpu``, ``server_num: n``)
with its n ranks on the one card.  ``-dtype bfloat16`` sets ``[server]
dtype`` (bfloat16 h and v, float32 accumulators).

Batches are made before the clock starts, so the numbers are the
device path's alone (the host batcher's time is reported apart):

* ``step_ms``: host clock around ``steps`` calls of ``Word2Vec.step``
  ending in ``torch.cuda.synchronize()``, divided by ``steps``;
* ``device_ms_per_step``: the summed kernel and copy time of a
  ``torch.profiler`` window of ten further steps, per step;
* ``idle_share``: ``1 - device_ms_per_step / step_ms``, the share of an
  unprofiled step the device is not busy (the profiled window itself
  runs slower, ``window_ms_per_step``, from the profiler's overhead);
* ``by_kernel_ms_per_step``: the window's device time by kernel name,
  largest first;
* ``by_host_op_ms_per_step``: the window's host time by operator (self
  time, the twelve largest), and ``host_ops_per_step``, the operators
  called a step: what a host-bound step spends its time on;
* ``centers_per_batch``: real centers per batch (a stencil batch holds
  fewer than ``BATCH`` when its span fills first);
* ``table_mib``: the table's bytes on the card (the four fields), and
  ``peak_device_mib`` the peak of allocated device memory over the timed
  steps.

Prints one JSON object; ``-trace`` also writes the window's Chrome trace.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          synthetic_corpus_bulk)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser

#: the text8-shaped corpus of the reference configuration
TEXT8_CORPUS = dict(n_sentences=17_000, vocab_size=70_000, length=1_000,
                    seed=42)
#: demo.conf's model and server settings
DEMO_CONF = {
    "cluster": {"transfer": "xla", "server_num": 1},
    "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                 "sample": 1e-5, "learning_rate": 0.05},
    "server": {"initial_learning_rate": 0.7},
    "worker": {"minibatch": 5000},
}
BATCH = 5_000
PROFILED_STEPS = 10
WARM_STEPS = 5


def card_line() -> str:
    """``name, power.limit`` of the current card, as nvidia-smi gives
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _short(name: str) -> str:
    """The port's kernels by their function name; others cut to 80
    characters."""
    m = re.search(r"\b(masked_gather_\w+|masked_scatter_add|"
                  r"adagrad_update|stencil_gather|context_sum_\w+|"
                  r"ring_send|ring_wait)\b",
                  name)
    return m.group(1) if m else name[:80]


def _busy_by_kernel(prof) -> dict:
    """Device time (ms) by kernel or copy name over the profiled window."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if ms > 0:
            key = _short(e.key)
            out[key] = out.get(key, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _host_by_op(prof, top: int = 12):
    """Host self time (ms) by operator over the profiled window, largest
    first, and the number of operator calls."""
    rows = [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[1])
    return ({k: ms for k, ms, _ in rows[:top]},
            sum(c for _, _, c in rows))


def profile(steps: int = 40, trace: str = "", stencil: int = 0,
            shared: int = 0, shards: int = 0,
            dtype: str = "float32") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("w2v_profile measures the card; no CUDA device "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    config = ConfigParser().update(DEMO_CONF)
    config.set("word2vec", "stencil", stencil)
    config.set("word2vec", "shared_negatives", shared)
    config.set("server", "dtype", dtype)
    if shards:
        config.set("cluster", "transfer", "tpu")
        config.set("cluster", "server_num", shards)
    model = Word2Vec(config=config, device="cuda")
    model.build_from_vocab(vocab)
    need = WARM_STEPS + steps + PROFILED_STEPS
    batcher = CBOWBatcher(corpus, vocab, model.window, model.sample,
                          seed=2008)
    t0 = time.perf_counter()
    batches = []
    epoch = batcher.epoch_stencil if model.stencil else batcher.epoch
    for b in epoch(BATCH):
        batches.append(b)
        if len(batches) == need:
            break
    batcher_s = time.perf_counter() - t0
    if len(batches) < need:
        raise RuntimeError(f"the corpus gave {len(batches)} batches, "
                           f"{need} needed")

    def run(bs):
        for b in bs:
            model.step_batch(b)

    run(batches[:WARM_STEPS])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = batches[WARM_STEPS:WARM_STEPS + steps]
    t0 = time.perf_counter()
    run(timed)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    words = sum(b.n_words for b in timed)

    window = batches[WARM_STEPS + steps:]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(window)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_kernel = _busy_by_kernel(prof)
    busy_ms = sum(by_kernel.values())
    host_by_op, host_calls = _host_by_op(prof)
    if trace:
        prof.export_chrome_trace(trace)
    return {
        "card": card_line(), "rendering": model.resolved_rendering,
        "steps": steps, "batch": BATCH,
        "transfer": model.transfer.name, "shards": model.cluster.n_servers,
        "centers_per_batch": words / steps,
        "vocab": len(vocab), "capacity": model.table.capacity,
        "dtype": dtype, "table_mib": sum(
            t.numel() * t.element_size()
            for v in model.table.state.values()
            for t in (v if isinstance(v, list) else [v])) / 2 ** 20,
        "step_ms": step_s * 1e3,
        "words_per_sec": words / (step_s * steps),
        "batcher_ms_per_batch": batcher_s / len(batches) * 1e3,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
        "profiled_steps": len(window),
        "window_ms_per_step": window_s / len(window) * 1e3,
        "device_ms_per_step": (busy_ms / len(window)) if busy_ms else
        "not measured",
        "idle_share": (1 - busy_ms / len(window) / (step_s * 1e3))
        if busy_ms else "not measured",
        "by_kernel_ms_per_step": {k: v / len(window)
                                  for k, v in by_kernel.items()},
        "by_host_op_ms_per_step": {k: v / len(window)
                                   for k, v in host_by_op.items()},
        "host_ops_per_step": host_calls / len(window),
        "push_paths": dict(model.transfer.push_paths),
    }


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("steps", "timed steps (default 40)")
    cmd.registerParameter("trace", "write the profiled window's Chrome "
                          "trace here")
    cmd.registerParameter("stencil", "1: the stencil rendering")
    cmd.registerParameter("shared", "1: shared negatives")
    cmd.registerParameter("shards", "n: the sharded parameter server with "
                          "n ranks on the card")
    cmd.registerParameter("dtype", "[server] dtype: float32 (default) or "
                          "bfloat16")
    out = profile(int(cmd.getValue("steps", "40")),
                  cmd.getValue("trace", ""),
                  int(cmd.getValue("stencil", "0")),
                  int(cmd.getValue("shared", "0")),
                  int(cmd.getValue("shards", "0")),
                  cmd.getValue("dtype", "float32"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
