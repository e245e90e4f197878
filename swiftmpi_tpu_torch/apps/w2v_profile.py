"""Time and profile word2vec steps of the port on the card, at the full
width of the reference configuration (demo.conf on the text8-shaped
synthetic corpus, the configuration ``chip_smoke.py`` runs).

    python -m swiftmpi_tpu_torch.apps.w2v_profile [-steps 40] \\
        [-stencil 1] [-shared 1] [-sg 1] [-dense 1] [-shards 8] \\
        [-transfer hybrid] [-traffic 1] [-vocab 1000000] \\
        [-dtype bfloat16] [-local_steps L] [-hogwild n] \\
        [-push_window W] [-wire_quant int8|bf16] [-wire_sketch 1] \\
        [-collective auto|sparse_allreduce] [-pull_quant int8|bf16] \\
        [-pull_cache N] [-trace build/w2v_step_trace.json] \\
        [-telemetry 1 [-telemetry_every K] [-numerics 1] [-obs_trace 1]]

``-stencil 1`` / ``-shared 1`` / ``-sg 1`` / ``-dense 1`` set
``[word2vec] stencil`` / ``shared_negatives`` / ``sg`` / ``dense_logits``
(the ``stencil``, ``shared``, ``stencil_shared``, ``sg``, ``sg_shared``
and ``dense`` renderings); the default is the gather rendering.
``-shards n`` runs the sharded parameter server (``[cluster] transfer:
tpu``, ``server_num: n``) with its n ranks on the one card; ``-transfer
hybrid`` runs the hybrid transfer instead (the frequency head in hot
planes, the tail on ``-shards`` ranks, one without it).  ``-traffic 1``
sets the transfer's ``count_traffic`` and reports the ledger's
``traffic()`` delta of each of ``TRAFFIC_STEPS`` steps after the profiled
window, beside ``ring_bytes_per_step`` (the ring's operand bytes).
``-vocab 1000000`` runs bench.py's ``scale_hybrid`` shape instead of the
reference one: 1,000,000 keys with bench.py's counts (``max(zipf(1.3) %
1000, 1)``, seed 0), the stencil rendering with a shared pool of 4096,
sample off, minibatch 5000 for the head's calibration, and stencil
batches of ``SCALE_BATCH`` centers over spans of sentences of 500 tokens.
bench.py draws the span tokens uniformly from the vocabulary, which sends
about 6% of the rows to the head; here they are drawn from the
vocabulary's own counts (``ZipfSpans``), so the head gets the traffic it
was calibrated for.  ``-dtype
bfloat16`` sets ``[server] dtype`` (bfloat16 h and v, float32
accumulators).  ``-local_steps L`` runs the snapshot async mode (grads
against a snapshot refreshed every L steps, as ``train`` runs it);
``-hogwild n`` hogwild with n workers on the card (``async_mode:
hogwild``, the card n times in the model's cluster), ``L`` batches a
worker (default 1), timed and profiled in whole groups of n*L batches.
``-push_window W`` runs ``inner_steps: INNER_STEPS`` groups with
``[cluster] push_window: W`` through ``Word2Vec._run_group``, as
``train`` runs them (on ``xla`` each group one CUDA graph replay after
the first; on ``tpu`` and ``hybrid`` eager), timed and profiled in whole
groups (``-push_window 1``: the same groups without windows); with
``-traffic 1`` the ledger's deltas are then one a group, and
``windows_per_group`` says how many window pushes a family a group
makes.  ``-push_window 8 -vocab 1000000 -transfer hybrid`` is bench.py's
``scale_window`` cell.

The wire stack's knobs set their ``[cluster]`` keys: ``-wire_quant``,
``-wire_sketch`` and ``-collective`` (with ``-push_window W > 1``: the
window's quantized and encoded rungs, the sparse allreduce),
``-pull_quant`` and ``-pull_cache N`` (the pull wire, at any window).
With ``-traffic 1``, ``wire`` reports the window decisions and the pull
decisions of the ledger deltas and their bytes a step (``wire_bytes``,
``pull_bytes``, the cache's hits).  A cached pull reads its versions
back to the host, so with ``-pull_cache`` and ``-traffic 1`` the ``xla``
groups run step by step, not as graph replays, as ``train`` runs them.

Batches are made before the clock starts, so the numbers are the
device path's alone (the host batcher's time is reported apart):

* ``step_ms``: host clock around ``steps`` calls of ``Word2Vec.step``
  ending in ``torch.cuda.synchronize()``, divided by ``steps``;
* ``device_ms_per_step``: the card's busy time (the union of its kernels'
  and copies' intervals, ``obs.profiler.device_busy``) in a
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

``-telemetry 1`` arms the telemetry plane over every step the app runs
(``[worker] telemetry`` with an in-memory recorder, ``telemetry_every:
K`` from ``-telemetry_every``, the transfer ledger's registry mirror);
``-numerics 1`` adds ``[obs] numerics`` (one bundle a step, or a group)
and ``-obs_trace 1`` the wire tracer (``[obs] trace``; it switches
``count_traffic`` on and the groups run eagerly).  The report then
carries ``telemetry``, the recorder's last step record, and
``numerics_bundles``.

Prints one JSON object; ``-trace`` also writes the window's Chrome trace.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

import numpy as np

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.obs import profiler as obs_profiler
from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, StencilBatch, Vocab,
                                          build_vocab, synthetic_corpus_bulk)
from swiftmpi_tpu_torch.kernels import ring
from swiftmpi_tpu_torch.models.word2vec import (Word2Vec, _batch_fields,
                                                _refresh, _snapshot,
                                                _stack_group_host)
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser
from swiftmpi_tpu_torch.utils.pipeline import LossAccum as _LossAccum

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
#: the ledger keys ``wire`` sums over the traffic steps: the window and
#: pull decisions (counts), the bytes and the cache hits (a step)
WIRE_REPORT = ("window_fmt_dense", "window_fmt_sparse", "window_fmt_q",
               "window_fmt_bitmap", "window_fmt_sketch", "collective_psum",
               "collective_sparse_ar", "pull_fmt_full", "pull_fmt_bf16",
               "pull_fmt_q", "wire_bytes", "pull_bytes", "pull_bytes_saved",
               "pull_cache_hits", "hot_psum_bytes_saved")

#: steps whose ledger deltas ``-traffic 1`` reports one by one
TRAFFIC_STEPS = 4
#: ``[worker] inner_steps`` of the ``-push_window`` runs (bench.py's
#: INNER_STEPS)
INNER_STEPS = 8

#: bench.py's scale_hybrid cell: its vocabulary, settings and batch
SCALE_VOCAB = 1_000_000
SCALE_CONF = {
    "cluster": {"transfer": "hybrid", "server_num": 1},
    "word2vec": {"len_vec": 100, "window": 4, "negative": 20, "sample": -1,
                 "learning_rate": 0.05, "stencil": 1,
                 "shared_negatives": 1, "shared_pool": 4096},
    "server": {"initial_learning_rate": 0.7, "frag_num": 1000},
    "worker": {"minibatch": 5000},
}
SCALE_BATCH = 16_384
SENT_LEN = 500


def scale_vocab(V: int = SCALE_VOCAB, seed: int = 0) -> Vocab:
    """bench.py's ``build_w2v_1m_model`` vocabulary: keys 1..V, counts
    ``max(zipf(1.3) % 1000, 1)`` from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(1.3, size=V) % 1000, 1).astype(np.int64)
    return Vocab(keys=np.arange(1, V + 1, dtype=np.uint64), counts=counts)


class ZipfSpans:
    """Stencil batches at the scale shape: ``B`` centers at positions
    ``W .. W + B - 1`` of a span of ``S = B + 2W`` tokens, sentences of
    ``SENT_LEN`` tokens, per-center halves uniform in ``1 .. W`` (bench.py's
    spans), the tokens drawn from the vocabulary's counts.  An ``epoch``
    yields ``n_batches`` batches; the stream is seeded."""

    def __init__(self, vocab: Vocab, window: int, n_batches: int,
                 seed: int = 1):
        self.vocab, self.window, self.n_batches = vocab, window, n_batches
        cdf = np.cumsum(vocab.counts, dtype=np.float64)
        self._cdf = cdf / cdf[-1]
        self._rng = np.random.default_rng(seed)

    def epoch_stencil(self, B: int):
        W, rng = self.window, self._rng
        S = B + 2 * W
        sent_id = (np.arange(S) // SENT_LEN).astype(np.int32)
        center_pos = (W + np.arange(B)).astype(np.int32)
        for _ in range(self.n_batches):
            tokens = np.searchsorted(self._cdf, rng.random(S),
                                     side="right").astype(np.int32)
            half = rng.integers(1, W + 1, size=B).astype(np.int32)
            yield StencilBatch(tokens, sent_id, center_pos, half, B)


def card_line(index: int | None = None) -> str:
    """``name, power.limit`` of card ``index`` (the current card by
    default), as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device() if index is None
               else index].strip()


def _short(name: str) -> str:
    """The port's kernels by their function name; others cut to 80
    characters."""
    m = re.search(r"\b(masked_gather_\w+|masked_scatter_add|"
                  r"adagrad_update|stencil_gather|context_sum_\w+|"
                  r"ring_send|ring_wait)\b",
                  name)
    return m.group(1) if m else name[:80]


def _device_busy(prof) -> tuple:
    """The profiled window's device busy ms (``obs.profiler.device_busy``:
    overlapping streams count once) and its device ms by kernel or copy
    name, largest first."""
    busy_ms, by_name = obs_profiler.device_busy(prof)
    out = {}
    for name, ms in by_name.items():
        if ms > 0:
            key = _short(name)
            out[key] = out.get(key, 0.0) + ms
    return busy_ms, dict(sorted(out.items(), key=lambda kv: -kv[1]))


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
            dtype: str = "float32", sg: int = 0, dense: int = 0,
            local_steps: int = 1, hogwild: int = 0, transfer: str = "",
            traffic: int = 0, vocab_size: int = 0,
            push_window: int = 0, wire_quant: str = "off",
            wire_sketch: int = 0, collective: str = "psum",
            pull_quant: str = "off", pull_cache: int = 0,
            telemetry: int = 0, numerics: int = 0, obs_trace: int = 0,
            telemetry_every: int = 1) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("w2v_profile measures the card; no CUDA device "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch_size = BATCH
    if vocab_size:
        corpus, vocab = None, scale_vocab(vocab_size)
        config = ConfigParser().update(SCALE_CONF)
        batch_size = SCALE_BATCH
    else:
        corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
        vocab = build_vocab(corpus)
        config = ConfigParser().update(DEMO_CONF)
        config.set("word2vec", "stencil", stencil)
        config.set("word2vec", "shared_negatives", shared)
    config.set("server", "dtype", dtype)
    config.set("word2vec", "sg", sg)
    config.set("word2vec", "dense_logits", dense)
    config.set("word2vec", "local_steps", local_steps)
    if shards or transfer:
        config.set("cluster", "transfer", transfer or "tpu")
        config.set("cluster", "server_num", shards or 1)
    knobs = {"wire_quant": wire_quant, "wire_sketch": wire_sketch,
             "collective": collective, "pull_quant": pull_quant,
             "pull_cache": pull_cache}
    for k, v in knobs.items():
        config.set("cluster", k, v)
    cluster = None
    # whole hogwild or window groups: the warm-up, the timed steps and the
    # profiled window
    group = 1
    if push_window:
        config.set("cluster", "push_window", push_window)
        config.set("worker", "inner_steps", INNER_STEPS)
        group = INNER_STEPS
    if hogwild:
        config.set("word2vec", "async_mode", "hogwild")
        cluster = Cluster(config, devices=["cuda"] * hogwild).initialize()
        group = hogwild * max(local_steps, 1)
    if telemetry:
        config.set("worker", "telemetry", 1)
        config.set("worker", "telemetry_path", "")
        config.set("worker", "telemetry_every", telemetry_every)
        config.set("obs", "numerics", numerics)
        config.set("obs", "trace", obs_trace)
        config.set("obs", "trace_dir", os.path.join("build", "traces"))
    model = Word2Vec(config=config, device="cuda", cluster=cluster)
    model.build_from_vocab(vocab)
    rec = None
    if telemetry:
        rec = obs.configure(config, run="w2v_profile")
        rec.add_sampler(model.transfer.mirror_traffic)
        if numerics:
            model._arm_numerics(rec)
    warm = -(-WARM_STEPS // group) * group
    steps = -(-steps // group) * group
    n_window = -(-PROFILED_STEPS // group) * group
    n_traffic = (group if push_window else TRAFFIC_STEPS) if traffic else 0
    need = warm + steps + n_window + n_traffic
    if vocab_size:
        batcher = ZipfSpans(vocab, model.window, need)
    else:
        batcher = CBOWBatcher(corpus, vocab, model.window, model.sample,
                              seed=2008)
    model.transfer.count_traffic = bool(traffic) or \
        obs.get_tracer() is not None
    t0 = time.perf_counter()
    batches = []
    epoch = batcher.epoch_stencil if model.stencil else batcher.epoch
    for b in epoch(batch_size):
        batches.append(b)
        if len(batches) == need:
            break
    batcher_s = time.perf_counter() - t0
    if len(batches) < need:
        raise RuntimeError(f"the corpus gave {len(batches)} batches, "
                           f"{need} needed")

    # the snapshot mode's copy, refreshed every local_steps steps
    snapshot = (_snapshot(model.table.state, model.access.pull_fields,
                          model.cluster.mesh)
                if local_steps > 1 and not hogwild else None)
    done = replays = 0
    graphs = (bool(push_window) and model.transfer.name == "xla"
              and obs.get_tracer() is None
              and not (pull_cache and model.transfer.count_traffic))
    losses = (_LossAccum(None, model.device), _LossAccum(None, model.device))

    def run(bs):
        nonlocal done, replays
        if push_window:
            for i in range(0, len(bs), group):
                fields = tuple(torch.from_numpy(a).to(model.device) for a in
                               _stack_group_host(bs[i:i + group]))
                with obs.span("dispatch"):
                    replays += model._run_group(fields, graphs, None,
                                                *losses)
                obs.record_step(group)
            return
        if hogwild:
            for i in range(0, len(bs), group):
                model._hogwild_group([_batch_fields(b)
                                      for b in bs[i:i + group]])
                obs.record_step(group)
            return
        for b in bs:
            if snapshot is None:
                model.step_batch(b)
            else:
                model._step_fields(_batch_fields(b), None, snapshot)
                done += 1
                if done % local_steps == 0:
                    _refresh(snapshot, model.table.state)
            obs.record_step(1)

    run(batches[:warm])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    replays = 0                    # graph replays from here on
    timed = batches[warm:warm + steps]
    ring0 = ring.operand_bytes
    t0 = time.perf_counter()
    run(timed)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    ring_bytes = (ring.operand_bytes - ring0) / steps
    words = sum(b.n_words for b in timed)

    window = batches[warm + steps:warm + steps + n_window]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(window)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    busy_ms, by_kernel = _device_busy(prof)
    host_by_op, host_calls = _host_by_op(prof)
    if trace:
        prof.export_chrome_trace(trace)
    per_step = []
    rest = batches[warm + steps + n_window:]
    for i in range(0, len(rest), group if push_window else 1):
        # one traffic() read a step (a group with -push_window), after the
        # timed and profiled steps
        before = model.transfer.traffic()
        run(rest[i:i + (group if push_window else 1)])
        per_step.append({k: v for k, v in model.transfer.traffic_delta(
            before).items() if v})
    wire = dict(knobs, ef_planes=model.table.ef_fields,
                row_versions="@rowver" in model.table.state)
    tel = {}
    if rec is not None:
        rec.close()
        obs.uninstall_recorder()
        obs.uninstall_tracer()
        steps_recs = [r for r in rec.records() if r["kind"] == "step"]
        tel = {"telemetry": steps_recs[-1] if steps_recs else None,
               "telemetry_every": telemetry_every,
               "numerics_bundles": model._numerics.bundles
               if model._numerics is not None else 0}
    if traffic:
        # decisions as counted over the traffic steps; bytes and cache
        # hits a step
        for k in WIRE_REPORT:
            total = sum(d.get(k, 0) for d in per_step)
            per = "bytes" in k or k == "pull_cache_hits"
            wire[k + ("_per_step" if per else "")] = (
                total / max(len(rest), 1) if per else total)
    return {
        "wire": wire,
        "card": card_line(), "rendering": model.resolved_rendering,
        "local_steps": local_steps, "async_mode": model.async_mode,
        "workers": len(model.cluster.devices) if hogwild else 0,
        "steps": steps, "batch": batch_size,
        "n_hot": model.table.n_hot,
        "ring_bytes_per_step": ring_bytes,
        "traffic_per_step" if not push_window else "traffic_per_group":
        per_step,
        "push_window": push_window, "inner_steps": group if push_window
        else 1, "windows_per_group": -(-group // push_window)
        if push_window else 0, "graph_replays": replays,
        "window_expected_unique": model.transfer.window_expected_unique,
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
        **tel,
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
    cmd.registerParameter("sg", "1: skip-gram")
    cmd.registerParameter("dense", "1: dense logits")
    cmd.registerParameter("local_steps", "L > 1: the snapshot async mode; "
                          "with -hogwild, the batches a worker trains")
    cmd.registerParameter("hogwild", "n: hogwild with n workers on the "
                          "card")
    cmd.registerParameter("transfer", "tpu (default with -shards) or "
                          "hybrid")
    cmd.registerParameter("traffic", "1: count the transfer's traffic and "
                          "print each of a few steps' ledger deltas")
    cmd.registerParameter("vocab", "1000000: bench.py's scale_hybrid "
                          "shape")
    cmd.registerParameter("push_window", "W: groups of 8 steps with "
                          "[cluster] push_window: W")
    cmd.registerParameter("wire_quant", "[cluster] wire_quant: off "
                          "(default), int8 or bf16")
    cmd.registerParameter("wire_sketch", "1: [cluster] wire_sketch")
    cmd.registerParameter("collective", "[cluster] collective: psum "
                          "(default), auto or sparse_allreduce")
    cmd.registerParameter("pull_quant", "[cluster] pull_quant: off "
                          "(default), int8 or bf16")
    cmd.registerParameter("pull_cache", "N: [cluster] pull_cache lines")
    cmd.registerParameter("telemetry", "1: arm the telemetry plane")
    cmd.registerParameter("telemetry_every", "K: record every K steps "
                          "(default 1)")
    cmd.registerParameter("numerics", "1: with -telemetry, [obs] numerics")
    cmd.registerParameter("obs_trace", "1: with -telemetry, the wire "
                          "tracer ([obs] trace)")
    out = profile(int(cmd.getValue("steps", "40")),
                  cmd.getValue("trace", ""),
                  int(cmd.getValue("stencil", "0")),
                  int(cmd.getValue("shared", "0")),
                  int(cmd.getValue("shards", "0")),
                  cmd.getValue("dtype", "float32"),
                  int(cmd.getValue("sg", "0")),
                  int(cmd.getValue("dense", "0")),
                  int(cmd.getValue("local_steps", "1")),
                  int(cmd.getValue("hogwild", "0")),
                  cmd.getValue("transfer", ""),
                  int(cmd.getValue("traffic", "0")),
                  int(cmd.getValue("vocab", "0")),
                  int(cmd.getValue("push_window", "0")),
                  cmd.getValue("wire_quant", "off"),
                  int(cmd.getValue("wire_sketch", "0")),
                  cmd.getValue("collective", "psum"),
                  cmd.getValue("pull_quant", "off"),
                  int(cmd.getValue("pull_cache", "0")),
                  int(cmd.getValue("telemetry", "0")),
                  int(cmd.getValue("numerics", "0")),
                  int(cmd.getValue("obs_trace", "0")),
                  int(cmd.getValue("telemetry_every", "1")))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
