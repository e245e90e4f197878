"""Time one epoch of ``Word2Vec.train`` at the reference configuration
(demo.conf on the text8-shaped synthetic corpus, the configuration
``chip_smoke.py`` runs) through each input and dispatch path, on the card.

    python -m swiftmpi_tpu_torch.apps.input_profile [-runs a,b,c,d,e] \\
        [-repeat 2] [-profile 1]

The corpus is written as a token file (a temporary directory under
``build/``, removed after) and loaded by the native C++ loader
(``data/native.py``).  The runs (``INPUT_RUNS``, the input phase of
``chip_smoke.py``):

* ``a``: gather on the native ``PrefetchingCBOWBatcher``, ``[worker]
  pipeline: 0``, ``inner_steps: 1``;
* ``b``: ``a`` with ``pipeline: 4`` (batches rendered 4 ahead on a
  producer thread, copied to the card from pinned memory);
* ``c``: ``b`` with ``inner_steps: 8`` (8 steps a CUDA graph replay);
* ``d``: stencil with ``pipeline: 4``, ``inner_steps: 8``;
* ``e``: gather on the Python ``CBOWBatcher``, ``pipeline: 0``.

Each epoch prints one JSON line: steps, words, seconds (host clock,
ending in a synchronize), words/s, ``batcher_seconds`` (the loop's wait
for its next batch), ``stall_ms_per_step``, graph replays, the loss.
Before the runs, the batchers alone render one epoch each, with no
training (``batcher_ms_per_batch``: the native batcher, synchronous and
prefetching, gather and stencil, and the Python one): the host's side of
the input path.  ``-repeat n`` runs the list n times in turns (a b c ...
a b c ...).
``-profile 1`` adds one epoch of each run under ``torch.profiler``:
``device_busy_ms`` (the union of every kernel's and copy's interval) and
``idle_share`` = 1 - busy / that epoch's seconds; the profiled epoch
itself runs slower than an unprofiled one.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,
                                                 TEXT8_CORPUS, card_line)
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          synthetic_corpus_bulk,
                                          write_tokens_file)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.obs import profiler as obs_profiler
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser

ROOT = Path(__file__).resolve().parents[2]

#: run -> (rendering, batcher, [worker] keys)
INPUT_RUNS = {
    "a": ("gather", "native", {"pipeline": 0, "inner_steps": 1}),
    "b": ("gather", "native", {"pipeline": 4, "inner_steps": 1}),
    "c": ("gather", "native", {"pipeline": 4, "inner_steps": 8}),
    "d": ("stencil", "native", {"pipeline": 4, "inner_steps": 8}),
    "e": ("gather", "python", {"pipeline": 0, "inner_steps": 1}),
}


def load_native(corpus) -> tuple:
    """Write ``corpus`` as a token file and load it with the native
    loader: ``(vocab, tokens, offsets, info)``, ``info`` the file's size
    and the write and load seconds."""
    tmp = Path(tempfile.mkdtemp(prefix="input_", dir=ROOT / "build"))
    try:
        path = tmp / "text8_tokens.txt"
        t0 = time.perf_counter()
        write_tokens_file(corpus, str(path))
        t1 = time.perf_counter()
        vocab, tokens, offsets = native.load_corpus_native(str(path))
        t2 = time.perf_counter()
        info = {"bytes": path.stat().st_size, "write_seconds": t1 - t0,
                "load_seconds": t2 - t1}
    finally:
        shutil.rmtree(tmp)
    return vocab, tokens, offsets, info


def run_model(run: str, vocab, device="cuda") -> Word2Vec:
    rendering, _, worker = INPUT_RUNS[run]
    conf = ConfigParser().update(DEMO_CONF)
    conf.set("word2vec", "stencil", int(rendering == "stencil"))
    for k, v in worker.items():
        conf.set("worker", k, v)
    return Word2Vec(config=conf, device=device).build_from_vocab(vocab)


def run_batcher(run: str, model: Word2Vec, corpus, loaded):
    """The run's batcher: the native prefetching one over ``loaded``
    (``load_native``'s first three), or the Python one over ``corpus``."""
    if INPUT_RUNS[run][1] == "native":
        nvocab, tokens, offsets = loaded
        return native.PrefetchingCBOWBatcher(tokens, offsets, nvocab,
                                             model.window, model.sample)
    return CBOWBatcher(corpus, model.vocab, model.window, model.sample,
                       seed=2008)


def epoch_line(run: str, model: Word2Vec, losses) -> dict:
    m = model.train_metrics
    rendering, loader, worker = INPUT_RUNS[run]
    return {"run": run, "rendering": rendering, "batcher": loader, **worker,
            "steps": m["steps"], "words": m["words"],
            "seconds": m["seconds"], "words_per_sec": m["words_per_sec"],
            "batcher_seconds": m["batcher_seconds"],
            "host_stall_ms": m["host_stall_ms"],
            "stall_ms_per_step": m["stall_ms_per_step"],
            "fused": m["fused"], "graph_replays": m["graph_replays"],
            "pipeline_stats": m.get("pipeline"), "loss": losses,
            "epoch_err": m["epoch_err"]}


def batcher_only(corpus, vocab, loaded) -> dict:
    """Milliseconds a batch of each batcher rendering one epoch alone."""
    nvocab, tokens, offsets = loaded
    window, sample = DEMO_CONF["word2vec"]["window"], \
        DEMO_CONF["word2vec"]["sample"]
    out = {}
    for name, make in (
            ("native", lambda: native.NativeCBOWBatcher(
                tokens, offsets, nvocab, window, sample)),
            ("native_prefetching", lambda: native.PrefetchingCBOWBatcher(
                tokens, offsets, nvocab, window, sample)),
            ("python", lambda: CBOWBatcher(corpus, vocab, window, sample,
                                           seed=2008))):
        for epoch in ("epoch", "epoch_stencil"):
            batcher = make()
            t0 = time.perf_counter()
            n = sum(1 for _ in getattr(batcher, epoch)(BATCH))
            out[f"{name}.{epoch}"] = (time.perf_counter() - t0) / n * 1e3
    return out


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("runs", "comma-separated runs of a,b,c,d,e "
                          "(default all)")
    cmd.registerParameter("repeat", "times the list runs, in turns "
                          "(default 1)")
    cmd.registerParameter("profile", "1: one more epoch of each run under "
                          "torch.profiler (device busy time, idle share)")
    if not torch.cuda.is_available():
        raise RuntimeError("input_profile measures the card; no CUDA device "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = cmd.getValue("runs", ",".join(INPUT_RUNS)).split(",")
    card = card_line()
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    nvocab, tokens, offsets, info = load_native(corpus)
    print(json.dumps({"card": card, "tokens": len(tokens),
                      "vocab": len(nvocab), **info}), flush=True)
    loaded = (nvocab, tokens, offsets)
    print(json.dumps({"card": card, "batcher_ms_per_batch": batcher_only(
        corpus, vocab, loaded)}), flush=True)
    for rep in range(int(cmd.getValue("repeat", "1"))):
        for run in runs:
            model = run_model(run, vocab)
            losses = model.train(batcher=run_batcher(run, model, corpus,
                                                     loaded),
                                 niters=1, batch_size=BATCH)
            print(json.dumps({"repeat": rep, "card": card,
                              **epoch_line(run, model, losses)}), flush=True)
    if cmd.getValue("profile", "0") == "1":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for run in runs:
            model = run_model(run, vocab)
            batcher = run_batcher(run, model, corpus, loaded)
            with torch.profiler.profile(activities=acts) as prof:
                losses = model.train(batcher=batcher, niters=1,
                                     batch_size=BATCH)
            busy, _ = obs_profiler.device_busy(prof)
            line = epoch_line(run, model, losses)
            wall_ms = line["seconds"] * 1e3
            print(json.dumps({
                "profiled": True, "card": card, **line,
                "device_busy_ms": busy if busy else "not measured",
                "device_ms_per_step": (busy / line["steps"]) if busy
                else "not measured",
                "idle_share": (1 - busy / wall_ms) if busy
                else "not measured"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
