#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``swiftmpi_tpu_torch``) on one
CUDA card, at the full width of the reference word2vec configuration.

    python3 chip_smoke.py          # from the repository root

The configuration is demo.conf's (len_vec 100, window 4, negative 20,
sample 1e-5, learning_rate 0.05, server lr 0.7, minibatch 5000, transfer
xla, one server) on the text8-shaped synthetic corpus
``synthetic_corpus_bulk(17_000, 70_000, 1_000, seed=42)``, vocab counted
over the whole corpus.  Phases, each of which raises on a failed check:

1. setup: the card's name and power limit; build the CUDA kernels.
2. kernels: each kernel of the training path at the shapes one step of
   that path gives it, against its plain PyTorch version on the card,
   timed with CUDA events (median of 25 launches, L2 flushed between
   launches) beside the plain version and one library call.
3. step parity: one step on the card and the same step on the CPU from
   the same table and the same negative-sampling draws.
4. train: ``Word2Vec.train`` over a corpus prefix (>= 20 steps) with
   every launch counter set to 0 just before; each kernel must have
   launched and the loss must be finite.
5. CLI: ``apps.w2v_main.main`` on a small corpus; the dump must parse.

The line before the last is the ``{"kernels": [...]}`` summary; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,
                                                 TEXT8_CORPUS, card_line)
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          load_corpus, synthetic_corpus,
                                          synthetic_corpus_bulk,
                                          write_tokens_file)
from swiftmpi_tpu_torch.kernels import adagrad, build, gather, scatter
from swiftmpi_tpu_torch.models.word2vec import (Word2Vec, _cbow_targets,
                                                w2v_parser)
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: corpus prefix the train phase runs over (about 50 steps of 5000 centers
#: after subsampling at sample 1e-5)
TRAIN_SENTENCES = 1_600
MIN_TRAIN_STEPS = 20

#: published H100 SXM peaks (dense): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TIMED_RUNS = 25


def _json_line(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each after a
    read of a buffer twice the L2's size (the cold-L2 case: inside a step
    the table is partly L2-resident), from CUDA events."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels at the main path's shapes -----------------------------

def _step_inputs(model: Word2Vec, batch, rng: np.random.Generator):
    """The slots one training step hands to its kernels: the h pull and
    push at B*(K+1) target slots, the v pull at B*2W context slots (as
    ``Word2Vec._grads`` forms them), with draws made from ``rng``."""
    dev = model.device
    B, K = len(batch.centers), model.negative
    V = len(model.vocab)
    draws = (torch.as_tensor(rng.integers(0, V, (B, K)), device=dev),
             torch.as_tensor(rng.random((B, K), np.float32), device=dev))
    centers = torch.as_tensor(batch.centers, dtype=torch.int64, device=dev)
    contexts = torch.as_tensor(batch.contexts, dtype=torch.int64, device=dev)
    ctx_mask = torch.as_tensor(batch.ctx_mask, device=dev)
    t_slots, ctx_slots, t_valid = _cbow_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx, centers,
        contexts, ctx_mask, draws)
    h_slots = torch.where(t_valid, t_slots, -1).reshape(-1).contiguous()
    v_slots = ctx_slots.reshape(-1).contiguous()
    return draws, h_slots, v_slots


def _perturbed(slots: torch.Tensor, cap: int, rng: np.random.Generator):
    """``(slots, valid)`` with about 5% more rows marked invalid and a few
    valid rows out of range on either side (the kernels clip or drop
    them)."""
    s = slots.cpu().numpy().copy()
    valid = (s >= 0) & (rng.random(s.shape[0]) >= 0.05)
    pos = rng.choice(np.flatnonzero(valid), 8, replace=False)
    s[pos[:4]] = cap + 3
    s[pos[4:]] = -7
    dev = slots.device
    return (torch.as_tensor(s, device=dev).contiguous(),
            torch.as_tensor(valid, device=dev).contiguous())


def _gather_case(label, table, slots, valid, flush):
    out_k = gather.masked_gather(table, slots, valid)
    out_p = gather.masked_gather_plain(table, slots, valid)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"{label}: kernel != plain (max |err| {err})")
    n, d = slots.shape[0], table.shape[1]
    clipped = slots.clamp(0, table.shape[0] - 1).long()
    rows_read = torch.unique(clipped[valid]).numel()
    nbytes = 4 * d * rows_read + 5 * n + 4 * n * d
    idx64 = clipped.contiguous()
    return dict(
        name=f"masked_gather ({label})", route="cuda",
        source="swiftmpi_tpu_torch/kernels/csrc/gather.cu",
        replaces="swiftmpi_tpu/ops/pallas_gather.py:164",
        module=gather, shape=f"{n} rows x {d} of a {tuple(table.shape)} "
        f"f32 table, {int((~valid).sum())} invalid",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: gather.masked_gather(table, slots, valid),
                    flush),
        plain_ms=_time_ms(
            lambda: gather.masked_gather_plain(table, slots, valid), flush),
        library_ms=_time_ms(lambda: table.index_select(0, idx64), flush),
        library="Tensor.index_select", bytes=nbytes, flops=0)


def _scatter_case(label, slots, valid, cap, width, rng, flush):
    dev = slots.device
    n = slots.shape[0]
    g = torch.as_tensor(rng.normal(size=(n, width)).astype(np.float32)
                        * 1e-2, device=dev)
    g[:, -1] = 1.0                  # the dense push's fused count column
    out_k = scatter.masked_scatter_add(slots, valid, g, cap)
    out_p = scatter.masked_scatter_add_plain(slots, valid, g, cap)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-5)
    ok = valid & (slots >= 0) & (slots < cap)
    counts = torch.bincount(slots[ok].long(), minlength=cap).float()
    if not torch.equal(out_k[:, -1], counts):
        raise AssertionError(f"{label}: count column != per-slot counts")
    safe = torch.where(ok, slots, cap).long().contiguous()
    acc = torch.zeros((cap + 1, width), device=dev)
    nbytes = 5 * n + 4 * n * width + 4 * cap * width
    return dict(
        name=f"masked_scatter_add ({label})", route="cuda",
        source="swiftmpi_tpu_torch/kernels/csrc/scatter.cu",
        replaces="swiftmpi_tpu/ops/pallas_scatter.py:77",
        module=scatter, shape=f"{n} rows x {width} into ({cap}+1, {width})"
        f", {int((~ok).sum())} to the dump row",
        max_abs_err=err, tolerance="rtol 1e-5, atol 1e-5 (atomic order)",
        ms=_time_ms(lambda: scatter.masked_scatter_add(slots, valid, g, cap),
                    flush),
        plain_ms=_time_ms(lambda: scatter.masked_scatter_add_plain(
            slots, valid, g, cap), flush),
        library_ms=_time_ms(lambda: acc.index_add_(0, safe, g), flush),
        library="Tensor.index_add_", bytes=nbytes, flops=n * width)


def _adagrad_case(label, param, accum, grad, lr, flush):
    p1, a1, p2, a2 = param.clone(), accum.clone(), param.clone(), \
        accum.clone()
    adagrad.adagrad_update_(p1, a1, grad, lr)
    adagrad.adagrad_update_plain_(p2, a2, grad, lr)
    torch.cuda.synchronize()
    err = max((p1 - p2).abs().max().item(), (a1 - a2).abs().max().item())
    torch.testing.assert_close(a1, a2, rtol=2e-6, atol=0)
    torch.testing.assert_close(p1, p2, rtol=2e-6, atol=0)
    n = param.numel()
    pk, ak, pp, ap = (t.clone() for t in (param, accum, param, accum))
    return dict(
        name=f"adagrad_update_ ({label})", route="cuda",
        source="swiftmpi_tpu_torch/kernels/csrc/adagrad.cu",
        replaces="swiftmpi_tpu/ops/pallas_kernels.py:73",
        module=adagrad, shape=f"{tuple(param.shape)} f32, in place",
        max_abs_err=err, tolerance="rtol 2e-6 (rsqrtf)",
        ms=_time_ms(lambda: adagrad.adagrad_update_(pk, ak, grad, lr),
                    flush),
        plain_ms=_time_ms(lambda: adagrad.adagrad_update_plain_(
            pp, ap, grad, lr), flush),
        library_ms=None, library=None, bytes=20 * n, flops=7 * n)


def phase_kernels(model: Word2Vec, batch) -> list:
    rng = np.random.default_rng(7)
    state = model.table.state
    cap, d = model.table.capacity, model.len_vec
    _, h_slots, v_slots = _step_inputs(model, batch, rng)
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=model.device)
    cases = []
    hs, hv = _perturbed(h_slots, cap, rng)
    vs, vv = _perturbed(v_slots, cap, rng)
    cases.append(_gather_case("h pull", state["h"], hs, hv, flush))
    cases.append(_gather_case("v pull", state["v"], vs, vv, flush))
    cases.append(_scatter_case("h push", hs, hv, cap, d + 1, rng, flush))
    lr = model.access.learning_rate

    def grads_like(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               * 1e-2, device=model.device)

    accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                            device=model.device)
    cases.append(_adagrad_case("h table", state["h"], accum,
                               grads_like((cap, d)), lr, flush))
    rows = torch.unique(v_slots[v_slots >= 0]).long()
    cases.append(_adagrad_case(
        "v rows", state["v"].index_select(0, rows).contiguous(),
        accum.index_select(0, rows).contiguous(),
        grads_like((rows.numel(), d)), lr, flush))
    for c in cases:
        c["bound_ms"], c["bound_by"] = _bound_ms(c["bytes"], c["flops"])
        _json_line({"kernel": c["name"], "shape": c["shape"],
                    "max_abs_err": c["max_abs_err"],
                    "tolerance": c["tolerance"], "ms": c["ms"],
                    "plain_ms": c["plain_ms"], "library": c["library"],
                    "library_ms": c["library_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                    "bytes": c["bytes"]})
    return cases


# -- phase 3: one step on the card against the same step on the CPU ---------

def phase_step_parity(model: Word2Vec, cpu_model: Word2Vec, batch) -> None:
    rng = np.random.default_rng(11)
    draws, _, _ = _step_inputs(model, batch, rng)
    cpu_model.table.state = state_from_jax(state_to_numpy(model.table.state),
                                           "cpu")
    model.transfer.push_paths.clear()
    es_c, ec_c = model.step(batch.centers, batch.contexts, batch.ctx_mask,
                            draws=draws)
    es_p, ec_p = cpu_model.step(batch.centers, batch.contexts,
                                batch.ctx_mask,
                                draws=tuple(t.cpu() for t in draws))
    if ec_c != ec_p:
        raise AssertionError(f"err_cnt: card {ec_c} != cpu {ec_p}")
    if not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"err_sum: card {es_c} != cpu {es_p}")
    card, cpu = state_to_numpy(model.table.state), \
        state_to_numpy(cpu_model.table.state)
    worst = {}
    for f in cpu:
        gap = np.abs(card[f] - cpu[f])
        limit = 1e-5 + 1e-3 * np.abs(cpu[f])
        if not (gap <= limit).all():
            raise AssertionError(
                f"step parity: field {f} leaves |a-b| <= 1e-5 + 1e-3|b| "
                f"(max gap {gap.max()}, {(gap > limit).sum()} elements)")
        worst[f] = float(gap.max())
    _json_line({"phase": "step_parity", "err_sum": [es_c, es_p],
                "err_cnt": [ec_c, ec_p], "max_abs_gap": worst,
                "envelope": "1e-5 + 1e-3*|cpu|",
                "push_paths": dict(model.transfer.push_paths)})


# -- phase 4: training through the public entry point -----------------------

def phase_train(model: Word2Vec, corpus: np.ndarray, card: str) -> dict:
    batcher = CBOWBatcher(corpus[:TRAIN_SENTENCES], model.vocab,
                          model.window, model.sample, seed=2008)
    model.transfer.push_paths.clear()
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    if m["steps"] < MIN_TRAIN_STEPS:
        raise AssertionError(f"only {m['steps']} steps; raise "
                             "TRAIN_SENTENCES")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"the train phase never launched {missing}")
    _json_line({"phase": "train", "card": card, "loss": losses,
                "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"],
                "batcher_seconds": m["batcher_seconds"],
                "steps_per_sec": m["steps_per_sec"],
                "words_per_sec": m["words_per_sec"],
                "push_paths": m["push_paths"], "launches": counts})
    return counts


# -- phase 5: the CLI --------------------------------------------------------

def phase_cli() -> None:
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    data, conf, out = WORK / "corpus.txt", WORK / "w2v.conf", \
        WORK / "vectors.txt"
    write_tokens_file(synthetic_corpus(200, 500, 20, seed=1), str(data))
    conf.write_text("[cluster]\nserver_num: 1\ntransfer: xla\n"
                    "[worker]\nminibatch: 512\n"
                    "[server]\ninitial_learning_rate: 0.7\n"
                    "[word2vec]\nlen_vec: 100\nwindow: 4\nnegative: 20\n"
                    "sample: 0.001\nlearning_rate: 0.05\n")
    reset_global_config()
    kernels.reset_launches()
    rc = w2v_main.main(["w2v_main", "-config", str(conf), "-data",
                        str(data), "-niters", "1", "-output", str(out)])
    counts = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"w2v_main returned {rc}")
    vocab = build_vocab(load_corpus(str(data)))
    keys = set()
    for line in out.read_text().splitlines():
        key, _, rest = line.partition("\t")
        row = w2v_parser(rest)
        if row["v"].shape != (100,) or row["h"].shape != (100,) \
                or not (np.isfinite(row["v"]).all()
                        and np.isfinite(row["h"]).all()):
            raise AssertionError(f"bad dump row for key {key}")
        keys.add(int(key))
    if keys != set(vocab.keys.tolist()):
        raise AssertionError(f"dump has {len(keys)} keys, vocab "
                             f"{len(vocab)}")
    if not all(counts.values()):
        raise AssertionError(f"the CLI run skipped a kernel: {counts}")
    _json_line({"phase": "cli", "rows": len(keys), "launches": counts})
    shutil.rmtree(WORK)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc, sm_90a, {len(build.SOURCES)} sources in parallel)",
          flush=True)
    for name, log in build.build_logs.items():
        print(f"== nvcc {name}\n{log}", file=sys.stderr)

    t0 = time.perf_counter()
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    model = Word2Vec(config=ConfigParser().update(DEMO_CONF), device="cuda")
    model.build_from_vocab(vocab)
    cpu_model = Word2Vec(config=ConfigParser().update(DEMO_CONF), device="cpu")
    cpu_model.build_from_vocab(vocab)
    batch = next(iter(CBOWBatcher(corpus[:100], vocab, model.window,
                                  model.sample, seed=2008).epoch(BATCH)))
    print(f"corpus {corpus.size} tokens, vocab {len(vocab)}, table "
          f"capacity {model.table.capacity} x {model.len_vec}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cases = phase_kernels(model, batch)
    phase_step_parity(model, cpu_model, batch)
    del cpu_model
    counts = phase_train(model, corpus, card)
    phase_cli()

    summary = []
    for c in cases:
        name = c["module"].__name__.rsplit(".", 1)[-1]
        summary.append({
            "name": c["name"], "route": c["route"], "source": c["source"],
            "replaces": c["replaces"], "launches": counts[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(card, flush=True)
    _json_line({"kernels": summary})
    _json_line({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
