#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``swiftmpi_tpu_torch``) on one
CUDA card, at the full width of the reference word2vec configuration.

    python3 chip_smoke.py          # from the repository root

The configuration is demo.conf's (len_vec 100, window 4, negative 20,
sample 1e-5, learning_rate 0.05, server lr 0.7, minibatch 5000, transfer
xla, one server) on the text8-shaped synthetic corpus
``synthetic_corpus_bulk(17_000, 70_000, 1_000, seed=42)``, vocab counted
over the whole corpus, in four renderings (``PATHS``): ``gather`` (the
default), ``stencil`` (``stencil: 1``), ``stencil_shared`` (+
``shared_negatives: 1``, pool 1024) and ``shared``; and the sharded
parameter server (``[cluster] transfer: tpu``, ``server_num: 8``: eight
logical ranks, each with its own table shard and buffers, all on the one
card) in the ``gather`` and ``shared`` renderings (``gather@8``,
``shared@8``); and with bf16 tables (``[server] dtype: bfloat16``: h and v
bfloat16, accumulators float32) in ``gather``, ``stencil`` and
``gather@8`` (``gather:bf16``, ``stencil:bf16``, ``gather@8:bf16``).
Phases, each of which raises on a failed check:

1. setup: the card's name and power limit; build the CUDA kernels.
2. kernels: each kernel at the shapes one step of its path gives it —
   the gather path's pulls, push (sums and counts in one launch) and
   AdaGrad calls (over the table with the mean's divisor fused, and
   row-indexed on the sparse v push's rows), the stencil path's context
   sum from the stencil batch itself (a real stencil batch with extra pad
   centers and a shuffled block of centers), its mostly-padding h push
   and ``push_span``'s AdaGrad on the span's owner rows, and the sharded
   path's ring exchange of its request, row and odd-width buckets
   (stacked, one send and one wait launch), the eight owners' h pull, h
   push with counts and AdaGrad with the mean's reciprocal, each in one
   launch; and the bf16 forms the bf16 paths run (the pulls' bf16 rows,
   the mixed AdaGrad over the table, the block and the rows, the context
   sum over a bf16 table, the ring on bf16 row buckets) — against its
   plain PyTorch version on the card (bit for bit, except B3's float
   sums), timed with CUDA events (median of 25 launches, L2 flushed
   between launches, the host's enqueue not timed) beside the plain
   version and one library call.
3. step parity: one step on the card and the same step on the CPU from
   the same table and the same negative-sampling draws, for ``gather``,
   ``stencil``, ``stencil_shared``, ``gather:bf16`` and ``stencil:bf16``;
   and one sharded ``gather`` step, float32 and bf16, against the sharded
   CPU step and, row for row by key, against the one-shard ``xla`` step
   on the card.  float32 fields within 1e-5 + 1e-3|b|; bf16 fields within
   that envelope or one bfloat16 ulp of b, whichever is wider (the card
   sums some grads in another order, a float32 difference that can cross
   a rounding boundary; near zero a bfloat16 step is finer than 1e-5).
4. train: ``Word2Vec.train`` over a corpus prefix (>= 20 steps) for each
   rendering, every launch counter set to 0 just before; the run must have
   launched exactly the kernels of its path (the stencil kernel on every
   step of a stencil path) and the loss must be finite.
   A sharded run must launch the ring kernel once (one send, one wait)
   for every exchange of every step, the gather once per pull, the
   scatter-add and AdaGrad once per pushed family (each for all the
   card's ranks), overflow nothing and time out no wait.
5. CLI: ``apps.w2v_main.main`` on a small corpus with the gather conf,
   with ``stencil: 1``, with ``transfer: tpu``, ``server_num: 8`` and with
   ``[server] dtype: bfloat16``; each dump must parse (the bf16 one into
   bfloat16 values).

The line before the last is the ``{"kernels": [...]}`` summary, each
kernel's ``launches`` read from the train run of its path; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints neither.
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
import torch.nn.functional as F

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.apps.stencil_sweep import (batch_inputs,
                                                   context_sum_bytes)
from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,
                                                 TEXT8_CORPUS, card_line)
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, StencilBatch,
                                          build_vocab, load_corpus,
                                          synthetic_corpus,
                                          synthetic_corpus_bulk,
                                          write_tokens_file)
from swiftmpi_tpu_torch.kernels import (adagrad, build, gather, ring,
                                        scatter, stencil)
from swiftmpi_tpu_torch.models.word2vec import (Word2Vec, _cbow_targets,
                                                _parity_targets, w2v_parser)
from swiftmpi_tpu_torch.parameter.sparse_table import (shard_block,
                                                       split_rows)
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: rendering -> ([word2vec] keys, the kernels its train run launches, the
#: corpus prefix it trains over: >= 20 steps at sample 1e-5, where a
#: stencil span fills at about 800 real centers)
PATHS = {
    "gather": ({}, {"gather", "scatter", "adagrad"}, 800),
    "stencil": ({"stencil": 1}, {"stencil", "gather", "scatter", "adagrad"},
                200),
    "stencil_shared": ({"stencil": 1, "shared_negatives": 1},
                       {"stencil", "gather", "adagrad"}, 200),
    "shared": ({"shared_negatives": 1}, {"gather", "adagrad"}, 800),
}
#: ranks of the sharded parameter server, all on the one card
SHARDS = 8
#: sharded path -> launches a step on the card, each for all the card's
#: ranks: ring sends (one per exchange: two per pull, two per pushed
#: family), gathers (one per pull), scatter-adds (one per pushed family,
#: counts included), AdaGrad calls (one per pushed family, the mean's
#: reciprocal inside)
SHARDED = {
    f"gather@{SHARDS}": {"ring": 8, "gather": 2, "scatter": 2, "adagrad": 2},
    f"shared@{SHARDS}": {"ring": 10, "gather": 2, "scatter": 3,
                         "adagrad": 3},
}
for _path in SHARDED:
    PATHS[_path] = (PATHS[_path.split("@")[0]][0], set(SHARDED[_path]), 800)
#: paths run with bf16 tables too (``[server] dtype: bfloat16``), named
#: ``<path>:bf16``: the kernels of the float32 path, in their bf16 forms
BF16 = ":bf16"
for _path in ("gather", "stencil", f"gather@{SHARDS}"):
    PATHS[_path + BF16] = PATHS[_path]
MIN_TRAIN_STEPS = 20

#: published H100 SXM peaks (dense): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TIMED_RUNS = 25
#: about 50 us of the card's clock: longer than the host takes to enqueue
#: one wrapper call
SPIN_CYCLES = 100_000


def _json_line(obj) -> None:
    print(json.dumps(obj), flush=True)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def _model(path: str, vocab, device: str) -> Word2Vec:
    """The model of a path: a rendering, ``@n`` for the sharded parameter
    server with n ranks, ``:bf16`` for bf16 tables."""
    base, bf16, _ = path.partition(":")
    rendering, _, shards = base.partition("@")
    conf = ConfigParser().update(DEMO_CONF)
    for k, v in PATHS[path][0].items():
        conf.set("word2vec", k, v)
    if shards:
        conf.set("cluster", "transfer", "tpu")
        conf.set("cluster", "server_num", int(shards))
    if bf16:
        conf.set("server", "dtype", "bfloat16")
    model = Word2Vec(config=conf, device=device)
    if model.param_dtype != (torch.bfloat16 if bf16 else torch.float32):
        raise AssertionError(f"{path} conf gave {model.param_dtype} tables")
    if shards and (model.transfer.name != "tpu"
                   or model.cluster.n_servers != int(shards)):
        raise AssertionError(f"{path} conf gave transfer "
                             f"{model.transfer.name} over "
                             f"{model.cluster.n_servers} shard(s)")
    if model.resolved_rendering != rendering:
        raise AssertionError(f"{rendering} conf resolved to "
                             f"{model.resolved_rendering}")
    return model.build_from_vocab(vocab)


def _draws(model: Word2Vec, B: int, rng: np.random.Generator):
    """``(j, u)`` for one step of ``model``'s rendering, from ``rng``."""
    shape = (model.shared_pool,) if model.shared_negatives \
        else (B, model.negative)
    return (torch.as_tensor(rng.integers(0, len(model.vocab), shape),
                            device=model.device),
            torch.as_tensor(rng.random(shape, np.float32),
                            device=model.device))


def _time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each after a
    read of a buffer twice the L2's size (the cold-L2 case: inside a step
    the table is partly L2-resident), from CUDA events.  A spin of
    SPIN_CYCLES on the card sits between the read and the start event, so
    the host has enqueued ``fn`` before the card reaches it: the host's
    enqueue time is not timed."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    for s, e in zip(starts, ends):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels at the main paths' shapes ------------------------------

def _step_inputs(model: Word2Vec, batch, rng: np.random.Generator):
    """The slots one gather-rendering step hands to its kernels: the h
    pull and push at B*(K+1) target slots, the v pull at B*2W context
    slots (as ``Word2Vec._grads`` forms them), with draws from ``rng``."""
    dev = model.device
    draws = _draws(model, len(batch.centers), rng)
    centers = torch.as_tensor(batch.centers, dtype=torch.int64, device=dev)
    contexts = torch.as_tensor(batch.contexts, dtype=torch.int64, device=dev)
    ctx_mask = torch.as_tensor(batch.ctx_mask, device=dev)
    t_slots, ctx_slots, t_valid = _cbow_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx, centers,
        contexts, ctx_mask, draws)
    h_slots = torch.where(t_valid, t_slots, -1).reshape(-1).contiguous()
    v_slots = ctx_slots.reshape(-1).contiguous()
    return h_slots, v_slots


def _stencil_h_slots(model: Word2Vec, sb: StencilBatch,
                     rng: np.random.Generator):
    """The h push's B*(K+1) target slots of one stencil-rendering step
    (``Word2Vec._grads_stencil``): padded centers give -1 rows, which are
    most of a batch at sample 1e-5."""
    dev = model.device
    tokens = torch.as_tensor(sb.tokens, dtype=torch.int64, device=dev)
    cpos = torch.as_tensor(sb.center_pos, dtype=torch.int64, device=dev)
    span_slots = torch.where(torch.as_tensor(sb.sent_id, device=dev) >= 0,
                             model._slot_of_vocab[tokens], -1)
    row_valid = cpos >= 0
    cp = cpos.clamp(0, sb.span - 1)
    t_slots, t_valid = _parity_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx,
        tokens[cp], torch.where(row_valid, span_slots[cp], -1), row_valid,
        _draws(model, len(sb), rng))
    slots = torch.where(t_valid, t_slots, -1).reshape(-1).contiguous()
    return slots, (slots >= 0).contiguous()


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


def _gather_case(label, table, slots, valid, flush, path="gather"):
    """B2 on a ``(cap, d)`` table and ``(N,)`` slots, or a ``(R, cap, d)``
    block of shards and ``(R, N)`` slots in one launch: bit for bit
    against its plain version."""
    out_k = gather.masked_gather(table, slots, valid)
    out_p = gather.masked_gather_plain(table, slots, valid)
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"{label}: kernel != plain (max |err| {err})")
    n, (cap, d) = slots.numel(), table.shape[-2:]
    es = table.element_size()
    clipped = slots.clamp(0, cap - 1).long()
    if table.dim() == 3:
        clipped = clipped + torch.arange(
            table.shape[0], device=slots.device)[:, None] * cap
    rows_read = torch.unique(clipped[valid]).numel()
    nbytes = es * d * rows_read + 5 * n + es * n * d
    idx64 = clipped.reshape(-1).contiguous()
    flat = table.reshape(-1, d)
    rows = f"{slots.shape[0]} x {slots.shape[1]}" if slots.dim() == 2 \
        else f"{n}"
    return dict(
        name=f"masked_gather ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/gather.cu",
        replaces="swiftmpi_tpu/ops/pallas_gather.py:164",
        module=gather, shape=f"{rows} rows x {d} of a {tuple(table.shape)} "
        f"{_dtype_name(table)} table, {int((~valid).sum())} invalid, one "
        f"launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: gather.masked_gather(table, slots, valid),
                    flush),
        plain_ms=_time_ms(
            lambda: gather.masked_gather_plain(table, slots, valid), flush),
        library_ms=_time_ms(lambda: flat.index_select(0, idx64), flush),
        library="Tensor.index_select", bytes=nbytes, flops=0)


def _scatter_case(label, path, slots, valid, cap, width, rng, flush,
                  counts=True):
    """B3 on ``(N,)`` or ``(R, N)`` slots and grads of ``width``, with the
    counts in the same launch unless ``counts`` is false: sums within
    1e-5 + 1e-3|b| of the plain version (float reductions in no fixed
    order), counts exact."""
    dev = slots.device
    g = torch.as_tensor(rng.normal(size=(*slots.shape, width))
                        .astype(np.float32) * 1e-2, device=dev)
    got = scatter.masked_scatter_add(slots, valid, g, cap, counts=counts)
    want = scatter.masked_scatter_add_plain(slots, valid, g, cap,
                                            counts=counts)
    torch.cuda.synchronize()
    (acc_k, cnt_k), (acc_p, cnt_p) = (got, want) if counts else \
        ((got, None), (want, None))
    err = (acc_k - acc_p).abs().max().item()
    torch.testing.assert_close(acc_k, acc_p, rtol=1e-3, atol=1e-5)
    if counts and not torch.equal(cnt_k, cnt_p):
        raise AssertionError(f"{label}: counts != plain")
    ok = valid & (slots >= 0) & (slots < cap)
    R = slots.shape[0] if slots.dim() == 2 else 1
    # indices for every row, grads only for the rows that land
    n, n_ok = slots.numel(), int(ok.sum())
    nbytes = 5 * n + 4 * n_ok * width + 4 * R * cap * (width + int(counts))
    base = (torch.arange(R, device=dev)[:, None] * (cap + 1)
            if slots.dim() == 2 else 0)
    safe = (base + torch.where(ok, slots, cap)).reshape(-1).long()
    acc = torch.zeros((R * (cap + 1), width), device=dev)
    rows = f"{R} x {n // R}" if slots.dim() == 2 else f"{n}"
    return dict(
        name=f"masked_scatter_add ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/scatter.cu",
        replaces="swiftmpi_tpu/ops/pallas_scatter.py:77",
        module=scatter, shape=f"{rows} rows x {width} into {R} x ({cap}, "
        f"{width}){' + counts' if counts else ''}, {n - n_ok} invalid or "
        f"out of range, one launch",
        max_abs_err=err, tolerance="1e-5 + 1e-3|b| (reduction order), "
        "counts exact",
        ms=_time_ms(lambda: scatter.masked_scatter_add(
            slots, valid, g, cap, counts=counts), flush),
        plain_ms=_time_ms(lambda: scatter.masked_scatter_add_plain(
            slots, valid, g, cap, counts=counts), flush),
        library_ms=_time_ms(lambda: acc.index_add_(0, safe, g.view(-1, width)),
                            flush),
        library="Tensor.index_add_ (sums only)", bytes=nbytes,
        flops=n_ok * width)


#: why B1 has no library yardstick
ADAGRAD_LIBRARY = ("none: torch's Adagrad divides by sqrt(sum) + eps, not "
                   "rsqrt(sum + 1e-6)")


def _adagrad_case(label, path, param, accum, grad, lr, flush, rows=None,
                  **scale):
    """B1 in place, bit for bit against its plain version: dense over
    ``param`` (a table or a block of shards; ``mul``/``div`` a per-row
    operand), or row-indexed when ``rows`` is ``(slots, mask)``."""
    if rows is None:
        def kernel(p, a):
            adagrad.adagrad_update_(p, a, grad, lr, **scale)

        def plain(p, a):
            adagrad.adagrad_update_plain_(p, a, grad, lr, **scale)
        kept = param.numel() // param.shape[-1]
        what = f"{tuple(param.shape)} {_dtype_name(param)}"
    else:
        slots, mask = rows

        def kernel(p, a):
            adagrad.adagrad_update_rows_(p, a, slots, mask, grad, lr,
                                         **scale)

        def plain(p, a):
            adagrad.adagrad_update_rows_plain_(p, a, slots, mask, grad, lr,
                                               **scale)
        keep = (slots >= 0) & (slots < param.shape[0])
        kept = int((keep if mask is None else keep & mask).sum())
        what = (f"{kept} of {slots.shape[0]} rows x {param.shape[1]} "
                f"indexed into a {tuple(param.shape)} {_dtype_name(param)} "
                f"table")
    p1, a1, p2, a2 = (t.clone() for t in (param, accum, param, accum))
    kernel(p1, a1)
    plain(p2, a2)
    torch.cuda.synchronize()
    err = max((p1.float() - p2.float()).abs().max().item(),
              (a1 - a2).abs().max().item())
    if not (torch.equal(p1, p2) and torch.equal(a1, a2)):
        raise AssertionError(f"adagrad_update_ ({label}): kernel != plain "
                             f"(max |err| {err})")
    # every kept element: param, accum and grad read, param and accum
    # written (the param in its own dtype); per row: the scale, and the
    # slot and mask of an indexed row
    d, n_rows = param.shape[-1], grad.numel() // param.shape[-1]
    per_row = 4 * len(scale)
    if rows is not None:
        per_row += 4 + (rows[1] is not None)
    nbytes = (2 * param.element_size() + 12) * kept * d + per_row * n_rows
    pk, ak, pp, ap = (t.clone() for t in (param, accum, param, accum))
    op = (f", grad {'* mul' if 'mul' in scale else '/ div'} per row"
          if scale else "")
    if param.dtype == torch.bfloat16:
        op += ", float32 accum and grad (the mixed form)"
    return dict(
        name=f"adagrad_update_ ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/adagrad.cu",
        replaces="swiftmpi_tpu/ops/pallas_kernels.py:73",
        module=adagrad, shape=f"{what}, in place{op}, one launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: kernel(pk, ak), flush),
        plain_ms=_time_ms(lambda: plain(pp, ap), flush),
        library_ms=None, library=ADAGRAD_LIBRARY, bytes=nbytes,
        flops=(7 + bool(scale)) * kept * d)


def _span_owners(span_slots: torch.Tensor) -> torch.Tensor:
    """``push_span``'s owner rows: the first span position of each slot
    (JAX ``is_owner``)."""
    S, dev = span_slots.shape[0], span_slots.device
    valid = span_slots >= 0
    safe = torch.where(valid, span_slots, 0).long()
    pos = torch.arange(S, device=dev)
    first = torch.full((int(safe.max()) + 1,), S, device=dev)
    first.scatter_reduce_(0, safe, torch.where(valid, pos, S), "amin")
    return (valid & (first[safe] == pos)).contiguous()


def _stencil_inputs(model: Word2Vec, sb: StencilBatch,
                    rng: np.random.Generator):
    """``(span_slots, sent_id, center_pos, half)`` of a real stencil batch
    as the step hands them to the context sum, made harder: 64 more
    centers padded and a block of 256 real centers shuffled out of span
    order, so neighbouring centers reach span ranges far apart."""
    cpos, half = sb.center_pos.copy(), sb.half.copy()
    n = sb.n_words
    drop = rng.choice(n, 64, replace=False)
    cpos[drop], half[drop] = -1, 0
    blk = rng.permutation(min(256, n))
    cpos[:len(blk)], half[:len(blk)] = cpos[blk], half[blk]
    return batch_inputs(model, StencilBatch(
        tokens=sb.tokens, sent_id=sb.sent_id, center_pos=cpos, half=half,
        n_words=int((cpos >= 0).sum())))


def _stencil_case(label, path, table, args, window, flush):
    """B4 from the stencil batch itself (``args``: span slots, sent_id,
    center_pos, half) on a float32 or bf16 table, bit for bit against its
    plain version (the window inputs, then the k-order sum)."""
    out_k = stencil.stencil_context_sum(table, *args, window)
    out_p = stencil.stencil_context_sum_plain(table, *args, window)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"stencil_context_sum ({label}): kernel != "
                             f"plain (max |err| {err})")
    nbytes, rows_read, src, wmask = context_sum_bytes(table, *args, window)
    (B, K), (cap, d), S = wmask.shape, table.shape, args[0].shape[0]
    on = wmask != 0
    wm_t = wmask.to(table.dtype)          # 0 and 1: exact in either dtype
    lib_out = F.embedding_bag(src, table, mode="sum",
                              per_sample_weights=wm_t)
    lib_err = (lib_out.float() - out_p).abs().max().item()
    n_real = int((args[2] >= 0).sum())
    return dict(
        name=f"stencil_context_sum ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/stencil.cu",
        replaces="swiftmpi_tpu/ops/pallas_stencil.py:126",
        module=stencil, shape=f"{B} centers ({n_real} real) x window {K} "
        f"over a {S}-row span of a {tuple(table.shape)} "
        f"{_dtype_name(table)} table, {rows_read} distinct rows reached, "
        f"from the batch's arrays, one launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: stencil.stencil_context_sum(table, *args,
                                                        window), flush),
        plain_ms=_time_ms(lambda: stencil.stencil_context_sum_plain(
            table, *args, window), flush),
        library_ms=_time_ms(lambda: F.embedding_bag(
            src, table, mode="sum", per_sample_weights=wm_t), flush),
        library=f"F.embedding_bag(mode='sum', per_sample_weights) over the "
        f"window rows (inputs made beforehand; max |diff| {lib_err:.3g})",
        bytes=nbytes, flops=int(on.sum()) * d)


def _ring_case(label, tail, dtype, rng, flush, dev,
               path=f"gather@{SHARDS}"):
    """The ring exchange of ``SHARDS`` ranks' ``(SHARDS, *tail)`` operands,
    stacked as the transfer hands them over, against its plain version: a
    copy, so bit for bit; one send launch and one wait launch.  bf16
    operands cross as 4-byte words."""
    n = SHARDS
    if dtype == torch.int32:
        x = torch.as_tensor(rng.integers(-1, 11_000, (n, n, *tail))
                            .astype(np.int32), device=dev)
    else:
        x = torch.as_tensor(rng.random((n, n, *tail), np.float32) - 0.5,
                            device=dev).to(dtype)
    before = ring.launches
    out_k = ring.ring_exchange_stacked(x)
    launched = ring.launches - before
    out_p = ring.ring_exchange_stacked_plain(x)
    torch.cuda.synchronize()
    err = (out_k.double() - out_p.double()).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"ring_exchange ({label}): kernel != plain "
                             f"(max |err| {err})")
    if launched != 1:
        raise AssertionError(f"ring_exchange ({label}): {launched} "
                             "exchange launches, expected one")
    if ring.timeouts():
        raise AssertionError(f"ring_exchange ({label}): a wait timed out")
    if not torch.equal(x.transpose(0, 1).contiguous(), out_p):
        raise AssertionError(f"ring_exchange ({label}): the library "
                             "transpose != plain")
    del out_k, out_p
    nbytes = 2 * x.numel() * x.element_size()
    return dict(
        name=f"ring_exchange ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/ring.cu",
        replaces="swiftmpi_tpu/ops/pallas_ring.py:86",
        module=ring, shape=f"{n} ranks x {(n, *tail)} "
        f"{_dtype_name(x)}, stacked; 1 send launch + 1 wait launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: ring.ring_exchange_stacked(x), flush),
        plain_ms=_time_ms(lambda: ring.ring_exchange_stacked_plain(x), flush),
        library_ms=_time_ms(lambda: x.transpose(0, 1).contiguous(), flush),
        library="x.transpose(0, 1).contiguous()", bytes=nbytes, flops=0)


def phase_kernels(model: Word2Vec, batch, sbatch: StencilBatch) -> list:
    rng = np.random.default_rng(7)
    state = model.table.state
    cap, d = model.table.capacity, model.len_vec
    h_slots, v_slots = _step_inputs(model, batch, rng)
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=model.device)
    cases = []
    hs, hv = _perturbed(h_slots, cap, rng)
    vs, vv = _perturbed(v_slots, cap, rng)
    cases.append(_gather_case("h pull", state["h"], hs, hv, flush))
    cases.append(_gather_case("v pull", state["v"], vs, vv, flush))
    cases.append(_scatter_case("h push", "gather", hs, hv, cap, d, rng,
                               flush))
    # PR 1-3's fused count column: 404-byte rows, the scalar path
    cases.append(_scatter_case("h push, d + 1 wide", "gather", hs, hv, cap,
                               d + 1, rng, flush, counts=False))
    ss, sv = _stencil_h_slots(model, sbatch, rng)
    cases.append(_scatter_case("stencil h push", "stencil", ss, sv, cap, d,
                               rng, flush))
    lr = model.access.learning_rate

    def grads_like(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               * 1e-2, device=model.device)

    accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                            device=model.device)
    cases.append(_adagrad_case("h table", "gather", state["h"], accum,
                               grads_like((cap, d)), lr, flush))
    # the dense h push's mean, one family: the divisor inside the launch
    counts = torch.as_tensor(rng.integers(1, 9, cap).astype(np.float32),
                             device=model.device)
    cases.append(_adagrad_case("h table, / counts", "gather", state["h"],
                               accum, grads_like((cap, d)), lr, flush,
                               div=counts))
    rows = torch.unique(v_slots[v_slots >= 0]).long()
    cases.append(_adagrad_case(
        "v rows", "gather", state["v"].index_select(0, rows).contiguous(),
        accum.index_select(0, rows).contiguous(),
        grads_like((rows.numel(), d)), lr, flush))
    # the sparse v push as it runs now: the segment representatives'
    # rows updated in place, the mean's reciprocal inside the launch
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, rows.numel())
                                .astype(np.float32), device=model.device)
    cases.append(_adagrad_case(
        "v rows, row-indexed", "gather", state["v"], accum,
        grads_like((rows.numel(), d)), lr, flush,
        rows=(rows.to(torch.int32), None), mul=inv))
    sargs = _stencil_inputs(model, sbatch, rng)
    span_slots = sargs[0]
    cases.append(_stencil_case("v span", "stencil", state["v"], sargs,
                               model.window, flush))
    # push_span's apply: the S span rows gathered at their owners' slots
    span_rows = span_slots.clamp(min=0).long()
    cases.append(_adagrad_case(
        "push_span rows", "stencil",
        state["v"].index_select(0, span_rows).contiguous(),
        accum.index_select(0, span_rows).contiguous(),
        grads_like((span_rows.numel(), d)), lr, flush))
    # push_span as it runs now: the owner rows' slots updated in place
    S = span_slots.shape[0]
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, S).astype(np.float32),
                                device=model.device)
    owners = _span_owners(span_slots)
    cases.append(_adagrad_case(
        "push_span rows, row-indexed", "stencil", state["v"], accum,
        grads_like((S, d)), lr, flush, rows=(span_slots, owners), mul=inv))
    # bf16 tables: the same calls on bf16 h and v, float32 accumulators
    # and grads, as the bf16 gather and stencil paths make them
    hb, vb = state["h"].to(torch.bfloat16), state["v"].to(torch.bfloat16)
    gb, sb16 = "gather" + BF16, "stencil" + BF16
    cases.append(_gather_case("h pull, bf16", hb, hs, hv, flush, gb))
    cases.append(_gather_case("v pull, bf16", vb, vs, vv, flush, gb))
    cases.append(_adagrad_case("h table, bf16, / counts", gb, hb, accum,
                               grads_like((cap, d)), lr, flush, div=counts))
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, rows.numel())
                                .astype(np.float32), device=model.device)
    cases.append(_adagrad_case(
        "v rows, row-indexed, bf16", gb, vb, accum,
        grads_like((rows.numel(), d)), lr, flush,
        rows=(rows.to(torch.int32), None), mul=inv))
    cases.append(_stencil_case("bf16 v span", sb16, vb, sargs, model.window,
                               flush))
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, S).astype(np.float32),
                                device=model.device)
    cases.append(_adagrad_case(
        "push_span rows, row-indexed, bf16", sb16, vb, accum,
        grads_like((S, d)), lr, flush, rows=(span_slots, owners), mul=inv))
    return cases


def phase_kernels_sharded(model: Word2Vec, batch) -> list:
    """The sharded path's kernels at the shapes one of its gather steps
    gives them: the three ring exchanges of the h family; what rank 0 does
    as an owner with the ``SHARDS * C`` requests it receives (most of them
    padding: every sender pads its bucket to C) — the gather from its
    shard, the scatter-add of its received grads and, alone, of their
    counts (the per-rank launches of the first design), and AdaGrad over
    the shard; and, as the path now runs them, each in one launch for all
    ``SHARDS`` owners: the gather of their requests from the card's block
    of shards, the scatter-add of their received grads with their counts,
    and AdaGrad over the block with the mean's reciprocal."""
    rng = np.random.default_rng(17)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    path = f"gather@{SHARDS}"
    state = model.table.state
    h_slots, _ = _step_inputs(model, batch, rng)
    # each rank's slice of the h pull and push is B*(K+1)/SHARDS slots,
    # the bucket capacity per destination
    C = h_slots.shape[0] // SHARDS
    cases = [
        _ring_case("h requests", (C,), torch.int32, rng, flush, dev),
        _ring_case("h rows", (C, d), torch.float32, rng, flush, dev),
        _ring_case("odd row width", (C, d + 1), torch.float32, rng, flush,
                   dev)]
    groups, C_routed, cap = model.transfer._route(state, h_slots)
    if C_routed != C or len(groups) != 1:
        raise AssertionError(f"bucket capacity {C_routed}, expected {C}, "
                             f"in {len(groups)} device group(s)")
    owners = ring.ring_exchange_stacked(groups[0].req).view(SHARDS, -1)
    got, ok = owners[0], owners[0] >= 0
    cases.append(_gather_case("shard h pull", state["h"][0], got, ok, flush,
                              path))
    block = shard_block(state["h"])
    cases.append(_gather_case(f"{SHARDS} owners' h pull", block, owners,
                              (owners >= 0).contiguous(), flush, path))
    cases.append(_scatter_case("shard h push", path, got, ok, cap, d, rng,
                               flush, counts=False))
    cases.append(_scatter_case("shard h counts", path, got, ok, cap, 1, rng,
                               flush, counts=False))
    cases.append(_scatter_case(f"{SHARDS} owners' h push", path, owners,
                               owners >= 0, cap, d, rng, flush))
    accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                            device=dev)
    grad = torch.as_tensor(rng.normal(size=(cap, d)).astype(np.float32)
                           * 1e-2, device=dev)
    cases.append(_adagrad_case("h shard", path, state["h"][0].clone(), accum,
                               grad, model.access.learning_rate, flush))
    # the sharded mean push: one launch over the card's block of shards,
    # the reciprocal of each row's count inside it
    accum8 = torch.as_tensor(rng.random(block.shape, np.float32) * 1e-3,
                             device=dev)
    grad8 = torch.as_tensor(rng.normal(size=block.shape).astype(np.float32)
                            * 1e-2, device=dev)
    inv8 = 1.0 / torch.as_tensor(rng.integers(1, 9, block.shape[:2])
                                 .astype(np.float32), device=dev)
    cases.append(_adagrad_case(f"{SHARDS} shards, * 1/counts", path,
                               block.clone(), accum8, grad8,
                               model.access.learning_rate, flush, mul=inv8))
    # bf16 tables: the owners' pull from a bf16 block, the pulled rows'
    # exchange as 4-byte words, the mixed AdaGrad over the block
    pb = path + BF16
    blockb = block.to(torch.bfloat16)
    cases.append(_ring_case("h rows, bf16", (C, d), torch.bfloat16, rng,
                            flush, dev, path=pb))
    cases.append(_gather_case(f"{SHARDS} owners' h pull, bf16", blockb,
                              owners, (owners >= 0).contiguous(), flush, pb))
    cases.append(_adagrad_case(f"{SHARDS} shards, * 1/counts, bf16", pb,
                               blockb, accum8, grad8,
                               model.access.learning_rate, flush, mul=inv8))
    return cases


def report_cases(cases: list) -> None:
    for c in cases:
        c["bound_ms"], c["bound_by"] = _bound_ms(c["bytes"], c["flops"])
        _json_line({"kernel": c["name"], "shape": c["shape"],
                    "max_abs_err": c["max_abs_err"],
                    "tolerance": c["tolerance"], "ms": c["ms"],
                    "plain_ms": c["plain_ms"], "library": c["library"],
                    "library_ms": c["library_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                    "bytes": c["bytes"]})


# -- phase 3: one step on the card against the same step on the CPU ---------

def _cpu_state(state, cpu_model: Word2Vec):
    """A copy of a card table for ``cpu_model``: tensor by tensor (bf16
    bits unchanged), a sharded table's shards dealt as the CPU model deals
    them."""
    mesh = cpu_model.cluster.mesh
    return {f: (split_rows(torch.cat(v).cpu(), mesh)
                if isinstance(v, list) else v.cpu().clone())
            for f, v in state.items()}


def _global(v) -> torch.Tensor:
    """A field's global-row-order tensor on the CPU, either layout."""
    return torch.cat(v).cpu() if isinstance(v, list) else v.cpu()


def _ordinal(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 values as integers in the order of the reals: adjacent
    representable values differ by 1, +0 and -0 are both 0."""
    bits = t.contiguous().view(torch.int16).long() & 0xFFFF
    mag = bits & 0x7FFF
    return torch.where(bits >= 0x8000, -mag, mag)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The step from each bfloat16 value of ``t`` to the next one away
    from zero, in float32."""
    mag = t.abs()
    up = (mag.contiguous().view(torch.int16) + 1).view(torch.bfloat16)
    return up.float() - mag.float()


def _field_gap(what: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """float32 fields within |a-b| <= 1e-5 + 1e-3|b|.  bf16 fields within
    that envelope or one bfloat16 ulp of b, whichever is wider: one
    rounding step (2^-8 to 2^-7 relative) is wider than the envelope's
    1e-3 relative, and near zero the envelope's 1e-5 is wider than a step.
    Returns the largest gap, and for bf16 the largest gap in ulps and the
    share of bit-equal elements."""
    gap = (got.float() - want.float()).abs()
    limit = 1e-5 + 1e-3 * want.float().abs()
    out = {"max_abs_gap": gap.max().item()}
    if got.dtype == torch.bfloat16:
        limit = torch.maximum(limit, bf16_ulp(want))
        ulps = (_ordinal(got) - _ordinal(want)).abs()
        out.update(max_ulps=int(ulps.max()),
                   bit_equal_share=float((ulps == 0).float().mean()))
    if not bool((gap <= limit).all()):
        raise AssertionError(
            f"{what} leaves its tolerance (max gap {gap.max().item()}, "
            f"{int((gap > limit).sum())} elements; {out})")
    return out


def phase_step_parity(path: str, vocab, batch) -> None:
    """``batch``: a CBOW batch for the gather renderings, a stencil batch
    for the stencil ones."""
    model = _model(path, vocab, "cuda")
    cpu_model = _model(path, vocab, "cpu")
    B = len(batch)
    draws = _draws(model, B, np.random.default_rng(11))
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    kernels.reset_launches()
    es_c, ec_c = model.step_batch(batch, draws=draws)
    es_p, ec_p = cpu_model.step_batch(
        batch, draws=tuple(t.cpu() for t in draws))
    counts = kernels.launch_counts()
    if model.shared_negatives:
        if not math.isclose(ec_c, ec_p, rel_tol=1e-6):
            raise AssertionError(f"{path} err_cnt: card {ec_c} != cpu "
                                 f"{ec_p} (rel 1e-6)")
    elif ec_c != ec_p:
        raise AssertionError(f"{path} err_cnt: card {ec_c} != cpu {ec_p}")
    if not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"{path} err_sum: card {es_c} != cpu {es_p}")
    worst = {f: _field_gap(f"{path} step parity: field {f}",
                           _global(v), _global(cpu_model.table.state[f]))
             for f, v in model.table.state.items()}
    if model.stencil and counts["stencil"] != 1:
        raise AssertionError(f"{path} step launched the stencil kernel "
                             f"{counts['stencil']} times")
    _json_line({"phase": "step_parity", "rendering": path,
                "centers": B, "real_centers": batch.n_words,
                "err_sum": [es_c, es_p], "err_cnt": [ec_c, ec_p],
                "gap": worst, "envelope": "1e-5 + 1e-3*|cpu|; bf16 fields "
                "that or one ulp", "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


def phase_step_parity_sharded(vocab, batch, dtype: str = "") -> None:
    """One ``gather`` step of the sharded parameter server on the card,
    against the same sharded step on the CPU (whole tables, each field
    within ``_field_gap``'s tolerance, ``err_cnt`` exact) and against the one-shard ``xla`` step on the card, row for row
    by key: the two lay the same words out in different slots.
    ``dtype``: ``""`` or ``BF16``."""
    path = f"gather@{SHARDS}{dtype}"
    model = _model(path, vocab, "cuda")
    cpu_model = _model(path, vocab, "cpu")
    single = _model("gather" + dtype, vocab, "cuda")
    B = len(batch)
    draws = _draws(model, B, np.random.default_rng(11))
    # every word starts from the row the one-shard model gives it
    at_single = single._slot_of_vocab.long().cpu()
    at_sharded = model._slot_of_vocab.long().cpu()
    start = {f: _global(v) for f, v in model.table.state.items()}
    for f in start:
        start[f][at_sharded] = single.table.state[f].cpu()[at_single]
    model.table.state = {f: split_rows(t, model.cluster.mesh)
                         for f, t in start.items()}
    cpu_model.table.state = {f: split_rows(t, cpu_model.cluster.mesh)
                             for f, t in start.items()}
    kernels.reset_launches()
    es_c, ec_c = model.step_batch(batch, draws=draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu_model.step_batch(
        batch, draws=tuple(t.cpu() for t in draws))
    es_s, ec_s = single.step_batch(batch, draws=draws)
    if not ec_c == ec_p == ec_s:
        raise AssertionError(f"{path} err_cnt: card {ec_c}, cpu {ec_p}, "
                             f"one shard {ec_s}")
    if not (math.isclose(es_c, es_p, rel_tol=1e-4)
            and math.isclose(es_c, es_s, rel_tol=1e-4)):
        raise AssertionError(f"{path} err_sum: card {es_c}, cpu {es_p}, "
                             f"one shard {es_s}")
    card, cpu, one = ({f: _global(v) for f, v in m.table.state.items()}
                      for m in (model, cpu_model, single))
    worst_cpu = {f: _field_gap(f"{path} vs the CPU step, field {f},",
                               card[f], cpu[f]) for f in cpu}
    worst_one = {f: _field_gap(
        f"{path} vs the one-shard step by key, field {f},",
        card[f][at_sharded], one[f][at_single]) for f in one}
    moved = int((card["h"][at_sharded] != start["h"][at_sharded])
                .any(dim=1).sum())
    if not moved:
        raise AssertionError(f"{path}: the step moved no row")
    want = dict(SHARDED[f"gather@{SHARDS}"], stencil=0)
    if counts != want:
        raise AssertionError(f"{path} step launched {counts}, its path is "
                             f"{want}")
    if model.transfer.overflow_count() or ring.timeouts():
        raise AssertionError(f"{path}: overflow "
                             f"{model.transfer.overflow_count()}, wait "
                             f"timeouts {ring.timeouts()}")
    _json_line({"phase": "step_parity", "rendering": path, "centers": B,
                "real_centers": batch.n_words,
                "err_sum": [es_c, es_p, es_s], "err_cnt": [ec_c, ec_p, ec_s],
                "gap_vs_cpu": worst_cpu,
                "gap_vs_one_shard_by_key": worst_one,
                "rows_moved": moved, "envelope": "1e-5 + 1e-3*|b|; bf16 "
                "fields that or one ulp",
                "shard_fill": model.table.key_index.shard_fill().tolist(),
                "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


# -- phase 4: training through the public entry point -----------------------

def phase_train(rendering: str, vocab, corpus: np.ndarray,
                card: str) -> dict:
    """``rendering``: a path of ``PATHS``."""
    model = _model(rendering, vocab, "cuda")
    expect, n_sent = PATHS[rendering][1], PATHS[rendering][2]
    sharded = rendering.split(":")[0]
    batcher = CBOWBatcher(corpus[:n_sent], vocab, model.window, model.sample,
                          seed=2008)
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{rendering}: non-finite loss {losses}")
    if m["steps"] < MIN_TRAIN_STEPS:
        raise AssertionError(f"{rendering}: only {m['steps']} steps; raise "
                             "its corpus prefix")
    launched = {k for k, n in counts.items() if n}
    if launched != expect:
        raise AssertionError(f"{rendering}: the train run launched "
                             f"{sorted(launched)}, its path is "
                             f"{sorted(expect)}")
    if model.stencil and (counts["stencil"] != m["steps"]
                          or "v:span" not in m["push_paths"]):
        raise AssertionError(f"{rendering}: {counts['stencil']} stencil "
                             f"launches in {m['steps']} steps, push paths "
                             f"{m['push_paths']}")
    extra = {"dtype": _dtype_name(_global(model.table.state["h"]))}
    if sharded in SHARDED:
        # every step: one send and one wait launch for every exchange, one
        # gather per pull, one scatter-add and one AdaGrad per pushed
        # family
        want = {k: v * m["steps"] for k, v in SHARDED[sharded].items()}
        got = {k: counts[k] for k in want}
        extra.update(overflow_count=model.transfer.overflow_count(),
                     wait_timeouts=ring.timeouts(), shards=m["shards"])
        if got != want or extra["overflow_count"] or extra["wait_timeouts"] \
                or any(not k.endswith(":routed") for k in m["push_paths"]):
            raise AssertionError(
                f"{rendering}: launches {got} in {m['steps']} steps, its "
                f"path gives {want}; {extra}; push paths {m['push_paths']}")
    _json_line({"phase": "train", "rendering": rendering, "card": card,
                **extra,
                "loss": losses, "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"],
                "batcher_seconds": m["batcher_seconds"],
                "steps_per_sec": m["steps_per_sec"],
                "words_per_sec": m["words_per_sec"],
                "push_paths": m["push_paths"], "launches": counts})
    return counts


# -- phase 5: the CLI --------------------------------------------------------

def phase_cli(extra: str, expect: set, cluster: str = "server_num: 1\n"
              "transfer: xla\n", server: str = "") -> None:
    """``extra``: [word2vec] lines; ``server``: more [server] lines."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    data, conf, out = WORK / "corpus.txt", WORK / "w2v.conf", \
        WORK / "vectors.txt"
    write_tokens_file(synthetic_corpus(200, 500, 20, seed=1), str(data))
    conf.write_text("[cluster]\n" + cluster +
                    "[worker]\nminibatch: 512\n"
                    "[server]\ninitial_learning_rate: 0.7\n" + server +
                    "[word2vec]\nlen_vec: 100\nwindow: 4\nnegative: 20\n"
                    "sample: 0.001\nlearning_rate: 0.05\n" + extra)
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
        if server and not all(torch.equal(
                torch.from_numpy(r).to(torch.bfloat16).float(),
                torch.from_numpy(r)) for r in (row["v"], row["h"])):
            raise AssertionError(f"dump row for key {key} holds values "
                                 f"that are not bf16")
        keys.add(int(key))
    if keys != set(vocab.keys.tolist()):
        raise AssertionError(f"dump has {len(keys)} keys, vocab "
                             f"{len(vocab)}")
    launched = {k for k, n in counts.items() if n}
    if launched != expect:
        raise AssertionError(f"the CLI run ({extra.strip() or 'gather'}; "
                             f"{cluster.split()}) launched "
                             f"{sorted(launched)}, expected "
                             f"{sorted(expect)}")
    _json_line({"phase": "cli", "conf": extra.strip() or "gather",
                "cluster": " ".join(cluster.split()),
                "server": " ".join(server.split()),
                "rows": len(keys), "launches": counts})
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
    model = _model("gather", vocab, "cuda")

    def first(epoch):
        return next(iter(epoch(BATCH)))

    def prefix_batcher():
        return CBOWBatcher(corpus[:100], vocab, model.window, model.sample,
                           seed=2008)

    batch = first(prefix_batcher().epoch)
    sbatch = first(prefix_batcher().epoch_stencil)
    print(f"corpus {corpus.size} tokens, vocab {len(vocab)}, table "
          f"capacity {model.table.capacity} x {model.len_vec}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cases = phase_kernels(model, batch, sbatch)
    del model
    cases += phase_kernels_sharded(_model(f"gather@{SHARDS}", vocab, "cuda"),
                                   batch)
    report_cases(cases)
    phase_step_parity("gather", vocab, batch)
    phase_step_parity("stencil", vocab, sbatch)
    phase_step_parity("stencil_shared", vocab, sbatch)
    phase_step_parity_sharded(vocab, batch)
    phase_step_parity("gather" + BF16, vocab, batch)
    phase_step_parity("stencil" + BF16, vocab, sbatch)
    phase_step_parity_sharded(vocab, batch, BF16)
    counts = {r: phase_train(r, vocab, corpus, card) for r in PATHS}
    phase_cli("", PATHS["gather"][1])
    phase_cli("stencil: 1\n", PATHS["stencil"][1])
    phase_cli("", PATHS[f"gather@{SHARDS}"][1],
              cluster=f"server_num: {SHARDS}\ntransfer: tpu\n")
    phase_cli("", PATHS["gather" + BF16][1], server="dtype: bfloat16\n")

    summary = []
    for c in cases:
        name = c["module"].__name__.rsplit(".", 1)[-1]
        summary.append({
            "name": c["name"], "route": c["route"], "source": c["source"],
            "replaces": c["replaces"], "launches": counts[c["path"]][name],
            "path": c["path"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    print(card, flush=True)
    _json_line({"kernels": summary})
    _json_line({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
