"""Time the masked scatter-add kernel on the card.

    python -m swiftmpi_tpu_torch.apps.scatter_sweep

At the shapes the word2vec h push gives it at the reference configuration
(demo.conf on the text8-shaped synthetic corpus, the first batch, negative
draws from a seed): the one-shard dense push (105,000 target rows of 100
into the whole table, with counts), the same for a stencil batch (most rows
padding), and the owners' push of the sharded parameter server with 8
ranks on the card (8 x 105,000 received rows, most of them bucket padding,
into each rank's shard, with counts, in one launch).  One JSON line each:
the median kernel time from CUDA events with the L2 flushed before each
(as ``chip_smoke.py`` times it), taken before and after the plain
version's and one library call's (``index_add_`` of the sums alone); the
byte bound; the rows that land; and the mean number of landing rows in
the same 32-row and 128-row window that share a row's slot (1.0: nothing
to merge), what a warp's or the kernel's 128-row tile merge can save.

With ``-store PATH``, the A/B over every case (at each, the kernel's
faster median against the library call; correct when within the plain
version's tolerance with exact counts) is recorded as this card's
``vmem_scatter`` verdict in that verdict store (``ops/calibration.py``),
which ``kernel_status`` reports.  Without it nothing is recorded.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,
                                                 TEXT8_CORPUS, card_line)
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          synthetic_corpus_bulk)
from swiftmpi_tpu_torch.kernels import ring, scatter
from swiftmpi_tpu_torch.models.word2vec import (Word2Vec, _cbow_targets,
                                                _parity_targets)
from swiftmpi_tpu_torch.ops import calibration
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser

RUNS = 25
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


def _model(vocab, shards: int) -> Word2Vec:
    conf = ConfigParser().update(DEMO_CONF)
    if shards:
        conf.set("cluster", "transfer", "tpu")
        conf.set("cluster", "server_num", shards)
    return Word2Vec(config=conf, device="cuda").build_from_vocab(vocab)


def _h_slots(model: Word2Vec, batch, seed: int) -> torch.Tensor:
    """The h push's B*(K+1) target slots of one gather step (-1 where the
    target is not valid)."""
    dev, rng = model.device, np.random.default_rng(seed)
    B, K = len(batch.centers), model.negative
    draws = (torch.as_tensor(rng.integers(0, len(model.vocab), (B, K)),
                             device=dev),
             torch.as_tensor(rng.random((B, K), np.float32), device=dev))
    t_slots, _, t_valid = _cbow_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx,
        torch.as_tensor(batch.centers, dtype=torch.int64, device=dev),
        torch.as_tensor(batch.contexts, dtype=torch.int64, device=dev),
        torch.as_tensor(batch.ctx_mask, device=dev), draws)
    return torch.where(t_valid, t_slots, -1).reshape(-1).to(torch.int32)


def _stencil_h_slots(model: Word2Vec, sb, seed: int) -> torch.Tensor:
    """The h push's B*(K+1) target slots of one stencil step: padded
    centers give -1 rows, most of the batch at sample 1e-5."""
    dev, rng = model.device, np.random.default_rng(seed)
    B, K = len(sb), model.negative
    tokens = torch.as_tensor(sb.tokens, dtype=torch.int64, device=dev)
    cpos = torch.as_tensor(sb.center_pos, dtype=torch.int64, device=dev)
    span = torch.where(torch.as_tensor(sb.sent_id, device=dev) >= 0,
                       model._slot_of_vocab[tokens], -1)
    ok = cpos >= 0
    cp = cpos.clamp(0, sb.span - 1)
    draws = (torch.as_tensor(rng.integers(0, len(model.vocab), (B, K)),
                             device=dev),
             torch.as_tensor(rng.random((B, K), np.float32), device=dev))
    t_slots, t_valid = _parity_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx,
        tokens[cp], torch.where(ok, span[cp], -1), ok, draws)
    return torch.where(t_valid, t_slots, -1).reshape(-1).to(torch.int32)


def _sharing(slots: torch.Tensor, valid: torch.Tensor, window: int) -> float:
    """Mean, over landing rows, of the landing rows in the same
    ``window``-row window (rank by rank) with the same slot."""
    s = torch.where(valid & (slots >= 0), slots.long(), -1)
    s = s.reshape(-1, s.shape[-1])
    pad = (-s.shape[1]) % window
    w = torch.cat([s, s.new_full((s.shape[0], pad), -1)], 1).view(
        -1, window)
    per_row = []
    for part in w.split(1024):      # bounded memory for the pair table
        same = (part[:, :, None] == part[:, None, :]) & \
            (part[:, :, None] >= 0)
        per_row.append(same.sum(-1)[part >= 0].float())
    per_row = torch.cat(per_row)
    return float(per_row.mean()) if per_row.numel() else 0.0


def _case(label, slots, valid, cap, w, flush, rng):
    g = torch.as_tensor(rng.normal(size=(*slots.shape, w))
                        .astype(np.float32) * 1e-2, device=slots.device)
    want, want_cnt = scatter.masked_scatter_add_plain(slots, valid, g, cap,
                                                      counts=True)
    landing = int((valid & (slots >= 0) & (slots < cap)).sum())
    lead = slots.shape[0] if slots.dim() == 2 else 1
    nbytes = 5 * slots.numel() + 4 * landing * w + 4 * lead * cap * (w + 1)
    row = {"case": label, "rows": int(slots.numel()), "width": w,
           "capacity": cap, "landing_rows": landing,
           "rows_sharing_a_slot_in_32": _sharing(slots, valid, 32),
           "rows_sharing_a_slot_in_128": _sharing(slots, valid, 128),
           "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
    acc, cnt = scatter.masked_scatter_add(slots, valid, g, cap, counts=True)
    torch.testing.assert_close(acc, want, rtol=1e-3, atol=1e-5)
    if not torch.equal(cnt, want_cnt):
        raise AssertionError(f"{label}: counts != plain")

    def kernel():
        return scatter.masked_scatter_add(slots, valid, g, cap, counts=True)

    ok = valid & (slots >= 0) & (slots < cap)
    base = (torch.arange(lead, device=g.device)[:, None] * (cap + 1)
            if slots.dim() == 2 else 0)
    safe = (base + torch.where(ok, slots, cap)).reshape(-1).long()
    lib_acc = torch.zeros((lead * (cap + 1), w), device=g.device)
    row["ms"] = [_median_ms(kernel, flush)]
    row["plain_ms"] = _median_ms(lambda: scatter.masked_scatter_add_plain(
        slots, valid, g, cap, counts=True), flush)
    row["library_ms"] = _median_ms(
        lambda: lib_acc.index_add_(0, safe, g.reshape(-1, w)), flush)
    row["ms"].append(_median_ms(kernel, flush))
    return row


def sweep(store=None) -> list:
    """Time every case; record the verdict over them all in ``store``
    (none: print it only); return the rows."""
    if not torch.cuda.is_available():
        raise RuntimeError("scatter_sweep measures the card; no CUDA device "
                           "is available")
    card = card_line()
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    rng = np.random.default_rng(23)
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device="cuda")
    one = _model(vocab, 0)

    def first(epoch):
        return next(iter(epoch(BATCH)))

    def batcher():
        return CBOWBatcher(corpus[:100], vocab, one.window, one.sample,
                           seed=2008)

    batch = first(batcher().epoch)
    h = _h_slots(one, batch, 7).contiguous()
    rows = [_case("one-shard h push", h, (h >= 0).contiguous(),
                  one.table.capacity, one.len_vec, flush, rng)]
    h = _stencil_h_slots(one, first(batcher().epoch_stencil), 7)
    rows.append(_case("one-shard stencil h push", h, (h >= 0).contiguous(),
                      one.table.capacity, one.len_vec, flush, rng))
    del one
    sharded = _model(vocab, 8)
    h = _h_slots(sharded, batch, 7)
    groups, _, cap = sharded.transfer._route(sharded.table.state, h)
    got = ring.ring_exchange_stacked(groups[0].req).view(8, -1)
    rows.append(_case("8 owners' h push, one launch", got, got >= 0, cap,
                      sharded.len_vec, flush, rng))
    # _case raised unless the sums held the plain version's tolerance
    # and the counts were exact
    calibration.ab_verdict(
        "vmem_scatter", [r["library_ms"] for r in rows],
        [min(r["ms"]) for r in rows], True,
        shape=[f"{r['rows']}x{r['width']} onto {r['capacity']}"
               for r in rows], path=store, record_it=store is not None)
    for row in rows:
        print(json.dumps({"card": card, **row}), flush=True)
    return rows


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("store", "verdict store to record into "
                          "(default: record nothing)")
    sweep(store=cmd.getValue("store") if cmd.hasParameter("store")
          else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
