"""Time the masked gather kernel on the card.

    python -m swiftmpi_tpu_torch.apps.gather_sweep

At the shapes the word2vec pulls give it at the reference configuration
(demo.conf on the text8-shaped synthetic corpus, the first batch, negative
draws from a seed): the one-shard h pull (105,000 target rows of 100 from
the whole table), the v pull (40,000 context rows), and the owners' h pull
of the sharded parameter server with 8 ranks on the card (8 x 105,000
requests, most of them bucket padding, each from its rank's shard of the
card's block, in one launch).  One JSON line a shape: the median kernel
time from CUDA events with the L2 flushed before each and the host's
enqueue not timed (as ``chip_smoke.py`` times it), taken before and after
the plain version's and one library call's (``index_select`` of the
clipped rows); the byte bound; and whether the kernel is bit-equal to the
plain version.  The forms that were tried and dropped (a warp a row, and
a group of rows a warp without the L2 hints) are in PERF.md.
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
from swiftmpi_tpu_torch.kernels import gather, ring
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, _cbow_targets
from swiftmpi_tpu_torch.parameter.sparse_table import shard_block
from swiftmpi_tpu_torch.utils import ConfigParser

RUNS = 25
#: about 50 us of the card's clock, longer than a wrapper call's enqueue
SPIN_CYCLES = 100_000
#: published H100 SXM HBM bytes/s
PEAK_BYTES_S = 3.35e12


def _median_ms(fn, flush: torch.Tensor) -> float:
    """As ``chip_smoke._time_ms``: the L2 flushed before each launch and a
    spin on the card while the host enqueues, so only device time counts."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS)]
    for s, e in zip(starts, ends):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
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


def _pull_slots(model: Word2Vec, batch, seed: int):
    """The h pull's B*(K+1) target slots (-1 where the target is not
    valid) and the v pull's B*2W context slots of one gather step."""
    dev, rng = model.device, np.random.default_rng(seed)
    B, K = len(batch.centers), model.negative
    draws = (torch.as_tensor(rng.integers(0, len(model.vocab), (B, K)),
                             device=dev),
             torch.as_tensor(rng.random((B, K), np.float32), device=dev))
    t_slots, ctx_slots, t_valid = _cbow_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx,
        torch.as_tensor(batch.centers, dtype=torch.int64, device=dev),
        torch.as_tensor(batch.contexts, dtype=torch.int64, device=dev),
        torch.as_tensor(batch.ctx_mask, device=dev), draws)
    h = torch.where(t_valid, t_slots, -1).reshape(-1).to(torch.int32)
    return h.contiguous(), ctx_slots.reshape(-1).to(torch.int32).contiguous()


def _case(label, table, slots, flush):
    valid = (slots >= 0).contiguous()
    cap, d = table.shape[-2:]
    clipped = slots.clamp(0, cap - 1).long()
    if table.dim() == 3:
        clipped = clipped + torch.arange(
            table.shape[0], device=slots.device)[:, None] * cap
    n = slots.numel()
    nbytes = 4 * d * torch.unique(clipped[valid]).numel() + 5 * n + 4 * n * d
    idx = clipped.reshape(-1).contiguous()
    flat = table.reshape(-1, d)
    out = gather.masked_gather(table, slots, valid)
    row = {"case": label, "rows": n, "width": d, "bit_equal": bool(
        torch.equal(out, gather.masked_gather_plain(table, slots, valid))),
        "bound_ms": nbytes / PEAK_BYTES_S * 1e3}

    def kernel():
        return gather.masked_gather(table, slots, valid, out=out)

    row["ms"] = [_median_ms(kernel, flush)]
    row["plain_ms"] = _median_ms(
        lambda: gather.masked_gather_plain(table, slots, valid), flush)
    row["library_ms"] = _median_ms(lambda: flat.index_select(0, idx), flush)
    row["ms"].append(_median_ms(kernel, flush))
    return row


def sweep() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("gather_sweep measures the card; no CUDA device "
                           "is available")
    card = card_line()
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device="cuda")
    one = _model(vocab, 0)
    batch = next(iter(CBOWBatcher(corpus[:100], vocab, one.window,
                                  one.sample, seed=2008).epoch(BATCH)))
    h, v = _pull_slots(one, batch, 7)
    rows = [_case("h pull", one.table.state["h"], h, flush),
            _case("v pull", one.table.state["v"], v, flush)]
    del one
    sharded = _model(vocab, 8)
    h, _ = _pull_slots(sharded, batch, 7)
    groups, _, _ = sharded.transfer._route(sharded.table.state, h)
    owners = ring.ring_exchange_stacked(groups[0].req).view(8, -1)
    rows.append(_case("8 owners' h pull, one launch",
                      shard_block(sharded.table.state["h"]), owners, flush))
    for row in rows:
        print(json.dumps({"card": card, **row}), flush=True)


def main(argv=None) -> int:
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
