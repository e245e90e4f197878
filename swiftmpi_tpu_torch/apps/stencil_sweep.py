"""Time the forms of the stencil context-sum kernel on the card.

    python -m swiftmpi_tpu_torch.apps.stencil_sweep

At the stencil batches the word2vec stencil rendering gives it at the
reference configuration (demo.conf on the text8-shaped synthetic corpus,
the first stencil batch of 5,000 centers over a 5,008-row span): the
reference batch (sample 1e-5: about 790 real centers, the rest padded)
and the same corpus with subsampling off (every center real, so
neighbouring centers share most window rows), each on a float32 and a
bfloat16 table.  One JSON line a case and form: the median time from
CUDA events with the L2 flushed before each and the host's enqueue not
timed where a 50 us spin on the card outlasts it (as ``chip_smoke.py``
times it), the kernel's taken before and after the others; the byte
bound; and whether the form is bit-equal to the plain version.  Forms:

* ``kernel``: ``stencil_context_sum``, one launch from the batch's arrays;
* ``window inputs``: the torch ops of ``stencil_window_inputs`` alone,
  what the step ran before the first kernel until the kernel took them
  over (their enqueue outlasts the spin, so this is host time as much as
  device time);
* ``plain`` and ``library`` (``F.embedding_bag`` over the window rows with
  the mask as per-sample weights, the inputs made beforehand; on a
  bfloat16 table it sums into bfloat16).

At the commit that brought it, this sweep also timed the first kernel
(from the window inputs' ``(lo, wmask)``) and a form staging a tile of
centers' window rows in shared memory; PERF.md has those numbers.

With ``-store PATH``, the A/B over every case and dtype (at each, the
kernel's faster median against ``F.embedding_bag``; correct when
bit-equal to the plain version) is recorded as this card's
``stencil_fused`` verdict in that verdict store (``ops/calibration.py``),
which ``[cluster] data_plane: auto`` consults in a process that names
the store.  Without it nothing is recorded.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from swiftmpi_tpu_torch.apps.gather_sweep import PEAK_BYTES_S, _median_ms
from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,
                                                 TEXT8_CORPUS, card_line)
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          synthetic_corpus_bulk)
from swiftmpi_tpu_torch.kernels import stencil
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.ops import calibration
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser


def batch_inputs(model: Word2Vec, sb):
    """The context sum's operands of stencil batch ``sb`` as the step
    hands them over: span slots, sent_id, center_pos (int64), half."""
    dev = model.device
    tokens = torch.as_tensor(sb.tokens, dtype=torch.int64, device=dev)
    sent_id = torch.as_tensor(sb.sent_id, dtype=torch.int32, device=dev)
    slots = torch.where(sent_id >= 0, model._slot_of_vocab[tokens],
                        -1).contiguous()
    cp = torch.as_tensor(sb.center_pos, dtype=torch.int64, device=dev)
    half = torch.as_tensor(sb.half, dtype=torch.int32, device=dev)
    return slots, sent_id, cp, half


def context_sum_bytes(table, slots, sent_id, center_pos, half, window):
    """The bytes the function must move: the four index arrays read once,
    each distinct table row a window reaches read once, neu1 written
    once."""
    lo, wmask = stencil.stencil_window_inputs(sent_id, center_pos, half,
                                              window)
    K = wmask.shape[1]
    cap, d = table.shape
    pos = lo.long()[:, None] + torch.arange(K, device=lo.device)
    src = slots.long().clamp(0, cap - 1)[pos]
    rows = torch.unique(src[wmask != 0]).numel()
    B, S = center_pos.shape[0], slots.shape[0]
    return (8 * S + 12 * B + table.element_size() * d * rows
            + 4 * B * d), rows, src, wmask


def _cases(label, table, args, window, flush):
    nbytes, rows, src, wmask = context_sum_bytes(table, *args, window)
    want = stencil.stencil_context_sum_plain(table, *args, window)
    wm_t = wmask.to(table.dtype)     # 0 and 1: exact in either dtype
    base = {"case": label, "dtype": str(table.dtype).rsplit(".", 1)[-1],
            "centers": int(args[2].shape[0]),
            "real_centers": int((args[2] >= 0).sum()),
            "span": int(args[0].shape[0]), "rows_reached": rows,
            "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
    fns = {"kernel": lambda: stencil.stencil_context_sum(table, *args,
                                                           window),
           "window inputs": lambda: stencil.stencil_window_inputs(
               *args[1:], window)}
    out = []
    for form, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        out.append({**base, "form": form, "ms": [_median_ms(fn, flush)],
                    "bit_equal": bool(torch.equal(got, want))
                    if form == "kernel" else None})
    out.append({**base, "form": "plain", "ms": [_median_ms(
        lambda: stencil.stencil_context_sum_plain(table, *args, window),
        flush)], "bit_equal": True})
    out.append({**base, "form": "library F.embedding_bag", "ms": [_median_ms(
        lambda: F.embedding_bag(src, table, mode="sum",
                                per_sample_weights=wm_t), flush)],
        "bit_equal": None})
    # the kernel again, after the others
    out[0]["ms"].append(_median_ms(fns["kernel"], flush))
    return out


def sweep(store=None, corpus=None, vocab=None) -> list:
    """Time every case (over ``corpus`` and ``vocab``, by default the
    text8-shaped corpus); record the verdict over them all in ``store``
    (none: print it only); return the rows."""
    if not torch.cuda.is_available():
        raise RuntimeError("stencil_sweep measures the card; no CUDA device "
                           "is available")
    card = card_line()
    if corpus is None:
        corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    if vocab is None:
        vocab = build_vocab(corpus)
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device="cuda")
    conf = ConfigParser().update(DEMO_CONF)
    conf.set("word2vec", "stencil", 1)
    model = Word2Vec(config=conf, device="cuda").build_from_vocab(vocab)
    rows = []
    for label, sample in (("reference batch (sample 1e-5)", model.sample),
                          ("every center real (sample off)", -1.0)):
        sb = next(iter(CBOWBatcher(corpus[:100], vocab, model.window,
                                   sample, seed=2008).epoch_stencil(BATCH)))
        args = batch_inputs(model, sb)
        for dtype in (torch.float32, torch.bfloat16):
            table = model.table.state["v"].to(dtype)
            rows += _cases(label, table, args, model.window, flush)
    # each case and dtype: the kernel's row, then three others, the last
    # its library form
    kerns, libs = rows[0::4], rows[3::4]
    calibration.ab_verdict(
        "stencil_fused", [r["ms"][0] for r in libs],
        [min(r["ms"]) for r in kerns], all(r["bit_equal"] for r in kerns),
        shape=[f"{r['centers']}x{r['span']} {r['dtype']}" for r in kerns],
        path=store, record_it=store is not None)
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
