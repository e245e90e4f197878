"""How far two runs of the same training drift apart on the card, by
steps: the reference configuration's gather rendering on the native
batcher (``apps/input_profile.py`` runs ``a``, ``b`` and ``c``), trained
over the first N batches of an epoch, twice as run ``a`` and once each as
``b`` (``pipeline: 4``) and ``c`` (``inner_steps: 8``, graph replays).

    python -m swiftmpi_tpu_torch.apps.drift_probe [-steps 1,2,8,32,128,600]

Prints one JSON line per N: for the rerun of ``a``, for ``b`` and for
``c``, each table field's largest gap to the first ``a`` run and its
count of elements outside 1e-5 + 1e-3|a|, and the four losses.  The
dense h push (B3) and the sparse push's ``index_add_`` sum in no fixed
order, so a rerun of ``a`` starts a last-bit apart and the training
carries the difference on: this is the spread against which ``b`` and
``c`` are read.
"""

from __future__ import annotations

import itertools
import json
import sys

import torch

from swiftmpi_tpu_torch.apps.input_profile import (load_native, run_batcher,
                                                   run_model)
from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, TEXT8_CORPUS,
                                                 card_line)
from swiftmpi_tpu_torch.data.text import build_vocab, synthetic_corpus_bulk
from swiftmpi_tpu_torch.utils import CMDLine


class _Prefix:
    """The first ``n`` batches of each epoch of ``inner``."""

    def __init__(self, inner, n: int):
        self.inner, self.n, self.vocab = inner, n, inner.vocab

    def epoch(self, batch_size: int):
        return itertools.islice(self.inner.epoch(batch_size), self.n)


def _gap(model, ref) -> dict:
    out = {}
    for f, t in model.table.state.items():
        x, y = t.float(), ref.table.state[f].float()
        g = (x - y).abs()
        out[f] = [g.max().item(),
                  int((g > 1e-5 + 1e-3 * y.abs()).sum())]
    return out


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("steps", "comma-separated step counts (default "
                          "1,2,8,32,128,600)")
    if not torch.cuda.is_available():
        raise RuntimeError("drift_probe measures the card; no CUDA device "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    loaded = load_native(corpus)[:3]
    for n in map(int, cmd.getValue("steps", "1,2,8,32,128,600").split(",")):
        models, losses = [], []
        for run in ("a", "a", "b", "c"):
            m = run_model(run, vocab)
            batcher = _Prefix(run_batcher(run, m, corpus, loaded), n)
            losses.append(m.train(batcher=batcher, niters=1,
                                  batch_size=BATCH)[0])
            models.append(m)
        ref = models[0]
        print(json.dumps({
            "card": card, "steps": ref.train_metrics["steps"],
            "rerun_a": _gap(models[1], ref), "b": _gap(models[2], ref),
            "c": _gap(models[3], ref),
            "c_graph_replays": models[3].train_metrics["graph_replays"],
            "loss": losses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
