"""The general generator: a configuration's corpus and vocabulary from
the seed (``corpora/<corpus>.py``, named by the configuration's
``corpus`` key) and a traffic mix's batch feed (``feeds/<batcher>.py``,
named by the mix's ``batcher`` key).  A new corpus kind or feed is a new
file."""

from __future__ import annotations

import importlib

import numpy as np

SEED_MASK = (1 << 62) - 1


def sub_seed(seed: int, *words: int) -> int:
    """A 62-bit seed for one use of the run's seed (``words`` name it)."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *words])
    return int(ss.generate_state(2, np.uint32).view(np.uint64)[0]) \
        & SEED_MASK


def make_corpus(cfg: dict, seed: int):
    """``corpora/<cfg["corpus"]>.py``'s ``make(cfg, seed)``."""
    return importlib.import_module(
        f"benchmark.corpora.{cfg['corpus']}").make(cfg, seed)


def feed(tokens, offsets, vocab, cfg: dict, mix: dict, seed: int):
    """``feeds/<mix["batcher"]>.py``'s ``Feed`` over the corpus."""
    return importlib.import_module(
        f"benchmark.feeds.{mix['batcher']}").Feed(
            tokens, offsets, vocab, cfg, mix, seed)
