"""A corpus with text8's published word counts, in an order drawn from
the seed.

The count of the word of rank ``r`` is ``top_count * r**-a`` up to
``knee_rank`` and falls as ``r**-b`` beyond it, each rounded and at
least 1, over ``distinct_words`` ranks.  ``b`` puts the last word of
``min_count`` occurrences or more at rank ``words_at_min_count``, ``a``
makes the counts sum to ``corpus_tokens`` (the last few tokens go to
rank 2), and ``knee_rank`` is fitted to ``tokens_past_rank`` (the tokens
beyond that many most common words).  Every seed gets the same counts:
the seed draws only the order of the tokens.  As word2vec reads a
corpus, the words under ``min_count`` are dropped from the stream and
the vocabulary, and the rest is cut into sentences of
``sentence_length``."""

from __future__ import annotations

import numpy as np

from benchmark.traffic import sub_seed


def _tail_exponent(cfg: dict, a: float) -> float:
    r0, top = float(cfg["knee_rank"]), float(cfg["top_count"])
    c0 = top * r0 ** -a
    # the crossing of min_count - 0.5 between the last kept rank and the
    # next, so rounding keeps exactly words_at_min_count words
    at = float(cfg["words_at_min_count"]) + 0.5
    return np.log(c0 / (int(cfg["min_count"]) - 0.5)) / np.log(at / r0)


def _curve(cfg: dict, a: float) -> np.ndarray:
    n, r0 = int(cfg["distinct_words"]), float(cfg["knee_rank"])
    top = float(cfg["top_count"])
    r = np.arange(1, n + 1, dtype=np.float64)
    b = _tail_exponent(cfg, a)
    c = np.where(r <= r0, top * r ** -a, top * r0 ** -a * (r / r0) ** -b)
    return np.maximum(np.floor(c + 0.5), 1.0)


def word_counts(cfg: dict) -> np.ndarray:
    """The int64 counts by rank; they sum to ``corpus_tokens``."""
    total = int(cfg["corpus_tokens"])
    lo, hi = 0.5, 1.2
    for _ in range(60):                 # the sum grows as ``a`` falls
        mid = 0.5 * (lo + hi)
        if _curve(cfg, mid).sum() > total:
            lo = mid
        else:
            hi = mid
    counts = _curve(cfg, hi).astype(np.int64)
    counts[1] += total - int(counts.sum())
    return counts


def make(cfg: dict, seed: int):
    counts = word_counts(cfg)
    kept = int((counts >= int(cfg["min_count"])).sum())
    rng = np.random.default_rng(sub_seed(seed, 1))
    ranks = np.repeat(np.arange(kept, dtype=np.int32), counts[:kept])
    tokens = rng.permutation(ranks)
    length = int(cfg["sentence_length"])
    offsets = np.append(np.arange(0, len(tokens), length, dtype=np.int64),
                        np.int64(len(tokens)))
    keys = np.arange(1, kept + 1, dtype=np.uint64)   # rank order already
    return tokens, offsets, keys, counts[:kept].copy()
