"""A vocabulary of ``vocab_size`` words whose counts are the expected
counts of Zipf(``zipf_s``) over ``source_corpus_words`` words (at least
1), so no tail word is lost; the corpus draws ``corpus_sentences``
sentences of ``sentence_length`` words from the same probabilities."""

from __future__ import annotations

import numpy as np

from benchmark.traffic import sub_seed


def make(cfg: dict, seed: int):
    V, s = int(cfg["vocab_size"]), float(cfg["zipf_s"])
    w = np.arange(1, V + 1, dtype=np.float64) ** (-s)
    p = w / w.sum()
    counts = np.maximum(np.rint(p * float(cfg["source_corpus_words"])),
                        1).astype(np.int64)
    keys = np.arange(1, V + 1, dtype=np.uint64)  # rank order already
    rng = np.random.default_rng(sub_seed(seed, 2))
    n, length = int(cfg["corpus_sentences"]), int(cfg["sentence_length"])
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    tokens = np.empty(n * length, np.int32)
    chunk = 4_000_000
    for i in range(0, len(tokens), chunk):
        m = min(chunk, len(tokens) - i)
        tokens[i:i + m] = np.minimum(
            np.searchsorted(cdf, rng.random(m), side="right"), V - 1)
    offsets = np.arange(0, n * length + 1, length, dtype=np.int64)
    return tokens, offsets, keys, counts
