"""Text corpus pipeline for word2vec: vocab, subsampling, CBOW batches
(counterpart of ``swiftmpi_tpu/data/text.py``).

Host-side numpy, copied from the JAX package so the port imports nothing
of it.  :class:`CBOWBatcher` consumes its numpy generator in exactly the
JAX batcher's order — one permutation per epoch, then per sentence one
``integers(0, W, L)`` shrink draw and (with subsampling) one ``random(L)``
keep draw — so the same seed gives the same batches, element for element.
The work between draws, which the JAX batcher does position by position in
Python, is vectorized per sentence here; so is the vocab mapping.

Batches are static-shape: ``centers (B,)``, ``contexts (B, 2W)`` + mask,
all as vocab indices (0..V-1); the model maps vocab index -> table slot on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np

from swiftmpi_tpu_torch.ops.sampling import subsample_keep_prob
from swiftmpi_tpu_torch.utils.hashing import bkdr_hash

_M64 = (1 << 64) - 1
#: longest sentence the loader keeps in one piece
MAX_SENTENCE_LENGTH = 1000


@dataclass
class Vocab:
    keys: np.ndarray     # (V,) uint64 external key per vocab index
    counts: np.ndarray   # (V,) int64 corpus frequency

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def total_words(self) -> int:
        return int(self.counts.sum())

    @property
    def index(self) -> Dict[int, int]:
        """uint64 key -> vocab index (the JAX ``Vocab``'s third field),
        built on first use from ``keys``; treat it as read-only."""
        index = self.__dict__.get("_index")
        if index is None:
            index = self.__dict__["_index"] = {
                int(k): i for i, k in enumerate(self.keys.tolist())}
        return index

    def index_of(self, key: int):
        """Vocab index for a raw token key (negative ints wrap to uint64,
        matching storage), or None if OOV."""
        return self.index.get(int(key) & _M64)


#: key modes: ``int`` for the sync variant, ``bkdr`` for async and hogwild
TOKENIZE_MODES = ("int", "bkdr")


def tokenize(line: str, mode: str = "int") -> List[int]:
    """Words -> integer keys: ``int`` = atoi, with the string hash for a
    word that is not an integer (the sync variant, word2vec.h:206);
    ``bkdr`` = the string hash of every word (the async variant,
    word2vec_global.h:205-207)."""
    words = line.split()
    if mode == "bkdr":
        return [bkdr_hash(w) for w in words]
    if mode != "int":
        raise ValueError(f"unknown tokenize mode {mode!r}")
    out = []
    for w in words:
        try:
            out.append(int(w))
        except ValueError:
            out.append(bkdr_hash(w))
    return out


def _vocab_from_counts(keys: np.ndarray, counts: np.ndarray,
                       min_count: int) -> Vocab:
    keep = counts >= min_count
    keys, counts = keys[keep], counts[keep]
    order = np.lexsort((keys, -counts))      # frequent-first, then key asc
    keys = keys[order].astype(np.uint64)
    counts = counts[order].astype(np.int64)
    return Vocab(keys, counts)


def build_vocab(sentences, min_count: int = 1) -> Vocab:
    """Count every key (normalized to uint64) with ``np.unique`` and order
    the vocab by (count desc, key asc), as the JAX package does.
    ``sentences``: key lists, or a token array such as the ``(n, length)``
    output of :func:`synthetic_corpus_bulk`."""
    if isinstance(sentences, np.ndarray):
        flat = _as_uint64(sentences.ravel())
    else:
        parts = [_as_uint64(s) for s in sentences]
        flat = np.concatenate(parts) if parts else np.empty(0, np.uint64)
    keys, counts = np.unique(flat, return_counts=True)
    return _vocab_from_counts(keys, counts.astype(np.int64), min_count)


def load_corpus(path: str, mode: str = "int",
                min_sentence_length: int = 1) -> List[List[int]]:
    """Sentences as key lists (``mode``: :func:`tokenize`'s); one line =
    one sentence, chopped into ``MAX_SENTENCE_LENGTH`` chunks (bounds
    single-line corpora such as text8)."""
    if mode not in TOKENIZE_MODES:
        raise ValueError(f"unknown tokenize mode {mode!r}")
    sentences = []
    with open(path) as f:
        for line in f:
            toks = tokenize(line, mode)
            for i in range(0, len(toks), MAX_SENTENCE_LENGTH):
                chunk = toks[i:i + MAX_SENTENCE_LENGTH]
                if len(chunk) >= min_sentence_length:
                    sentences.append(chunk)
    return sentences


@dataclass
class CBOWBatch:
    centers: np.ndarray   # (B,) int32 vocab indices
    contexts: np.ndarray  # (B, 2W) int32 vocab indices; 0 at padding
    ctx_mask: np.ndarray  # (B, 2W) bool
    n_words: int          # real (unpadded) center count

    def __len__(self) -> int:
        return len(self.centers)


@dataclass
class StencilBatch:
    """Positional-stencil batch: a *stream span* of tokens plus per-center
    positions into it, so a step pulls at most ``S = B + 2W`` rows instead
    of ``B * 2W`` context rows.

    Center row ``i`` with ``p = center_pos[i]`` and ``h = half[i]`` has
    center token ``tokens[p]`` and contexts ``tokens[j]`` for ``j`` in
    ``[p-h, p+h]``, ``j != p``, ``0 <= j < S`` and ``sent_id[j] ==
    sent_id[p]``, in increasing ``j`` (:func:`stencil_to_cbow`)."""

    tokens: np.ndarray      # (S,) int32 span vocab indices; 0 at padding
    sent_id: np.ndarray     # (S,) int32 batch-local sentence id; -1 pad
    center_pos: np.ndarray  # (B,) int32 span index per center; -1 pad
    half: np.ndarray        # (B,) int32 effective half-window; 0 pad
    n_words: int            # real (unpadded) center count

    def __len__(self) -> int:
        return len(self.center_pos)

    @property
    def span(self) -> int:
        return len(self.tokens)


def stencil_to_cbow(batch: StencilBatch, window: int) -> CBOWBatch:
    """Expand a stencil batch to per-pair rows: with the same seed the
    expanded stream equals :meth:`CBOWBatcher.epoch`'s, element for
    element.  Vectorized over the centers; the JAX package loops."""
    W = int(window)
    B, S, n = len(batch.center_pos), batch.span, batch.n_words
    centers = np.zeros(B, np.int32)
    ctxs = np.zeros((B, 2 * W), np.int32)
    mask = np.zeros((B, 2 * W), bool)
    p = batch.center_pos[:n].astype(np.int64)
    offs = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
    j = p[:, None] + offs[None, :]
    jc = np.clip(j, 0, S - 1)
    m = ((np.abs(offs)[None, :] <= batch.half[:n, None]) & (j >= 0)
         & (j < S) & (batch.sent_id[jc] == batch.sent_id[p][:, None]))
    vals = np.where(m, batch.tokens[jc], 0)
    pack = np.argsort(~m, axis=1, kind="stable")   # left-pack, j order kept
    centers[:n] = batch.tokens[p]
    ctxs[:n] = np.take_along_axis(vals, pack, axis=1)
    mask[:n] = np.take_along_axis(m, pack, axis=1)
    return CBOWBatch(centers, ctxs, mask, n)


def _as_uint64(sent) -> np.ndarray:
    try:
        return np.asarray(sent, dtype=np.int64).view(np.uint64)
    except OverflowError:
        return np.array([int(k) & _M64 for k in sent], dtype=np.uint64)


class _SpanState:
    """The stencil batch being filled: span arrays, how many span rows
    (``fill``) and centers (``nc``) are used, and the batch-local sentence
    counter ``ns``."""

    def __init__(self, S: int, batch_size: int):
        self.S, self.batch_size = S, batch_size
        self._fresh()

    def _fresh(self) -> None:
        self.tokens = np.zeros(self.S, np.int32)
        self.sids = np.full(self.S, -1, np.int32)
        self.cpos = np.full(self.batch_size, -1, np.int32)
        self.halves = np.zeros(self.batch_size, np.int32)
        self.fill = self.nc = self.ns = 0

    def flush(self) -> StencilBatch:
        out = StencilBatch(self.tokens, self.sids, self.cpos, self.halves,
                           self.nc)
        self._fresh()
        return out


class CBOWBatcher:
    """Streams fixed-size CBOW batches over a corpus."""

    def __init__(self, sentences: Sequence[Sequence[int]], vocab: Vocab,
                 window: int, sample: float = -1.0, seed: int = 2008):
        self.vocab = vocab
        self.window = int(window)
        self.sample = float(sample)
        self.rng = np.random.default_rng(seed)
        self.keep_prob = subsample_keep_prob(vocab.counts, sample)
        # pre-map sentences to vocab indices, dropping OOV
        order = np.argsort(vocab.keys, kind="stable")
        sorted_keys = vocab.keys[order]
        V = len(sorted_keys)
        self._sents: List[np.ndarray] = []
        for sent in sentences:
            keys = _as_uint64(sent)
            if keys.size == 0 or V == 0:
                continue
            pos = np.minimum(np.searchsorted(sorted_keys, keys), V - 1)
            hit = sorted_keys[pos] == keys
            if hit.any():
                self._sents.append(order[pos[hit]].astype(np.int32))

    def _sentence_rows(self, sent: np.ndarray, bs: np.ndarray,
                       center_keep: np.ndarray):
        """Every admitted center of one sentence with its context row:
        positions ``pos - half .. pos + half`` inside the sentence, the
        center excluded, in increasing position order, left-packed and
        zero-padded to 2W — the JAX batcher's per-position loop."""
        W = self.window
        L = len(sent)
        offs = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
        half = W - bs.astype(np.int64)
        idx = np.arange(L)[:, None] + offs[None, :]
        mask = ((np.abs(offs)[None, :] <= half[:, None])
                & (idx >= 0) & (idx < L))
        rows = center_keep & mask.any(axis=1)
        if not rows.any():
            return None
        idx, mask = idx[rows], mask[rows]
        vals = np.where(mask, sent[np.clip(idx, 0, L - 1)], 0)
        pack = np.argsort(~mask, axis=1, kind="stable")
        ctx = np.take_along_axis(vals, pack, axis=1).astype(np.int32)
        m = np.take_along_axis(mask, pack, axis=1)
        return sent[rows].astype(np.int32), ctx, m

    def epoch(self, batch_size: int) -> Iterator[CBOWBatch]:
        """One pass over the corpus in a fresh random sentence order.

        Subsampling gates only the *center* position (reference
        word2vec.h:561-562); dropped words still appear in their
        neighbors' context windows."""
        W = self.window
        pend_c: List[np.ndarray] = []
        pend_x: List[np.ndarray] = []
        pend_m: List[np.ndarray] = []
        n_pend = 0
        for si in self.rng.permutation(len(self._sents)):
            sent = self._sents[si]
            bs, center_keep = self._sentence_draws(sent)
            got = self._sentence_rows(sent, bs, center_keep)
            if got is None:
                continue
            pend_c.append(got[0])
            pend_x.append(got[1])
            pend_m.append(got[2])
            n_pend += len(got[0])
            if n_pend < batch_size:
                continue
            c = np.concatenate(pend_c)
            x = np.concatenate(pend_x)
            m = np.concatenate(pend_m)
            lo = 0
            while n_pend - lo >= batch_size:
                hi = lo + batch_size
                yield CBOWBatch(c[lo:hi].copy(), x[lo:hi].copy(),
                                m[lo:hi].copy(), batch_size)
                lo = hi
            pend_c, pend_x, pend_m = [c[lo:]], [x[lo:]], [m[lo:]]
            n_pend -= lo
        if n_pend:
            # pad the tail to the static batch shape with masked rows
            pad = batch_size - n_pend
            c = np.concatenate(pend_c + [np.zeros(pad, np.int32)])
            x = np.concatenate(pend_x + [np.zeros((pad, 2 * W), np.int32)])
            m = np.concatenate(pend_m + [np.zeros((pad, 2 * W), bool)])
            yield CBOWBatch(c, x, m, n_pend)

    def _sentence_draws(self, sent: np.ndarray):
        """One sentence's draws, in the JAX batcher's order: the per-position
        random shrink ``b`` in ``[0, W)`` (word2vec.h:555), then (with
        subsampling) the center keep coins."""
        L = len(sent)
        bs = self.rng.integers(0, self.window, size=L)
        if self.sample >= 0:
            return bs, self.rng.random(L) < self.keep_prob[sent]
        return bs, np.ones(L, bool)

    def epoch_stencil(self, batch_size: int) -> Iterator[StencilBatch]:
        """One pass emitting :class:`StencilBatch` stream spans of fixed
        capacity ``S = batch_size + 2W``; the rng is consumed exactly as
        :meth:`epoch` consumes it.  Every admitted center's full window is
        resident in its span, and a sentence split across batches replays
        its last ``W`` tokens into the new span.

        The JAX batcher admits one position at a time.  Here one sentence
        is cut into segments that fit the current span, and each segment
        is admitted in one vectorized step: a segment ends at the first
        center that finds the batch full or whose window's right edge
        would leave the span — exactly where the per-position loop
        flushes.  Within a segment the appended run ends at the largest
        right edge, which is where the per-position appends end."""
        W = self.window
        S = batch_size + 2 * W
        st = _SpanState(S, batch_size)
        for si in self.rng.permutation(len(self._sents)):
            sent = self._sents[si]
            L = len(sent)
            bs, keep = self._sentence_draws(sent)
            sid = st.ns
            st.ns += 1
            half = W - bs.astype(np.int64)
            pos = np.arange(L)
            right = np.minimum(half, L - 1 - pos)
            adm = np.flatnonzero(keep & (np.minimum(half, pos) + right > 0))
            ends = adm + right[adm]
            p0 = 0          # first sentence position resident in the span
            base = st.fill  # span index of sentence position p0
            have = 0        # sentence positions [p0, p0+have) are resident
            i = 0
            while i < len(adm):
                if have == 0:
                    # nothing resident yet: skip the prefix no window reaches
                    p0 = max(p0, int(adm[i]) - W)
                seg = ends[i:i + batch_size - st.nc]
                over = np.flatnonzero(base + (seg - p0) >= S)
                n = int(over[0]) if over.size else seg.size
                if n:
                    end = int(seg[:n].max())
                    if end - p0 >= have:
                        n_new = end - p0 + 1 - have
                        st.tokens[st.fill:st.fill + n_new] = \
                            sent[p0 + have:end + 1]
                        st.sids[st.fill:st.fill + n_new] = sid
                        st.fill += n_new
                        have += n_new
                    st.cpos[st.nc:st.nc + n] = base + (adm[i:i + n] - p0)
                    st.halves[st.nc:st.nc + n] = half[adm[i:i + n]]
                    st.nc += n
                    i += n
                if i < len(adm):
                    yield st.flush()
                    # resume mid-sentence: replay the left tail so the
                    # next centers keep their left context
                    p = int(adm[i])
                    p0 = max(0, p - W)
                    base = 0
                    have = st.fill = p - p0
                    st.tokens[:have] = sent[p0:p]
                    st.sids[:have] = 0
                    sid, st.ns = 0, 1
        if st.nc:
            yield st.flush()

    def epoch_prefetch(self, batch_size: int, depth: int = 4
                       ) -> Iterator[CBOWBatch]:
        """:meth:`epoch` through a background producer thread
        (``io.pipeline.PrefetchIterator``), ``depth`` batches ahead: the
        same batches in the same order from the same draws, built on the
        host (the thread makes no tensor)."""
        from swiftmpi_tpu_torch.io.pipeline import PrefetchIterator
        return PrefetchIterator(self.epoch(batch_size), depth=depth,
                                name="cbow-epoch-prefetch")

    def epoch_stencil_prefetch(self, batch_size: int, depth: int = 4
                               ) -> Iterator[StencilBatch]:
        """:meth:`epoch_stencil` through the same background producer."""
        from swiftmpi_tpu_torch.io.pipeline import PrefetchIterator
        return PrefetchIterator(self.epoch_stencil(batch_size),
                                depth=depth, name="cbow-stencil-prefetch")


def synthetic_corpus(n_sentences: int, vocab_size: int, length: int = 20,
                     seed: int = 0, zipf: float = 1.2) -> List[List[int]]:
    """Zipf-distributed token streams with local correlation (neighbors
    share a topic), so embeddings have signal to learn."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-zipf)
    p /= p.sum()
    out = []
    for _ in range(n_sentences):
        topic = rng.integers(0, 5)
        base = rng.choice(vocab_size, size=length, p=p)
        # topic words interleaved -> co-occurrence structure
        base[::3] = (topic * 7 + base[::3] // 5) % vocab_size
        out.append([int(x) + 1 for x in base])  # keys are 1-based ints
    return out


def synthetic_corpus_bulk(n_sentences: int, vocab_size: int,
                          length: int = 1000, seed: int = 0,
                          zipf: float = 1.2) -> np.ndarray:
    """Bulk rendering of :func:`synthetic_corpus`'s distribution: one CDF
    and vectorized ``searchsorted`` draws.  Returns an
    ``(n_sentences, length)`` int32 array of 1-based keys."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-zipf))
    cdf /= cdf[-1]
    out = np.empty((n_sentences, length), np.int32)
    # row chunks bound the float64 draw + int64 searchsorted transients
    chunk = max(1, 2_000_000 // max(length, 1))
    for i in range(0, n_sentences, chunk):
        n = min(chunk, n_sentences - i)
        base = np.searchsorted(
            cdf, rng.random((n, length)), side="right")
        topics = rng.integers(0, 5, size=(n, 1))
        base[:, ::3] = (topics * 7 + base[:, ::3] // 5) % vocab_size
        out[i:i + n] = base + 1                  # keys are 1-based ints
    return out


def write_tokens_file(arr, path: str) -> None:
    """Write sentences (rows of keys) as the loader's text format: one
    space-separated sentence per line."""
    rows = arr.tolist() if isinstance(arr, np.ndarray) else arr
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(map(str, row)) + "\n")
