"""Sequential numpy oracle of the reference word2vec CBOW+NS training loop
(counterpart of ``swiftmpi_tpu/testing/w2v_oracle.py``, line for line).

A faithful single-threaded re-statement of the reference's sync variant —
the actual ``learn_instance`` hot loop plus everything around it that
shapes the numbers:

* word2vec-C LCG sampling streams (the reference's
  ``src/utils/random.h:25-42``) via ``swiftmpi_tpu_torch.utils.rng.Random`` — window shrink
  ``b = lcg() % window``, negative draws ``table[(lcg() >> 16) %
  table_size]`` with the key-0 single redraw quirk, subsampling coin flips
  on the separate float LCG (word2vec.h:566,577-586,621-630);
* the precomputed-sigmoid ExpTable with hard clipping at ±MAX_EXP
  (word2vec.h:237-267,591-598), bucket quantization included;
* the per-batch regenerated unigram^0.75 negative-sampling table over the
  *batch* word frequencies in ascending-key order (word2vec.h:303-311,
  398-425);
* per-key gradient mean-normalization at push serialization
  (``grad /= count``, word2vec.h:120-132);
* server-side per-element AdaGrad with fudge 1e-6, one apply per key per
  push (word2vec.h:167-191);
* the reference's error metric ``accu(1e4·g²)`` per evaluated target and
  its per-iteration ``norm()`` (word2vec.h:442-457,593);
* batch chunking of ``minibatch+1`` lines (the ``line_count > batchsize``
  post-increment break, word2vec.h:367-368,527) and cumulative
  ``num_words`` across batches (``clear()`` never resets it,
  word2vec.h:384-395 — a real quirk the subsampling probabilities see).

This is a *behavioral* port for parity testing, not a translation: the
reference is multithreaded C++ over an RPC parameter server; this is ~150
lines of vectorized-where-possible numpy with a single deterministic
sequential order (the reference's own order with ``nthreads=1``).

Known deliberate deviations, each invisible to loss-parity tolerance:
* row init uses numpy uniform, not C ``rand()`` (unseedable from here);
  same ``(U(0,1)-0.5)/len`` distribution (vec1.h:229-232);
* ``table_size`` defaults to 1e6 instead of 1e8 (word2vec.h:8) — the
  sampling distribution is quantized at 1e-6 instead of 1e-8.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from swiftmpi_tpu_torch.utils.rng import Random

EXP_TABLE_SIZE = 1000
MAX_EXP = 6.0

_EXP_TABLE: Optional[np.ndarray] = None


def _table() -> np.ndarray:
    global _EXP_TABLE
    if _EXP_TABLE is None:
        i = np.arange(EXP_TABLE_SIZE, dtype=np.float64)
        t = np.exp((i / EXP_TABLE_SIZE * 2.0 - 1.0) * MAX_EXP)
        _EXP_TABLE = (t / (t + 1.0)).astype(np.float32)
    return _EXP_TABLE


def exp_table_sigmoid(f: float) -> float:
    """The reference's bucketed sigmoid for |f| < MAX_EXP
    (word2vec.h:256)."""
    idx = int((f + MAX_EXP) * (EXP_TABLE_SIZE / MAX_EXP / 2.0))
    return float(_table()[idx])


def _g(f: float, label: int, alpha: float, quantized: bool) -> float:
    """(label - sigmoid_clipped(f)) * alpha with the reference's branch
    structure (word2vec.h:591-598)."""
    if f > MAX_EXP:
        return (label - 1.0) * alpha
    if f < -MAX_EXP:
        return float(label) * alpha
    s = exp_table_sigmoid(f) if quantized else 1.0 / (1.0 + np.exp(-f))
    return (label - s) * alpha


def gen_unigram_table(word_freq: Dict[int, int],
                      table_size: int = 1_000_000) -> np.ndarray:
    """The reference's per-batch negative-sampling table
    (word2vec.h:398-425): words in ascending key order (std::map), table
    cell i holds the word whose cumulative freq^0.75 share covers
    i/table_size, with the reference's assign-then-advance order."""
    wordids = np.array(sorted(word_freq), dtype=np.int64)
    pow_ = np.array([word_freq[int(w)] for w in wordids],
                    np.float64) ** 0.75
    cum = np.cumsum(pow_ / pow_.sum())
    # table[a] = wordids[i(a)] where i(a) = #{j : cum[j] < a/table_size},
    # exactly the loop's post-assignment `if (a/ts > d1) i++` advance
    a_frac = np.arange(table_size, dtype=np.float64) / table_size
    idx = np.searchsorted(cum, a_frac, side="left")
    return wordids[np.minimum(idx, len(wordids) - 1)]


def cbow_batch_grads(h: np.ndarray, v: np.ndarray,
                     centers: Sequence[int],
                     contexts: np.ndarray, ctx_mask: np.ndarray,
                     negatives: np.ndarray, alpha: float,
                     quantized_sigmoid: bool = True):
    """One minibatch of the reference CBOW-NS gradient math
    (word2vec.h:550-615) with *explicit* inputs — windows and negatives
    are taken as given so a test can feed both implementations identical
    randomness.

    ``h``, ``v``: (V, d) rows indexed by word id.  ``contexts``/``ctx_mask``:
    (B, C) padded context ids.  ``negatives``: (B, K).  Returns
    (mean-normalized dense h-grads, v-grads, err_sum, err_cnt) — exactly
    what one push carries (word2vec.h:120-132).
    """
    V, d = h.shape
    gh = np.zeros((V, d), np.float32)
    gv = np.zeros((V, d), np.float32)
    ch = np.zeros(V, np.int64)
    cv = np.zeros(V, np.int64)
    err_sum, err_cnt = 0.0, 0
    for i, center in enumerate(centers):
        ctx = contexts[i][ctx_mask[i]]
        if ctx.size == 0:
            continue
        neu1 = v[ctx].astype(np.float64).sum(axis=0)
        neu1e = np.zeros(d, np.float64)
        targets = [(int(center), 1)] + [(int(n), 0) for n in negatives[i]]
        for target, label in targets:
            if label == 0 and target == int(center):
                continue                      # word2vec.h:584-586
            f = float(neu1 @ h[target])
            g = _g(f, label, alpha, quantized_sigmoid)
            err_sum += 1e4 * g * g            # word2vec.h:593
            err_cnt += 1
            neu1e += g * h[target]
            gh[target] += (g * neu1).astype(np.float32)
            ch[target] += 1
        for c in ctx:
            gv[c] += neu1e.astype(np.float32)
            cv[c] += 1
    # push-time mean normalization (word2vec.h:120-132)
    nz = ch > 0
    gh[nz] /= ch[nz, None]
    nz = cv > 0
    gv[nz] /= cv[nz, None]
    return gh, gv, err_sum, err_cnt


class W2VOracle:
    """End-to-end sequential trainer with the reference's full batch
    lifecycle: gather → pull (regen unigram table) → learn → push
    (mean-normalize + server AdaGrad)."""

    def __init__(self, len_vec: int, window: int, negative: int,
                 alpha: float, server_lr: float, sample: float = -1.0,
                 minibatch_lines: int = 50, table_size: int = 1_000_000,
                 fudge: float = 1e-6, seed: int = 2008,
                 init_seed: int = 0):
        self.len_vec, self.window, self.negative = len_vec, window, negative
        self.alpha, self.server_lr, self.sample = alpha, server_lr, sample
        self.minibatch_lines = minibatch_lines
        self.table_size = table_size
        self.fudge = fudge
        self.lcg = Random(seed)
        self._init_rng = np.random.RandomState(init_seed)
        # lazily-initialized rows, keyed by word id (WParam ctor,
        # word2vec.h:38-45: random h/v, zero squared-grad sums)
        self.h: Dict[int, np.ndarray] = {}
        self.v: Dict[int, np.ndarray] = {}
        self.h2sum: Dict[int, np.ndarray] = {}
        self.v2sum: Dict[int, np.ndarray] = {}
        self.num_words = 0      # cumulative across batches (quirk)

    def _ensure(self, word: int) -> None:
        if word not in self.h:
            d = self.len_vec
            self.h[word] = ((self._init_rng.rand(d) - 0.5) / d
                            ).astype(np.float32)
            self.v[word] = ((self._init_rng.rand(d) - 0.5) / d
                            ).astype(np.float32)
            self.h2sum[word] = np.zeros(d, np.float32)
            self.v2sum[word] = np.zeros(d, np.float32)

    def _to_sample(self, word: int, word_freq: Dict[int, int]) -> bool:
        """Subsampling keep decision (word2vec.h:621-630): freq relative
        to the cumulative num_words, float-LCG coin."""
        if self.sample < 0:
            return True
        freq = word_freq[word] / self.num_words
        ran = 1.0 - np.sqrt(self.sample / freq)
        return self.lcg.gen_float() > ran

    def train(self, sentences: List[List[int]], niters: int = 1
              ) -> List[float]:
        """Returns per-iteration mean error (Error::norm,
        word2vec.h:491)."""
        losses = []
        for _ in range(niters):
            err_sum, err_cnt = 0.0, 0
            # batches of minibatch+1 lines: the reference's post-increment
            # `line_count > batchsize` break processes one extra line
            step = self.minibatch_lines + 1
            for start in range(0, len(sentences), step):
                chunk = sentences[start:start + step]
                es, ec = self._train_batch(chunk)
                err_sum += es
                err_cnt += ec
            losses.append(err_sum / max(err_cnt, 1))
        return losses

    def _train_batch(self, chunk: List[List[int]]) -> Tuple[float, int]:
        # gather_keys: batch word frequencies; num_words accumulates
        # across the whole run (clear() never resets it)
        word_freq: Dict[int, int] = {}
        for sent in chunk:
            for w in sent:
                word_freq[w] = word_freq.get(w, 0) + 1
                self.num_words += 1
        if len(word_freq) < 5:                # word2vec.h:528 guard
            return 0.0, 0
        for w in word_freq:
            self._ensure(w)                   # lazy init at pull
        table = gen_unigram_table(word_freq, self.table_size)
        # pulled snapshot: grads are computed against pull-time values,
        # updates land only at push (param cache semantics)
        h_snap = {w: self.h[w].copy() for w in word_freq}
        v_snap = {w: self.v[w].copy() for w in word_freq}
        gh: Dict[int, np.ndarray] = {}
        gv: Dict[int, np.ndarray] = {}
        ch: Dict[int, int] = {}
        cv: Dict[int, int] = {}
        err_sum, err_cnt = 0.0, 0

        for sent in chunk:
            L = len(sent)
            for pos in range(L):
                word = sent[pos]
                if not self._to_sample(word, word_freq):
                    continue
                b = self.lcg() % self.window   # word2vec.h:566
                neu1 = np.zeros(self.len_vec, np.float64)
                ctx: List[int] = []
                for a in range(b, self.window * 2 + 1 - b):
                    if a == self.window:
                        continue
                    c = pos - self.window + a
                    if 0 <= c < L:
                        ctx.append(sent[c])
                        neu1 += v_snap[sent[c]]
                neu1e = np.zeros(self.len_vec, np.float64)
                for dd in range(self.negative + 1):
                    if dd == 0:
                        target, label = word, 1
                    else:
                        target = int(
                            table[(self.lcg() >> 16) % self.table_size])
                        if target == 0:       # single redraw quirk
                            target = int(
                                table[(self.lcg() >> 16) % self.table_size])
                        if target == word:
                            continue
                        label = 0
                    f = float(neu1 @ h_snap[target])
                    g = _g(f, label, self.alpha, quantized=True)
                    err_sum += 1e4 * g * g
                    err_cnt += 1
                    neu1e += g * h_snap[target]
                    if target not in gh:
                        gh[target] = np.zeros(self.len_vec, np.float64)
                        ch[target] = 0
                    gh[target] += g * neu1
                    ch[target] += 1
                for c in ctx:
                    if c not in gv:
                        gv[c] = np.zeros(self.len_vec, np.float64)
                        cv[c] = 0
                    gv[c] += neu1e
                    cv[c] += 1

        # push: mean-normalize then server AdaGrad, one apply per key
        for w, grad in gh.items():
            self._adagrad(self.h, self.h2sum, w,
                          (grad / ch[w]).astype(np.float32))
        for w, grad in gv.items():
            self._adagrad(self.v, self.v2sum, w,
                          (grad / cv[w]).astype(np.float32))
        return err_sum, err_cnt

    def _adagrad(self, params, sqsums, w: int, grad: np.ndarray) -> None:
        """word2vec.h:177-185: accum += g²; p += lr·g/sqrt(accum+fudge)
        — gradient *ascent*, accumulator updated first."""
        sqsums[w] = sqsums[w] + grad * grad
        params[w] = params[w] + (
            self.server_lr * grad / np.sqrt(sqsums[w] + self.fudge)
        ).astype(np.float32)
