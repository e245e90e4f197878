"""word2vec CBOW + negative sampling, sync variant, on one device
(counterpart of ``swiftmpi_tpu/models/word2vec.py``, gather rendering).

Reference hot loop (word2vec.h:550-615), per center word:
    b = rand % window;  context = +-(window-b) neighbors
    neu1 = sum of context input vectors v              (CBOW, raw sum)
    for target in {center (label 1), K negatives (label 0)}:
        skip negative if target == center
        f = neu1 . h_target
        g = (label - sigmoid_clipped(f)) * alpha       (ExpTable clip)
        error += 10000 * g^2
        h_grad[target] += g * neu1 ; neu1e += g * h_target
    v_grad[context_j] += neu1e  for each context word

One minibatch of that loop is one :meth:`Word2Vec.step`: two pulls (h at
the B*(K+1) target slots, v at the B*2W context slots) through the gather
kernel, the CBOW-NS math in plain torch, and two pushes (h by target
slot, v by context slot, both mean-normalized per slot) through the
transfer's dense or sparse apply.  The table tensors are updated in place,
the counterpart of the JAX step donating its state.  ``step`` takes the
negative-sampling draws ``(j, u)`` as an optional argument: the seam the
parity tests replay the JAX package's draws through.

Configurations the slice does not cover raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from swiftmpi_tpu_torch.data.text import (CBOWBatcher, Vocab, build_vocab,
                                          load_corpus)
from swiftmpi_tpu_torch.device import resolve_device
from swiftmpi_tpu_torch.io.checkpoint import dump_table_text
from swiftmpi_tpu_torch.ops.sampling import (alias_draws,
                                             build_unigram_alias,
                                             sample_alias_slots_from_draws)
from swiftmpi_tpu_torch.ops.sigmoid import sigmoid_clipped
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.transfer import PushSpec, get_transfer
from swiftmpi_tpu_torch.utils.config import ConfigParser, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

Draws = Tuple[torch.Tensor, torch.Tensor]

#: config sections the slice does not port at all -> ROADMAP item
_UNPORTED_SECTIONS = {"obs": "A14", "control": "A13", "serve": "A13"}


def _on(x, device, dtype) -> torch.Tensor:
    """Batch array (numpy or tensor) -> contiguous ``dtype`` tensor on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(device=device, dtype=dtype).contiguous()


def _cbow_targets(slot_of_vocab, alias_prob, alias_idx, centers, contexts,
                  ctx_mask, draws: Draws):
    """Target/context slot matrices and validity masks of a CBOW batch
    (JAX ``_cbow_targets``), with the negatives resolved from the draws
    ``(j, u)``."""
    B = centers.shape[0]
    j, u = draws
    negs, neg_slots = sample_alias_slots_from_draws(
        j, u, alias_prob, alias_idx, slot_of_vocab)
    t_slots = torch.cat([slot_of_vocab[centers][:, None], neg_slots],
                        dim=1)                                  # (B, K+1)
    ctx_slots = torch.where(ctx_mask, slot_of_vocab[contexts], -1)
    row_valid = ctx_mask.any(dim=1)
    # negative == center is skipped (word2vec.h:584-586)
    t_valid = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                    device=centers.device),
                         negs != centers[:, None]], dim=1)
    t_valid = t_valid & row_valid[:, None]
    return t_slots, ctx_slots, t_valid


def _assemble_push(tf, cf, h_flat, v_flat):
    """One push per gradient family: h-grads keyed by target slots,
    v-grads keyed by context slots, both ``mean=True`` (the reference's
    per-key grad/count normalization, word2vec.h:120-132)."""
    return (PushSpec(tf, {"h": h_flat}, mean=True),
            PushSpec(cf, {"v": v_flat}, mean=True))


def w2v_formatter(row: Dict[str, np.ndarray]) -> str:
    """Reference WParam operator<< layout: v-vector TAB h-vector
    (word2vec.h:100-110)."""
    v = " ".join(repr(float(x)) for x in row["v"])
    h = " ".join(repr(float(x)) for x in row["h"])
    return f"{v}\t{h}"


def w2v_parser(text: str) -> Dict[str, np.ndarray]:
    v_s, _, h_s = text.partition("\t")
    return {"v": np.array([float(x) for x in v_s.split()], np.float32),
            "h": np.array([float(x) for x in h_s.split()], np.float32)}


class Word2Vec:
    def __init__(self, config: Optional[ConfigParser] = None, device=None,
                 capacity_per_shard: Optional[int] = None, seed: int = 0):
        self.config = config if config is not None else global_config()
        g = self.config.get_or
        self.len_vec = g("word2vec", "len_vec", 100).to_int32()
        self.window = g("word2vec", "window", 4).to_int32()
        self.negative = g("word2vec", "negative", 20).to_int32()
        self.sample = g("word2vec", "sample", -1.0).to_float()
        self.alpha = g("word2vec", "learning_rate", 0.05).to_float()
        self.min_sentence_length = g(
            "word2vec", "min_sentence_length", 1).to_int32()
        self.minibatch = g("worker", "minibatch", 5000).to_int32()
        server_lr = g("server", "initial_learning_rate", 0.7).to_float()
        self._check_supported()
        self.device = resolve_device(device)
        self.access = w2v_access(server_lr, self.len_vec)
        self.transfer = get_transfer(
            g("cluster", "transfer", "xla").to_string())
        self._capacity_per_shard = capacity_per_shard
        self.table: Optional[SparseTable] = None
        self.vocab: Optional[Vocab] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)
        self.train_metrics: dict = {}

    def _check_supported(self) -> None:
        """Raise on every configuration the slice does not port.
        ``[worker] inner_steps: N`` is not one: the JAX package's N fused
        steps are N ordinary steps one after another, the same math."""
        g = self.config.get_or
        refuse = []

        def want(cond, what, item):
            if cond:
                refuse.append(f"{what} (ROADMAP {item})")

        want(g("word2vec", "stencil", 0).to_int32() != 0,
             "[word2vec] stencil", "A7")
        want(g("word2vec", "sg", 0).to_int32() != 0, "[word2vec] sg", "A8")
        want(g("word2vec", "shared_negatives", 0).to_int32() != 0,
             "[word2vec] shared_negatives", "A8")
        want(g("word2vec", "dense_logits", "auto").to_string() == "1",
             "[word2vec] dense_logits: 1", "A8")
        want(g("word2vec", "local_steps", 1).to_int32() > 1,
             "[word2vec] local_steps > 1", "A8")
        want(g("word2vec", "async_mode", "").to_string() == "hogwild",
             "[word2vec] async_mode: hogwild", "A8")
        want(g("cluster", "push_window", 1).to_int32() > 1,
             "[cluster] push_window > 1", "A12")
        for key in ("wire_quant", "pull_quant"):
            want(g("cluster", key, "off").to_string() != "off",
                 f"[cluster] {key}", "A12")
        want(g("cluster", "pull_cache", 0).to_int32() != 0,
             "[cluster] pull_cache", "A12")
        want(g("cluster", "wire_sketch", 0).to_int32() != 0,
             "[cluster] wire_sketch", "A12")
        want(g("cluster", "collective", "psum").to_string() != "psum",
             "[cluster] collective other than psum", "A12")
        want(g("cluster", "server_num", 1).to_int32() != 1,
             "[cluster] server_num > 1", "A11")
        want(g("server", "dtype", "float32").to_string() != "float32",
             "[server] dtype other than float32", "bf16 tables for B1/B2")
        want(g("worker", "pipeline", 0).to_int32() != 0,
             "[worker] pipeline", "A9")
        want(g("worker", "telemetry", 0).to_int32() != 0,
             "[worker] telemetry", "A14")
        for sec, item in _UNPORTED_SECTIONS.items():
            want(bool(self.config.section(sec)), f"[{sec}]", item)
        if refuse:
            raise NotImplementedError(
                "not ported in this slice: " + "; ".join(refuse))

    # -- vocab / table bring-up -------------------------------------------
    def build(self, sentences) -> "Word2Vec":
        return self.build_from_vocab(build_vocab(sentences))

    def build_from_vocab(self, vocab: Vocab) -> "Word2Vec":
        """Table and sampler from a prebuilt vocab."""
        self.vocab = vocab
        V = len(vocab)
        if V == 0:
            raise ValueError(
                "empty vocabulary — no sentence survived loading; check the "
                "corpus and [word2vec] min_sentence_length")
        if self.table is None:
            cap = self._capacity_per_shard or max(64, int(V * 1.3) + 1)
            self.table = SparseTable(self.access, KeyIndex(1, cap),
                                     self.device, seed=0)
        slots = self.table.key_index.lookup(vocab.keys)
        self._slot_of_vocab = torch.as_tensor(slots, dtype=torch.int32,
                                              device=self.device)
        prob, alias = build_unigram_alias(vocab.counts)
        self._alias_prob = torch.as_tensor(prob, device=self.device)
        self._alias_idx = torch.as_tensor(alias, dtype=torch.int64,
                                          device=self.device)
        log.info("vocab: %d words, %d tokens; table capacity %d on %s",
                 V, vocab.total_words, self.table.capacity, self.device)
        return self

    # -- the step ------------------------------------------------------------
    def _grads(self, state, centers, contexts, ctx_mask, draws: Draws):
        """Gradient phase (JAX ``_build_grads``, gather rendering): pull
        rows, CBOW-NS math, one push spec per family — no push."""
        B, W2 = contexts.shape
        K, d = self.negative, self.len_vec
        t_slots, ctx_slots, t_valid = _cbow_targets(
            self._slot_of_vocab, self._alias_prob, self._alias_idx,
            centers, contexts, ctx_mask, draws)
        t_slots = torch.where(t_valid, t_slots, -1)
        # split pulls: targets need only h, contexts only v
        h_t = self.transfer.pull(
            state, t_slots.reshape(-1), self.access, fields=("h",)
        )["h"].reshape(B, K + 1, d)
        v_ctx = self.transfer.pull(
            state, ctx_slots.reshape(-1), self.access, fields=("v",)
        )["v"].reshape(B, W2, d)

        neu1 = torch.sum(v_ctx * ctx_mask[..., None], dim=1)     # (B, d)
        f = torch.einsum("bd,bkd->bk", neu1, h_t)
        labels = torch.zeros((B, K + 1), dtype=torch.float32,
                             device=f.device)
        labels[:, 0] = 1.0
        g = (labels - sigmoid_clipped(f)) * self.alpha
        g = torch.where(t_valid, g, 0.0)                         # (B, K+1)

        h_contrib = g[..., None] * neu1[:, None, :]              # (B,K+1,d)
        neu1e = torch.einsum("bk,bkd->bd", g, h_t)               # (B, d)
        v_contrib = torch.where(ctx_mask[..., None], neu1e[:, None, :],
                                0.0)                             # (B,2W,d)
        pushes = _assemble_push(
            t_slots.reshape(-1), ctx_slots.reshape(-1),
            h_contrib.reshape(-1, d), v_contrib.reshape(-1, d))
        err_sum = torch.sum(1e4 * g * g)          # word2vec.h:593
        err_cnt = t_valid.sum()
        return pushes, err_sum, err_cnt

    def _apply(self, state, pushes):
        """Apply phase (JAX ``_build_apply``): every family through the
        transfer's push, in place on ``state``."""
        for spec in pushes:
            state = self.transfer.push(state, spec.slots, spec.grads,
                                       self.access, mean=spec.mean)
        return state

    def _draws(self, B: int) -> Draws:
        return alias_draws(self._gen, len(self.vocab), (B, self.negative),
                           self.device)

    def step(self, centers, contexts, ctx_mask,
             draws: Optional[Draws] = None) -> Tuple[float, int]:
        """One sync training step on one batch (vocab indices, numpy or
        tensors); ``draws`` replaces the model's own ``(j, u)`` alias
        draws.  Updates the table in place; returns ``(err_sum,
        err_cnt)`` as host numbers."""
        dev = self.device
        # int64 once per batch: torch indexing wants it (kernels get int32)
        centers = _on(centers, dev, torch.int64)
        contexts = _on(contexts, dev, torch.int64)
        ctx_mask = _on(ctx_mask, dev, torch.bool)
        if draws is None:
            draws = self._draws(centers.shape[0])
        else:
            draws = (_on(draws[0], dev, torch.int64),
                     _on(draws[1], dev, torch.float32))
        state = self.table.state
        pushes, es, ec = self._grads(state, centers, contexts, ctx_mask,
                                     draws)
        self._apply(state, pushes)
        es, ec = torch.stack([es.double(), ec.double()]).tolist()
        return es, int(round(ec))

    # -- training (word2vec.h:475-547) ---------------------------------------
    def train(self, data=None, niters: int = 1,
              batch_size: Optional[int] = None, batcher=None,
              draws: Optional[Iterator] = None) -> List[float]:
        """``data``: corpus path or list of key-list sentences.  Returns
        the per-iteration mean error Σerr_sum / Σerr_cnt (reference
        Error::norm per train_iter).  ``batcher``: a custom batch source
        with an ``epoch(batch_size)`` iterator.  ``draws``: an iterator of
        ``(j, u)`` pairs, one per step, replacing the model's generator.

        The loss sums stay on the host as Python numbers, one read per
        step, so a long run never wraps a device counter."""
        if batcher is None:
            if isinstance(data, str):
                data = load_corpus(data, min_sentence_length=max(
                    self.min_sentence_length, 1))
            if data is None:
                raise ValueError("train() needs data or a batcher")
            if self.vocab is None:
                self.build(data)
            batcher = CBOWBatcher(data, self.vocab, self.window,
                                  self.sample, seed=2008)
        elif self.vocab is None:
            if not hasattr(batcher, "vocab"):
                raise RuntimeError(
                    "call build()/build_from_vocab() before train() with a "
                    "vocab-less batcher")
            self.build_from_vocab(batcher.vocab)
        batch_size = batch_size or max(
            256, self.minibatch // (2 * self.window))
        losses = []
        words = steps = 0
        host_s = 0.0
        t0 = time.perf_counter()
        for it in range(niters):
            err_sum, err_cnt = 0.0, 0
            epoch = iter(batcher.epoch(batch_size))
            while True:
                th = time.perf_counter()
                batch = next(epoch, None)
                host_s += time.perf_counter() - th
                if batch is None:
                    break
                es, ec = self.step(
                    batch.centers, batch.contexts, batch.ctx_mask,
                    draws=None if draws is None else next(draws))
                err_sum += es
                err_cnt += ec
                words += batch.n_words
                steps += 1
            loss = err_sum / max(err_cnt, 1)
            losses.append(loss)
            elapsed = time.perf_counter() - t0
            log.info("iter %d: error %.5f  (%.0f words/s)", it, loss,
                     words / max(elapsed, 1e-9))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.train_metrics = {
            "steps": steps, "words": words, "seconds": seconds,
            "batcher_seconds": host_s,
            "steps_per_sec": steps / max(seconds, 1e-9),
            "words_per_sec": words / max(seconds, 1e-9),
            "push_paths": dict(self.transfer.push_paths)}
        return losses

    # -- embeddings out --------------------------------------------------------
    def save(self, path: str) -> int:
        # reference WParam layout: v TAB h (word2vec.h:100-110)
        return dump_table_text(self.table, path, w2v_formatter)
