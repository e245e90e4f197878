"""sent2vec: paragraph-vector (PV-DM-style) inference over frozen word
vectors (counterpart of ``swiftmpi_tpu/models/sent2vec.py``).

Re-design of the reference's ``apps/sent2vec/sent2vec.cpp``: load a
trained word2vec table, then for each sentence start a random sentence
vector and run ``niters`` gradient passes that update only that vector;
word gradients are never pushed (``WordMiniBatch::push() = delete``,
sent2vec.cpp:6-12).

Per position (sent2vec.cpp:108-181):
    neu1 = sent_vec + sum of context word v-vectors  (random-shrunk window)
    for target in {center (1), K negatives (0)}:  skip neg == center
        g = (label - sigmoid_clipped(neu1 . h_target)) * alpha
        neu1e += g * h_target
    sent_vec += alpha * neu1e          # alpha applied twice, as in the
                                       # reference (g already carries it)

On the card, as the JAX package's ``lax.scan`` runs it: sentences are
batched ``(S, L)``, the passes and the positions within a pass run in
order, and each position is vectorised over the batch.  The table rows
come from the masked row gather (``kernels.gather``, B2): the context rows
``V_all`` once per batch, with the sentence mask as ``valid`` (the same
function as the JAX package's ``take(max(slots, 0)) * mask``), and the
target rows of a whole pass (the center and its K negatives at every
position, all valid) once per pass: the word table is frozen, so they do
not depend on the sentence vector, and one launch of ``L * S * (K+1)``
rows replaces ``L`` launches of ``S * (K+1)``.  The context sums of a pass
are likewise formed before its position loop (they depend on the pass's
window shrink, not on the sentence vector), so a position is two products
and a few elementwise ops.  Rows are upcast to float32 before any math,
as every pull of the port is.

Draws: each batch draws its initial sentence vectors ``sent0 (S, d)``,
then each pass its window shrink ``b (S, L)`` in ``[0, window)`` and its
negatives as raw alias draws ``(j, u)`` of shape ``(S, L, K)``, from the
model's generator; ``infer_sentences(draws=...)`` replaces them (the
replay seam of the tests: the JAX package's key splits and
``_alias_draw_packed`` give the same quantities).

Sentence ids are the BKDR hash of the raw line (sent2vec.cpp:75); the
output format is ``sent_id\\tv0 v1 ...`` (sent2vec.cpp:82-86).

Serving, as the JAX package serves it: ``infer_sentences(snapshot=...)``
reads h, v and the key->slot map from a published ``TableSnapshot`` of
the word table instead of the live one (its host planes uploaded to the
model's device for the call), so inference can run beside a training
loop at bounded staleness; with ``serve_publisher`` set, the finished
sentence vectors are published as a ``{"sent": ...}`` snapshot keyed by
sentence id, which ``serve.query`` answers nearest-sentence queries
over.  Like the JAX package, the snapshot path reads the tail planes
(``tail_array``) at the snapshot's unified slots, so it holds only for
a table without a hot head (ROADMAP queue C).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from swiftmpi_tpu_torch.convert import tensor_from_numpy
from swiftmpi_tpu_torch.data.text import Vocab, bkdr_hash, tokenize
from swiftmpi_tpu_torch.kernels.gather import masked_gather
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.ops.sampling import (alias_draws, build_unigram_alias,
                                             sample_alias_slots_from_draws)
from swiftmpi_tpu_torch.ops.sigmoid import sigmoid_clipped
from swiftmpi_tpu_torch.utils.config import ConfigParser
from swiftmpi_tpu_torch.utils.logger import get_logger
from swiftmpi_tpu_torch.utils.timers import Error

log = get_logger(__name__)

_M64 = (1 << 64) - 1

#: one batch's draws: ``sent0 (S, d)`` and per pass ``(b, j, u)``
BatchDraws = Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]]]


class Sent2Vec:
    #: batches in flight before the oldest is read back to the host
    MAX_IN_FLIGHT = 16

    def __init__(self, word_model: Word2Vec,
                 config: Optional[ConfigParser] = None, seed: int = 0):
        """``word_model``: a Word2Vec whose table holds the frozen word
        vectors (train it, or ``build_word_model_from_dump``); inference
        runs on its device."""
        self.config = config if config is not None else word_model.config
        g = self.config.get_or
        self.window = g("word2vec", "window", 4).to_int32()
        self.negative = g("word2vec", "negative", 20).to_int32()
        self.alpha = g("word2vec", "learning_rate", 0.05).to_float()
        self.batchsize = g("worker", "minibatch", 256).to_int32()
        self.word_model = word_model
        self.len_vec = word_model.len_vec
        self.device = word_model.device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0xD0C)
        W = self.window
        self._offsets = torch.tensor(
            [o for o in range(-W, W + 1) if o != 0], device=self.device)
        self.error = Error()
        #: a ``SnapshotPublisher`` the sentence vectors are published to
        #: after each ``infer_sentences`` (None: not published)
        self.serve_publisher = None

    def draw(self, S: int, L: int, niters: int) -> BatchDraws:
        """One batch's draws from the model's generator."""
        gen, dev, d = self._gen, self.device, self.len_vec
        V = len(self.word_model.vocab)
        sent0 = (torch.rand((S, d), generator=gen, device=dev) - 0.5) / d
        passes = []
        for _ in range(niters):
            b = torch.randint(0, self.window, (S, L), generator=gen,
                              device=dev)
            passes.append((b, *alias_draws(gen, V, (S, L, self.negative),
                                           dev)))
        return sent0, passes

    def _infer(self, h_table, v_table, word_slots, word_mask, vocab_pos,
               slot_of_vocab, alias_prob, alias_idx, draws: BatchDraws
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(S, d)`` sentence vectors and the last pass's Σ g² (JAX's
        ``errs[-1]``), on the device; ``word_slots``/``vocab_pos`` ``(S,
        L)`` table slots and vocab ids, ``word_mask`` the real words."""
        S, L = word_slots.shape
        K, d, alpha = self.negative, self.len_vec, self.alpha
        dev = word_slots.device
        sv, passes = draws
        sv = sv.to(dev, torch.float32)
        # B2: every context row of the batch, masked rows zero
        v_all = masked_gather(v_table, word_slots.reshape(-1),
                              word_mask.reshape(-1)).float().view(S, L, d)
        ctx_idx = torch.arange(L, device=dev)[:, None] + self._offsets
        ctx_c = ctx_idx.clamp(0, L - 1)                        # (L, 2W)
        ctx_v = v_all[:, ctx_c, :]                             # (S,L,2W,d)
        ctx_ok = ((ctx_idx >= 0) & (ctx_idx < L))[None] & word_mask[:, ctx_c]
        labels = torch.zeros((S, K + 1), device=dev)
        labels[:, 0] = 1.0
        all_valid = torch.ones(L * S * (K + 1), dtype=torch.bool, device=dev)
        gg = torch.zeros((), device=dev)
        for b, j, u in passes:
            negs, neg_slots = sample_alias_slots_from_draws(
                j.to(dev), u.to(dev), alias_prob, alias_idx, slot_of_vocab)
            half = self.window - b.to(dev)                     # (S, L)
            ok = ctx_ok & (self._offsets.abs() <= half[..., None])
            ctx_sum = torch.sum(ctx_v * ok[..., None], dim=2)  # (S, L, d)
            t_slots = torch.cat([word_slots[..., None], neg_slots], dim=2)
            valid = torch.cat([torch.ones((S, L, 1), dtype=torch.bool,
                                          device=dev),
                               negs != vocab_pos[..., None]], dim=2) \
                & word_mask[..., None]                         # (S,L,K+1)
            # B2: the pass's target rows, position-major, all valid
            h_all = masked_gather(
                h_table, t_slots.transpose(0, 1).reshape(-1).contiguous(),
                all_valid).float().view(L, S, K + 1, d)
            gg = torch.zeros((), device=dev)
            for p in range(L):
                neu1 = sv + ctx_sum[:, p]
                h_t = h_all[p]
                f = torch.einsum("sd,skd->sk", neu1, h_t)
                g = torch.where(valid[:, p],
                                (labels - sigmoid_clipped(f)) * alpha, 0.0)
                sv = sv + alpha * torch.einsum("sk,skd->sd", g, h_t)
                gg = gg + torch.sum(g * g)
        return sv, gg

    # -- driver (sent2vec.cpp:37-104) ----------------------------------------
    def infer_sentences(self, lines: List[str], niters: int = 10,
                        tokenize_mode: str = "int", snapshot=None,
                        draws: Optional[Iterator[BatchDraws]] = None
                        ) -> List[Tuple[int, np.ndarray]]:
        """``(bkdr_hash(line), vector)`` for every line with a word in the
        vocab (all-OOV lines are skipped, as the reference skips
        unparseable ones), in line order.  Lines are batched
        ``batchsize`` at a time, padded to ``batchsize`` sentences and to
        a power-of-two length.  ``draws``: one :data:`BatchDraws` per
        batch, replacing the model's generator.  ``snapshot``: a
        ``serve.TableSnapshot`` of the word table, read in place of the
        live table (its ``h`` and ``v`` planes and key->slot map, uploaded
        to the device once for the call).  With ``serve_publisher`` set,
        the vectors are published there at the end."""
        wm = self.word_model
        if wm.vocab is None:
            raise RuntimeError(
                "word model has no vocab; train it in-process or load a "
                "dump via build_word_model_from_dump()")
        dev = self.device
        index = {int(k): i for i, k in enumerate(wm.vocab.keys.tolist())}
        kept: List[Tuple[str, List[int]]] = []
        for ln in lines:
            t = [i for i in (index.get(k & _M64)
                             for k in tokenize(ln, tokenize_mode))
                 if i is not None]
            if t:
                kept.append((ln, t))
        if len(lines) - len(kept):
            log.warning("sent2vec: skipped %d all-OOV sentence(s)",
                        len(lines) - len(kept))
        prob, alias = build_unigram_alias(wm.vocab.counts)
        alias_prob = torch.as_tensor(prob, device=dev)
        alias_idx = torch.as_tensor(alias, dtype=torch.int64, device=dev)
        if snapshot is not None:
            # the published view: host planes uploaded for this call
            h_table, v_table = (tensor_from_numpy(
                np.asarray(snapshot.tail_array(f))).to(dev)
                for f in ("h", "v"))
            slot_np = snapshot.lookup(wm.vocab.keys).astype(np.int32)
            slot_of_vocab = torch.as_tensor(slot_np, device=dev)
        else:
            slot_of_vocab = wm._slot_of_vocab
            slot_np = slot_of_vocab.cpu().numpy()
            # global slot order (a sharded table's shards concatenated)
            h_table, v_table = (wm.table.global_rows(f)
                                for f in ("h", "v"))
        queued: list = []
        out: List[Tuple[int, np.ndarray]] = []

        def drain_one():
            chunk, vecs, err = queued.pop(0)
            self.error.accu(float(err), len(chunk))
            vecs = vecs.cpu().numpy()
            for i, (ln, _) in enumerate(chunk):
                out.append((bkdr_hash(ln), vecs[i]))

        S = self.batchsize         # pad the tail: one shape per L
        for start in range(0, len(kept), S):
            chunk = kept[start:start + S]
            max_len = max(len(t) for _, t in chunk)
            L = 1 << (max_len - 1).bit_length()  # bucket to a power of two
            vocab_pos = np.zeros((S, L), np.int64)
            mask = np.zeros((S, L), bool)
            for i, (_, t) in enumerate(chunk):
                vocab_pos[i, :len(t)] = t
                mask[i, :len(t)] = True
            batch_draws = (self.draw(S, L, niters) if draws is None
                           else _as_draws(next(draws), dev))
            vecs, err = self._infer(
                h_table, v_table,
                torch.as_tensor(slot_np[vocab_pos], device=dev),
                torch.as_tensor(mask, device=dev),
                torch.as_tensor(vocab_pos, device=dev), slot_of_vocab,
                alias_prob, alias_idx, batch_draws)
            queued.append((chunk, vecs, err))
            while len(queued) >= self.MAX_IN_FLIGHT:
                drain_one()
        while queued:
            drain_one()
        log.info("sent2vec: %d sentences, error %.5f", len(out),
                 self.error.norm())
        if self.serve_publisher is not None and out:
            # the sentence vectors as a snapshot keyed by sentence id:
            # serve.query answers nearest-sentence queries over it
            self.serve_publisher.publish(
                {"sent": np.stack([v for _, v in out])},
                keys=np.array([sid for sid, _ in out], np.uint64),
                slots=np.arange(len(out), dtype=np.int64),
                meta={"query_field": "sent"})
        return out

    def write(self, results, path: str) -> None:
        """``sent_id\\tv0 v1 ...`` lines (sent2vec.cpp:82-86), each value
        as Python's ``repr`` of the float, as the JAX package writes
        them."""
        with open(path, "w") as f:
            for sid, vec in results:
                f.write(f"{sid}\t" + " ".join(repr(float(x)) for x in vec)
                        + "\n")


def _as_draws(d, device) -> BatchDraws:
    """Replayed draws (numpy or tensors) as tensors on ``device``."""
    def t(x, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))     # a writable copy
        return x.to(device, dtype)
    sent0, passes = d
    return (t(sent0, torch.float32),
            [(t(b, torch.int64), t(j, torch.int64), t(u, torch.float32))
             for b, j, u in passes])


def build_word_model_from_dump(dump_path: str, config: ConfigParser,
                               capacity_per_shard: int = 1 << 16,
                               device=None) -> Word2Vec:
    """Load a word2vec text dump (either package's ``save``) as the frozen
    word table, growing the table when the dump outgrows
    ``capacity_per_shard``, and rebuild the vocab sent2vec needs: the
    dump's keys in its order, counts 1 (the dump, like the reference's,
    carries no frequencies, so negatives over a loaded dump are drawn
    uniformly)."""
    model = Word2Vec(config=config, capacity_per_shard=capacity_per_shard,
                     device=device)
    model.load(dump_path)
    ki = model.table.key_index
    keys = np.fromiter(ki.keys(), np.uint64, len(ki))
    model.vocab = Vocab(keys, np.ones(len(keys), np.int64))
    model._slot_of_vocab = torch.as_tensor(ki.lookup(keys), dtype=torch.int32,
                                           device=model.device)
    return model
