"""word2vec CBOW + negative sampling, sync variant (counterpart of
``swiftmpi_tpu/models/word2vec.py``), on one device (``transfer: xla``)
or over the n ranks of the sharded parameter server (``transfer: tpu``,
``server_num: n``).

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

One minibatch of that loop is one step, rendered one of four ways, as the
JAX package resolves them (``resolved_rendering``):

* ``gather`` (default): two pulls (h at the B*(K+1) target slots, v at
  the B*2W context slots) through the gather kernel and two pushes (h by
  target slot, v by context slot, both mean-normalized per slot) through
  the transfer's dense or sparse apply.
* ``shared`` (``shared_negatives: 1``): one pool of ``shared_pool``
  negatives for the whole batch; the negative phase is three matrix
  products and the pool rows push as their own sum family.
* ``stencil`` (``stencil: 1``): the batch is a stream span; neu1 comes
  from the stencil context-sum kernel over the span's rows (one launch
  from the batch's own arrays), and the v gradient folds onto span
  positions and pushes through ``push_span``.
* ``stencil_shared``: the stencil context side with the shared pool.

With ``transfer: tpu`` (gather and shared renderings only, as in the
JAX package) the step's arithmetic still runs once over the whole batch,
as the jitted JAX step does over global arrays; only the pulls and pushes
are per rank, routed by ``transfer/sharded.py``.

``[server] dtype: bfloat16`` stores the embedding fields h and v in
bfloat16, as the JAX package does: every pull is upcast to float32
before any math, the gradients and the AdaGrad accumulators stay float32,
and the update rounds once on store.

The table tensors are updated in place, the counterpart of the JAX step
donating its state.  Each step takes the negative-sampling draws ``(j,
u)`` as an optional argument: the seam the parity tests replay the JAX
package's draws through.  Configurations not ported raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.data.text import (CBOWBatch, CBOWBatcher,
                                          StencilBatch, Vocab, build_vocab,
                                          load_corpus)
from swiftmpi_tpu_torch.device import resolve_device
from swiftmpi_tpu_torch.io.checkpoint import dump_table_text
from swiftmpi_tpu_torch.kernels.stencil import stencil_context_sum
from swiftmpi_tpu_torch.ops.sampling import (alias_draws,
                                             build_unigram_alias,
                                             sample_alias_from_draws,
                                             sample_alias_slots_from_draws)
from swiftmpi_tpu_torch.ops.sigmoid import sigmoid_clipped
from swiftmpi_tpu_torch.parameter import SparseTable, w2v_access
from swiftmpi_tpu_torch.transfer import PushSpec
from swiftmpi_tpu_torch.utils.config import ConfigParser, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

Draws = Tuple[torch.Tensor, torch.Tensor]

#: config sections the slice does not port at all -> ROADMAP item
_UNPORTED_SECTIONS = {"obs": "A14", "control": "A13", "serve": "A13"}

#: ``[server] dtype`` -> the embedding fields' dtype
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _on(x, device, dtype) -> torch.Tensor:
    """Batch array (numpy or tensor) -> contiguous ``dtype`` tensor on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(device=device, dtype=dtype).contiguous()


def _parity_targets(slot_of_vocab, alias_prob, alias_idx, centers, c_slots,
                    row_valid, draws: Draws):
    """Target slots ``(B, K+1)`` — the center, then K negatives resolved
    from the draws ``(j, u)`` — and their validity: a negative equal to
    its center is skipped (word2vec.h:584-586), and a row without context
    is dead."""
    B = centers.shape[0]
    negs, neg_slots = sample_alias_slots_from_draws(
        draws[0], draws[1], alias_prob, alias_idx, slot_of_vocab)
    t_slots = torch.cat([c_slots[:, None], neg_slots], dim=1)
    t_valid = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                    device=centers.device),
                         negs != centers[:, None]], dim=1)
    return t_slots, t_valid & row_valid[:, None]


def _cbow_targets(slot_of_vocab, alias_prob, alias_idx, centers, contexts,
                  ctx_mask, draws: Draws):
    """Target/context slot matrices and validity masks of a CBOW batch
    (JAX ``_cbow_targets``), with the negatives resolved from the draws
    ``(j, u)``."""
    ctx_slots = torch.where(ctx_mask, slot_of_vocab[contexts], -1)
    t_slots, t_valid = _parity_targets(
        slot_of_vocab, alias_prob, alias_idx, centers,
        slot_of_vocab[centers], ctx_mask.any(dim=1), draws)
    return t_slots, ctx_slots, t_valid


def _parity_ns(neu1, h_t, t_valid, alpha):
    """Per-center negative sampling (labels: the center 1, negatives 0):
    ``(g, h_contrib, neu1e)`` with dead targets' ``g`` zeroed."""
    B, K1 = t_valid.shape
    f = torch.einsum("bd,bkd->bk", neu1, h_t)
    labels = torch.zeros((B, K1), dtype=torch.float32, device=f.device)
    labels[:, 0] = 1.0
    g = torch.where(t_valid, (labels - sigmoid_clipped(f)) * alpha, 0.0)
    h_contrib = g[..., None] * neu1[:, None, :]                 # (B,K+1,d)
    neu1e = torch.einsum("bk,bkd->bd", g, h_t)                   # (B, d)
    return g, h_contrib, neu1e


def _shared_ns(neu1, h_pos, h_neg, centers, negs, row_valid, alpha,
               ratio):
    """Batch-shared negative sampling (JAX ``_build_grads_shared``): the
    pool's logits, grads and error terms as matrix products, each pool
    pair weighted ``ratio = negative / shared_pool`` so a center still
    carries ``negative`` negatives' worth of gradient and loss.  Returns
    ``(gh_pos, gh_neg, neu1e, n_valid, err_sum, err_cnt)``; ``err_cnt``
    is fractional."""
    f_pos = torch.einsum("bd,bd->b", neu1, h_pos)                # (B,)
    f_neg = neu1 @ h_neg.T                                       # (B, K)
    g_pos = torch.where(row_valid,
                        (1.0 - sigmoid_clipped(f_pos)) * alpha, 0.0)
    # negative == center skipped (word2vec.h:584-586)
    n_valid = (negs[None, :] != centers[:, None]) & row_valid[:, None]
    g_neg = torch.where(n_valid, (0.0 - sigmoid_clipped(f_neg)) * alpha,
                        0.0)
    gw = g_neg * ratio
    gh_pos = g_pos[:, None] * neu1                               # (B, d)
    gh_neg = gw.T @ neu1                                         # (K, d)
    neu1e = g_pos[:, None] * h_pos + gw @ h_neg                  # (B, d)
    err_sum = torch.sum(1e4 * g_pos * g_pos) \
        + ratio * torch.sum(1e4 * g_neg * g_neg)
    err_cnt = row_valid.sum() + ratio * n_valid.sum()
    return gh_pos, gh_neg, neu1e, n_valid, err_sum, err_cnt


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
                 capacity_per_shard: Optional[int] = None, seed: int = 0,
                 cluster: Optional[Cluster] = None):
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
        self.stencil = g("word2vec", "stencil", 0).to_int32() != 0
        self.shared_negatives = g(
            "word2vec", "shared_negatives", 0).to_int32() != 0
        self.shared_pool = g("word2vec", "shared_pool", 1024).to_int32()
        server_lr = g("server", "initial_learning_rate", 0.7).to_float()
        # [server] dtype: bfloat16 halves the embedding fields' bytes; the
        # math stays float32 (upcast on pull, round once on store)
        dtype_s = g("server", "dtype", "float32").to_string()
        if dtype_s not in PARAM_DTYPES:
            raise ValueError(f"[server] dtype must be float32 or "
                             f"bfloat16, got {dtype_s!r}")
        self.param_dtype = PARAM_DTYPES[dtype_s]
        self._check_supported()
        #: the rendering the step runs, named as the JAX package names it
        self.resolved_rendering = (
            ("stencil_shared" if self.shared_negatives else "stencil")
            if self.stencil else
            ("shared" if self.shared_negatives else "gather"))
        self.device = resolve_device(device)
        # one device holds the batch, the step's arithmetic and, for now,
        # every rank of the layout (shards on different cards: ROADMAP A11)
        self.cluster = cluster or Cluster(
            self.config, devices=[self.device]).initialize()
        self.access = w2v_access(server_lr, self.len_vec,
                                 param_dtype=self.param_dtype)
        self.transfer = self.cluster.transfer
        self._capacity_per_shard = capacity_per_shard
        self.table: Optional[SparseTable] = None
        self.vocab: Optional[Vocab] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)
        W = self.window
        #: the stencil's context offsets -W..-1, 1..W
        self._offsets = torch.cat([torch.arange(-W, 0), torch.arange(1, W + 1)
                                   ]).to(self.device)
        self.train_metrics: dict = {}

    def _check_supported(self) -> None:
        """Raise on every configuration the slice does not port, after the
        JAX package's own ``ValueError``s for combinations that are not
        configurations at all.  ``[worker] inner_steps: N`` is ported: the
        JAX package's N fused steps are N ordinary steps one after
        another, the same math."""
        g = self.config.get_or
        sg = g("word2vec", "sg", 0).to_int32() != 0
        dense_raw = g("word2vec", "dense_logits", "auto").to_string()
        dense = dense_raw != "auto" and int(dense_raw) != 0
        transfer = g("cluster", "transfer", "xla").to_string()
        data_plane = g("cluster", "data_plane", "auto").to_string()
        if self.stencil:
            if sg:
                raise ValueError(
                    "stencil is a CBOW-only rendering (span positions index "
                    "a center's context window); drop sg or stencil")
            if dense:
                raise ValueError(
                    "dense_logits and stencil are two different renderings "
                    "of the gather working set — pick one")
            if transfer not in ("xla", "hybrid"):
                raise ValueError(
                    "the stencil rendering pushes its span family through "
                    "push_span — set [cluster] transfer: xla or hybrid")
        elif dense and self.shared_negatives:
            raise ValueError(
                "dense_logits and shared_negatives are two different "
                "renderings of the negative-sampling phase — pick one")
        if data_plane not in ("auto", "pallas", "xla"):
            raise ValueError(f"[cluster] data_plane must be auto, pallas or "
                             f"xla, got {data_plane!r}")
        refuse = []

        def want(cond, what, item):
            if cond:
                refuse.append(f"{what} (ROADMAP {item})")

        # the port routes neu1 through the fused kernel only: the XLA
        # chain would put a plain version on the card's path
        want(self.stencil and data_plane == "xla",
             "[cluster] data_plane: xla with stencil (the device-kind "
             "verdict store)", "A16")
        want(sg, "[word2vec] sg", "A8")
        want(dense_raw == "1", "[word2vec] dense_logits: 1", "A8")
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
        want(transfer == "tpu" and data_plane == "xla",
             "[cluster] data_plane: xla with transfer: tpu (the library "
             "exchange)", "A16")
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
            cap = self._capacity_per_shard or max(
                64, int(V * 1.3 / self.cluster.n_servers) + 1)
            self.table = self.cluster.create_table("w2v", self.access, cap)
        slots = self.table.key_index.lookup(vocab.keys)
        self._slot_of_vocab = torch.as_tensor(slots, dtype=torch.int32,
                                              device=self.device)
        prob, alias = build_unigram_alias(vocab.counts)
        self._alias_prob = torch.as_tensor(prob, device=self.device)
        self._alias_idx = torch.as_tensor(alias, dtype=torch.int64,
                                          device=self.device)
        log.info("vocab: %d words, %d tokens; table capacity %d in %d "
                 "shard(s) on %s", V, vocab.total_words, self.table.capacity,
                 self.cluster.n_servers, self.device)
        return self

    # -- gradient phases (JAX _build_grads*) --------------------------------
    def _pull(self, state, slots, field: str) -> torch.Tensor:
        """Rows of ``field`` at ``slots``, upcast to float32 (a no-op for
        a float32 table) before any math, as JAX's ``.astype(f32)``."""
        return self.transfer.pull(state, slots, self.access,
                                  fields=(field,))[field].float()

    def _grads(self, state, centers, contexts, ctx_mask, draws: Draws):
        """Gather rendering (JAX ``_build_grads``): pull rows, CBOW-NS
        math, one push spec per family — no push."""
        B, W2 = contexts.shape
        K, d = self.negative, self.len_vec
        t_slots, ctx_slots, t_valid = _cbow_targets(
            self._slot_of_vocab, self._alias_prob, self._alias_idx,
            centers, contexts, ctx_mask, draws)
        t_slots = torch.where(t_valid, t_slots, -1)
        # split pulls: targets need only h, contexts only v
        h_t = self._pull(state, t_slots.reshape(-1), "h").reshape(B, K + 1, d)
        v_ctx = self._pull(state, ctx_slots.reshape(-1), "v").reshape(B, W2, d)
        neu1 = torch.sum(v_ctx * ctx_mask[..., None], dim=1)     # (B, d)
        g, h_contrib, neu1e = _parity_ns(neu1, h_t, t_valid, self.alpha)
        v_contrib = torch.where(ctx_mask[..., None], neu1e[:, None, :],
                                0.0)                             # (B,2W,d)
        pushes = _assemble_push(
            t_slots.reshape(-1), ctx_slots.reshape(-1),
            h_contrib.reshape(-1, d), v_contrib.reshape(-1, d))
        err_sum = torch.sum(1e4 * g * g)          # word2vec.h:593
        return pushes, err_sum, t_valid.sum()

    def _grads_shared(self, state, centers, contexts, ctx_mask,
                      draws: Draws):
        """Shared-negative rendering (JAX ``_build_grads_shared``): one
        pool of ``shared_pool`` negatives for the batch, so the h pull is
        B + pool rows.  Three push families: the centers and the contexts
        mean-normalized per slot, the pool rows as their own sum family
        (each already sums its ~B pair contributions)."""
        B, W2 = contexts.shape
        d = self.len_vec
        sov = self._slot_of_vocab
        negs = sample_alias_from_draws(draws[0], draws[1], self._alias_prob,
                                       self._alias_idx)          # (pool,)
        c_slots, n_slots = sov[centers], sov[negs]
        ctx_slots = torch.where(ctx_mask, sov[contexts], -1)
        row_valid = ctx_mask.any(dim=1)
        h = self._pull(state, torch.cat([c_slots, n_slots]), "h")
        v_ctx = self._pull(state, ctx_slots.reshape(-1), "v").reshape(B, W2, d)
        neu1 = torch.sum(v_ctx * ctx_mask[..., None], dim=1)
        gh_pos, gh_neg, neu1e, n_valid, err_sum, err_cnt = _shared_ns(
            neu1, h[:B], h[B:], centers, negs, row_valid, self.alpha,
            self.negative / self.shared_pool)
        v_contrib = torch.where(ctx_mask[..., None], neu1e[:, None, :], 0.0)
        pushes = (
            PushSpec(torch.where(row_valid, c_slots, -1), {"h": gh_pos},
                     mean=True),
            PushSpec(torch.where(n_valid.any(dim=0), n_slots, -1),
                     {"h": gh_neg}),
            PushSpec(ctx_slots.reshape(-1), {"v": v_contrib.reshape(-1, d)},
                     mean=True))
        return pushes, err_sum, err_cnt

    def _grads_stencil(self, state, tokens, sent_id, center_pos, half,
                       draws: Draws):
        """Stencil rendering (JAX ``_build_grads_stencil``): the batch is
        a stream span of S = B + 2W tokens, neu1 is the stencil context
        sum over the span's rows (one kernel launch, its window rule the
        same pairs as ``ctx_mask``), and the v gradient inverts the
        stencil onto span positions (with contribution counts) for
        ``push_span``.  The h side is the parity or the shared-pool
        negative phase."""
        S, B, d = tokens.shape[0], center_pos.shape[0], self.len_vec
        sov = self._slot_of_vocab
        span_slots = torch.where(sent_id >= 0, sov[tokens], -1)   # (S,)
        row_valid = center_pos >= 0
        cp = center_pos.clamp(0, S - 1)
        centers = tokens[cp]
        c_slots = torch.where(row_valid, span_slots[cp], -1)
        ctx_idx = cp[:, None] + self._offsets[None, :]            # (B, 2W)
        ci = ctx_idx.clamp(0, S - 1)
        ctx_mask = ((ctx_idx >= 0) & (ctx_idx < S)
                    & (sent_id[ci] == sent_id[cp][:, None])
                    & (self._offsets.abs()[None, :] <= half[:, None])
                    & row_valid[:, None])
        neu1 = stencil_context_sum(state["v"], span_slots, sent_id,
                                   center_pos, half, self.window)
        if self.shared_negatives:
            negs = sample_alias_from_draws(draws[0], draws[1],
                                           self._alias_prob, self._alias_idx)
            n_slots = sov[negs]
            h = self._pull(state, torch.cat([c_slots, n_slots]), "h")
            gh_pos, gh_neg, neu1e, n_valid, err_sum, err_cnt = _shared_ns(
                neu1, h[:B], h[B:], centers, negs, row_valid, self.alpha,
                self.negative / self.shared_pool)
            pushes = (PushSpec(c_slots, {"h": gh_pos}, mean=True),
                      PushSpec(torch.where(n_valid.any(dim=0), n_slots, -1),
                               {"h": gh_neg}),
                      self._span_push(span_slots, ci, ctx_mask, neu1e))
            return pushes, err_sum, err_cnt
        K = self.negative
        t_slots, t_valid = _parity_targets(
            sov, self._alias_prob, self._alias_idx, centers, c_slots,
            row_valid, draws)
        t_slots = torch.where(t_valid, t_slots, -1)
        h_t = self._pull(state, t_slots.reshape(-1), "h").reshape(B, K + 1, d)
        g, h_contrib, neu1e = _parity_ns(neu1, h_t, t_valid, self.alpha)
        pushes = (PushSpec(t_slots.reshape(-1),
                           {"h": h_contrib.reshape(-1, d)}, mean=True),
                  self._span_push(span_slots, ci, ctx_mask, neu1e))
        return pushes, torch.sum(1e4 * g * g), t_valid.sum()

    def _span_push(self, span_slots, ci, ctx_mask, neu1e) -> PushSpec:
        """Invert the stencil: per-pair context grads land on span
        positions (a span-local sum, not a capacity scatter), with the
        contribution counts ``push_span``'s mean divides by."""
        S, d = span_slots.shape[0], neu1e.shape[1]
        contrib = torch.where(ctx_mask[..., None], neu1e[:, None, :], 0.0)
        idx = ci.reshape(-1)
        vg = torch.zeros((S, d), dtype=torch.float32, device=neu1e.device)
        vg.index_add_(0, idx, contrib.reshape(-1, d))
        vc = torch.zeros(S, dtype=torch.float32, device=neu1e.device)
        vc.index_add_(0, idx, ctx_mask.reshape(-1).float())
        return PushSpec(span_slots, {"v": vg}, mean=True, counts=vc)

    def _apply(self, state, pushes):
        """Apply phase (JAX ``_build_apply``): every family through the
        transfer's push — a span family (one that carries counts) through
        ``push_span`` — in place on ``state``."""
        for spec in pushes:
            if spec.counts is not None:
                self.transfer.push_span(state, spec.slots, spec.grads,
                                        spec.counts, self.access,
                                        mean=spec.mean)
            else:
                self.transfer.push(state, spec.slots, spec.grads,
                                   self.access, mean=spec.mean)
        return state

    # -- the step ------------------------------------------------------------
    def _draws(self, B: int, draws) -> Draws:
        """The step's ``(j, u)``: one pool of ``shared_pool`` for the
        shared renderings, ``(B, negative)`` otherwise; ``draws`` (numpy
        or tensors) replaces the model's generator."""
        if draws is not None:
            return (_on(draws[0], self.device, torch.int64),
                    _on(draws[1], self.device, torch.float32))
        shape = ((self.shared_pool,) if self.shared_negatives
                 else (B, self.negative))
        return alias_draws(self._gen, len(self.vocab), shape, self.device)

    def _finish(self, grads_fn, *args) -> Tuple[float, Union[int, float]]:
        state = self.table.state
        pushes, es, ec = grads_fn(state, *args)
        self._apply(state, pushes)
        es, ec = torch.stack([es.double(), ec.double()]).tolist()
        # the shared renderings' count is fractional (negative/pool
        # weights); the others count pairs and stay exact integers
        return es, (ec if self.shared_negatives else int(ec))

    def step(self, centers, contexts, ctx_mask,
             draws: Optional[Draws] = None) -> Tuple[float, Union[int, float]]:
        """One sync step on one CBOW batch (vocab indices, numpy or
        tensors) in the gather or shared rendering; ``draws`` replaces the
        model's own ``(j, u)`` alias draws.  Updates the table in place;
        returns ``(err_sum, err_cnt)`` as host numbers (``err_cnt`` a
        float for shared negatives)."""
        if self.stencil:
            raise ValueError("this model renders stencil batches: call "
                             "step_stencil")
        dev = self.device
        # int64 once per batch: torch indexing wants it (kernels get int32)
        centers = _on(centers, dev, torch.int64)
        contexts = _on(contexts, dev, torch.int64)
        ctx_mask = _on(ctx_mask, dev, torch.bool)
        grads = self._grads_shared if self.shared_negatives else self._grads
        return self._finish(grads, centers, contexts, ctx_mask,
                            self._draws(centers.shape[0], draws))

    def step_stencil(self, tokens, sent_id, center_pos, half,
                     draws: Optional[Draws] = None
                     ) -> Tuple[float, Union[int, float]]:
        """One sync step on one stencil batch (a ``StencilBatch``'s
        arrays), as :meth:`step`."""
        if not self.stencil:
            raise ValueError("this model renders CBOW batches: call step "
                             "(or set [word2vec] stencil: 1)")
        dev = self.device
        tokens = _on(tokens, dev, torch.int64)
        center_pos = _on(center_pos, dev, torch.int64)
        return self._finish(self._grads_stencil, tokens,
                            _on(sent_id, dev, torch.int32), center_pos,
                            _on(half, dev, torch.int32),
                            self._draws(center_pos.shape[0], draws))

    def step_batch(self, batch: Union[CBOWBatch, StencilBatch],
                   draws: Optional[Draws] = None):
        """:meth:`step` or :meth:`step_stencil` by the batch's type."""
        if isinstance(batch, StencilBatch):
            return self.step_stencil(batch.tokens, batch.sent_id,
                                     batch.center_pos, batch.half, draws)
        return self.step(batch.centers, batch.contexts, batch.ctx_mask,
                         draws)

    # -- training (word2vec.h:475-547) ---------------------------------------
    def train(self, data=None, niters: int = 1,
              batch_size: Optional[int] = None, batcher=None,
              draws: Optional[Iterator] = None) -> List[float]:
        """``data``: corpus path or list of key-list sentences.  Returns
        the per-iteration mean error Σerr_sum / round(Σerr_cnt) (reference
        Error::norm per train_iter; the count rounded once per iteration,
        as the JAX package does).  ``batcher``: a custom batch source with
        an ``epoch(batch_size)`` iterator (``epoch_stencil`` with
        ``stencil: 1``).  ``draws``: an iterator of ``(j, u)`` pairs, one
        per step, replacing the model's generator.

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
        if not batch_size:
            # the default, rounded up to a whole number of centers per
            # rank: the sharded transfer splits every slot array evenly
            n = self.cluster.n_servers
            batch_size = -(-max(256, self.minibatch // (2 * self.window))
                           // n) * n
        losses = []
        words = steps = 0
        host_s = 0.0
        t0 = time.perf_counter()
        for it in range(niters):
            err_sum, err_cnt = 0.0, 0.0
            epoch = iter(batcher.epoch_stencil(batch_size) if self.stencil
                         else batcher.epoch(batch_size))
            while True:
                th = time.perf_counter()
                batch = next(epoch, None)
                host_s += time.perf_counter() - th
                if batch is None:
                    break
                es, ec = self.step_batch(
                    batch, None if draws is None else next(draws))
                err_sum += es
                err_cnt += ec
                words += batch.n_words
                steps += 1
            loss = err_sum / max(int(round(err_cnt)), 1)
            losses.append(loss)
            elapsed = time.perf_counter() - t0
            log.info("iter %d: error %.5f  (%.0f words/s)", it, loss,
                     words / max(elapsed, 1e-9))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.train_metrics = {
            "rendering": self.resolved_rendering,
            "steps": steps, "words": words, "seconds": seconds,
            "batcher_seconds": host_s,
            "steps_per_sec": steps / max(seconds, 1e-9),
            "words_per_sec": words / max(seconds, 1e-9),
            "shards": self.cluster.n_servers,
            "push_paths": dict(self.transfer.push_paths)}
        return losses

    # -- embeddings out --------------------------------------------------------
    def save(self, path: str) -> int:
        # reference WParam layout: v TAB h (word2vec.h:100-110)
        return dump_table_text(self.table, path, w2v_formatter)
