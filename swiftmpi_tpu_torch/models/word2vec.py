"""word2vec CBOW or skip-gram + negative sampling, sync and async
(counterpart of ``swiftmpi_tpu/models/word2vec.py``), on one device
(``transfer: xla``) or over the n ranks of the sharded parameter server
(``transfer: tpu``, ``server_num: n``).

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

One minibatch of that loop is one step, rendered one of seven ways, as
the JAX package resolves them (``resolved_rendering``):

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
* ``dense`` (``dense_logits: 1``): the gather rendering's math through
  full ``(B, capacity)`` logits — three large matrix products — with the
  h gradient arriving capacity-shaped and applied to the whole table
  (``PushSpec(dense=True)``).  ``dense_logits: auto`` resolves to
  ``gather``, as the JAX package resolves it off a TPU.
* ``sg`` (``sg: 1``): skip-gram over the ``(B, 2W)`` pair axis, K
  negatives drawn fresh per pair, so the h pull and push take
  ``B·2W·(K+1)`` rows.
* ``sg_shared`` (``sg: 1``, ``shared_negatives: 1``): skip-gram with one
  pool for the batch, the pairs run through the shared negative phase.

With ``transfer: tpu`` (every rendering but the stencil ones and
``dense``, as in the JAX package) the step's arithmetic still runs once
over the whole batch, as the jitted JAX step does over global arrays;
only the pulls and pushes are per rank, routed by
``transfer/sharded.py``.  ``transfer: hybrid`` (every rendering but
``dense``) calibrates a ``HotColdPartition`` from the vocab's counts in
``build_from_vocab`` and routes the tail as ``tpu`` does, the head
through the hot planes (``transfer/hybrid.py``); its stencil renderings
pull the span through the transfer and sum the context rows with torch
ops, the JAX package's non-fused path (the stencil kernel reads one
table tensor, which a hybrid table does not have).  With the transfer's
``count_traffic`` set, ``train_metrics["transfer_traffic"]`` carries its
``traffic()``.

Two async modes, as in the JAX package's ``train``:

* ``local_steps: L > 1`` (the snapshot mode): each step computes its
  grads against a snapshot of the table and pushes onto the live table;
  the snapshot is refreshed every L steps.  The port updates the table in
  place, so the snapshot is a copy of the pulled fields (h and v), made
  when ``train`` starts and refreshed in place.
* ``async_mode: hogwild``: every device the ``Cluster`` was given (a
  device may repeat) is a worker; each trains ``local_steps`` batches on
  its own replica of the table with its own draws, then every worker's
  pushes are applied to the shared table in worker-major order
  (``_hogwild_group``).  One replica buffer serves the workers in turn.

``[server] dtype: bfloat16`` stores the embedding fields h and v in
bfloat16, as the JAX package does: every pull is upcast to float32
before any math, the gradients and the AdaGrad accumulators stay float32,
and the update rounds once on store.

``[cluster] push_window: W > 1`` coalesces the pushes of a sync group
(``inner_steps > 1``), as JAX's ``_build_multi_step_windowed``: the
group's steps split into windows of W (the last one shorter), every step
of a window computes its grads against the table as the window found
it, and each push family's ``(W, B, ...)`` stack goes through one
``transfer.push_window`` (:meth:`Word2Vec._window_group`).  On ``xla``
such a group is one CUDA graph like any other; the window's format is
decided on the host from shapes alone.  ``build_from_vocab`` sets the
transfer's ``window_expected_unique`` from the vocab's counts.

The wire stack's knobs are armed in ``build_from_vocab``, before any step
runs or a graph is captured, as the JAX package arms them: at
``push_window > 1``, ``[cluster] wire_quant: int8|bf16`` (the
``sparse_q`` rung, and the table's ``@ef`` planes), ``wire_sketch: 1``
and ``collective: auto|sparse_allreduce`` (with the hot-touch density
seeded from the vocab); at any window, ``pull_quant: int8|bf16`` and
``pull_cache: N`` (with the table's ``@rowver`` plane).  A push-side
knob at ``push_window: 1`` is ignored with JAX's warning.  A cached pull
books its ledger on the host after reading its slots and versions back,
which a CUDA graph cannot do: with ``pull_cache`` and ``count_traffic``
set, ``train`` runs the groups step by step instead of replaying graphs.
``resume`` flushes the pull cache (a restore can rewind the versions).

The table tensors are updated in place, the counterpart of the JAX step
donating its state.  Each step takes the negative-sampling draws ``(j,
u)`` as an optional argument: the seam the parity tests replay the JAX
package's draws through.  Configurations not ported raise
``NotImplementedError`` naming the ROADMAP item that ports them.

``train`` is the JAX package's loop: ``_epoch_items`` renders the epoch
into single batches and ``[worker] inner_steps`` groups on the host
(through ``[worker] pipeline: K``'s producer thread, with pinned H2D
copies on a side stream, when K > 0); a step reads nothing back to the
host, the loss sums stay on the device (``_LossAccum``, one read at the
end of the epoch); and on a CUDA device with ``transfer: xla`` a group of
N sync steps is one replay of a captured CUDA graph (``_FusedSteps``, one
graph per group length, as JAX compiles one fused scan per length).  The
async modes run their steps one by one, as JAX runs them unfused.
``train`` also writes npz checkpoints every ``checkpoint_every``
iterations and reports to the fault bus (``testing/faults.py``);
``resume`` restores one in place, ``save`` and ``load`` are the text dump
(``io/checkpoint.py``).

The telemetry plane (``obs/``) is armed by ``train`` as the JAX package
arms it: ``[worker] telemetry`` installs a StepRecorder (or reuses an
outer one) fed by ``obs.record_step`` (a group counts its length), with
samplers for the ``Throughput`` split and the transfer ledger's registry
mirror; each dispatch (a step, or a group) is the ``dispatch`` span.
``[obs] numerics`` stages one bundle a dispatch on the collector's
device buffers (:meth:`Word2Vec._numerics_run`: the updated fields are
copied at dispatch entry, the push statistics summed over the dispatch,
the table read at its exit; inside the CUDA graph on ``xla``), and the
detector's baselines ride checkpoints as ``extra__numerics`` in the JAX
package's bytes.  ``[obs] costs`` books every graph capture
(``w2v_multi``), ``[obs] profile_*`` opens profiler windows on the step
funnel, and ``[obs] trace`` installs the wire tracer, which switches
``count_traffic`` on and runs the steps eagerly (no graph), as the
tracer reads each exchange's count in program order.  With every plane
off the path launches and computes exactly what it did without them,
and the graphs' key is unchanged.

Serving and control run in the training process, at the JAX package's
safe points (after a single step, after a group, graph replay or eager,
once an epoch on hogwild, and at the end of ``train``), on the trainer
thread between dispatches:

* ``[serve] every: K`` publishes a versioned host copy of the table and
  its key map every K consumed steps through the model's
  ``SnapshotPublisher`` (:meth:`Word2Vec.serving_publisher`), which
  ``EmbeddingReader`` threads read without touching the device.
* ``[control] control: on`` arms the control plane (:meth:`Word2Vec.
  _arm_control`): a ``DecayedSketch`` of the ids the producer renders
  (on the pipeline's producer thread with ``pipeline: K``) and a
  ``Controller`` that re-derives ``hot_k`` (``hybrid``: an online
  ``SparseTable.repartition``), ``push_window`` and ``wire_format``
  (``inner_steps > 1``) and ``collective`` (not ``psum``, hybrid
  windows) every ``[control] every`` steps.  An applied change drops the
  captured graphs, and the next group recaptures.  With numerics armed,
  the controller takes the detector's demote hook: a sustained EF
  runaway sets ``wire_quant`` and ``pull_quant`` to ``off`` at the next
  safe point (:meth:`Word2Vec._numerics_demote`).  ``control: off`` (the
  default) builds nothing, and every trajectory is bit for bit the one
  without the section.

Across ``dp`` processes (``python -m swiftmpi_tpu_torch.launch -np
N``) every hook the JAX package runs there runs too: ``xla``, ``tpu``
and ``hybrid`` (every process computes the same hot head, checked over
the processes); the window and wire knobs are armed (the ``@ef`` planes
made and checkpointed), but ``train`` fuses no group across processes,
as JAX's does not, so the pushes are per step and the tables equal the
``push_window: 1`` run's with the ``@ef`` planes left zero; the pull
knobs act per step; ``[serve] every`` publishes each process's own
replica.  ``[control] control`` is refused there, because the JAX
package's control plane cannot run across processes.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.cluster import Cluster, bootstrap
from swiftmpi_tpu_torch.cluster.hashfrag import expected_unique_rows
from swiftmpi_tpu_torch.control import (Controller, ControlSettings,
                                        DecayedSketch, Knob, Proposal)
from swiftmpi_tpu_torch.data.text import (CBOWBatch, CBOWBatcher,
                                          StencilBatch, Vocab, build_vocab,
                                          load_corpus)
from swiftmpi_tpu_torch.data.distributed import (DistributedBatcher,
                                                 shard_sentences)
from swiftmpi_tpu_torch.data.native import NativeCBOWBatcher
from swiftmpi_tpu_torch.device import resolve_device
from swiftmpi_tpu_torch.io.checkpoint import (dump_table_text,
                                              load_checkpoint,
                                              load_table_text, npz_path,
                                              save_checkpoint)
from swiftmpi_tpu_torch.io.pipeline import CudaTransfer, PrefetchIterator
from swiftmpi_tpu_torch.kernels import ring
from swiftmpi_tpu_torch.kernels.stencil import stencil_context_sum
from swiftmpi_tpu_torch.obs import numerics as obs_numerics
from swiftmpi_tpu_torch.ops.calibration import DATA_PLANE_MODES, route
from swiftmpi_tpu_torch.ops.sampling import (alias_draws,
                                             build_unigram_alias,
                                             sample_alias_from_draws,
                                             sample_alias_slots_from_draws)
from swiftmpi_tpu_torch.ops.sigmoid import sigmoid_clipped
from swiftmpi_tpu_torch.parallel.collectives import host_psum
from swiftmpi_tpu_torch.parameter import SparseTable, w2v_access
from swiftmpi_tpu_torch.parameter.key_index import (CapacityError,
                                                    HotColdPartition,
                                                    price_hot_collectives,
                                                    window_wire_format)
from swiftmpi_tpu_torch.parameter.sparse_table import (hot_name,
                                                       shard_block,
                                                       tensor_to_numpy)
from swiftmpi_tpu_torch.transfer.plan import COLLECTIVE_MODES
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.transfer import PushSpec
from swiftmpi_tpu_torch.serve.snapshot import SnapshotPublisher
from swiftmpi_tpu_torch.utils.config import ConfigParser, global_config
from swiftmpi_tpu_torch.utils.graphs import StepGraph, graph_key, run_group
from swiftmpi_tpu_torch.utils.logger import get_logger
from swiftmpi_tpu_torch.utils.pipeline import LossAccum as _LossAccum
from swiftmpi_tpu_torch.utils.pipeline import resolve_dispatch_bound
from swiftmpi_tpu_torch.utils.timers import Throughput

log = get_logger(__name__)

Draws = Tuple[torch.Tensor, torch.Tensor]

#: ``[server] dtype`` -> the embedding fields' dtype
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: rendering -> the method computing its gradient phase
_GRADS = {"gather": "_grads", "dense": "_grads_dense",
          "shared": "_grads_shared", "sg": "_grads_sg",
          "sg_shared": "_grads_sg_shared", "stencil": "_grads_stencil",
          "stencil_shared": "_grads_stencil"}


def _on(x, device, dtype) -> torch.Tensor:
    """Batch array (numpy or tensor) -> contiguous ``dtype`` tensor on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(device=device, dtype=dtype).contiguous()


def _batch_fields(batch: Union[CBOWBatch, StencilBatch]) -> tuple:
    """A batch's arrays in the order the step takes them."""
    if isinstance(batch, StencilBatch):
        return (batch.tokens, batch.sent_id, batch.center_pos, batch.half)
    return (batch.centers, batch.contexts, batch.ctx_mask)


def _stack_group_host(batches) -> tuple:
    """Stack a group of same-shape batches on the host, field by field
    (one contiguous H2D copy per field, not one per batch): the rendering
    work the input pipeline's producer thread takes off the critical
    path.  JAX's ``_stack_group_host`` and ``_stack_group_host_stencil``
    in one."""
    return tuple(np.stack([np.asarray(a) for a in arrays])
                 for arrays in zip(*map(_batch_fields, batches)))


class _FusedSteps(StepGraph):
    """N training steps as one CUDA graph (the counterpart of JAX's
    ``_build_multi_step``: N steps in one dispatch): ``utils.graphs``'
    :class:`StepGraph` of the model's group step
    (:meth:`Word2Vec._group_step`: :meth:`Word2Vec._step_fields` a step,
    or one call on the whole group with ``push_window > 1`` or numerics
    armed), its static buffers in the step's argument dtypes, the model's
    generator registered (each replay draws fresh negatives, the draws N
    eager steps would take), the summed ``(err_sum, err_cnt)`` its
    outputs."""

    def __init__(self, model: "Word2Vec", fields):
        step, whole = model._group_step()
        super().__init__(step, fields, model._arg_dtypes(), model._gen,
                         model.transfer.push_paths, whole=whole)


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


def _sg_targets(slot_of_vocab, alias_prob, alias_idx, centers, contexts,
                ctx_mask, draws: Draws):
    """Target/context slots and validity of a skip-gram batch (JAX
    ``_build_grads_sg``): per pair ``(b, w)`` the center, then K negatives
    from the ``(B, 2W, K)`` draws; a negative equal to its center is
    skipped (word2vec.h:584-586) and a padding pair is dead.  Returns
    ``(t_slots (B, 2W, K+1), ctx_slots (B, 2W), t_valid)``, dead slots
    -1."""
    B, W2 = contexts.shape
    negs, neg_slots = sample_alias_slots_from_draws(
        draws[0], draws[1], alias_prob, alias_idx, slot_of_vocab)
    t_valid = torch.cat([
        torch.ones((B, W2, 1), dtype=torch.bool, device=centers.device),
        negs != centers[:, None, None]], dim=2) & ctx_mask[..., None]
    c_slots = slot_of_vocab[centers][:, None, None].expand(B, W2, 1)
    t_slots = torch.where(t_valid, torch.cat([c_slots, neg_slots], dim=2), -1)
    ctx_slots = torch.where(ctx_mask, slot_of_vocab[contexts], -1)
    return t_slots, ctx_slots, t_valid


def _parity_ns(neu1, h_t, t_valid, alpha):
    """Per-example negative sampling (labels: the center 1, negatives 0)
    over any leading axes — a CBOW center ``(B,)`` or a skip-gram pair
    ``(B, 2W)``: ``neu1 (..., d)``, ``h_t (..., K+1, d)``.  Returns
    ``(g, h_contrib, neu1e)`` with dead targets' ``g`` zeroed."""
    f = torch.einsum("...d,...kd->...k", neu1, h_t)
    labels = torch.zeros(t_valid.shape, dtype=torch.float32,
                         device=f.device)
    labels[..., 0] = 1.0
    g = torch.where(t_valid, (labels - sigmoid_clipped(f)) * alpha, 0.0)
    h_contrib = g[..., None] * neu1[..., None, :]             # (...,K+1,d)
    neu1e = torch.einsum("...k,...kd->...d", g, h_t)          # (..., d)
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


def _snapshot(state, fields, mesh) -> dict:
    """A copy of ``fields`` of a table state, their hot planes included.
    A sharded field's copy keeps the shards of each device one block
    (``shard_block``), as the sharded transfer reads them."""
    out = {}
    for f in (*fields, *(hot_name(f) for f in fields
                         if hot_name(f) in state)):
        v = state[f]
        if not isinstance(v, list):
            out[f] = v.clone()
            continue
        out[f] = [None] * len(v)
        for _, ranks in mesh.device_groups:
            block = shard_block([v[r] for r in ranks]).clone()
            for i, r in enumerate(ranks):
                out[f][r] = block[i]
    return out


def _refresh(snapshot: dict, state) -> None:
    """Copy ``state``'s fields into the snapshot's tensors, in place."""
    for f, v in snapshot.items():
        pairs = zip(v, state[f]) if isinstance(v, list) else [(v, state[f])]
        for dst, src in pairs:
            dst.copy_(src)


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
        self.sg = g("word2vec", "sg", 0).to_int32() != 0
        # dense_logits: 0/1 force; "auto" resolves to the gather
        # rendering, as the JAX package resolves it off a TPU (no on-chip
        # verdict for this device kind)
        dense_raw = g("word2vec", "dense_logits", "auto").to_string()
        self.dense_logits = dense_raw != "auto" and int(dense_raw) != 0
        # local_steps > 1: the snapshot async mode; with async_mode:
        # hogwild, the batches each worker trains between reconciliations
        self.local_steps = g("word2vec", "local_steps", 1).to_int32()
        self.async_mode = g("word2vec", "async_mode", "").to_string()
        self.hogwild = self.async_mode == "hogwild"
        server_lr = g("server", "initial_learning_rate", 0.7).to_float()
        # [server] dtype: bfloat16 halves the embedding fields' bytes; the
        # math stays float32 (upcast on pull, round once on store)
        dtype_s = g("server", "dtype", "float32").to_string()
        if dtype_s not in PARAM_DTYPES:
            raise ValueError(f"[server] dtype must be float32 or "
                             f"bfloat16, got {dtype_s!r}")
        self.param_dtype = PARAM_DTYPES[dtype_s]
        # [worker] inner_steps: N batches a group, one CUDA graph replay on
        # the card (transfer: xla); 1 = one step at a time
        self.inner_steps = g("worker", "inner_steps", 1).to_int32()
        # [worker] pipeline: K > 0 renders batches K ahead on a producer
        # thread and copies them to the card from pinned memory; the
        # producer owns no RNG and keeps the batch order, so K changes
        # WHEN work happens, never what is computed
        self.pipeline_depth = g("worker", "pipeline", 0).to_int32()
        if self.pipeline_depth < 0:
            raise ValueError("[worker] pipeline must be >= 0")
        # [worker] dispatch_depth: in-flight step watermark
        # (utils.pipeline.resolve_dispatch_bound): "auto", an integer, or
        # 0 for unbounded
        self.dispatch_depth = g("worker", "dispatch_depth",
                                "auto").to_string()
        # [cluster] push_window: W > 1 coalesces W steps' pushes of a sync
        # group into one exchange a family
        self.push_window_size = g("cluster", "push_window", 1).to_int32()
        if self.push_window_size < 1:
            raise ValueError("[cluster] push_window must be >= 1")
        # the wire stack (transfer/plan.py): value quantization of the
        # window's sparse wire with its @ef error feedback, the sketch
        # rung, the dense and hot reconciles' collective, and the pull
        # wire's quantization and versioned cache
        self.wire_quant = g("cluster", "wire_quant", "off").to_string()
        if self.wire_quant not in ("off", "int8", "bf16"):
            raise ValueError("[cluster] wire_quant must be off, int8 or "
                             f"bf16, got {self.wire_quant!r}")
        self.pull_quant = g("cluster", "pull_quant", "off").to_string()
        if self.pull_quant not in ("off", "int8", "bf16"):
            raise ValueError("[cluster] pull_quant must be off, int8 or "
                             f"bf16, got {self.pull_quant!r}")
        self.pull_cache = g("cluster", "pull_cache", 0).to_int32()
        if self.pull_cache < 0:
            raise ValueError("[cluster] pull_cache must be >= 0, got "
                             f"{self.pull_cache!r}")
        self.wire_sketch = g("cluster", "wire_sketch", 0).to_int32()
        if self.wire_sketch not in (0, 1):
            raise ValueError("[cluster] wire_sketch must be 0 or 1, got "
                             f"{self.wire_sketch!r}")
        self.collective_mode = g("cluster", "collective",
                                 "psum").to_string()
        if self.collective_mode not in COLLECTIVE_MODES:
            raise ValueError("[cluster] collective must be one of "
                             f"{COLLECTIVE_MODES}, got "
                             f"{self.collective_mode!r}")
        self._check_supported()
        # [serve] every: publish a bounded-staleness serving snapshot of
        # the table every N consumed train steps (serve/snapshot.py); 0
        # (the default) = serving off.  [serve] depth bounds how many
        # published generations the publisher keeps referenced.
        self.serve_every = g("serve", "every", 0).to_int32()
        self.serve_depth = g("serve", "depth", 2).to_int32()
        if self.serve_every < 0:
            raise ValueError("[serve] every must be >= 0")
        self.serve_publisher: Optional[SnapshotPublisher] = None
        # [control]: off (the default) constructs nothing: no sketch, no
        # controller, no observation; build_from_vocab arms it
        self.control_settings = ControlSettings.from_config(self.config)
        self.controller: Optional[Controller] = None
        self._control_sketch: Optional[DecayedSketch] = None
        self._control_recompiles = 0
        self._control_dirty = False
        # [obs] numerics: off (the default) builds nothing; armed by
        # train() (the collector, its detector and the quant tap)
        self.numerics_on = obs_numerics.enabled(self.config)
        self._numerics: Optional[obs_numerics.NumericsCollector] = None
        self._numerics_restore = None   # checkpointed baseline bytes
        self._numerics_rec_id: Optional[int] = None
        #: the armed dispatch's push statistics, one triple a step
        self._num_acc: Optional[list] = None
        #: the rendering the step runs, named as the JAX package names it
        if self.stencil:
            self.resolved_rendering = ("stencil_shared"
                                       if self.shared_negatives
                                       else "stencil")
        elif self.sg:
            self.resolved_rendering = ("sg_shared" if self.shared_negatives
                                       else "sg")
        elif self.shared_negatives:
            self.resolved_rendering = "shared"
        else:
            self.resolved_rendering = ("dense" if self.dense_logits
                                       else "gather")
        self.device = resolve_device(device)
        # one device holds the batch, the step's arithmetic and every rank
        # of the layout (shards on different cards: ROADMAP A11d); the
        # cluster joins the launcher's process group first
        self.cluster = cluster or Cluster(
            self.config, devices=[self.device]).initialize()
        self._check_processes()
        self.access = w2v_access(server_lr, self.len_vec,
                                 param_dtype=self.param_dtype)
        self.transfer = self.cluster.transfer
        #: ``[cluster] data_plane``: ``auto``, ``pallas`` or ``xla``
        self.data_plane = self.cluster.data_plane
        #: the stencil's neu1 route on ``xla`` (``[cluster] data_plane``
        #: through ``ops.calibration.route``): ``"kernel"`` (B4) or
        #: ``"library"`` (the JAX package's chain of torch ops)
        self.stencil_route = (
            route(self.data_plane, "stencil_fused", self.device)
            if self.stencil and self.transfer.name == "xla" else None)
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
        #: group length -> its captured CUDA graph (JAX ``_fused_cache``),
        #: valid for the tensors of ``_fused_key``
        self._fused_cache: Dict[int, _FusedSteps] = {}
        self._fused_key: tuple = ()
        #: group length -> its capture handle in the compile catalog
        #: (``obs.costs``), dropped with the graphs
        self._captures: dict = {}

    @property
    def data_plane_routes(self) -> dict:
        """The route each ``[cluster] data_plane``-steered kernel of this
        model takes, ``"kernel"`` or ``"library"``: ``stencil_fused``
        (the stencil's neu1 on ``xla``) and ``ring_push`` (the sharded
        exchange on ``tpu`` and ``hybrid``)."""
        out = {}
        if self.stencil_route is not None:
            out["stencil_fused"] = self.stencil_route
        tail = getattr(self.transfer, "tail", self.transfer)
        if getattr(tail, "exchange_route", None) is not None:
            out["ring_push"] = tail.exchange_route
        return out

    def _check_supported(self) -> None:
        """Raise on every configuration the slice does not port, after the
        JAX package's own ``ValueError``s for combinations that are not
        configurations at all."""
        g = self.config.get_or
        sg, dense = self.sg, self.dense_logits
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
            if self.hogwild:
                raise ValueError(
                    "async_mode=hogwild drives per-pair batches; the "
                    "stencil rendering composes with the snapshot "
                    "(local_steps) async mode instead")
        elif sg and dense:
            raise ValueError(
                "dense_logits is a CBOW-only rendering; with sg: 1 the "
                "per-pair skip-gram phase would ignore it — drop one of "
                "the two flags")
        elif dense and self.shared_negatives:
            raise ValueError(
                "dense_logits and shared_negatives are two different "
                "renderings of the negative-sampling phase — pick one")
        if dense and transfer != "xla":
            raise ValueError(
                "dense_logits computes the h-grad as a full-capacity "
                "matmul and applies it directly — the 'tpu'/'hybrid' "
                "backends' row-sharded routing doesn't apply (set "
                "[cluster] transfer: xla)")
        if self.hogwild and transfer != "xla":
            raise ValueError(
                "async_mode=hogwild requires the gather/scatter 'xla' "
                "transfer: each worker replica trains locally (set "
                "[cluster] transfer: xla)")
        if data_plane not in DATA_PLANE_MODES:
            raise ValueError(f"[cluster] data_plane must be auto, pallas or "
                             f"xla, got {data_plane!r}")

    def _check_processes(self) -> None:
        """Under ``dp > 1`` processes: raise for ``[control] control``,
        which the JAX package cannot run across processes (ROADMAP queue
        C).  The window and wire knobs are armed as in one process, and
        ``train`` runs no fused group across processes (JAX's rule), so
        its pushes are per step; the pull knobs and ``[serve]`` act per
        step and per process."""
        dp = self.cluster.dp
        if dp > 1 and self.control_settings.enabled:
            raise NotImplementedError(
                f"[control] control across {dp} processes: the JAX "
                "package's control plane cannot run across processes (its "
                "sketch, control/sketch.py observe, reads a batch the "
                "DistributedBatcher made global and fails with 'Fetching "
                "value for jax.Array that spans non-addressable devices'), "
                "so there is no reference to hold it against (ROADMAP "
                "queue C); run the control plane in one process")

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
            partition = None
            if self.transfer.name == "hybrid":
                # the measured frequency head goes to the hot planes; the
                # minibatch sizes the calibration's dense/sparse crossover
                partition = HotColdPartition.from_counts(
                    vocab.keys, vocab.counts, batch_rows=self.minibatch)
                # every replica must hold the same head: the hot psum
                # sums the processes' planes row by row
                self.transfer._dp_agree(
                    "the hot head", np.asarray(partition.hot_keys,
                                               np.uint64).tobytes())
                log.info("hybrid placement: %d hot keys (%.1f%% of token "
                         "mass); %d tail keys sharded", partition.n_hot,
                         100 * (partition.head_mass or 0.0),
                         V - partition.n_hot)
            self.table = self.cluster.create_table(
                "w2v", self.access, cap, partition=partition)
        slots = self.table.key_index.lookup(vocab.keys)
        self._slot_of_vocab = torch.as_tensor(slots, dtype=torch.int32,
                                              device=self.device)
        if self.push_window_size > 1:
            # the window's sparse/dense crossover priced at the unique rows
            # a window of draws from the vocab's counts leaves
            self.transfer.window_expected_unique = expected_unique_rows(
                vocab.counts, self.push_window_size * self.minibatch)
        self._arm_wire()
        prob, alias = build_unigram_alias(vocab.counts)
        self._alias_prob = torch.as_tensor(prob, device=self.device)
        self._alias_idx = torch.as_tensor(alias, dtype=torch.int64,
                                          device=self.device)
        if self.control_settings.enabled:
            self._arm_control()
        log.info("vocab: %d words, %d tokens; table capacity %d in %d "
                 "shard(s) on %s", V, vocab.total_words, self.table.capacity,
                 self.cluster.n_servers, self.device)
        return self

    def _arm_wire(self) -> None:
        """Arm the wire stack's knobs on the transfer and the planes they
        need on the table (JAX ``build_from_vocab``), before any step."""
        windowed = self.push_window_size > 1
        if self.wire_quant != "off":
            if windowed:
                self.transfer.wire_quant = self.wire_quant
                self.table.ensure_ef(tuple(self.access.grad_fields))
            else:
                log.warning(
                    "[cluster] wire_quant: %s has no effect at "
                    "push_window: 1 (per-step pushes ship f32); "
                    "ignoring", self.wire_quant)
        if self.wire_sketch:
            if windowed:
                self.transfer.wire_sketch = True
            else:
                log.warning(
                    "[cluster] wire_sketch has no effect at "
                    "push_window: 1 (per-step pushes ship indexed "
                    "rows); ignoring")
        if self.collective_mode != "psum":
            if windowed:
                self.transfer.collective_mode = self.collective_mode
                self.transfer.hot_touched_fraction = \
                    self._seed_hot_touched_fraction()
                log.info("[cluster] collective: %s armed (seed hot-touch "
                         "density %.4f)", self.collective_mode,
                         self.transfer.hot_touched_fraction or 0.0)
            else:
                log.warning(
                    "[cluster] collective: %s has no effect at "
                    "push_window: 1 (the per-step hot psum is not "
                    "plan-compiled); ignoring", self.collective_mode)
        if self.pull_quant != "off":
            # pulls happen every step at any window
            self.transfer.pull_quant = self.pull_quant
            log.info("[cluster] pull_quant: %s armed", self.pull_quant)
        if self.pull_cache:
            self.transfer.pull_cache = int(self.pull_cache)
            self.table.ensure_row_versions()
            log.info("[cluster] pull_cache: %d lines armed", self.pull_cache)

    def _seed_hot_touched_fraction(self) -> Optional[float]:
        """The expected share of the hot head one window touches (JAX
        ``_seed_hot_touched_fraction``): over the head's keys, ``1 - (1 -
        p)^draws`` with ``p`` a key's share of the whole vocab's count,
        summed and divided by ``n_hot``; None without a hot head."""
        n_hot = int(self.table.n_hot)
        if n_hot <= 0:
            return None
        c = np.asarray(self.vocab.counts, np.float64).ravel()
        total = c.sum()
        if total <= 0:
            return None
        head = np.sort(c)[::-1][:n_hot] / total
        draws = self.push_window_size * self.minibatch
        touched = float(np.sum(-np.expm1(
            draws * np.log1p(-np.minimum(head, 1.0)))))
        return min(touched / n_hot, 1.0)

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

    def _grads_dense(self, state, centers, contexts, ctx_mask,
                     draws: Draws):
        """Dense-logits rendering (JAX ``_build_grads_dense``): the gather
        rendering's sampling, clipped sigmoid and mean-normalized update,
        with the h side through the whole table instead of row gathers:

            F      = neu1 @ h.T              (B, cap) logits
            f[b,k] = F[b, t[b,k]]
            G      = g scattered into (B, cap), duplicates summed
            h_grad = G.T @ neu1 / counts     (cap, d), already normalized
            neu1e  = G @ h                   (B, d)

        The three products are plain float32 matrix products (PyTorch's
        default precision, no TF32), as the JAX package leaves them to
        XLA.  The h push is capacity-shaped (``PushSpec(dense=True)``): the
        AdaGrad kernel applies it over the whole table, and untouched rows
        see exact zeros.  The v side is the gather rendering's."""
        B, W2 = contexts.shape
        d = self.len_vec
        h_all = state["h"].float()                            # (cap, d)
        cap = h_all.shape[0]
        t_slots, ctx_slots, t_valid = _cbow_targets(
            self._slot_of_vocab, self._alias_prob, self._alias_idx,
            centers, contexts, ctx_mask, draws)
        safe_t = torch.where(t_valid, t_slots, 0).clamp(0, cap - 1).long()
        v_ctx = self._pull(state, ctx_slots.reshape(-1), "v").reshape(B, W2, d)
        neu1 = torch.sum(v_ctx * ctx_mask[..., None], dim=1)     # (B, d)
        F = neu1 @ h_all.T                                      # (B, cap)
        f = F.gather(1, safe_t)                                 # (B, K+1)
        labels = torch.zeros(t_valid.shape, dtype=torch.float32,
                             device=f.device)
        labels[:, 0] = 1.0
        g = torch.where(t_valid, (labels - sigmoid_clipped(f)) * self.alpha,
                        0.0)
        # G takes F's memory (F is spent): one (B, cap) buffer, not two
        G = F.zero_().scatter_add_(1, safe_t, g)
        counts = torch.zeros(cap, dtype=torch.float32, device=f.device)
        counts.index_add_(0, safe_t.reshape(-1), t_valid.reshape(-1).float())
        h_grad = (G.T @ neu1) / counts.clamp(min=1.0)[:, None]
        neu1e = G @ h_all
        v_contrib = torch.where(ctx_mask[..., None], neu1e[:, None, :], 0.0)
        pushes = (PushSpec(None, {"h": h_grad}, dense=True),
                  PushSpec(ctx_slots.reshape(-1),
                           {"v": v_contrib.reshape(-1, d)}, mean=True))
        return pushes, torch.sum(1e4 * g * g), t_valid.sum()

    def _grads_sg(self, state, centers, contexts, ctx_mask, draws: Draws):
        """Skip-gram rendering (JAX ``_build_grads_sg``): the pair axis
        ``(B, 2W)`` — input ``v[context]``, targets ``h[center]`` and K
        negatives drawn fresh per pair (the draws are ``(B, 2W, K)``);
        masked pairs contribute nothing.  The h pull and push take
        ``B·2W·(K+1)`` rows, the v pull and push ``B·2W``; both pushes are
        mean families and ``err_cnt`` counts live target pairs."""
        B, W2 = contexts.shape
        K, d = self.negative, self.len_vec
        t_slots, ctx_slots, t_valid = _sg_targets(
            self._slot_of_vocab, self._alias_prob, self._alias_idx, centers,
            contexts, ctx_mask, draws)
        h_t = self._pull(state, t_slots.reshape(-1), "h").reshape(
            B, W2, K + 1, d)
        v_in = self._pull(state, ctx_slots.reshape(-1), "v").reshape(B, W2, d)
        g, h_contrib, v_contrib = _parity_ns(v_in, h_t, t_valid, self.alpha)
        v_contrib = torch.where(ctx_mask[..., None], v_contrib, 0.0)
        pushes = _assemble_push(
            t_slots.reshape(-1), ctx_slots.reshape(-1),
            h_contrib.reshape(-1, d), v_contrib.reshape(-1, d))
        return pushes, torch.sum(1e4 * g * g), t_valid.sum()

    def _grads_sg_shared(self, state, centers, contexts, ctx_mask,
                         draws: Draws):
        """Skip-gram with one pool (JAX ``_build_grads_sg_shared``): every
        pair ``(b, w)`` is a row of the shared negative phase, with input
        ``v[context]`` and positive ``h[center_b]``, so the h pull is B +
        pool rows.  Three pushes: the positive pairs' h grads and the
        contexts' v grads mean-normalized per slot, the pool's ``(pool,
        d)`` h grads as a SUM family (a mean there would divide each
        pool row's ~B·2W summed pair contributions away).  Loss terms are
        weighted ``negative / pool``; ``err_cnt`` is fractional."""
        B, W2 = contexts.shape
        d = self.len_vec
        sov = self._slot_of_vocab
        negs = sample_alias_from_draws(draws[0], draws[1], self._alias_prob,
                                       self._alias_idx)          # (pool,)
        c_slots, n_slots = sov[centers], sov[negs]
        ctx_slots = torch.where(ctx_mask, sov[contexts], -1)
        h = self._pull(state, torch.cat([c_slots, n_slots]), "h")
        v_in = self._pull(state, ctx_slots.reshape(-1), "v")     # (B*2W, d)
        pair_centers = centers[:, None].expand(B, W2).reshape(-1)
        h_pos = h[:B, None, :].expand(B, W2, d).reshape(-1, d)
        pair_valid = ctx_mask.reshape(-1)
        gh_pos, gh_neg, v_contrib, n_valid, err_sum, err_cnt = _shared_ns(
            v_in, h_pos, h[B:], pair_centers, negs, pair_valid, self.alpha,
            self.negative / self.shared_pool)
        v_contrib = torch.where(pair_valid[:, None], v_contrib, 0.0)
        pos_slots = torch.where(ctx_mask, c_slots[:, None], -1)
        pushes = (
            PushSpec(pos_slots.reshape(-1), {"h": gh_pos}, mean=True),
            PushSpec(torch.where(n_valid.any(dim=0), n_slots, -1),
                     {"h": gh_neg}),
            PushSpec(ctx_slots.reshape(-1), {"v": v_contrib}, mean=True))
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
        if self.stencil_route == "kernel":
            neu1 = stencil_context_sum(state["v"], span_slots, sent_id,
                                       center_pos, half, self.window)
        else:
            # hybrid, or data_plane's library route on xla: the span's
            # rows through the transfer (hot and tail planes), the masked
            # context sum as the JAX package's own non-fused path sums
            # them
            v_span = self._pull(state, span_slots, "v")           # (S, d)
            neu1 = torch.sum(v_span[ci] * ctx_mask[..., None], dim=1)
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
        ``push_span``, a dense family straight through the access method
        over the whole table (push path ``<fields>:table``) — in place on
        ``state``."""
        for spec in pushes:
            if spec.dense:
                self.transfer.push_paths[f"{','.join(spec.grads)}:table"] += 1
                self.access.apply_push(state, spec.grads)
            elif spec.counts is not None:
                self.transfer.push_span(state, spec.slots, spec.grads,
                                        spec.counts, self.access,
                                        mean=spec.mean)
            else:
                self.transfer.push(state, spec.slots, spec.grads,
                                   self.access, mean=spec.mean)
        return state

    def _apply_window(self, state, window):
        """Apply phase of a window (JAX ``_build_apply_window``):
        ``window`` holds each step's push specs; each family's W pushes,
        stacked ``(W, B, ...)``, go through one ``transfer.push_window``.
        A dense (capacity-shaped) family has no deferred window: it
        raises."""
        for specs in zip(*window):
            spec = specs[0]
            if spec.dense:
                raise ValueError(
                    "[cluster] push_window > 1 cannot coalesce dense "
                    "(capacity-shaped) pushes — disable [word2vec] "
                    "dense_logits or set push_window: 1")
            self.transfer.push_window(
                state, torch.stack([p.slots for p in specs]),
                {f: torch.stack([p.grads[f] for p in specs])
                 for f in spec.grads}, self.access, mean=spec.mean,
                counts=None if spec.counts is None
                else torch.stack([p.counts for p in specs]))
        return state

    def _window_group(self, fields, draws: Optional[List[Draws]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sync group with ``push_window: W`` (JAX
        ``_build_multi_step_windowed``): ``fields`` the group's ``(N,
        ...)`` stacked batch fields, ``draws`` one ``(j, u)`` a step or
        None.  The N steps split into windows ``[s, min(s + W, N))``;
        every step of a window computes its grads against the table as
        the window found it, then :meth:`_apply_window` pushes the
        window.  Returns the summed ``(err_sum, err_cnt)`` on the
        device."""
        state = self.table.state
        N, W = fields[0].shape[0], self.push_window_size
        es_t = ec_t = 0
        for s in range(0, N, W):
            window = []
            for i in range(s, min(s + W, N)):
                pushes, es, ec = self._grads_for(
                    state, tuple(f[i] for f in fields),
                    None if draws is None else draws[i])
                self._note_pushes(pushes)
                window.append(pushes)
                es_t, ec_t = es_t + es, ec_t + ec
            self._apply_window(state, window)
        return es_t, ec_t

    def _steps_group(self, fields, draws: Optional[List[Draws]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The N steps of a group, one after the other, on the whole
        group's stacked fields; the summed ``(err_sum, err_cnt)``."""
        es_t = ec_t = 0
        for i in range(fields[0].shape[0]):
            es, ec = self._step_fields(tuple(f[i] for f in fields),
                                       None if draws is None else draws[i])
            es_t, ec_t = es_t + es, ec_t + ec
        return es_t, ec_t

    def _note_pushes(self, pushes) -> None:
        """Add one step's push statistics to the armed dispatch (numerics
        on, sync modes); nothing otherwise."""
        if self._num_acc is not None:
            self._num_acc.append(obs_numerics.spec_stats(
                pushes, int(self.table.n_hot)))

    def _numerics_run(self, fn) -> Tuple[torch.Tensor, torch.Tensor]:
        """One dispatch ``fn() -> (err_sum, err_cnt)`` staging one numerics
        bundle (JAX ``stage_step``): the updated fields copied at entry
        (the collector's buffers), the steps' push statistics summed, the
        table read at exit.  Plain ``fn()`` with numerics off."""
        num = self._numerics
        if num is None:
            return fn()
        fields = tuple(self.access.grad_fields)
        state = self.table.state
        state0 = num.snapshot(state, fields)
        self._num_acc = acc = []
        try:
            es, ec = fn()
        finally:
            self._num_acc = None
        grad_acc = None
        for stats in acc:
            grad_acc = obs_numerics.add_stats(grad_acc, stats)
        obs_numerics.stage_step(num, state0, state, grad_acc, es, ec,
                                fields)
        return es, ec

    def _group_step(self):
        """``(step, whole)``: what one group runs — the per-step
        ``_step_fields`` (``whole`` False), or one call on the whole
        group's stacked fields (``push_window > 1``: the windows; numerics
        armed: one dispatch, one bundle)."""
        body = (self._window_group if self.push_window_size > 1
                else self._steps_group)
        if self._numerics is not None:
            return (lambda f, draws=None: self._numerics_run(
                lambda: body(f, draws))), True
        if self.push_window_size > 1:
            return self._window_group, True
        return self._step_fields, False

    # -- the step ------------------------------------------------------------
    def draw_shape(self, B: int) -> Tuple[int, ...]:
        """The shape of a step's ``(j, u)`` draws for a batch of B
        centers: one pool of ``shared_pool`` for the shared renderings,
        ``(B, 2W, negative)`` for skip-gram (fresh negatives per pair),
        ``(B, negative)`` otherwise."""
        if self.shared_negatives:
            return (self.shared_pool,)
        if self.sg:
            return (B, 2 * self.window, self.negative)
        return (B, self.negative)

    def _draws(self, B: int, draws) -> Draws:
        """The step's ``(j, u)`` of :meth:`draw_shape`; ``draws`` (numpy
        or tensors) replaces the model's generator.  Across ``dp``
        processes every process's generator is seeded alike, so each one
        draws the global batch's ``(dp * B, ...)`` and keeps its own rows,
        as JAX draws once over its global batch and every process holds
        its block; a shared pool is the global batch's one pool."""
        if draws is not None:
            return (_on(draws[0], self.device, torch.int64),
                    _on(draws[1], self.device, torch.float32))
        dp = self.cluster.dp
        if dp == 1 or self.shared_negatives:
            return alias_draws(self._gen, len(self.vocab),
                               self.draw_shape(B), self.device)
        j, u = alias_draws(self._gen, len(self.vocab),
                           self.draw_shape(dp * B), self.device)
        mine = slice(self.cluster.dp_rank * B, (self.cluster.dp_rank + 1) * B)
        return j[mine], u[mine]

    def _arg_dtypes(self) -> Tuple[torch.dtype, ...]:
        """The dtypes the step takes a batch's fields in, in
        ``_epoch_items`` order: int64 where torch indexes with them (the
        kernels get int32 slots), the stencil's window ids int32."""
        if self.stencil:
            return (torch.int64, torch.int32, torch.int64, torch.int32)
        return (torch.int64, torch.int64, torch.bool)

    def _grads_for(self, state, fields, draws: Optional[Draws] = None):
        """The gradient phase of the model's rendering on one batch's
        fields (numpy arrays or tensors: ``(centers, contexts,
        ctx_mask)``, or ``(tokens, sent_id, center_pos, half)`` with
        ``stencil: 1``), against ``state``: ``(pushes, err_sum,
        err_cnt)``, nothing pushed."""
        args = tuple(_on(f, self.device, dt)
                     for f, dt in zip(fields, self._arg_dtypes()))
        B = args[2].shape[0] if self.stencil else args[0].shape[0]
        grads_fn = getattr(self, _GRADS[self.resolved_rendering])
        return grads_fn(state, *args, self._draws(B, draws))

    def _step_fields(self, fields, draws: Optional[Draws] = None,
                     snapshot=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step on one batch's fields, in place on the table: grads
        against the table itself (sync), or against ``snapshot`` (the
        snapshot async mode), pushes onto the table.  Reads nothing back
        to the host: returns ``(err_sum, err_cnt)`` as device scalars."""
        state = self.table.state
        pushes, es, ec = self._grads_for(
            state if snapshot is None else snapshot, fields, draws)
        self._note_pushes(pushes)
        self._apply(state, pushes)
        return es, ec

    def _hogwild_group(self, group, draws: Optional[Iterator] = None,
                       replica=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One hogwild group (JAX ``_build_hogwild_step``): ``group`` holds
        ``n_workers * local_steps`` batches' fields, worker-major.  Each
        worker trains its ``local_steps`` batches on a replica of the
        table as it stands at the group's start (its own pushes landing on
        its replica, its own draws: ``draws`` yields one ``(j, u)`` a step,
        worker-major), then every worker's pushes are applied to the table
        in worker-major order, each AdaGrad apply seeing the accumulators
        the pushes before it grew (the reference server's arrival-order
        apply, server.h:159-176).  The workers run in turn on one replica
        buffer (``replica``, made here if None); every push keeps its own
        grad tensors until the chain applies it.  Returns the summed
        ``(err_sum, err_cnt)`` as device scalars."""
        n = len(self.cluster.devices)
        steps = max(self.local_steps, 1)
        if len(group) != n * steps:
            raise ValueError(f"a hogwild group is {n} workers x {steps} "
                             f"local_steps batches, got {len(group)}")
        base = self.table.state
        if replica is None:
            replica = {f: torch.empty_like(t) for f, t in base.items()}
        chain, es_t, ec_t = [], 0, 0
        for w in range(n):
            for f, t in base.items():
                replica[f].copy_(t)
            for fields in group[w * steps:(w + 1) * steps]:
                pushes, es, ec = self._grads_for(
                    replica, fields, None if draws is None else next(draws))
                self._apply(replica, pushes)
                chain.append(pushes)
                es_t, ec_t = es_t + es, ec_t + ec
        for pushes in chain:
            self._apply(base, pushes)
        return es_t, ec_t

    def _host(self, es: torch.Tensor, ec: torch.Tensor
              ) -> Tuple[float, Union[int, float]]:
        es, ec = torch.stack([es.double(), ec.double()]).tolist()
        # the shared renderings' count is fractional (negative/pool
        # weights); the others count pairs and stay exact integers
        return es, (ec if self.shared_negatives else int(ec))

    def step(self, centers, contexts, ctx_mask,
             draws: Optional[Draws] = None) -> Tuple[float, Union[int, float]]:
        """One sync step on one CBOW batch (vocab indices, numpy or
        tensors) in any rendering but the stencil ones; ``draws`` (of
        :meth:`draw_shape`) replaces the model's own ``(j, u)`` alias
        draws.  Updates the table in place;
        returns ``(err_sum, err_cnt)`` as host numbers (``err_cnt`` a
        float for shared negatives)."""
        if self.stencil:
            raise ValueError("this model renders stencil batches: call "
                             "step_stencil")
        fields = (centers, contexts, ctx_mask)
        return self._host(*self._numerics_run(
            lambda: self._step_fields(fields, draws)))

    def step_stencil(self, tokens, sent_id, center_pos, half,
                     draws: Optional[Draws] = None
                     ) -> Tuple[float, Union[int, float]]:
        """One sync step on one stencil batch (a ``StencilBatch``'s
        arrays), as :meth:`step`."""
        if not self.stencil:
            raise ValueError("this model renders CBOW batches: call step "
                             "(or set [word2vec] stencil: 1)")
        fields = (tokens, sent_id, center_pos, half)
        return self._host(*self._numerics_run(
            lambda: self._step_fields(fields, draws)))

    def step_batch(self, batch: Union[CBOWBatch, StencilBatch],
                   draws: Optional[Draws] = None):
        """:meth:`step` or :meth:`step_stencil` by the batch's type."""
        if isinstance(batch, StencilBatch):
            return self.step_stencil(*_batch_fields(batch), draws)
        return self.step(*_batch_fields(batch), draws)

    # -- training (word2vec.h:475-547) ---------------------------------------
    def _epoch_items(self, batcher, batch_size: int, stencil: bool,
                     fuse: bool):
        """Render one epoch into a stream of work items (JAX
        ``_epoch_items``): ``('group', host-stacked fields, [n_words...])``
        for groups of ``inner_steps`` batches and ``('single', fields,
        n_words)`` otherwise.  Pure host rendering — NO RNG (the negative
        draws stay with the consumer, in consumption order) and no device
        call — so the stream is the same inline or through the prefetch
        pipeline: the determinism contract of ``[worker] pipeline``."""
        inner = self.inner_steps
        group = []
        # the control plane's sketch observes the center/token ids HERE,
        # on the rendering side (host numpy, a thread-safe observe): with
        # a pipeline this runs on the producer thread
        sketch = self._control_sketch

        def group_item():
            fields = _stack_group_host(group)
            if sketch is not None:
                sketch.observe(fields[0])
            return ("group", fields, [b.n_words for b in group])

        epoch_iter = (batcher.epoch_stencil(batch_size) if stencil
                      else batcher.epoch(batch_size))
        for batch in epoch_iter:
            # every stencil batch is fixed-shape (padded span), so all of
            # them group, tails included
            if fuse and (stencil or len(batch.centers) == batch_size):
                group.append(batch)
                if len(group) == inner:
                    yield group_item()
                    group = []
                continue
            # an odd-shaped batch: flush the pending group first, so the
            # update order matches the ungrouped loop
            if group:
                yield group_item()
                group = []
            fields = _batch_fields(batch)
            if sketch is not None:
                sketch.observe(fields[0])
            yield ("single", fields, batch.n_words)
        if group:                  # leftover partial group
            yield group_item()

    def _graph_key(self) -> tuple:
        """The addresses a captured graph reads and writes: the table's
        tensors and the sampler's, and the table's generation; and
        whether the step books the traffic ledger; and the window width
        and the transfer's plan knobs, whose layout and decisions a graph
        bakes in.  A table or vocab set since the capture (``table.state =
        ...``, ``build_from_vocab``, ``SparseTable.grow`` or
        ``repartition``), ``count_traffic`` switched or a knob moved needs
        new graphs."""
        t = self.transfer
        key = graph_key(self.table, self._slot_of_vocab, self._alias_prob,
                        self._alias_idx) + (
            self.push_window_size, t.count_traffic, t.wire_quant,
            t.wire_quant_guard,
            bool(t.wire_sketch), t.collective_mode, t.hot_touched_fraction,
            t.sparse_ar_ratio, t.window_expected_unique, t.pull_quant,
            t.pull_quant_guard, t.pull_cache)
        # armed numerics captures its bundle into the graph; off, the key
        # is the one without the plane
        return key + (("numerics",) if self._numerics is not None else ())

    def _run_group(self, fields, graphs: bool, draws, es_q: _LossAccum,
                   ec_q: _LossAccum) -> bool:
        """The steps of one group, in order (``utils.graphs.run_group``):
        one replay of the group length's CUDA graph when ``graphs`` and
        the graph exists (returns True), else the steps one by one; with
        ``graphs`` the first group of a length is the graph's warm-up."""
        group_step, whole = self._group_step()

        def step(f):
            if whole:
                return group_step(f, None if draws is None else [
                    next(draws) for _ in range(f[0].shape[0])])
            return group_step(f, None if draws is None else next(draws))
        L = fields[0].shape[0]
        capture = self._captures.get(L)
        if capture is None:
            # the compile catalog's funnel: one handle a group length,
            # dropped with the graphs, so a new length books a compile,
            # never a retrace
            capture = self._captures[L] = obs.costs.track(
                "w2v_multi", obs.costs.Captures(
                    lambda f: _FusedSteps(self, f)), steps_per_call=L)
        with obs.span("dispatch"):
            out, replayed = run_group(self._fused_cache, fields, step,
                                      graphs, capture, whole=whole)
        for es, ec in out:
            es_q.add(es)
            ec_q.add(ec)
        return replayed

    def train(self, data=None, niters: int = 1,
              batch_size: Optional[int] = None, batcher=None,
              draws: Optional[Iterator] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1, checkpoint_retain: int = 1,
              start_iter: int = 0) -> List[float]:
        """``data``: corpus path or list of key-list sentences.  Returns
        the per-iteration mean error Σerr_sum / round(Σerr_cnt) (reference
        Error::norm per train_iter; the count rounded once per iteration,
        as the JAX package does).  ``batcher``: a custom batch source with
        an ``epoch(batch_size)`` iterator (``epoch_stencil`` with
        ``stencil: 1``), e.g. the native ``PrefetchingCBOWBatcher``.
        ``draws``: an iterator of ``(j, u)`` pairs, one per step (per
        worker step, worker-major, in hogwild), replacing the model's
        generator.

        The loss sums stay on the device (``_LossAccum``) and are read
        once an epoch; a step reads nothing back.  ``[worker] pipeline:
        K`` renders K work items ahead on a producer thread; ``[worker]
        inner_steps: N`` groups N batches, and on a CUDA device with
        ``transfer: xla`` (and no ``draws``) runs a group as one CUDA graph
        replay; elsewhere the N steps run one by one, the same math.  The
        async modes run unfused, as in the JAX package: ``local_steps: L``
        steps against a snapshot refreshed every L steps of this call;
        ``async_mode: hogwild`` trains groups of ``n_workers *
        local_steps`` full batches (:meth:`_hogwild_group`) on the
        synchronous input loop, drops the batches of an epoch's last
        partial group (``train_metrics["hogwild_skipped_tail_words"]``)
        and raises if an epoch fills no group.

        ``checkpoint_path``: a full-fidelity npz checkpoint (AdaGrad sums
        included, ``extra__iter`` = ``start_iter`` + the iterations done)
        every ``checkpoint_every`` iterations, after the iteration's last
        step (its input pipeline closed, the device synchronized), keeping
        ``checkpoint_retain`` generations; resume with :meth:`resume`.
        Every iteration reports ``start_iter + it`` to the fault bus
        (``testing.faults.step_event``) at its top, where chaos plans and
        ``train_with_resume``'s hang watchdog hook in, and every save to
        ``faults.checkpoint_event``."""
        nprocs = self.cluster.dp
        if batcher is None:
            if isinstance(data, str):
                data = load_corpus(data, min_sentence_length=max(
                    self.min_sentence_length, 1))
            if data is None:
                raise ValueError("train() needs data or a batcher")
            if self.vocab is None:
                self.build(data)
            sents, seed = data, 2008
            if nprocs > 1:
                # this process's shard and rank-decorrelated subsampling:
                # the reference's one data file per node
                sents = shard_sentences(data, self.cluster.dp_rank, nprocs)
                seed += self.cluster.dp_rank
            batcher = CBOWBatcher(sents, self.vocab, self.window,
                                  self.sample, seed=seed)
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
        stencil = self.stencil
        hogwild = self.hogwild
        if stencil and nprocs > 1:
            raise ValueError(
                "the stencil rendering is single-process for now "
                "(DistributedBatcher shards per-pair batches); drop "
                "stencil or run single-process")
        if nprocs > 1:
            if hogwild:
                # hogwild's workers are one process's; across processes
                # the JAX package runs the snapshot mode instead
                self.local_steps = max(self.local_steps, 2)
                log.warning(
                    "async_mode=hogwild spans a single process's devices; "
                    "multi-process run falls back to snapshot bounded "
                    "staleness (local_steps=%d; measured loss envelope "
                    "+0.02%% vs hogwild at realistic scale — see "
                    "docs/ARCHITECTURE.md)", self.local_steps)
                hogwild = False
            if not isinstance(batcher, DistributedBatcher):
                batcher = DistributedBatcher(batcher)
        sync = self.local_steps <= 1 and not hogwild
        # groups (and graphs) are the sync loop's, in one process: JAX
        # fuses only there
        fuse = sync and self.inner_steps > 1 and nprocs == 1
        cuda = self.device.type == "cuda"
        # serving plane: arm the publisher so concurrent EmbeddingReaders
        # can read bounded-staleness views while this loop trains
        if self.serve_every > 0:
            self.serving_publisher()
        meter = Throughput()
        tel_rec, owns_rec = self._arm_telemetry(meter, sync)
        # one graph replay a group: one card, one shard (the ring's epoch
        # is a host counter a replay would repeat), the model's generator;
        # no graph while a tracer reads the ledger's counts in program
        # order
        graphs = (fuse and cuda and self.transfer.name == "xla"
                  and draws is None and obs.get_tracer() is None
                  and not (self.transfer.pull_cache
                           and self.transfer.count_traffic))
        if graphs and self._graph_key() != self._fused_key:
            self._fused_cache, self._captures = {}, {}
            self._fused_key = self._graph_key()
        pipelined = (self.pipeline_depth > 0 and not hogwild
                     and nprocs == 1)
        if self.pipeline_depth > 0 and not pipelined:
            log.warning(
                "[worker] pipeline=%d requested but %s — running the "
                "synchronous input loop", self.pipeline_depth,
                "hogwild groups its own batches" if hogwild
                else "multi-process batches are already-placed global "
                     "arrays")
        bound = resolve_dispatch_bound(self.dispatch_depth,
                                       pipelined=pipelined)
        # numpy leaves -> the card: pinned copies on a side stream, on
        # the producer thread when pipelined, inline otherwise
        stage = CudaTransfer(self.device) if cuda and not hogwild else None
        # the snapshot async mode's stale view (JAX ``frozen``): the
        # fields the grads read, copied now and refreshed every
        # local_steps steps of this call
        snapshot = None if sync or hogwild else _snapshot(
            self.table.state, self.access.pull_fields, self.cluster.mesh)
        step_i = dropped = 0
        pipe_stats = ({"produced": 0, "consumed": 0, "peak_queue_depth": 0,
                       "stall_s": 0.0, "transfer_s": 0.0}
                      if pipelined else None)
        losses, err = [], []
        words = steps = replays = 0
        # ring waits that gave up before this run (each leaves its
        # exchange's receive buffer unread)
        late_base = ring.timeouts()
        t0 = time.perf_counter()
        try:
            for it in range(niters):
                # the global iteration, cumulative across resumed runs: a
                # plan's crash at step k means after k finished iterations
                faults.step_event(start_iter + it)
                if faults.consume_nan():
                    self._poison_row()
                    if snapshot is not None:
                        _refresh(snapshot, self.table.state)
                es_q = _LossAccum(bound, self.device)
                ec_q = _LossAccum(None, self.device)
                if hogwild:
                    n, nw, skipped = self._hogwild_epoch(
                        batcher, batch_size, draws, meter, es_q, ec_q)
                    steps, words, dropped = (steps + n, words + nw,
                                             dropped + skipped)
                    # hogwild groups its own dispatches: publish at the
                    # epoch, the mode's consistency point
                    self._serve_on_steps(1)
                else:
                    items = self._epoch_items(batcher, batch_size, stencil,
                                              fuse)
                    pipe = None
                    if pipelined:
                        items = pipe = PrefetchIterator(
                            items, depth=self.pipeline_depth, transfer=stage)
                    elif stage is not None:
                        items = map(stage, items)
                    try:
                        while True:
                            # the stall clock covers exactly the input
                            # wait: inline it times rendering and staging,
                            # pipelined the empty-queue waits
                            with meter.stalling():
                                nxt = next(items, None)
                            if nxt is None:
                                break
                            if stage is not None:
                                nxt = stage.ready(nxt)
                            kind, fields, n_words = nxt
                            if kind == "group":
                                replays += self._run_group(
                                    fields, graphs, draws, es_q, ec_q)
                                n, nw = len(n_words), sum(n_words)
                            else:
                                d = None if draws is None else next(draws)
                                with obs.span("dispatch"):
                                    es, ec = self._numerics_run(
                                        lambda: self._step_fields(
                                            fields, d, snapshot))
                                es_q.add(es)
                                ec_q.add(ec)
                                n, nw = 1, n_words
                                step_i += 1
                                if snapshot is not None \
                                        and step_i % self.local_steps == 0:
                                    _refresh(snapshot, self.table.state)
                            meter.record(nw, steps=n)
                            obs.record_step(n)
                            steps += n
                            words += nw
                            self._serve_on_steps(n)
                            if self._control_on_steps(n) \
                                    and snapshot is not None:
                                # an apply re-laid the table out: the
                                # async view is copied from the new one
                                snapshot = _snapshot(
                                    self.table.state,
                                    self.access.pull_fields,
                                    self.cluster.mesh)
                    finally:
                        if pipe is not None:
                            pipe.close()
                            for k, v in pipe.stats().items():
                                if k == "peak_queue_depth":
                                    pipe_stats[k] = max(pipe_stats[k], v)
                                elif k != "depth":
                                    pipe_stats[k] += v
                # the epoch's sums and the run's ring waits that gave up,
                # over every process in process order: a wait that gave
                # up let its step go on with stale data, so every process
                # fails the run together
                es, ec, late = host_psum([es_q.total(), ec_q.total(),
                                          ring.timeouts() - late_base])
                if late:
                    raise RuntimeError(
                        f"iteration {start_iter + it}: {int(late)} ring "
                        f"exchange wait(s) timed out across "
                        f"{nprocs} process(es); the steps after them read "
                        f"stale data, so the run is stopped")
                err.append((es, ec))
                loss = err[-1][0] / max(int(round(err[-1][1])), 1)
                losses.append(loss)
                log.info("iter %d: error %.5f  (%.0f words/s)", it, loss,
                         meter.rate())
                if checkpoint_path and (it + 1) % checkpoint_every == 0:
                    self._checkpoint(checkpoint_path, start_iter + it + 1,
                                     checkpoint_retain)
            if cuda:
                torch.cuda.synchronize(self.device)
        finally:
            if stage is not None:
                stage.close()
        seconds = time.perf_counter() - t0
        # the final publish: readers see the trained state wherever the
        # every-K cadence landed
        self._serve_publish()
        self._close_telemetry(tel_rec, owns_rec)
        self.train_metrics = {
            "rendering": self.resolved_rendering,
            "steps": steps, "words": words, "seconds": seconds,
            "batcher_seconds": meter.host_stall_ms() / 1e3,
            "steps_per_sec": steps / max(seconds, 1e-9),
            "words_per_sec": words / max(seconds, 1e-9),
            "shards": self.cluster.n_servers,
            "push_paths": dict(self.transfer.push_paths),
            # host-stall vs device-time split (utils.timers.Throughput)
            "host_stall_ms": meter.host_stall_ms(),
            "device_ms": meter.device_ms(),
            "stall_ms_per_step": meter.stall_ms_per_step(),
            "pipeline_depth": self.pipeline_depth if pipelined else 0,
            "loader": ("native" if isinstance(batcher, NativeCBOWBatcher)
                       else "python"),
            "inner_steps": self.inner_steps,
            "push_window": self.push_window_size,
            "fused": graphs, "graph_replays": replays,
            "data_plane": self.data_plane_routes,
            "local_steps": self.local_steps, "async_mode": self.async_mode,
            "hogwild_skipped_tail_words": dropped,
            # per epoch (Σerr_sum, Σerr_cnt), the loss's two sums
            "epoch_err": err, "processes": nprocs}
        if isinstance(batcher, DistributedBatcher):
            # the host time of the lockstep's flag exchanges
            self.train_metrics["lockstep_ms_per_step"] = (
                1e3 * batcher.lockstep_s / max(batcher.lockstep_steps, 1))
        if pipe_stats is not None:
            self.train_metrics["pipeline"] = pipe_stats
        if self.transfer.count_traffic:
            # the ledger's totals, read once the run is done
            self.train_metrics["transfer_traffic"] = self.transfer.traffic()
        if self.controller is not None:
            self.train_metrics["control"] = {
                **self.controller.summary(),
                "recompiles": self._control_recompiles}
        if self._numerics is not None:
            det = self._numerics.detector
            self.train_metrics["numerics"] = {
                "bundles": self._numerics.bundles,
                "anomalies": det.anomalies_emitted if det else 0}
        return losses

    # -- the telemetry plane (obs/) -----------------------------------------
    def _arm_telemetry(self, meter: Throughput, sync: bool):
        """Arm the telemetry plane for this ``train`` call (JAX
        ``train``'s prologue): reuse an outer recorder or configure one
        from ``[worker]``/``[obs]`` (which also arms the compile catalog,
        the profiler session and the tracer), add the samplers (the
        ``Throughput`` split, the transfer ledger's mirror), arm numerics,
        and switch ``count_traffic`` on for an installed tracer.  Returns
        ``(recorder or None, whether this call owns it)``."""
        tel_rec = obs.get_recorder()
        owns_rec = tel_rec is None
        if owns_rec:
            tel_rec = obs.configure(self.config, run="word2vec")
        if tel_rec is not None:
            def _tel_sample(reg, _m=meter):
                reg.counter("train/host_stall_ms_total").set_total(
                    _m.host_stall_ms())
                reg.counter("train/device_ms_total").set_total(
                    _m.device_ms())
                reg.gauge("train/words_per_sec").set(_m.rate())
            tel_rec.add_sampler(_tel_sample)
            tel_rec.add_sampler(self.transfer.mirror_traffic)
        if self.numerics_on and tel_rec is not None and sync:
            self._arm_numerics(tel_rec)
        tracer = obs.get_tracer()
        if tracer is not None:
            self.transfer.count_traffic = True
            # hot-key attribution: the control sketch's decayed counts
            # replace the reservoir's touch estimates
            if self._control_sketch is not None:
                tracer.attach_sketch(self._control_sketch)
        return tel_rec, owns_rec

    def _close_telemetry(self, tel_rec, owns_rec: bool) -> None:
        """The end of ``train``: disarm the quant tap (a numerics-off model
        training next in this process must book nothing), finish an open
        profiler window, and close the recorder this call owns (its
        samplers read the ledger and the numerics buffers once more)."""
        from swiftmpi_tpu_torch.transfer import api as transfer_api
        if self._numerics is not None:
            transfer_api.clear_numerics_tap()
        prof = obs.get_profiler()
        if prof is not None:
            prof.close()
        if owns_rec and tel_rec is not None:
            tel_rec.close()
            obs.uninstall_recorder()

    def _arm_numerics(self, tel_rec) -> None:
        """Arm the numerics plane (JAX ``_arm_numerics``): the collector
        and its detector once (with checkpointed baselines restored, and
        the controller's demote hook registered), the transfer-wide
        quantization-error tap, and the sampler on the recorder (once a
        recorder).  A first-time arm drops the graphs captured without
        the bundle."""
        from swiftmpi_tpu_torch.transfer import api as transfer_api
        if self._numerics is None:
            det = obs_numerics.detector_from_config(self.config)
            if self._numerics_restore is not None:
                det.load_state_bytes(self._numerics_restore)
                self._numerics_restore = None
            self._numerics = obs_numerics.NumericsCollector(detector=det)
            self._fused_cache, self._captures = {}, {}
            if self.controller is not None:
                self.controller.attach_numerics(det, self._numerics_demote)
        transfer_api.set_numerics_tap(self._numerics.quant_tap)
        if id(tel_rec) != self._numerics_rec_id:
            tel_rec.add_sampler(self._numerics.sampler)
            self._numerics_rec_id = id(tel_rec)

    def _hogwild_epoch(self, batcher, batch_size: int, draws, meter,
                       es_q: _LossAccum, ec_q: _LossAccum) -> tuple:
        """One hogwild epoch (JAX ``_hogwild_epoch``): groups of
        ``n_workers * local_steps`` full batches, one
        :meth:`_hogwild_group` each; a batch of another size and the last
        partial group are dropped (the reference's workers likewise end an
        iteration unevenly, word2vec_global.h:630-651).  Returns ``(steps,
        words, dropped words)``; raises if no group was filled."""
        n = len(self.cluster.devices)
        group = n * max(self.local_steps, 1)
        replica = {f: torch.empty_like(t)
                   for f, t in self.table.state.items()}
        buf, dropped, groups, words = [], 0, 0, 0
        batches = iter(batcher.epoch(batch_size))
        while True:
            with meter.stalling():
                batch = next(batches, None)
            if batch is None:
                break
            if len(batch.centers) != batch_size:
                dropped += batch.n_words
                continue
            buf.append(batch)
            if len(buf) < group:
                continue
            es, ec = self._hogwild_group([_batch_fields(b) for b in buf],
                                         draws, replica)
            es_q.add(es)
            ec_q.add(ec)
            nw = sum(b.n_words for b in buf)
            meter.record(nw, steps=group)
            obs.record_step(group)
            groups, words, buf = groups + 1, words + nw, []
        dropped += sum(b.n_words for b in buf)
        if not groups:
            raise RuntimeError(
                f"hogwild epoch dispatched NO group: the corpus yielded "
                f"fewer than {group} full batches of {batch_size} centers "
                f"(group = {n} workers x {group // n} local_steps).  Lower "
                f"batch_size/local_steps or use more data — otherwise the "
                f"run would silently train nothing")
        if dropped:
            log.info("hogwild: %d tail words skipped this iter (need full "
                     "groups of %d batches x %d centers)", dropped, group,
                     batch_size)
        return groups * group, words, dropped

    # -- the serving plane ([serve]) ------------------------------------------
    def serving_publisher(self) -> SnapshotPublisher:
        """The model's :class:`~swiftmpi_tpu_torch.serve.snapshot.
        SnapshotPublisher`, made on the first call (or by ``train`` when
        ``[serve] every > 0``).  Attach ``EmbeddingReader`` instances to
        it from any number of query threads; ``train`` publishes a
        versioned host copy of the table and its key->slot map every
        ``[serve] every`` consumed steps, and once at its end."""
        if self.serve_publisher is None:
            self.serve_publisher = SnapshotPublisher(
                every=max(self.serve_every, 1), depth=self.serve_depth)
        return self.serve_publisher

    def _serve_on_steps(self, n: int) -> None:
        """Trainer-thread publication hook: account ``n`` consumed steps
        and publish when the staleness bound is reached.  The key->slot
        view is read HERE, on the trainer thread, where no ``grow`` or
        repartition is mid-flight, so readers see a matched (state, key
        map) pair."""
        pub = self.serve_publisher
        if pub is not None:
            pub.on_steps(self.table, n=n, keys=lambda: self.vocab.keys,
                         slots=lambda: self._slot_of_vocab.cpu().numpy(),
                         meta={"query_field": "v"})

    def _serve_publish(self) -> None:
        """Unconditional publish (the end of ``train``)."""
        pub = self.serve_publisher
        if pub is not None:
            pub.publish(self.table, keys=lambda: self.vocab.keys,
                        slots=lambda: self._slot_of_vocab.cpu().numpy(),
                        meta={"query_field": "v"})

    # -- the control plane ([control]) ---------------------------------------
    def _arm_control(self) -> None:
        """The control plane for this model (JAX ``_arm_control``): the
        decayed id sketch, seeded from the vocab's counts so evaluation 0
        reproduces the build-time calibration; the knobs (``hot_k`` on
        ``hybrid``; ``push_window`` and ``wire_format`` with
        ``inner_steps > 1``; ``collective`` when it is not ``psum`` on
        hybrid windows); and the controller.  The appliers own the
        safe-point machinery: the repartition and dropping the graphs."""
        st = self.control_settings
        keys = np.asarray(self.vocab.keys, np.uint64)
        self._control_key_order = np.argsort(keys, kind="stable")
        self._control_sorted_keys = keys[self._control_key_order]
        self._control_sketch = DecayedSketch(
            len(self.vocab), decay=st.decay, seed_counts=self.vocab.counts)
        self._control_recompiles = 0
        hybrid = self.transfer.name == "hybrid"
        knobs = []
        if hybrid:
            knobs.append(Knob(
                "hot_k", current=lambda: int(self.table.key_index.n_hot),
                propose=self._propose_hot_k, apply=self._apply_hot_k,
                describe=lambda p: {"n_hot": int(p.n_hot),
                                    "head_mass": p.head_mass}))
        if self.inner_steps > 1:
            knobs.append(Knob(
                "push_window", current=lambda: int(self.push_window_size),
                propose=self._propose_push_window,
                apply=self._apply_push_window))
            knobs.append(Knob(
                "wire_format", current=lambda: float(
                    self.transfer.window_expected_unique or 0.0),
                propose=self._propose_wire, apply=self._apply_wire))
        if self.collective_mode != "psum" and hybrid \
                and self.inner_steps > 1:
            # the collective crossover's input: the hot-touch density the
            # sparse-allreduce pricing reads
            knobs.append(Knob(
                "collective", current=lambda: float(
                    self.transfer.hot_touched_fraction or 0.0),
                propose=self._propose_collective,
                apply=self._apply_collective))
        self.controller = Controller(st, transfer=self.transfer,
                                     sketch=self._control_sketch,
                                     knobs=knobs)
        tracer = obs.get_tracer()
        if tracer is not None:
            tracer.attach_sketch(self._control_sketch)

    def _control_on_steps(self, n: int) -> bool:
        """Trainer-thread control hook, at the serving plane's safe points
        (no step running on the host, the table current).  True when an
        applied decision re-laid the table out or dropped the graphs: the
        train loop then re-reads what it holds of the table."""
        ctl = self.controller
        if ctl is None:
            return False
        self._control_dirty = False
        ctl.on_steps(n)
        return self._control_dirty

    def _control_mass(self, keys_arr, counts) -> float:
        """Sketch mass carried by a set of vocab keys."""
        keys_arr = np.asarray(keys_arr, np.uint64).ravel()
        if keys_arr.size == 0:
            return 0.0
        pos = np.searchsorted(self._control_sorted_keys, keys_arr)
        pos = np.minimum(pos, self._control_sorted_keys.size - 1)
        return float(counts[self._control_key_order[pos]].sum())

    def _rebuild_step(self) -> None:
        """The safe-point counterpart of JAX's recompile: a knob change
        that moves rows or reshapes the window invalidates every captured
        graph (the table's tensors, ``n_hot`` and the window layout are
        baked in), so the graphs and their catalog handles go, keyed
        afresh; the next group of each length recaptures."""
        self._fused_cache, self._captures = {}, {}
        self._fused_key = self._graph_key()
        self._control_recompiles += 1
        self._control_dirty = True

    def _propose_hot_k(self, counts, delta):
        """Re-run the hot/cold calibration on the decayed histogram.  Win
        = the token-mass points the new hot set holds over the current
        one, under the current traffic."""
        if counts is None:
            return None
        total = float(counts.sum())
        if total <= 0:
            return None
        # x1024: from_counts takes int64 counts; keep ~10 fractional bits
        # of the decayed histogram instead of truncating it
        part = HotColdPartition.from_counts(
            self.vocab.keys, counts * 1024.0, batch_rows=self.minibatch)
        cur = self.table.key_index.partition
        if cur is not None and part == cur:
            return None
        new_mass = self._control_mass(part.hot_keys, counts) / total
        cur_mass = (self._control_mass(cur.hot_keys, counts) / total
                    if cur is not None and cur.n_hot else 0.0)
        return Proposal(part, new_mass - cur_mass, {
            "old_n_hot": int(cur.n_hot) if cur is not None else 0,
            "new_n_hot": int(part.n_hot),
            "old_head_mass": cur_mass, "new_head_mass": new_mass,
            "sketch_observed": int(self._control_sketch.observed)})

    def _apply_hot_k(self, part, evidence) -> bool:
        """Repartition at the safe point.  A shard without room for the
        demoted rows rejects the decision (``CapacityError`` is raised
        before any change: the table is untouched)."""
        try:
            plan = self.table.repartition(part)
        except CapacityError as e:
            evidence["error"] = str(e)
            return False
        evidence["moved_rows"] = int(plan.moved_rows)
        slots = self.table.key_index.lookup(self.vocab.keys)
        self._slot_of_vocab = torch.as_tensor(slots, dtype=torch.int32,
                                              device=self.device)
        self._rebuild_step()
        return True

    def _propose_push_window(self, counts, delta):
        """Retune the window width over {W/2, W, 2W} (capped at
        ``inner_steps``).  Cost = the expected unique rows on the wire a
        step, ``E[U(w*B)] / w``."""
        if counts is None:
            return None
        W, B = self.push_window_size, self.minibatch
        cands = sorted({max(1, W // 2), W,
                        min(2 * W, max(self.inner_steps, 1))})
        if len(cands) == 1:
            return None

        def cost(w):
            return expected_unique_rows(counts, w * B) / w

        cur_cost = cost(W)
        if cur_cost <= 0:
            return None
        best = min(cands, key=cost)
        if best == W:
            return None
        return Proposal(int(best), (cur_cost - cost(best)) / cur_cost, {
            "old_w": int(W), "new_w": int(best),
            "rows_per_step_old": cur_cost,
            "rows_per_step_new": cost(best)})

    def _apply_push_window(self, w, evidence) -> bool:
        """The new width, and its window's unique-row estimate from the
        sketch (None at W = 1), as JAX's ``_apply_push_window``: the wire
        stack armed at build (``wire_quant``'s ``@ef`` planes at W > 1)
        stays as it was."""
        w = int(w)
        self.push_window_size = w
        self.transfer.window_expected_unique = (
            expected_unique_rows(self._control_sketch.counts,
                                 w * self.minibatch) if w > 1 else None)
        self._rebuild_step()
        return True

    def _propose_wire(self, counts, delta):
        """Refresh the window format's crossover input: the expected
        unique rows under the decayed histogram.  Win = the relative drift
        of ``E[U]`` since it was last set; the evidence carries the format
        a one-field window family would take under the old and the new
        estimate."""
        if counts is None or self.push_window_size <= 1:
            return None
        old = self.transfer.window_expected_unique
        if old is None:
            return None
        new = expected_unique_rows(counts,
                                   self.push_window_size * self.minibatch)
        d = self.len_vec
        row_bytes = 4 + 4 * d + 4          # i32 index + f32 row + counts
        qrb = 4 + (d + 4 if self.wire_quant == "int8" else 2 * d) + 4 \
            if self.wire_quant != "off" else None
        rows = self.push_window_size * self.minibatch

        def _fmt(eu):
            return window_wire_format(
                rows, self.table.capacity, row_bytes,
                dense_ratio=self.transfer.wire_dense_ratio("window"),
                expected_unique=eu, quant=self.wire_quant,
                quant_row_bytes=qrb,
                quant_guard=self.transfer.wire_quant_guard,
                sketch=bool(self.transfer.wire_sketch))

        return Proposal(float(new), abs(new - old) / max(float(old), 1.0),
                        {"old_expected_unique": float(old),
                         "new_expected_unique": float(new),
                         "old_format": _fmt(float(old)),
                         "new_format": _fmt(float(new))})

    def _apply_wire(self, eu, evidence) -> bool:
        """The new estimate on the transfer; the window plan keys on it,
        and the graphs that baked the old decision go."""
        self.transfer.window_expected_unique = float(eu)
        self._rebuild_step()
        return True

    def _propose_collective(self, counts, delta):
        """Refresh the hot-touch density the collective crossover prices
        by: the expected touched share of the hot head under the decayed
        histogram (the saturation model ``_seed_hot_touched_fraction``
        seeds from the vocab).  Win = the relative drift of the share; the
        evidence carries the collective a one-field family would take
        under the old and the new share."""
        if counts is None or self.push_window_size <= 1:
            return None
        n_hot = int(self.table.key_index.n_hot)
        if n_hot <= 0:
            return None
        old = self.transfer.hot_touched_fraction
        if old is None:
            return None
        c = np.asarray(counts, np.float64).ravel()
        total = c.sum()
        if total <= 0:
            return None
        head = np.sort(c)[::-1][:n_hot] / total
        draws = self.push_window_size * self.minibatch
        new = min(float(np.sum(-np.expm1(
            draws * np.log1p(-np.minimum(head, 1.0))))) / n_hot, 1.0)

        def _pick(frac):
            decision, _ = price_hot_collectives(
                n_hot, 4 * self.len_vec + 4, frac,
                sparse_ar_ratio=self.transfer.sparse_ar_ratio)
            return decision

        return Proposal(float(new),
                        abs(new - old) / max(float(old), 1e-6),
                        {"old_touched_fraction": float(old),
                         "new_touched_fraction": float(new),
                         "old_collective": _pick(float(old)),
                         "new_collective": _pick(float(new))})

    def _apply_collective(self, frac, evidence) -> bool:
        """The new density on the transfer (the hot plan keys on it); the
        graphs that baked the old collective go."""
        self.transfer.hot_touched_fraction = float(frac)
        self._rebuild_step()
        return True

    def _numerics_demote(self, anomaly: dict) -> Optional[str]:
        """The controller-applied numerics action (JAX
        ``_numerics_demote``): a sustained EF-residual runaway sets
        ``wire_quant`` and ``pull_quant`` to ``off`` on the model and the
        transfer at the control plane's safe point, and the graphs go.
        Returns the previous setting (for the decision event), or None
        when both are already off."""
        old_w, old_p = self.wire_quant, self.pull_quant
        if old_w == "off" and old_p == "off":
            return None
        log.warning(
            "numerics: sustained EF residual runaway on %s — demoting "
            "wire_quant %s -> off, pull_quant %s -> off",
            anomaly.get("series"), old_w, old_p)
        self.wire_quant = self.pull_quant = "off"
        self.transfer.wire_quant = "off"
        self.transfer.pull_quant = "off"
        self._rebuild_step()
        return old_w if old_w != "off" else f"pull:{old_p}"

    # -- checkpoints -------------------------------------------------------
    def _checkpoint(self, path: str, iteration: int, retain: int) -> None:
        """Save the table with ``extra__iter`` = ``iteration`` once the
        device has finished every step, then report the save to the fault
        bus.  Across processes every process waits at a barrier until
        process 0's file is on disk, so a world that dies after this
        iteration restarts from it, every process from the same
        generation."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        extra = {"iter": np.int64(iteration)}
        if self._numerics is not None \
                and self._numerics.detector is not None:
            # the baselines ride along: a resumed run scores its first
            # windows against the learned regime, not a cold baseline
            extra["numerics"] = self._numerics.detector.state_bytes()
        save_checkpoint(self.table, path, extra=extra, retain=retain)
        bootstrap.barrier()
        log.info("checkpoint @ iter %d -> %s", iteration, path)
        faults.checkpoint_event(npz_path(path))

    def _poison_row(self) -> None:
        """The ``nan`` fault (``testing.faults.consume_nan``): row 0 of
        the first grad field becomes NaN, in place."""
        f = self.access.grad_fields[0]
        v = self.table.state[f]
        (v[0] if isinstance(v, list) else v)[0] = float("nan")
        log.warning("fault injection: poisoned %s row 0 with NaN", f)

    def _remap_vocab(self) -> None:
        """Re-read the vocab's slots after the key index changed (a
        restore or a growth), in place: a captured CUDA graph reads this
        tensor, and stays valid unless the table's tensors moved."""
        if self.vocab is None:
            return
        slots = torch.as_tensor(self.table.key_index.lookup(self.vocab.keys),
                                dtype=torch.int32)
        self._slot_of_vocab.copy_(slots)

    def grow(self, new_capacity_per_shard: int) -> None:
        """Mid-run table growth (the reference's dense_hash_map
        self-growth, sparsetable.h:17-149, here an explicit re-layout;
        JAX ``Word2Vec.grow``): :meth:`SparseTable.grow`, then the
        fix-ups it leaves.  The vocab's slot map is re-read in place.  The
        pull cache starts cold, since the ``@rowver`` plane moved with its
        rows and a slot-keyed shadow could hit on another key's stamp.
        The captured graphs need nothing here: the table's new tensors
        and generation change ``_graph_key``, so the next group of each
        length recaptures; the transfers' plans are keyed by capacity."""
        self.table.grow(new_capacity_per_shard)
        self._remap_vocab()
        self.transfer.pull_shadow_flush()

    def embedding(self, key: int) -> Optional[np.ndarray]:
        """The input-side (v) row of an external key, from the hot head
        or the tail, as a host array in the field's dtype; None for a key
        the table does not hold."""
        ki = self.table.key_index
        if key not in ki:
            return None
        row = self.table.unified_rows("v", [ki.slot(key)])[0]
        return tensor_to_numpy(row)

    def embedding_index(self, field: str = "v"):
        """Cosine-similarity index over the live table's ``field`` rows of
        the vocab (``.neighbors(key)``, ``.analogy(a, b, c)``), on the
        model's device: a snapshot, to be rebuilt to see newer updates."""
        from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex
        if self.vocab is None:
            raise RuntimeError(
                "no vocab; build()/build_from_vocab() first (after a "
                "bare load(), use EmbeddingIndex.from_text on the dump)")
        slots = self._slot_of_vocab.cpu().numpy()
        vecs = self.table.unified_rows_host(field, upcast=True)[slots]
        return EmbeddingIndex(self.vocab.keys, vecs, device=self.device)

    def resume(self, checkpoint_path: str) -> int:
        """Restore a mid-training checkpoint in place (either package's
        npz); returns the iteration it was taken at.  The vocab's slot
        map is re-read from the restored key index.  An ``extra__numerics``
        entry (the numerics detector's baselines, either package's) is
        loaded into the armed detector, or kept for the next arming."""
        if self.table is None:
            raise RuntimeError("build() or load() the model before resume()")
        extra = load_checkpoint(self.table, checkpoint_path)
        self._remap_vocab()
        # a restore can rewind the version stamps: the cache starts cold
        self.transfer.pull_shadow_flush()
        num_state = extra.get("numerics")
        if num_state is not None:
            if self._numerics is not None \
                    and self._numerics.detector is not None:
                self._numerics.detector.load_state_bytes(num_state)
            else:
                self._numerics_restore = num_state
        return int(extra.get("iter", 0))

    # -- embeddings out/in (word2vec.h:100-117) --------------------------------
    def save(self, path: str) -> int:
        """The reference's text dump, WParam layout ``v TAB h``
        (word2vec.h:100-110), written by the native C++ writer when its
        library builds: byte for byte the JAX package's ``save``."""
        return dump_table_text(self.table, path, fields=("v", "h"))

    def load(self, path: str) -> int:
        """Load a ``save`` dump (either package's) into the table, made
        at ``capacity_per_shard`` if there is none yet; the table grows
        when the dump does not fit.  Returns the rows loaded."""
        if self.table is None:
            if self._capacity_per_shard is None:
                raise RuntimeError("set capacity_per_shard before load()")
            self.table = self.cluster.create_table(
                "w2v", self.access, self._capacity_per_shard)
        n = load_table_text(self.table, path, fields=("v", "h"))
        self._remap_vocab()
        return n
