"""GloVe (global word-vector factorization) on the parameter server
(counterpart of ``swiftmpi_tpu/models/glove.py``).

Beyond the reference's app set: GloVe's original trainer is server-side
AdaGrad over a sparse table, the reference's parameter-server contract,
so the whole model is an access-method schema plus one step.

Math (Pennington et al. 2014): for each co-occurrence count x_ij,

    J_ij = w_i . wt_j + b_i + bt_j - log(x_ij)
    loss = f(x_ij) * J_ij^2,   f(x) = min((x / x_max)^alpha, 1)

with symmetric-window counts weighted 1/distance, trained by AdaGrad on
(w, b) of the focus word and (wt, bt) of the context word.  The exported
embedding is the standard w + wt sum.

The co-occurrence set is built once on the host as COO arrays
(:func:`cooccurrence`, numpy copied from the JAX package); every epoch is
a permutation of it drawn from ``np.random.default_rng(seed)`` (the JAX
package's numpy stream, so the two trajectories can be compared step for
step), padded by cycling to whole groups, staged on the host
(:meth:`GloVe.stage_host`) and run as groups of ``[worker] inner_steps``
minibatch steps.  A step is two pulls through the masked row gather (B2;
``(w, b)`` at the focus slots and ``(wt, bt)`` at the context slots, one
launch per field), elementwise math, and two mean pushes of two families
each through the transfer: sparse below half the table's capacity (B1's
row-indexed form per family), else dense (B3 and B1's table form per
family).  On a CUDA device with ``transfer: xla`` a group is one replay of
a captured CUDA graph (``utils/graphs.py``), the counterpart of the JAX
package's ``lax.scan``; elsewhere its steps run one by one.  ``transfer:
tpu`` routes through the sharded server; ``hybrid`` builds the table with
no partition, as the JAX package does, so it is the ``tpu`` path bit for
bit.  ``[worker] pipeline: K`` stages groups K ahead on a producer thread with
pinned copies to the card (``io/pipeline.py``); the permutations stay on
the consumer, in epoch order, so results do not depend on K.  The loss
sums stay on the device and are read once an epoch.

Across ``dp`` processes every process builds the vocab and the
co-occurrence set from the whole corpus and draws the same epoch
permutations, as the JAX package feeds every process the whole data
set; each computes its share of every minibatch
(``data.distributed.batch_share``: cells ``rank``-major, padded with
``-1`` cells of weight 0, to a multiple of the shard ranks), the
transfer sums the shares before the update, and the epoch's loss sums
are added over the processes in process order: the one-process step
over the whole minibatch.  Groups run their steps eagerly there.

Config section ``[glove]``: ``len_vec`` (default 100), ``window`` (10),
``x_max`` (100), ``alpha`` (0.75), ``learning_rate`` (0.05),
``minibatch`` (4096), plus ``[worker] inner_steps``, ``pipeline`` and
``dispatch_depth``.

The telemetry plane is armed by ``train`` as in the JAX package:
``[worker] telemetry`` (a recorder, the ``dispatch`` span a group,
``obs.record_step``), ``[obs] numerics`` (one bundle a group, staged on
the collector's device buffers inside the graph; observe-only: GloVe has
no control plane), ``[obs] costs`` (each graph capture books
``glove_step``), the profiler windows and the tracer.  GloVe reads no
``[control]`` or ``[serve]`` key, as the JAX package's does not.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.data.distributed import batch_share
from swiftmpi_tpu_torch.data.text import Vocab, build_vocab
from swiftmpi_tpu_torch.device import resolve_device
from swiftmpi_tpu_torch.io.checkpoint import dump_table_text
from swiftmpi_tpu_torch.io.pipeline import CudaTransfer, PrefetchIterator
from swiftmpi_tpu_torch.obs import numerics as obs_numerics
from swiftmpi_tpu_torch.parallel.collectives import host_psum
from swiftmpi_tpu_torch.parameter.access import (AdaGradAccess, AdaGradRule,
                                                 FieldSpec, vec_rand_init,
                                                 zeros_init)
from swiftmpi_tpu_torch.parameter.sparse_table import tensor_to_numpy
from swiftmpi_tpu_torch.utils.config import ConfigParser, global_config
from swiftmpi_tpu_torch.utils.graphs import StepGraph, graph_key, run_group
from swiftmpi_tpu_torch.utils.logger import get_logger
from swiftmpi_tpu_torch.utils.pipeline import (LossAccum,
                                               resolve_dispatch_bound)
from swiftmpi_tpu_torch.utils.timers import Throughput

log = get_logger(__name__)

#: a step's arguments: focus slots, context slots, log x, f(x)
_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32)


def glove_access(learning_rate: float, len_vec: int) -> AdaGradAccess:
    """One table keyed by word: focus (w, b) and context (wt, bt)
    families with per-element AdaGrad sums — the optimizer GloVe
    shipped with, already the framework's native access method."""
    return AdaGradAccess(
        learning_rate,
        rules=(AdaGradRule("w", "w2sum", "w"),
               AdaGradRule("wt", "wt2sum", "wt"),
               AdaGradRule("b", "b2sum", "b"),
               AdaGradRule("bt", "bt2sum", "bt")),
        fields={"w": FieldSpec(len_vec, vec_rand_init),
                "wt": FieldSpec(len_vec, vec_rand_init),
                "b": FieldSpec(1, zeros_init),
                "bt": FieldSpec(1, zeros_init),
                "w2sum": FieldSpec(len_vec, zeros_init),
                "wt2sum": FieldSpec(len_vec, zeros_init),
                "b2sum": FieldSpec(1, zeros_init),
                "bt2sum": FieldSpec(1, zeros_init)},
        pull_fields=("w", "wt", "b", "bt"),
    )


def cooccurrence(sentences, vocab: Vocab, window: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric-window co-occurrence counts, weight ``1/distance``
    (the GloVe paper's decreasing weighting).  Returns COO arrays
    (focus_idx, ctx_idx, weight) over VOCAB indices, deduplicated.

    Vectorized per offset: for distance k every in-sentence token pair
    (t, t+k) contributes 1/k to BOTH (i,j) and (j,i); pairs are folded
    by combined int64 key with ``np.unique`` — no per-pair python."""
    V = len(vocab.keys)
    idx_rows: List[np.ndarray] = []
    wts: List[np.ndarray] = []
    for sent in sentences:
        ids = [vocab.index_of(k) for k in sent]
        t = np.asarray([i for i in ids if i is not None], np.int64)
        if len(t) < 2:
            continue
        for k in range(1, min(window, len(t) - 1) + 1):
            a, b = t[:-k], t[k:]
            idx_rows.append(a * V + b)
            idx_rows.append(b * V + a)
            w = np.full(len(a), 1.0 / k, np.float32)
            wts.append(w)
            wts.append(w)
    if not idx_rows:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    combined = np.concatenate(idx_rows)
    weights = np.concatenate(wts)
    uniq, inv = np.unique(combined, return_inverse=True)
    x = np.zeros(len(uniq), np.float32)
    np.add.at(x, inv, weights)
    return ((uniq // V).astype(np.int32), (uniq % V).astype(np.int32), x)


class GloVe:
    def __init__(self, config: Optional[ConfigParser] = None,
                 cluster: Optional[Cluster] = None,
                 capacity_per_shard: Optional[int] = None, seed: int = 0,
                 device=None):
        self.config = config if config is not None else global_config()
        g = self.config.get_or
        self.len_vec = g("glove", "len_vec", 100).to_int32()
        self.window = g("glove", "window", 10).to_int32()
        self.x_max = g("glove", "x_max", 100.0).to_float()
        self.alpha = g("glove", "alpha", 0.75).to_float()
        lr = g("glove", "learning_rate", 0.05).to_float()
        self.minibatch = g("glove", "minibatch", 4096).to_int32()
        self.inner_steps = g("worker", "inner_steps", 1).to_int32()
        # [worker] pipeline / dispatch_depth: as in word2vec; the epoch
        # permutations are drawn on the consumer in epoch order, so K
        # changes when work happens, never what is computed
        self.pipeline_depth = g("worker", "pipeline", 0).to_int32()
        if self.pipeline_depth < 0:
            raise ValueError("[worker] pipeline must be >= 0")
        self.dispatch_depth = g("worker", "dispatch_depth",
                                "auto").to_string()
        self.device = resolve_device(device)
        self.cluster = cluster or Cluster(
            self.config, devices=[self.device]).initialize()
        self.access = glove_access(lr, self.len_vec)
        self.transfer = self.cluster.transfer
        self.seed = seed
        self._capacity_per_shard = capacity_per_shard
        self.table = None
        self.vocab: Optional[Vocab] = None
        #: the table slot of each vocab index (int32, host)
        self._slot_of_vocab: Optional[np.ndarray] = None
        self._coo = None
        #: group length -> its captured CUDA graph, valid for _graph_key
        self._graphs: Dict[int, StepGraph] = {}
        self._graph_key: tuple = ()
        #: group length -> its capture handle in the compile catalog
        self._captures: dict = {}
        self.train_metrics: dict = {}
        # [obs] numerics (obs/numerics.py): off constructs nothing
        self.numerics_on = obs_numerics.enabled(self.config)
        self._numerics: Optional[obs_numerics.NumericsCollector] = None
        self._numerics_rec_id: Optional[int] = None
        #: the armed group's push statistics, one triple a step
        self._num_acc: Optional[list] = None

    # -- build: vocab + co-occurrence + table ------------------------------
    def build(self, sentences) -> "GloVe":
        self.vocab = build_vocab(sentences)
        V = len(self.vocab.keys)
        cap = self._capacity_per_shard or max(
            64, int(V * 1.3) // self.cluster.n_servers + 1)
        self.table = self.cluster.create_table(
            "glove", self.access, cap, seed=self.seed)
        self._slot_of_vocab = self.table.key_index.lookup(
            self.vocab.keys).astype(np.int32)
        fi, ci, x = cooccurrence(sentences, self.vocab, self.window)
        self._coo = (fi, ci, x)
        log.info("glove: vocab %d, %d co-occurrence cells (window %d)",
                 V, len(x), self.window)
        return self

    # -- the step (JAX _build_step's ``one``) ---------------------------------
    def _step(self, fs, cs, logx, fx) -> Tuple[torch.Tensor]:
        """One minibatch, in place on the table; ``(loss,)`` as a device
        scalar (``fx·J²`` summed)."""
        access, transfer = self.access, self.transfer
        state = self.table.state
        rows_f = transfer.pull(state, fs, access, fields=("w", "b"))
        rows_c = transfer.pull(state, cs, access, fields=("wt", "bt"))
        w, b = rows_f["w"], rows_f["b"][:, 0]
        wt, bt = rows_c["wt"], rows_c["bt"][:, 0]
        J = (w * wt).sum(dim=1) + b + bt - logx
        g = fx * J                                       # dJ/d(dot)
        loss = (fx * J * J).sum()
        # AdaGradAccess ADDS lr*g (the reference's ascent convention,
        # lr.cpp:68-75): push the NEGATIVE gradient
        gw = (-g)[:, None] * wt
        gwt = (-g)[:, None] * w
        gb = (-g)[:, None].contiguous()
        if self._num_acc is not None:
            n_hot = int(self.table.n_hot)
            self._num_acc.append(obs_numerics.add_stats(
                obs_numerics.push_stats(fs, {"w": gw, "b": gb}, n_hot),
                obs_numerics.push_stats(cs, {"wt": gwt, "bt": gb}, n_hot)))
        transfer.push(state, fs, {"w": gw, "b": gb}, access, mean=True)
        transfer.push(state, cs, {"wt": gwt, "bt": gb}, access, mean=True)
        return (loss,)

    # -- minibatch staging -------------------------------------------------
    def stage_host(self, sel: np.ndarray, inner: int, B: int):
        """COO selection -> host ``(fs, cs, logx, fx)`` stacks of shape
        (inner, B): the ONE definition of slot mapping and the
        f(x) = min((x/x_max)^alpha, 1) weighting, shared by train() and
        the profile app.  Pure numpy — what the input pipeline's producer
        thread runs off the critical path."""
        fi, ci, x = self._coo
        sov = self._slot_of_vocab
        sel = np.resize(sel, inner * B)
        xs = x[sel]
        return (sov[fi[sel]].reshape(inner, B),
                sov[ci[sel]].reshape(inner, B),
                np.log(xs).reshape(inner, B),
                np.minimum((xs / self.x_max) ** self.alpha,
                           1.0).astype(np.float32).reshape(inner, B))

    def stage(self, sel: np.ndarray, inner: int, B: int):
        """``stage_host`` as tensors on the model's device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(f)).to(
            self.device, dt) for f, dt in zip(
                self.stage_host(sel, inner, B), _DTYPES))

    def _numerics_group(self, fields) -> Tuple[torch.Tensor]:
        """One group as one numerics dispatch (JAX ``multi`` with the
        plane armed): the four fields copied at entry, the steps' push
        statistics summed, one bundle staged; ``(loss,)`` summed."""
        num = self._numerics
        fields_up = ("w", "wt", "b", "bt")
        state = self.table.state
        state0 = num.snapshot(state, fields_up)
        self._num_acc = acc = []
        try:
            loss = None
            for i in range(fields[0].shape[0]):
                (li,) = self._step(*(f[i] for f in fields))
                loss = li if loss is None else loss + li
        finally:
            self._num_acc = None
        grad_acc = None
        for stats in acc:
            grad_acc = obs_numerics.add_stats(grad_acc, stats)
        n = float(fields[0].shape[0] * fields[0].shape[1])
        obs_numerics.stage_step(num, state0, state, grad_acc, loss, n,
                                fields_up)
        return (loss,)

    def _run_group(self, fields, graphs: bool) -> Tuple[List[tuple], bool]:
        """One group's steps on ``(inner, B)`` device tensors: a graph
        replay when ``graphs`` (after a warm-up and capture on the first
        group of a length), else the steps one by one (with numerics
        armed, one call on the whole group).  Returns the ``(loss,)``
        outputs and whether the group was a replay."""
        armed = self._numerics is not None
        key = ((graph_key(self.table), self.transfer.count_traffic, armed)
               if graphs else self._graph_key)
        if key != self._graph_key:
            self._graphs, self._graph_key = {}, key
            self._captures = {}
        if armed:
            step, whole = self._numerics_group, True
        else:
            step, whole = (lambda f: self._step(*f)), False
        L = fields[0].shape[0]
        capture = self._captures.get(L)
        if capture is None:
            capture = self._captures[L] = obs.costs.track(
                "glove_step", obs.costs.Captures(lambda f: StepGraph(
                    step, f, push_paths=self.transfer.push_paths,
                    whole=whole)), steps_per_call=L)
        return run_group(self._graphs, fields, step, graphs, capture,
                         whole=whole)

    # -- training ----------------------------------------------------------
    def train(self, sentences=None, niters: int = 1) -> List[float]:
        """Returns the mean loss per epoch: Σ f(x)·J² over the epoch's
        padded cells over their number, as the JAX package reports it."""
        if self.table is None:
            if sentences is None:
                raise RuntimeError("build() first or pass sentences")
            self.build(sentences)
        n = len(self._coo[2])
        if n == 0:
            raise RuntimeError("empty co-occurrence set")
        B = min(self.minibatch, n)
        inner = max(1, self.inner_steps)
        cuda = self.device.type == "cuda"
        dp, rank = self.cluster.dp, self.cluster.dp_rank
        graphs = (inner > 1 and cuda and self.transfer.name == "xla"
                  and dp == 1)
        pipelined = self.pipeline_depth > 0
        bound = resolve_dispatch_bound(self.dispatch_depth,
                                       pipelined=pipelined)
        stage = CudaTransfer(self.device) if cuda else None
        rng = np.random.default_rng(self.seed)
        meter = Throughput()
        tel_rec, owns_rec = self._arm_telemetry(meter)
        losses: List[float] = []
        steps = replays = 0
        pipe_stats = ({"produced": 0, "consumed": 0, "peak_queue_depth": 0,
                       "stall_s": 0.0, "render_s": 0.0, "transfer_s": 0.0}
                      if pipelined else None)
        t0 = time.perf_counter()

        def staged_groups(order):
            # the epoch permutation was already drawn (consumer thread,
            # epoch order) — from here on the staging is pure numpy, so
            # it can run ahead on the producer thread
            for gstart in range(0, len(order), B * inner):
                cols = self.stage_host(order[gstart:gstart + B * inner],
                                       inner, B)
                if dp > 1:
                    cols = batch_share(cols, (-1, -1, 0.0, 0.0), rank, dp,
                                       axis=1,
                                       multiple=getattr(self.transfer, "n",
                                                        1))
                yield cols

        try:
            for it in range(niters):
                order = rng.permutation(n)
                # pad the tail by CYCLING the permutation (static shapes,
                # via stage_host()'s np.resize — holds even when one group
                # exceeds n); repeats are extra samples of real cells, and
                # per-slot mean normalization keeps their scale right
                n_groups = -(-n // (B * inner))
                order = np.resize(order, n_groups * B * inner)
                loss_q = LossAccum(bound, self.device)
                items = staged_groups(order)
                pipe = None
                if pipelined:
                    items = pipe = PrefetchIterator(
                        items, depth=self.pipeline_depth, transfer=stage)
                elif stage is not None:
                    items = map(stage, items)
                try:
                    while True:
                        with meter.stalling():
                            fields = next(items, None)
                        if fields is None:
                            break
                        if stage is not None:
                            fields = stage.ready(fields)
                        fields = tuple(
                            torch.as_tensor(f).to(self.device, dt)
                            for f, dt in zip(fields, _DTYPES))
                        with obs.span("dispatch"):
                            out, replayed = self._run_group(fields, graphs)
                        replays += replayed
                        for (loss,) in out:
                            loss_q.add(loss)
                        steps += inner
                        meter.record(B * inner)
                        obs.record_step(inner)
                finally:
                    if pipe is not None:
                        pipe.close()
                        for k, v in pipe.stats().items():
                            if k == "peak_queue_depth":
                                pipe_stats[k] = max(pipe_stats[k], v)
                            elif k != "depth":
                                pipe_stats[k] += v
                total = loss_q.total()
                if dp > 1:
                    (total,) = host_psum([total])
                mean_loss = total / len(order)
                losses.append(mean_loss)
                log.info("glove iter %d: %d cells  loss %.6f", it, n,
                         mean_loss)
            if cuda:
                torch.cuda.synchronize(self.device)
        finally:
            if stage is not None:
                stage.close()
        seconds = time.perf_counter() - t0
        self._close_telemetry(tel_rec, owns_rec)
        cells = steps * B
        self.train_metrics = {
            "steps": steps, "cells": cells, "seconds": seconds,
            "cells_per_sec": cells / max(seconds, 1e-9),
            "host_stall_ms": meter.host_stall_ms(),
            "unstalled_ms": meter.unstalled_ms(),
            "stall_ms_per_step": meter.stall_ms_per_step(),
            "pipeline_depth": self.pipeline_depth,
            "inner_steps": inner, "fused": graphs, "graph_replays": replays,
            "push_paths": dict(self.transfer.push_paths),
            "shards": self.cluster.n_servers}
        if pipe_stats is not None:
            self.train_metrics["pipeline"] = pipe_stats
        if self._numerics is not None:
            det = self._numerics.detector
            self.train_metrics["numerics"] = {
                "bundles": self._numerics.bundles,
                "anomalies": det.anomalies_emitted if det else 0}
        return losses

    # -- the telemetry plane (obs/) -----------------------------------------
    def _arm_telemetry(self, meter: Throughput):
        """Reuse an outer recorder or configure one (JAX ``GloVe.train``),
        add the ``Throughput`` and ledger-mirror samplers and arm
        numerics.  Returns ``(recorder or None, whether this call owns
        it)``."""
        tel_rec = obs.get_recorder()
        owns_rec = tel_rec is None
        if owns_rec:
            tel_rec = obs.configure(self.config, run="glove")
        if tel_rec is not None:
            def _tel_sample(reg, _m=meter):
                reg.counter("train/host_stall_ms_total").set_total(
                    _m.host_stall_ms())
                reg.counter("train/unstalled_ms_total").set_total(
                    _m.unstalled_ms())
            tel_rec.add_sampler(_tel_sample)
            tel_rec.add_sampler(self.transfer.mirror_traffic)
        if self.numerics_on and tel_rec is not None:
            self._arm_numerics(tel_rec)
        return tel_rec, owns_rec

    def _close_telemetry(self, tel_rec, owns_rec: bool) -> None:
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
        """Arm the numerics plane (observe-only: GloVe has no control
        plane): the collector once, the quant tap, the sampler once a
        recorder; a first-time arm drops the graphs."""
        from swiftmpi_tpu_torch.transfer import api as transfer_api
        if self._numerics is None:
            self._numerics = obs_numerics.NumericsCollector(
                detector=obs_numerics.detector_from_config(self.config))
            self._graphs, self._graph_key, self._captures = {}, (), {}
        transfer_api.set_numerics_tap(self._numerics.quant_tap)
        if id(tel_rec) != self._numerics_rec_id:
            tel_rec.add_sampler(self._numerics.sampler)
            self._numerics_rec_id = id(tel_rec)

    # -- outputs -----------------------------------------------------------
    def _vectors(self) -> np.ndarray:
        """The exported embedding: standard w + wt sum, vocab order —
        ONE definition shared by the live index and the dump (numpy on
        the host, as the JAX package sums them)."""
        if self.vocab is None:
            raise RuntimeError("build() first")
        slots = self._slot_of_vocab
        return (tensor_to_numpy(self.table.global_rows("w"))[slots]
                + tensor_to_numpy(self.table.global_rows("wt"))[slots])

    def embedding_index(self):
        """Cosine index over the standard w + wt embedding sum, on the
        model's device."""
        from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex

        return EmbeddingIndex(self.vocab.keys, self._vectors(),
                              device=self.device)

    def save(self, path: str) -> int:
        """``key TAB (w + wt)-vector`` — the standard GloVe export, in
        the single-vector dump layout ``w2v_eval`` indexes directly (the
        JAX package's file, byte for byte)."""
        vecs = self._vectors()
        n = 0
        with open(path, "w") as f:
            for key, vec in zip(self.vocab.keys, vecs):
                f.write(f"{int(key)}\t"
                        + " ".join(repr(float(v)) for v in vec) + "\n")
                n += 1
        return n

    def save_full(self, path: str) -> int:
        """Both families in the reference checkpoint text format."""
        return dump_table_text(self.table, path,
                               fields=("w", "wt", "b", "bt"))
