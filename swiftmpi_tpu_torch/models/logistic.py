"""Sparse logistic regression on the parameter server (counterpart of
``swiftmpi_tpu/models/logistic.py``; the reference's
``apps/logistic/lr.cpp``).

Math, as in the reference and the JAX package: predict = σ(Σ w_f·x_f);
err = target − predict (gradient *ascent* on the log-likelihood); the
per-iteration training error is the mean err² (lr.cpp:358-375); AdaGrad
with fudge 1e-6 on the server; weights initialized U(0,1) (lr.cpp:48-50),
here from the table's ``torch.Generator``.

A minibatch is one step, in one of two renderings:

* **sparse** (the default, ``[worker] dense_features: 0`` or ``auto``):
  padded ``(B, F)`` feature slots; the pull is the masked row gather
  (B2) at ``where(mask, slots, -1)``, then ``logits = Σ w·x·mask``, the
  sigmoid, ``err`` on the valid rows, and a mean push of ``err·x·mask``
  by slot (the reference's ``grad/count`` at serialization,
  lr.cpp:32-38).  The push goes dense once ``B·F`` reaches half the
  table's capacity (B3 with its counts, then B1's table form with the
  mean's divisor inside the launch), else sparse (B1's row-indexed form,
  the mean's reciprocal inside the launch).
* **dense** (``dense_features: 1``): each minibatch densified on the host
  into ``X (B, capacity)`` and the per-slot counts (``_densify``, the same
  contribution and count multiset the sparse push sees), then ``X @ w``
  and ``err @ X`` as plain products (the JAX package leaves both to XLA,
  outside any Pallas kernel) and B1's table form with the mean's divisor.
  ``auto`` keeps the JAX package's rule, which flips to dense only on a
  TPU: here it takes the sparse rendering, on the CPU and on CUDA.

``[worker] inner_steps: N`` groups N minibatches, the counterpart of the
JAX package's ``lax.scan``: on a CUDA device with ``transfer: xla`` a
group is one replay of a captured CUDA graph (``utils/graphs.py``, one
graph per group length, captured anew when the table grows), elsewhere N
eager steps; a tail shorter than N runs as eager steps, as in JAX.
``[worker] scan_unroll`` is accepted and changes nothing: a graph replay
has no loop to unroll.  The step reads nothing back to the host; the
per-batch losses are summed on the device (``LossAccum``) and read once
an epoch.

The table grows during training: a minibatch whose new keys do not fit
raises ``CapacityError`` in the key index before any slot is made; the
queued group then runs through the old step, the table doubles
(``SparseTable.grow``, new rows drawn from the table's generator seeded
``seed + 1``), the graphs are dropped, and the minibatch is looked up
again.

With ``transfer: tpu`` (``server_num: n``) the pulls and pushes route
through the sharded parameter server, n ranks on the one card, and a
group runs its steps one by one (the ring's epoch is a host counter a
replay would repeat).  ``transfer: hybrid`` builds the table with no
partition (LR has no frequency histogram up front, as in the JAX
package): ``n_hot = 0``, the ``tpu`` path bit for bit (batches padded to
the rank count).

Across ``dp`` processes (``python -m swiftmpi_tpu_torch.launch -np
N``) every process reads the whole data set, as the JAX package feeds
it, looks every batch up in its own key index (so every replica makes
the same slots and grows alike), and computes its share of the batch
(``data.distributed.batch_share``: rows ``rank``-major, padded with
rows that contribute nothing).  The transfer sums the shares over the
processes before the one update (the dense rendering sums its product
and counts through the same exchange), and the epoch's error sums are
added over the processes in process order: a step is the one-process
step over the whole batch, each update counted once.  Groups run their
steps eagerly there (a cross-process exchange is no graph's).

As the JAX package's LR, the model reads no ``[obs]``, ``[worker]
telemetry``, ``[control]`` or ``[serve]`` key (it trains with them set);
its graph captures go through the compile catalog (``obs.costs``:
``lr_multi``, ``lr_dense_multi``), booked when a caller armed it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.data.distributed import batch_share
from swiftmpi_tpu_torch.data.libsvm import (CSRData, iter_minibatches,
                                            load_data)
from swiftmpi_tpu_torch.device import resolve_device
from swiftmpi_tpu_torch.io.checkpoint import dump_table_text, load_table_text
from swiftmpi_tpu_torch.io.pipeline import CudaTransfer
from swiftmpi_tpu_torch.parallel.collectives import host_psum
from swiftmpi_tpu_torch.parameter import lr_access
from swiftmpi_tpu_torch.parameter.key_index import CapacityError
from swiftmpi_tpu_torch.parameter.sparse_table import shard_block
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.utils.config import ConfigParser, global_config
from swiftmpi_tpu_torch.utils.graphs import StepGraph, graph_key, run_group
from swiftmpi_tpu_torch.utils.logger import get_logger
from swiftmpi_tpu_torch.utils.pipeline import LossAccum

log = get_logger(__name__)

#: a sparse step's arguments: slots, values, mask, targets
_SPARSE_DTYPES = (torch.int32, torch.float32, torch.bool, torch.float32)
#: a dense step's: X, per-slot counts, targets, row validity
_DENSE_DTYPES = (torch.float32, torch.float32, torch.float32, torch.bool)


def _max_feats(data) -> int:
    if isinstance(data, CSRData):
        return data.max_feats
    return max(len(f) for _, f in data)


def lr_formatter(row: Dict[str, np.ndarray]) -> str:
    """Reference LRParam operator<<: just the weight (lr.cpp:24-27)."""
    return repr(float(row["val"][0]))


def lr_parser(text: str) -> Dict[str, np.ndarray]:
    """The weight back from :func:`lr_formatter`'s text, as a ``(1,)``
    float32 row."""
    return {"val": np.array([float(text.split()[0])], np.float32)}


class LogisticRegression:
    def __init__(self, config: Optional[ConfigParser] = None,
                 cluster: Optional[Cluster] = None,
                 capacity_per_shard: int = 1 << 16, seed: int = 0,
                 device=None):
        self.config = config if config is not None else global_config()
        g = self.config.get_or
        self.minibatch = g("worker", "minibatch", 200).to_int32()
        lr = g("server", "initial_learning_rate", 0.05).to_float()
        self.device = resolve_device(device)
        self.cluster = cluster or Cluster(
            self.config, devices=[self.device]).initialize()
        self.access = lr_access(lr)
        self.table = self.cluster.create_table(
            "lr", self.access, capacity_per_shard, seed=seed)
        self.transfer = self.cluster.transfer
        self.inner_steps = g("worker", "inner_steps", 1).to_int32()
        # [worker] dense_features: auto|0|1 — the capacity-dense rendering
        self.dense_features = g("worker", "dense_features",
                                "auto").to_string()
        # [worker] scan_unroll: JAX's lax.scan unroll factor; a CUDA graph
        # replay has no loop to unroll, so the value changes nothing
        self.scan_unroll = g("worker", "scan_unroll", 1).to_int32()
        #: group length -> its captured CUDA graph, valid for _graph_key
        self._graphs: Dict[int, StepGraph] = {}
        self._graph_key: tuple = ()
        #: group length -> its capture handle in the compile catalog
        #: (``obs.costs``), dropped with the graphs
        self._captures: dict = {}
        #: the parser of the last file ``train``/``predict`` loaded
        self.parser = ""
        self.train_metrics: dict = {}

    # -- the sparse rendering (JAX _step_core) -----------------------------
    def _step_core(self, slots, vals, mask, targets):
        """One minibatch, in place on the table: ``(Σ err², rows)`` as
        device scalars (the loss times its row count, so a group's sums
        add up)."""
        access, transfer = self.access, self.transfer
        state = self.table.state
        B, F = slots.shape
        flat = torch.where(mask, slots, -1).reshape(-1)
        w = transfer.pull(state, flat, access)["val"].reshape(B, F)
        logits = (w * vals * mask).sum(dim=1)
        predict = torch.sigmoid(logits)
        row_valid = mask.any(dim=1)
        err = torch.where(row_valid, targets - predict, 0.0)
        # mean=True: the reference's grad.val/grad.count normalization at
        # push serialization (lr.cpp:32-38)
        contrib = (err[:, None] * vals * mask).reshape(-1, 1)
        transfer.push(state, flat, {"val": contrib}, access, mean=True)
        n = row_valid.sum().float()
        loss = (err * err).sum() / n.clamp(min=1.0)
        return loss * n, n

    # -- the dense rendering (JAX _densify, _dense_core) --------------------
    def dense_enabled(self) -> bool:
        mode = self.dense_features.lower()
        if mode in ("1", "on", "true"):
            return True
        # "0" and "auto": the JAX rule flips to dense only when the
        # model's devices are TPUs, so auto is sparse here
        return False

    def _densify(self, slots, vals, mask, targets):
        """(B, F) padded-sparse batch -> capacity-dense ``(X, cnt, t, v)``:
        ``X[b, slot] += val`` and ``cnt[slot] += 1`` per valid
        (row, feature) occurrence — the same contribution and count
        multiset the sparse push sees (duplicate features in one row
        accumulate in both, as in the reference's per-key grad/count)."""
        cap = self.table.capacity
        B, F = slots.shape
        X = np.zeros((B, cap), np.float32)
        cnt = np.zeros((cap,), np.float32)
        m = np.asarray(mask, bool)
        rows = np.broadcast_to(np.arange(B)[:, None], (B, F))
        np.add.at(X, (rows[m], np.asarray(slots)[m]),
                  np.asarray(vals, np.float32)[m])
        np.add.at(cnt, np.asarray(slots)[m], 1.0)
        return (X, cnt, np.asarray(targets, np.float32), m.any(axis=1))

    def _table_view(self, field: str) -> torch.Tensor:
        """``field`` over the whole table in global slot order, in place:
        the ``(cap, 1)`` tensor, or a sharded table's ``(n, cap_per_shard,
        1)`` block of shards."""
        v = self.table.state[field]
        return shard_block(v) if isinstance(v, list) else v

    def _dense_core(self, X, cnt, targets, valid):
        val, g2 = self._table_view("val"), self._table_view("grad2sum")
        w = val.reshape(-1)                                # (cap,)
        predict = torch.sigmoid(X @ w)
        err = torch.where(valid, targets - predict, 0.0)
        grad = err @ X                                     # (cap,)
        if self.transfer.dp > 1:
            # every process's share of the product and the counts
            grad, cnt = self.transfer._dp_psum([grad, cnt])
        # the mean's division by the counts inside B1's table form
        self.access.apply_push(
            {"val": val, "grad2sum": g2},
            {"val": grad.view(val.shape)},
            div=cnt.clamp(min=1.0).view(val.shape[:-1]))
        n = valid.sum().float()
        loss = (err * err).sum() / n.clamp(min=1.0)
        return loss * n, n

    # -- training (lr.cpp:157-240) -------------------------------------------
    def _on_device(self, cols, dtypes, stage):
        """Host arrays -> tensors on the model's device in ``dtypes``,
        through ``stage`` (pinned copies on a side stream) on CUDA."""
        if stage is not None:
            cols = stage.ready(stage(tuple(np.ascontiguousarray(c)
                                           for c in cols)))
        else:
            cols = tuple(torch.from_numpy(np.ascontiguousarray(c))
                         for c in cols)
        return tuple(c.to(self.device, dt) for c, dt in zip(cols, dtypes))

    def train(self, data, niters: int = 1,
              max_feats: Optional[int] = None) -> List[float]:
        """``data``: path to a libSVM file, a pre-parsed instance list, or
        ``CSRData`` (native parser output).  Returns per-iteration mean
        training error (reference logs ``error: total/nrecords`` per iter,
        lr.cpp:231)."""
        if isinstance(data, str):
            data = load_data(data)
            self.parser = data.parser
        inner = max(1, self.inner_steps)
        F = max_feats or _max_feats(data)
        cuda = self.device.type == "cuda"
        dp, rank = self.cluster.dp, self.cluster.dp_rank
        graphs = (inner > 1 and cuda and self.transfer.name == "xla"
                  and dp == 1)
        # a share of whole rows that splits over the shard ranks
        n = getattr(self.transfer, "n", 1)
        multiple = n // np.gcd(n, F)
        stage = CudaTransfer(self.device) if cuda else None
        losses, epoch_err = [], []
        steps = records = replays = growths = 0
        group: list = []
        t0 = time.perf_counter()

        def flush_group(num_q: LossAccum, den_q: LossAccum) -> None:
            nonlocal steps, replays
            if not group:
                return
            dense = self.dense_enabled()
            if dense:
                entries = [self._densify(*e) for e in group]
                core, dtypes = self._dense_core, _DENSE_DTYPES
            else:
                entries = list(group)
                core, dtypes = self._step_core, _SPARSE_DTYPES
            if len(entries) == inner and inner > 1:
                # the table's tensors and generation, and the step's shape
                key = (graph_key(self.table), F, dense,
                       self.transfer.count_traffic)
                if key != self._graph_key:
                    self._graphs, self._graph_key = {}, key
                    self._captures = {}
                stacked = self._on_device(
                    [np.stack(col) for col in zip(*entries)], dtypes, stage)
                capture = self._captures.get(inner)
                if capture is None:
                    # the compile catalog's funnel (JAX: lr_multi and
                    # lr_dense_multi)
                    capture = self._captures[inner] = obs.costs.track(
                        "lr_dense_multi" if dense else "lr_multi",
                        obs.costs.Captures(lambda f: StepGraph(
                            lambda a: core(*a), f,
                            push_paths=self.transfer.push_paths)),
                        steps_per_call=inner)
                out, replayed = run_group(
                    self._graphs, stacked, lambda f: core(*f), graphs,
                    capture)
                replays += replayed
            else:
                # a tail (or a pre-growth flush) shorter than a group:
                # eager steps, as JAX dispatches them one by one
                out = [core(*self._on_device(cols, dtypes, stage))
                       for cols in entries]
            for num, den in out:
                num_q.add(num)
                den_q.add(den)
            steps += len(entries)
            group.clear()

        try:
            for it in range(niters):
                num_q = LossAccum("auto", self.device)
                den_q = LossAccum(None, self.device)
                for batch in iter_minibatches(data, self.minibatch, F):
                    keys = np.where(batch.mask, batch.feat_ids, 0)
                    while True:
                        try:
                            slots = self.table.key_index.lookup(keys)
                            break
                        except CapacityError:
                            # the lookup made no slot; queued batches hold
                            # the old layout's slots: run them first, then
                            # re-lay the table out and drop its graphs
                            flush_group(num_q, den_q)
                            self.table.grow()
                            self._graphs, self._graph_key = {}, ()
                            self._captures = {}
                            growths += 1
                            log.info("table grown to %d rows",
                                     self.table.capacity)
                    cols = (slots, batch.feat_vals, batch.mask,
                            batch.targets)
                    if dp > 1:
                        cols = batch_share(cols, (0, 0.0, False, 0.0), rank,
                                           dp, multiple=multiple)
                    group.append(cols)
                    if len(group) == inner:
                        flush_group(num_q, den_q)
                flush_group(num_q, den_q)
                total, count = num_q.total(), den_q.total()
                if dp > 1:
                    total, count = host_psum([total, count])
                epoch_err.append((total, count))
                records += int(round(count))
                mean_err = total / max(int(round(count)), 1)
                losses.append(mean_err)
                log.info("iter %d: %d records  error: %.6f", it,
                         int(round(count)), mean_err)
            if cuda:
                torch.cuda.synchronize(self.device)
        finally:
            group.clear()
            if stage is not None:
                stage.close()
        seconds = time.perf_counter() - t0
        self.train_metrics = {
            "rendering": "dense" if self.dense_enabled() else "sparse",
            "steps": steps, "records": records, "seconds": seconds,
            "records_per_sec": records / max(seconds, 1e-9),
            "push_paths": dict(self.transfer.push_paths),
            "inner_steps": inner, "fused": graphs, "graph_replays": replays,
            "growths": growths, "capacity": self.table.capacity,
            "parser": self.parser, "shards": self.cluster.n_servers,
            # per epoch (Σ err², rows), the error's two sums
            "epoch_err": epoch_err}
        return losses

    # -- prediction (lr.cpp:240-295) ---------------------------------------
    def predict(self, data, max_feats: Optional[int] = None) -> np.ndarray:
        """σ(Σ w·x) per instance; the weights pulled through the transfer
        (B2), the sums on the host in numpy, as the JAX package does."""
        if isinstance(data, str):
            data = load_data(data)
            self.parser = data.parser
        F = max_feats or _max_feats(data)
        scores = []
        for batch in iter_minibatches(data, self.minibatch, F):
            slots = self.table.key_index.lookup(
                np.where(batch.mask, batch.feat_ids, 0), create=False)
            slots = np.where(batch.mask, slots, -1).astype(np.int32)
            rows = self.transfer.pull(
                self.table.state,
                torch.from_numpy(slots.reshape(-1)).to(self.device),
                self.access)["val"]
            w = rows.cpu().numpy().reshape(len(batch), F)
            logits = (w * batch.feat_vals * batch.mask).sum(axis=1)
            scores.append(1.0 / (1.0 + np.exp(-logits)))
        return np.concatenate(scores)[:len(data)]

    def error_rate(self, data) -> float:
        """Offline eval, the reference's tools/evaluate.py (26-line
        threshold-at-0.5 error rate)."""
        if isinstance(data, str):
            data = load_data(data)
            self.parser = data.parser
        scores = self.predict(data)
        targets = (data.labels if isinstance(data, CSRData)
                   else np.array([y for y, _ in data]))
        return float(((scores > 0.5) != (targets > 0.5)).mean())

    # -- checkpoint (lr.cpp:297-300; server.h:49-77) -------------------------
    def save(self, path: str) -> int:
        return dump_table_text(self.table, path, fields=("val",))

    def load(self, path: str) -> int:
        """Rows written in place, or into a grown table (whose new
        generation drops the graphs at the next ``train``)."""
        return load_table_text(self.table, path, fields=("val",))
