"""Data parallelism over the batch stream (counterpart of
``swiftmpi_tpu/data/distributed.py``).

The reference distributes training data by giving each MPI rank its own
file; each rank computes on its shard and the gradients combine at the
servers.  Here every process streams batches from its own shard
(:func:`shard_sentences`), and the transfer reconciles each step's pushes
across the processes.  A batch stays local: there is no global array, and
the global batch is ``batch_size * process_count``.

LR and GloVe read the whole data set in every process, as the JAX
package feeds them (replicated), and each process computes its share of
every global batch (:func:`batch_share`): the transfer sums the shares,
so a step is the one-process step over the whole batch, and no update is
counted twice.

Lockstep protocol: every process must run the same number of steps (each
push is a collective), but shards deplete unevenly (subsampling is
random).  Before each step a gather over gloo on the host exchanges
``(has_batch, n_words)`` (int64); the epoch ends the moment any shard runs
dry, and each step's ``n_words`` is the global sum.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from swiftmpi_tpu_torch.cluster import bootstrap
from swiftmpi_tpu_torch.data.text import CBOWBatch
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)


def shard_sentences(sentences, rank: Optional[int] = None,
                    nprocs: Optional[int] = None):
    """This process's data shard (round-robin, balanced to one sentence):
    the reference's per-node data file."""
    rank = bootstrap.process_index() if rank is None else rank
    nprocs = bootstrap.process_count() if nprocs is None else nprocs
    return sentences[rank::nprocs]


def batch_share(arrays: Sequence[np.ndarray], pads: Sequence,
                rank: int, nprocs: int, axis: int = 0,
                multiple: int = 1) -> tuple:
    """Process ``rank``'s share of one global batch that every process
    holds whole: along ``axis``, the batch padded with ``pads`` (one fill
    value an array, rows that contribute nothing) to ``nprocs`` equal
    shares of a multiple of ``multiple`` rows, the ``rank``-th of them
    (JAX's batch spec ``P((data, shard))``: process-major)."""
    n = arrays[0].shape[axis]
    share = -(-n // (nprocs * multiple)) * multiple
    out = []
    for a, fill in zip(arrays, pads):
        a = np.asarray(a)
        short = share * nprocs - n
        if short:
            shape = list(a.shape)
            shape[axis] = short
            a = np.concatenate([a, np.full(shape, fill, a.dtype)], axis)
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(rank * share, (rank + 1) * share)
        out.append(a[tuple(idx)])
    return tuple(out)


class DistributedBatcher:
    """Wraps a per-process batcher into a lockstep batch stream.

    ``batcher`` yields ``CBOWBatch``es; batches shorter than
    ``batch_size`` are dropped so every process keeps one shape.  Each
    yielded batch is this process's, with ``n_words`` the sum over the
    processes.  ``lockstep_s`` adds up the host time of the flag
    exchanges."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.vocab = getattr(batcher, "vocab", None)
        self.lockstep_s = 0.0
        self.lockstep_steps = 0

    def _flags(self, batch) -> torch.Tensor:
        import torch.distributed as dist
        flag = torch.tensor([0 if batch is None else 1,
                             0 if batch is None else batch.n_words],
                            dtype=torch.int64)
        parts = [torch.empty_like(flag)
                 for _ in range(bootstrap.process_count())]
        t0 = time.perf_counter()
        dist.all_gather(parts, flag)
        self.lockstep_s += time.perf_counter() - t0
        self.lockstep_steps += 1
        return torch.stack(parts)

    def epoch(self, batch_size: int) -> Iterator[CBOWBatch]:
        it = self.batcher.epoch(batch_size)
        steps = 0
        while True:
            batch = next(it, None)
            while batch is not None and len(batch) != batch_size:
                batch = next(it, None)      # drop ragged batches
            flags = self._flags(batch)
            if int(flags[:, 0].min()) == 0:
                if batch is not None:
                    log.debug("epoch cut at %d steps: another shard ran "
                              "dry first", steps)
                return
            yield CBOWBatch(batch.centers, batch.contexts, batch.ctx_mask,
                            int(flags[:, 1].sum()))
            steps += 1
