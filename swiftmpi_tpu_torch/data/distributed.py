"""Data parallelism over the batch stream (counterpart of
``swiftmpi_tpu/data/distributed.py``).

The reference distributes training data by giving each MPI rank its own
file; each rank computes on its shard and the gradients combine at the
servers.  Here every process streams batches from its own shard
(:func:`shard_sentences`), and the transfer reconciles each step's pushes
across the processes.  A batch stays local: there is no global array, and
the global batch is ``batch_size * process_count``.

Lockstep protocol: every process must run the same number of steps (each
push is a collective), but shards deplete unevenly (subsampling is
random).  Before each step a gather over gloo on the host exchanges
``(has_batch, n_words)`` (int64); the epoch ends the moment any shard runs
dry, and each step's ``n_words`` is the global sum.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

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
