"""Serving plane (counterpart of ``swiftmpi_tpu/serve/``): bounded-
staleness reads over live training state.

The parameter server exists to *answer pulls*; this package is the read
side the training machinery earns.

* :mod:`~swiftmpi_tpu_torch.serve.snapshot` — ``SnapshotPublisher`` /
  ``TableSnapshot``: the trainer publishes an immutable, versioned host
  copy of the table every K consumed steps.  Readers on other threads
  only ever see a complete snapshot (one reference assignment — never a
  half-copied state dict), so staleness is bounded by K steps and torn
  reads are impossible by construction.
* :mod:`~swiftmpi_tpu_torch.serve.reader` — ``EmbeddingReader``: the
  pull-only read API.  Hot-head slots answer from the ``@hot`` planes'
  host copy; tail slots go through an LRU front built on
  ``parameter.cache.LocalParamCache`` before paying a vectorized host
  gather.  Readers never launch device work.
* :mod:`~swiftmpi_tpu_torch.serve.query` — the batched top-k neighbor
  path: one normalized ``(Q, d) @ (d, V)`` product and a partial sort
  over the snapshot's host rows (``device=True``: the torch path on the
  card, for trainer-thread bulk use).
* :mod:`~swiftmpi_tpu_torch.serve.shipper` — ``SnapshotShipper`` /
  ``SnapshotReplica``: each published snapshot shipped into a
  version-chained delta stream (a full base + row deltas through the
  ``transfer.delta`` codec) that replica readers replay into a local
  host table exposing the publisher's reader surface, so
  ``EmbeddingReader(replica)`` serves unchanged.

Metrics land in the ``obs`` registry under ``serve/*`` (snapshots,
queries, hits and misses, staleness, latency histograms) when telemetry
is on; the readers also keep always-on plain-int counters.
"""

from swiftmpi_tpu_torch.serve.reader import EmbeddingReader, LruTailFront
from swiftmpi_tpu_torch.serve.shipper import (SnapshotReplica,
                                              SnapshotShipper)
from swiftmpi_tpu_torch.serve.snapshot import (SnapshotPublisher,
                                               SnapshotUnavailable,
                                               TableSnapshot)

__all__ = ["EmbeddingReader", "LruTailFront", "SnapshotPublisher",
           "SnapshotReplica", "SnapshotShipper", "SnapshotUnavailable",
           "TableSnapshot"]
