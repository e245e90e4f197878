"""The rank layout of the sharded parameter server (counterpart of
``swiftmpi_tpu/cluster/mesh.py``).

Where the JAX package names a device mesh and lets XLA place the
collectives, the port names ``n`` ranks and the device each one lives on.
Every rank plays both roles, worker (it holds a slice of the batch) and
server (it holds a table shard), the reference's default deployment
(cluster/cluster.h:65-71).  Ranks are logical: several may share one
device, so ``n`` shards run on one card, each with its own table rows and
buffers.

A multi-process run adds the data axis, as JAX's ``ps_mesh(hybrid=True)``
does: ``dp`` processes (``dp_rank`` this one), each holding a full table
replica over its own ``n`` shard ranks.  The shard axis stays within a
process; only the push's reconcile crosses processes (the transfers'
``dp`` path, through ``parallel/collectives.py``).  Shards on different
cards are ROADMAP A11d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from swiftmpi_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SHARD_AXIS = "shard"


@dataclass(frozen=True)
class RankLayout:
    """``devices[r]`` is the device of rank ``r``; ``dp`` processes hold a
    replica each, this one is ``dp_rank``."""

    devices: Tuple[torch.device, ...]
    axis: str = SHARD_AXIS
    dp: int = 1
    dp_rank: int = 0

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))

    @property
    def device_groups(self) -> Tuple[Tuple[torch.device, Tuple[int, ...]],
                                     ...]:
        """``(device, its ranks in rank order)`` for every distinct
        device: the ranks whose table shards form one block."""
        return tuple((dev, tuple(r for r, d in enumerate(self.devices)
                                 if d == dev))
                     for dev in self.distinct_devices)


def visible_devices() -> Tuple[torch.device, ...]:
    """Every CUDA card this process sees; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: -device "
            "cpu) to run the plain PyTorch versions on the CPU")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def ps_mesh(n: Optional[int] = None,
            devices: Optional[Sequence] = None,
            hybrid: bool = False) -> RankLayout:
    """``n`` ranks (default: one per device) dealt over ``devices``
    (default: every visible card) round-robin: rank ``r`` lives on
    ``devices[r % len(devices)]``.  With ``hybrid`` in a multi-process
    run, the layout gains the data axis: one replica per process."""
    devs = tuple(torch.device(d) for d in (
        visible_devices() if devices is None else devices))
    if not devs:
        raise ValueError("ps_mesh needs at least one device")
    n = len(devs) if n is None else int(n)
    if n <= 0:
        raise ValueError("ps_mesh needs a positive rank count")
    dp, dp_rank = 1, 0
    if hybrid:
        from swiftmpi_tpu_torch.cluster.bootstrap import (process_count,
                                                          process_index)
        dp, dp_rank = process_count(), process_index()
    return RankLayout(tuple(devs[r % len(devs)] for r in range(n)),
                      dp=dp, dp_rank=dp_rank)


def mesh_info(mesh: RankLayout) -> Dict[str, object]:
    """Layout introspection for the bring-up log."""
    names, sizes = [mesh.axis], [mesh.n]
    if mesh.dp > 1:
        names, sizes = [DATA_AXIS] + names, [mesh.dp] + sizes
    return {"axis_names": names, "axis_sizes": sizes,
            "n_devices": len(mesh.distinct_devices),
            "devices": [str(d) for d in mesh.distinct_devices],
            "dp_rank": mesh.dp_rank}


class Mesh:
    """Named axes of logical ranks, all on one device: the counterpart of
    ``jax.sharding.Mesh`` for the transformer family.  ``axis_names`` and
    ``shape[axis]`` read as JAX's do; ``device`` is where every rank's
    tensors live (the current CUDA card unless ``device="cpu"``)."""

    def __init__(self, axes: Mapping[str, int], device: DeviceLike = None):
        shape = {str(a): int(n) for a, n in dict(axes).items()}
        if not shape:
            raise ValueError("a mesh needs at least one axis")
        bad = {a: n for a, n in shape.items() if n < 1}
        if bad:
            raise ValueError(f"mesh axes need positive sizes, got {bad}")
        self.shape: Dict[str, int] = shape
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.device = resolve_device(device)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"
