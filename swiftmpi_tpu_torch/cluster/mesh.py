"""The rank layout of the sharded parameter server (counterpart of
``swiftmpi_tpu/cluster/mesh.py``).

Where the JAX package names a device mesh and lets XLA place the
collectives, the port names ``n`` ranks and the device each one lives on.
Every rank plays both roles, worker (it holds a slice of the batch) and
server (it holds a table shard), the reference's default deployment
(cluster/cluster.h:65-71).  Ranks are logical: several may share one
device, so ``n`` shards run on one card, each with its own table rows and
buffers.  Only the 1-D ``shard`` layout is ported; the data axis across
processes and the ``torch.distributed`` bootstrap are not (ROADMAP A11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

SHARD_AXIS = "shard"


@dataclass(frozen=True)
class RankLayout:
    """``devices[r]`` is the device of rank ``r``."""

    devices: Tuple[torch.device, ...]
    axis: str = SHARD_AXIS

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
            devices: Optional[Sequence] = None) -> RankLayout:
    """``n`` ranks (default: one per device) dealt over ``devices``
    (default: every visible card) round-robin: rank ``r`` lives on
    ``devices[r % len(devices)]``."""
    devs = tuple(torch.device(d) for d in (
        visible_devices() if devices is None else devices))
    if not devs:
        raise ValueError("ps_mesh needs at least one device")
    n = len(devs) if n is None else int(n)
    if n <= 0:
        raise ValueError("ps_mesh needs a positive rank count")
    return RankLayout(tuple(devs[r % len(devs)] for r in range(n)))


def mesh_info(mesh: RankLayout) -> Dict[str, object]:
    """Layout introspection for the bring-up log."""
    return {"axis_names": [mesh.axis], "axis_sizes": [mesh.n],
            "n_devices": len(mesh.distinct_devices),
            "devices": [str(d) for d in mesh.distinct_devices]}
