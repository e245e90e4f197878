"""Cluster layer of the port: rank layout, key routing, orchestrator."""

from swiftmpi_tpu_torch.cluster.hashfrag import HashFrag
from swiftmpi_tpu_torch.cluster.mesh import (SHARD_AXIS, RankLayout,
                                             mesh_info, ps_mesh)

__all__ = ["Cluster", "HashFrag", "RankLayout", "SHARD_AXIS", "mesh_info",
           "ps_mesh"]


def __getattr__(name):
    # Cluster pulls in parameter and transfer, and parameter imports
    # hashfrag from here: import it lazily to keep the cycle open
    if name == "Cluster":
        from swiftmpi_tpu_torch.cluster.cluster import Cluster
        return Cluster
    raise AttributeError(name)
