"""Cluster layer of the port: bootstrap, rank layout, key routing,
orchestrator, and the elastic membership plane (the member table and the
elastic worker)."""

__all__ = ["Cluster", "HashFrag", "Mesh", "RankLayout", "SHARD_AXIS",
           "mesh_info",
           "ps_mesh", "MemberTable", "StaleEpochError", "ElasticWorker"]

#: exported name -> its module.  Imported at first use: parameter imports
#: hashfrag from here (Cluster pulls in parameter and transfer), and the
#: launcher imports the bootstrap and the member table without torch
_EXPORTS = {"Cluster": "cluster", "HashFrag": "hashfrag",
            "Mesh": "mesh", "RankLayout": "mesh", "SHARD_AXIS": "mesh", "mesh_info": "mesh",
            "ps_mesh": "mesh", "MemberTable": "membership",
            "StaleEpochError": "membership", "ElasticWorker": "elastic"}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(
        f"swiftmpi_tpu_torch.cluster.{mod}"), name)
