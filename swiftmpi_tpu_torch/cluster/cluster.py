"""Cluster orchestrator: bring-up and tear-down around a training run
(counterpart of ``swiftmpi_tpu/cluster/cluster.py``, the reference
``Cluster<WorkerT, ServerT, KeyT>``, cluster/cluster.h:9-140).

``initialize()`` builds the rank layout, the hashfrag routing table and
the transfer backend from the ``[cluster]`` section; ``create_table``
makes a table sharded the way the transfer routes; ``finalize(path)``
dumps the registered tables as text.

Config surface (reference cluster.h:13-25 + demo.conf):

* ``server_num`` — number of table shards; absent means one per visible
  device.
* ``transfer`` — ``xla`` (one device, no routing) or ``tpu`` (the sharded
  parameter server: bucketed request/response routing between
  ``server_num`` ranks).  ``hybrid`` and ``local`` are not ported.
* ``[server] frag_num`` — hashfrag granularity.
* ``data_plane`` — ``auto``/``pallas`` run the hand-written kernels;
  ``xla`` (the JAX package's library route) is not ported.

All ranks of a layout must live on one device for now: shards on
different cards and the multi-process bootstrap are ROADMAP A11.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from swiftmpi_tpu_torch.cluster.hashfrag import HashFrag
from swiftmpi_tpu_torch.cluster.mesh import (mesh_info, ps_mesh,
                                             visible_devices)
from swiftmpi_tpu_torch.parameter.access import AccessMethod
from swiftmpi_tpu_torch.parameter.key_index import KeyIndex
from swiftmpi_tpu_torch.parameter.sparse_table import SparseTable
from swiftmpi_tpu_torch.transfer.api import Transfer, get_transfer
from swiftmpi_tpu_torch.utils.config import ConfigParser, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

DATA_PLANE_MODES = ("auto", "pallas", "xla")


class Cluster:
    def __init__(self, config: Optional[ConfigParser] = None,
                 devices: Optional[Sequence] = None):
        self.config = config if config is not None else global_config()
        self._devices = devices
        self.mesh = None
        self.hashfrag: Optional[HashFrag] = None
        self.transfer: Optional[Transfer] = None
        self.tables: Dict[str, SparseTable] = {}
        self._initialized = False

    # -- bring-up (cluster.h:27-30) ----------------------------------------
    def initialize(self) -> "Cluster":
        g = self.config.get_or
        devices = tuple(visible_devices() if self._devices is None
                        else self._devices)
        n_servers = g("cluster", "server_num", len(devices)).to_int32()
        backend = g("cluster", "transfer", "xla").to_string()
        self.data_plane = g("cluster", "data_plane", "auto").to_string()
        if self.data_plane not in DATA_PLANE_MODES:
            raise ValueError(f"[cluster] data_plane must be one of "
                             f"{DATA_PLANE_MODES}, got {self.data_plane!r}")
        if backend == "tpu":
            # explicit routing: every rank is worker + server
            self.mesh = ps_mesh(n_servers, devices)
            if len(self.mesh.distinct_devices) > 1:
                raise NotImplementedError(
                    f"transfer: tpu over {len(self.mesh.distinct_devices)} "
                    "devices: shards on different cards are not ported yet "
                    "(ROADMAP A11); pass one device")
            kwargs = {"mesh": self.mesh, "data_plane": self.data_plane}
        else:
            if backend == "xla" and n_servers != 1:
                raise NotImplementedError(
                    f"[cluster] server_num: {n_servers} with transfer: xla "
                    "(the model-axis sharded table) is not ported yet "
                    "(ROADMAP A11); set transfer: tpu for the sharded "
                    "parameter server, or server_num: 1")
            # one device, no routing: the table is one tensor per field
            self.mesh = None
            kwargs = {}
        self.device = devices[0] if self.mesh is None \
            else self.mesh.devices[0]
        self.n_servers = n_servers
        frag_num = (self.config.get("server", "frag_num").to_int32()
                    if self.config.has("server", "frag_num") else None)
        self.hashfrag = HashFrag(n_servers, frag_num)
        self.transfer = get_transfer(backend, **kwargs)
        self._initialized = True
        log.info("cluster up: %s transfer=%s",
                 mesh_info(self.mesh) if self.mesh is not None
                 else {"n_devices": 1, "devices": [str(self.device)]},
                 backend)
        return self

    # -- tables ------------------------------------------------------------
    def create_table(self, name: str, access: AccessMethod,
                     capacity_per_shard: int, seed: int = 0) -> SparseTable:
        if not self._initialized:
            raise RuntimeError("Cluster.initialize() first")
        ki = KeyIndex(self.n_servers, capacity_per_shard,
                      hashfrag=self.hashfrag)
        table = SparseTable(access, ki, self.device, seed=seed,
                            mesh=self.mesh)
        self.tables[name] = table
        return table

    # -- tear-down (cluster.h:41-54) ---------------------------------------
    def finalize(self, path: Optional[str] = None, formatter=None) -> None:
        """Dump registered tables as text checkpoints (reference
        SparseTable::output, sparsetable.h:119-132) and drop them."""
        if path is not None:
            from swiftmpi_tpu_torch.io.checkpoint import dump_table_text
            for name, table in self.tables.items():
                out = path if len(self.tables) == 1 else f"{path}.{name}"
                dump_table_text(table, out, formatter)
                log.info("finalize: dumped table %s -> %s", name, out)
        self.tables.clear()
        self._initialized = False
