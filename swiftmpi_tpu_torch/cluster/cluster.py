"""Cluster orchestrator: bring-up and tear-down around a training run
(counterpart of ``swiftmpi_tpu/cluster/cluster.py``, the reference
``Cluster<WorkerT, ServerT, KeyT>``, cluster/cluster.h:9-140).

``initialize()`` builds the rank layout, the hashfrag routing table and
the transfer backend from the ``[cluster]`` section; ``create_table``
makes a table sharded the way the transfer routes; ``finalize(path)``
dumps the registered tables as text.

Config surface (reference cluster.h:13-25 + demo.conf):

* ``server_num`` — number of table shards; absent means one per visible
  device.  On ``xla`` the n model-axis shards are one ``(n * cap, d)``
  tensor per field with ``KeyIndex(n, cap)``'s slot layout, so a slot
  means what it means in the JAX package's model-sharded table.
* ``transfer`` — ``xla`` (one device, no routing), ``tpu`` (the sharded
  parameter server: bucketed request/response routing between
  ``server_num`` ranks), ``hybrid`` (the same rank layout as ``tpu`` for
  the tail, the frequency head in hot planes; ``create_table(...,
  partition=)`` gives a table its head) or ``local`` (the numpy oracle,
  no layout).
* ``[server] frag_num`` — hashfrag granularity.
* ``data_plane`` — ``pallas`` runs the hand-written kernels (B4 for the
  stencil's neu1, B5 for the sharded exchange), ``xla`` the JAX
  package's library route (torch ops, the ranks' transpose), ``auto``
  the kernels unless the process named a device-kind verdict store
  (``ops/calibration.use_store``) that records the library route at
  least 10% faster than a correct kernel.

``initialize()`` first joins the process group the launcher names
(``cluster/bootstrap.py``, the ``MPI_Init`` of the reference).  In a run
of ``dp`` processes every process holds a full table replica, on ``xla``
or over its own ``server_num`` ranks on ``tpu`` and ``hybrid`` (the data
axis, JAX's hybrid mesh), and the transfers reconcile every push across
the processes.  ``local`` under ``dp > 1`` is refused: the JAX package's
word2vec cannot train on ``local`` even in one process.
All ranks of a layout must live on one device: shards on different cards
are ROADMAP A11d.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from swiftmpi_tpu_torch.cluster.bootstrap import (init_distributed,
                                                  process_count,
                                                  process_index)
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
        #: the devices the cluster was given (or found), repeats kept: the
        #: hogwild mode runs one worker on each
        self.devices: tuple = ()
        self.mesh = None
        self.hashfrag: Optional[HashFrag] = None
        self.transfer: Optional[Transfer] = None
        self.tables: Dict[str, SparseTable] = {}
        self._initialized = False

    # -- bring-up (cluster.h:27-30) ----------------------------------------
    def initialize(self) -> "Cluster":
        # MPI_Init equivalent: join the process group the launcher named
        # (a no-op otherwise; see cluster/bootstrap.py)
        multi_process = init_distributed(self.config)
        #: processes holding a replica each (the data axis), and this one
        self.dp, self.dp_rank = process_count(), process_index()
        g = self.config.get_or
        devices = self.devices = tuple(visible_devices()
                                       if self._devices is None
                                       else self._devices)
        n_servers = g("cluster", "server_num", len(devices)).to_int32()
        backend = g("cluster", "transfer", "xla").to_string()
        self.data_plane = g("cluster", "data_plane", "auto").to_string()
        if self.data_plane not in DATA_PLANE_MODES:
            raise ValueError(f"[cluster] data_plane must be one of "
                             f"{DATA_PLANE_MODES}, got {self.data_plane!r}")
        if self.dp > 1 and backend == "local":
            raise NotImplementedError(
                f"transfer: local across {self.dp} processes: the JAX "
                "package's local backend is its host oracle, and its "
                "word2vec cannot train on it even in one process (a "
                "TracerArrayConversionError in the jitted step), so there "
                "is no reference to hold a data axis against (ROADMAP "
                "queue C); use xla, tpu or hybrid")
        if backend in ("tpu", "hybrid"):
            # explicit routing: every rank is worker + server; hybrid's
            # tail IS the tpu routing.  Multi-process: the shard axis stays
            # within the process, the data axis spans the processes
            self.mesh = ps_mesh(n_servers, devices, hybrid=multi_process)
            if len(self.mesh.distinct_devices) > 1:
                raise NotImplementedError(
                    f"transfer: {backend} over "
                    f"{len(self.mesh.distinct_devices)} "
                    "devices: shards on different cards are not ported yet "
                    "(ROADMAP A11d); pass one device")
            kwargs = {"mesh": self.mesh, "data_plane": self.data_plane}
        else:
            if n_servers < 1:
                raise ValueError(f"[cluster] server_num must be >= 1, got "
                                 f"{n_servers}")
            # one device, no routing: the table is one tensor per field,
            # the n model-axis shards its consecutive slices
            self.mesh = None
            kwargs = {}
        self.device = devices[0] if self.mesh is None \
            else self.mesh.devices[0]
        self.n_servers = n_servers
        frag_num = (self.config.get("server", "frag_num").to_int32()
                    if self.config.has("server", "frag_num") else None)
        self.hashfrag = HashFrag(n_servers, frag_num)
        self.transfer = get_transfer(backend, **kwargs)
        self.transfer.set_data_axis(self.dp, self.dp_rank)
        self._initialized = True
        log.info("cluster up: %s transfer=%s", self.info(), backend)
        return self

    def info(self) -> dict:
        """The layout for the bring-up log: the rank layout's axes, or the
        one device of ``xla`` with its model-axis shards; the data axis
        when there are several processes."""
        if self.mesh is not None:
            return mesh_info(self.mesh)
        names, sizes = ["model"], [self.n_servers]
        if self.dp > 1:
            names, sizes = ["data"] + names, [self.dp] + sizes
        return {"axis_names": names, "axis_sizes": sizes, "n_devices": 1,
                "devices": [str(self.device)], "dp_rank": self.dp_rank}

    # -- tables ------------------------------------------------------------
    def create_table(self, name: str, access: AccessMethod,
                     capacity_per_shard: int, seed: int = 0,
                     partition=None) -> SparseTable:
        """``partition``: an optional ``HotColdPartition`` that gives the
        table a hot head (``transfer: hybrid``); tail keys keep the
        hashfrag-sharded layout."""
        if not self._initialized:
            raise RuntimeError("Cluster.initialize() first")
        ki = KeyIndex(self.n_servers, capacity_per_shard,
                      hashfrag=self.hashfrag, partition=partition)
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
