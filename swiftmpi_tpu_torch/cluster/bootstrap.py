"""Multi-process bring-up: the reference's MPI control plane on
``torch.distributed`` (counterpart of ``swiftmpi_tpu/cluster/
bootstrap.py``).

The reference boots with ``MPI_Init`` and uses MPI only as a control
plane: rank and size, an IP-table allgather so every rank can address
every other, and barriers (reference utils/mpi.h:11-53); processes are
started by ``mpirun -np N``.  Here the control plane is a gloo process
group over a ``TCPStore`` that process 0 serves: :func:`process_index` and
:func:`process_count` are rank and size, :func:`barrier` is
``MPI_Barrier``, and the store (:func:`store`) is where the processes
trade what the data plane needs to address each other (the CUDA IPC
handles of ``kernels.ring.ProcessRing``).  gloo carries host values and
CPU tensors only: on the card the data moves through B5's cross-process
exchange, never through gloo.

Processes are started by ``python -m swiftmpi_tpu_torch.launch -np N --
prog args...`` (``launch.py``), the ``mpirun`` equivalent, which sets the
environment contract below; a pod scheduler would set the same keys.

Environment contract (set by the launcher):

* ``SMTPU_COORDINATOR``    — ``host:port`` of process 0's store.
* ``SMTPU_NUM_PROCESSES``  — world size.
* ``SMTPU_PROCESS_ID``     — this process's rank.
* ``SMTPU_FLEET_DIR``      — the shared fleet-telemetry directory (set by
  ``launch.py -fleet-dir``; the elastic member table lives there too).
* ``SMTPU_DIST_TIMEOUT``   — seconds a collective or a store read waits
  for a peer before the run fails (default 300): a dead or stuck peer
  fails the run instead of hanging it.

The ``[cluster] coordinator``, ``num_processes`` and ``process_id`` config
keys name the same three values when the environment does not.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np

from swiftmpi_tpu_torch.utils.config import ConfigParser
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

ENV_COORDINATOR = "SMTPU_COORDINATOR"
ENV_NUM_PROCESSES = "SMTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "SMTPU_PROCESS_ID"
ENV_FLEET_DIR = "SMTPU_FLEET_DIR"
ENV_TIMEOUT = "SMTPU_DIST_TIMEOUT"

#: seconds a collective or a store read waits for a peer by default
DEFAULT_TIMEOUT_S = 300.0

_store = None


def distributed_env() -> Optional[dict]:
    """The launcher's contract from the environment, or None for a
    single-process run (the reference analog: started under mpirun or
    plain)."""
    if ENV_COORDINATOR not in os.environ:
        return None
    return {
        "coordinator_address": os.environ[ENV_COORDINATOR],
        "num_processes": int(os.environ.get(ENV_NUM_PROCESSES, "1")),
        "process_id": int(os.environ.get(ENV_PROCESS_ID, "0")),
    }


def timeout_s() -> float:
    """The bounded wait of every collective and store read."""
    return float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT_S))


def init_distributed(config: Optional[ConfigParser] = None) -> bool:
    """``MPI_Init`` equivalent.  Joins the process group named by the
    environment (or the ``[cluster] coordinator/num_processes/
    process_id`` config keys); a no-op when neither names one, or when
    already joined.  Returns True iff this run is multi-process."""
    global _store
    if _store is not None:
        return process_count() > 1
    env = distributed_env()
    if env is None and config is not None and \
            config.has("cluster", "coordinator"):
        g = config.get_or
        env = {"coordinator_address":
               config.get("cluster", "coordinator").to_string(),
               "num_processes": g("cluster", "num_processes", 1).to_int32(),
               "process_id": g("cluster", "process_id", 0).to_int32()}
    if env is None or env["num_processes"] <= 1:
        return False
    import torch.distributed as dist
    host, _, port = env["coordinator_address"].rpartition(":")
    rank, world = env["process_id"], env["num_processes"]
    timeout = datetime.timedelta(seconds=timeout_s())
    store = dist.TCPStore(host or "127.0.0.1", int(port), world,
                          is_master=rank == 0, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timeout)
    _store = store
    log.info("distributed up: process %d/%d (gloo, store %s)", rank, world,
             env["coordinator_address"])
    return True


def shutdown_distributed() -> None:
    """``MPI_Finalize`` equivalent; safe to call unconditionally.  Closes
    the cross-process exchange's mappings first."""
    global _store
    if _store is None:
        return
    import torch.distributed as dist
    from swiftmpi_tpu_torch.kernels import ring
    ring.close_process_rings()
    dist.destroy_process_group()
    _store = None


def store():
    """The process group's key-value store (the rendezvous the data plane
    trades its IPC handles through); None when not launched."""
    return _store


def barrier(name: str = "smtpu_barrier") -> None:
    """``MPI_Barrier`` equivalent (reference utils/mpi.h:37): blocks until
    every process reaches it; a no-op for one process."""
    if _store is None:
        return
    import torch.distributed as dist
    dist.barrier()


def host_array(x) -> np.ndarray:
    """Full host value of a table tensor.  Every process holds a full
    replica, so a local read is the whole value (the JAX package's
    ``process_allgather`` of a global array has nothing to gather here)."""
    from swiftmpi_tpu_torch.parameter.sparse_table import tensor_to_numpy
    return tensor_to_numpy(x) if hasattr(x, "detach") else np.asarray(x)


def is_writer() -> bool:
    """True on the process that owns shared-filesystem writes: every
    process computes the same table, process 0 writes it."""
    return process_index() == 0


def process_index() -> int:
    if _store is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    if _store is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size()
