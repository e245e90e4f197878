"""Elastic worker: the per-rank data plane of the elastic world
(counterpart of ``swiftmpi_tpu/cluster/elastic.py``, with the rows on the
card).

:class:`ElasticWorker` is what a rank *does* with the member table that
:mod:`swiftmpi_tpu_torch.cluster.membership` publishes: it owns the rows
of its shards, trains them, and moves them across process boundaries when
the epoch advances.  A process group cannot change its membership
mid-run, so the elastic data plane rides the fleet directory instead,
faithful to SwiftMPI's *asynchronous* parameter-server model, where
workers never lockstep and staleness is bounded, not zero:

* **Dumps** (:meth:`ElasticWorker.maybe_dump`): every ``dump_every``
  steps a rank publishes its rows as ONE encoded delta
  (``rows_r<rank>.npz``), the survivors' adoption source when the rank
  dies: the staleness envelope is the dump cadence plus the delta
  encoding's quantization error.
* **Deltas** ship in the window push's wire formats
  (:func:`~swiftmpi_tpu_torch.transfer.delta.encode_delta` prices sparse,
  bitmap and sparse_q with the same crossover), so migration traffic
  obeys the same byte model as training traffic.
* **Two-phase rejoin**: on a ``prepare`` epoch a move source exports
  fresh deltas (``mig_e<epoch>_s<src>_r<dst>.npz``) and acks, keeping its
  rows; only the ``committed`` twin makes sources drop and the rejoiner
  import.  A source death mid-prepare rolls the epoch back and strands
  nothing.
* **Failure detection**, worker half: :func:`elastic_barrier` is a file
  barrier with a timeout; a peer that never stamps is reported to the
  caller (the supervisor's FleetCollector health view is the other half).
  Stale participation is always loud:
  :exc:`~swiftmpi_tpu_torch.cluster.membership.StaleEpochError`.

**The rows live on the worker's device.**  One ``(capacity, dim)``
float32 tensor, ``capacity = n_shards * rows_per_shard``, beside an
owned-key mask: the synthetic keys are dense in ``[0, capacity)``
(``key = shard + i * n_shards``), so a key is its own row and
``key % n_shards`` its shard.  The per-key targets are computed once on
the host with float64 numpy (the JAX package's expression, so the bits
match) and uploaded as float32.  A step is one pass over the owned rows,
``rows + lr * (target - rows)`` as a subtraction, a multiplication and
an addition in float32 (three separate operations, never fused into a
multiply-add: the bits equal numpy's update).  Dumps and migration
exports read the owned rows through the masked gather kernel
(:func:`~swiftmpi_tpu_torch.kernels.gather.masked_gather`, B2), one
launch per dump and one per prepare's export, then copy them to the host
and encode there.  Imports zero the gained shards' rows and write the
delta's rows with ``index_copy_``.  :meth:`rows_dict` reads the owned
rows back as the JAX package's ``{key: row}`` dict.

The training workload is a deterministic per-row contraction (each row
relaxes toward a key-seeded target), so convergence, and re-convergence
after adopting stale rows, is measurable as a scalar loss without any
model machinery in the chaos drills.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch.cluster import membership as mem
from swiftmpi_tpu_torch.cluster.membership import (MemberTable,
                                                   StaleEpochError,
                                                   read_membership)
from swiftmpi_tpu_torch.control.sketch import DecayedSketch
from swiftmpi_tpu_torch.device import DeviceLike, resolve_device
from swiftmpi_tpu_torch.kernels import gather
from swiftmpi_tpu_torch.transfer.delta import (atomic_savez, decode_delta,
                                               delta_wire_bytes,
                                               encode_delta)
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

#: host rows of targets computed at a time (bounds the float64 scratch)
_TARGET_CHUNK = 8192
#: the target's phase step: the golden ratio's fractional part
_PHI = 0.6180339887498949


# -- file barrier with timeout (failure detection, worker half) ------------

def elastic_barrier(dirpath: str, epoch: int, rank: int,
                    live, timeout_s: float = 10.0,
                    poll_s: float = 0.05) -> List[int]:
    """Epoch-stamped file barrier: stamp, then wait for every rank in
    ``live``.  Returns the ranks that never stamped within ``timeout_s``;
    an EMPTY list means the barrier passed.  The caller reports
    stragglers instead of hanging forever on them (the reference's
    poisoned-barrier failure mode)."""
    def path(r: int) -> str:
        return os.path.join(dirpath, f"barrier_e{epoch}_r{r}")

    with open(path(rank), "w"):
        pass
    deadline = time.monotonic() + timeout_s
    waiting = [r for r in live if r != rank]
    while waiting and time.monotonic() < deadline:
        waiting = [r for r in waiting if not os.path.exists(path(r))]
        if waiting:
            time.sleep(poll_s)
    return waiting


class ElasticWorker:
    """One rank's shard-owning trainer under elastic membership, its rows
    on ``device`` (``None``: the CUDA device, raising when there is none;
    ``"cpu"`` runs the same code on the CPU, as the tests do).

    Shard routing is the member table's ``owner_of_shard``.  The
    synthetic key space is dense per shard (``key = shard + i *
    n_shards``), so a key is a valid bitmap position and all three sparse
    delta formats stay in play.  Per-shard touch loads fold through a
    :class:`~swiftmpi_tpu_torch.control.sketch.DecayedSketch`, the
    placement signal published for the supervisor."""

    def __init__(self, rank: int, fleet_dir: str, *, world_size: int,
                 n_shards: int, rows_per_shard: int = 32, dim: int = 8,
                 lr: float = 0.25, quant: str = "int8",
                 dump_every: int = 5, sketch_decay: float = 0.9,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.rank = int(rank)
        self.dir = fleet_dir
        self.world_size = int(world_size)
        self.n_shards = int(n_shards)
        self.rows_per_shard = int(rows_per_shard)
        self.dim = int(dim)
        self.lr = float(lr)
        self.quant = quant
        self.dump_every = max(int(dump_every), 1)
        self.capacity = self.n_shards * self.rows_per_shard
        #: the rows, a key's row at index ``key``; only owned rows count
        self.rows = torch.zeros((self.capacity, self.dim),
                                dtype=torch.float32, device=self.device)
        #: owned-key mask, on the host (key lists) and on the device
        self.owned = np.zeros(self.capacity, np.bool_)
        self._owned_dev = torch.zeros(self.capacity, dtype=torch.bool,
                                      device=self.device)
        self._targets = self._target_rows()
        self.sketch = DecayedSketch(self.n_shards, decay=sketch_decay)
        self.member_table: Optional[MemberTable] = None
        self.epoch = -1
        self.step_count = 0
        self.migration_bytes = 0     # modeled encoded delta traffic
        self.moves_applied = 0
        self.events: List[dict] = []  # sync decisions, for the child log

    # -- deterministic workload -------------------------------------------
    def target(self, key: int) -> np.ndarray:
        """Key-seeded unit-scale target the row relaxes toward; same on
        every rank, so an adopted row keeps converging to the same answer
        its dead owner was chasing."""
        phase = (np.arange(self.dim, dtype=np.float64) + 1.0) \
            * (float(key) * _PHI % 37.0 + 1.0)
        return np.sin(phase).astype(np.float32)

    def _target_rows(self) -> torch.Tensor:
        """Every key's :meth:`target`, the same float64 expression over
        a block of keys at a time, uploaded as float32."""
        out = torch.empty((self.capacity, self.dim), dtype=torch.float32,
                          device=self.device)
        cols = np.arange(self.dim, dtype=np.float64) + 1.0
        for lo in range(0, self.capacity, _TARGET_CHUNK):
            keys = np.arange(lo, min(lo + _TARGET_CHUNK, self.capacity),
                             dtype=np.float64)
            phase = cols[None, :] * (keys * _PHI % 37.0 + 1.0)[:, None]
            out[lo:lo + len(keys)] = torch.from_numpy(
                np.sin(phase).astype(np.float32))
        return out

    def keys_of_shard(self, shard: int) -> List[int]:
        return [shard + i * self.n_shards
                for i in range(self.rows_per_shard)]

    def shard_of(self, key: int) -> int:
        return int(key) % self.n_shards

    def owned_shards(self) -> List[int]:
        if self.member_table is None:
            return []
        return self.member_table.shards_of(self.rank)

    def owned_keys(self) -> List[int]:
        return np.flatnonzero(self.owned).tolist()

    @property
    def n_owned(self) -> int:
        """Owned rows (the JAX worker's ``len(rows)``)."""
        return int(self.owned.sum())

    def rows_dict(self) -> Dict[int, np.ndarray]:
        """The owned rows on the host as ``{key: (dim,) float32}``, the
        JAX worker's ``rows``."""
        keys = np.flatnonzero(self.owned)
        vals = self.rows.index_select(
            0, torch.as_tensor(keys, device=self.device)).cpu().numpy()
        return {int(k): v for k, v in zip(keys, vals)}

    def _set_owned(self, keys, flag: bool) -> None:
        self.owned[np.asarray(keys, np.int64)] = flag
        self._owned_dev = torch.from_numpy(self.owned).to(self.device)

    def _read_rows(self, keys: np.ndarray) -> np.ndarray:
        """``(len(keys), dim)`` host rows at ``keys``: one masked gather
        launch on the card, then one copy to the host."""
        if not len(keys):
            return np.zeros((0, self.dim), np.float32)
        slots = torch.as_tensor(keys.astype(np.int32), device=self.device)
        valid = torch.ones(len(keys), dtype=torch.bool, device=self.device)
        return gather.masked_gather(self.rows, slots, valid).cpu().numpy()

    def loss(self) -> float:
        """Mean over the owned rows of each row's mean squared distance
        to its target (the squares in float32, as numpy's, the means in
        float64)."""
        if not self.owned.any():
            return 0.0
        diff = self._targets - self.rows
        per_row = (diff * diff).double().mean(dim=1)
        return float(per_row[self._owned_dev].mean())

    def step(self) -> float:
        """One training step over every owned row (the async-PS model:
        local progress between membership syncs).  Returns the loss
        BEFORE the update, folds the touch counts into the sketch, and
        handles the periodic dump + load publication."""
        pre = self.loss()
        if self.owned.any():
            r = self.rows
            upd = r + self.lr * (self._targets - r)
            self.rows = torch.where(self._owned_dev[:, None], upd, r)
        shards = self.owned_shards()
        if shards:
            self.sketch.observe(np.repeat(np.asarray(shards, np.int64),
                                          self.rows_per_shard))
        self.step_count += 1
        if self.step_count % self.dump_every == 0:
            self.maybe_dump()
            self.publish_load()
        return pre

    # -- dumps, loads, census ---------------------------------------------
    def dump_path(self, rank: Optional[int] = None) -> str:
        return os.path.join(self.dir,
                            f"rows_r{self.rank if rank is None else rank}"
                            ".npz")

    def maybe_dump(self) -> str:
        """Publish every owned row as ONE encoded delta, epoch-stamped:
        the resume state of a restarted rank and the adoption source when
        this rank dies; its cadence IS the staleness envelope."""
        keys = np.asarray(self.owned_keys(), np.int64)
        vals = self._read_rows(keys)
        # the synthetic key space is dense in [0, capacity), so keys
        # double as bitmap positions
        enc = encode_delta(keys, vals, self.capacity, self.quant,
                           positions=keys if len(keys) else None)
        enc["epoch"] = np.array(int(self.epoch))
        enc["step"] = np.array(int(self.step_count))
        path = self.dump_path()
        atomic_savez(path, **enc)
        return path

    def publish_load(self) -> None:
        loads = self.sketch.fold()
        mem.publish_load(self.dir, self.rank,
                         {s: float(loads[s]) for s in range(self.n_shards)
                          if loads[s] > 0})

    def write_census(self) -> str:
        """Publish this rank's owned-key census (epoch-stamped): after
        reconvergence every key must appear in exactly one live rank's
        census."""
        path = os.path.join(self.dir, f"census_r{self.rank}.json")
        blob = json.dumps({"epoch": int(self.epoch),
                           "keys": self.owned_keys()})
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(blob)
        os.replace(tmp, path)
        return path

    # -- membership sync ---------------------------------------------------
    def _seed_shard(self, shard: int) -> None:
        keys = self.keys_of_shard(shard)
        self.rows[torch.as_tensor(keys, device=self.device)] = 0.0
        self._set_owned(keys, True)

    def _drop_shard(self, shard: int) -> None:
        self._set_owned(self.keys_of_shard(shard), False)

    def _import_delta(self, enc, shards) -> int:
        """Install a decoded delta's rows for ``shards`` only (a dump may
        carry more than what moved).  Returns rows imported."""
        keys, vals = decode_delta(enc)
        mine = np.isin(keys % self.n_shards,
                       np.asarray(sorted(int(s) for s in shards), np.int64))
        n = int(mine.sum())
        if n:
            self.rows.index_copy_(
                0, torch.as_tensor(keys[mine], device=self.device),
                torch.from_numpy(np.ascontiguousarray(vals[mine])).to(
                    self.device))
            self._set_owned(keys[mine], True)
        return n

    def mig_path(self, epoch: int, src: int, dst: int) -> str:
        # keyed by (epoch, src, dst): a rejoin's handback usually has
        # several sources exporting to one destination
        return os.path.join(self.dir, f"mig_e{epoch}_s{src}_r{dst}.npz")

    def _export_moves(self, table: MemberTable) -> None:
        """PREPARE phase, source side: export fresh rows for every shard
        this rank is giving up, one encoded delta per destination (their
        rows read in one gather launch), then ack.  Rows are KEPT until
        the commit: the all-or-nothing half of the epoch protocol."""
        by_dst: Dict[int, List[int]] = {}
        for s, src, dst in table.moves:
            if src == self.rank:
                by_dst.setdefault(dst, []).append(s)
        parts = [(dst, np.asarray(
            [k for s in shards for k in self.keys_of_shard(s)
             if self.owned[k]], np.int64))
            for dst, shards in sorted(by_dst.items())]
        vals = self._read_rows(np.concatenate(
            [keys for _, keys in parts] or [np.zeros(0, np.int64)]))
        at = 0
        for dst, keys in parts:
            enc = encode_delta(keys, vals[at:at + len(keys)],
                               self.capacity, self.quant,
                               positions=keys if len(keys) else None)
            at += len(keys)
            enc["epoch"] = np.array(int(table.epoch))
            atomic_savez(self.mig_path(table.epoch, self.rank, dst), **enc)
            self.migration_bytes += delta_wire_bytes(enc)
        if by_dst:
            mem.write_ack(self.dir, table.epoch, self.rank,
                          {"dsts": sorted(by_dst)})

    def _adopt_committed(self, table: MemberTable) -> None:
        """Install a committed table: import what moved to me, drop what
        moved away, seed what has no source (initial ownership)."""
        mine_now = set(table.shards_of(self.rank))
        # during a PREPARE epoch the effective owner map is still
        # prev_owner (sources keep rows until commit), so "before" is read
        # from it, else a commit sees no delta to import
        if self.member_table is None:
            mine_before = set()
        elif (self.member_table.state == mem.PREPARE
              and self.member_table.prev_owner is not None):
            mine_before = {s for s, r in enumerate(self.member_table.prev_owner)
                           if r == self.rank}
        else:
            mine_before = set(self.member_table.shards_of(self.rank))
        moved_to_me = {s: src for s, src, dst in table.moves
                       if dst == self.rank}
        # drop first: shards that left (commit of a prepare I sourced)
        for s in sorted(mine_before - mine_now):
            self._drop_shard(s)
        gained = sorted(mine_now - mine_before)
        # group imports by source so each delta file is read once
        by_src: Dict[int, List[int]] = {}
        fresh: List[int] = []
        for s in gained:
            src = moved_to_me.get(s)
            if src is None:
                fresh.append(s)
            else:
                by_src.setdefault(src, []).append(s)
        for s in fresh:
            self._seed_shard(s)
        for src, shards in sorted(by_src.items()):
            # rows a delta misses start at zero, as seeded ones do
            for s in shards:
                self._seed_shard(s)
            imported = 0
            # rejoin commit: the source exported a fresh mig delta for
            # me; death: adopt from the dead rank's last dump (stale by
            # <= dump_every steps, the documented envelope)
            for path in (self.mig_path(table.epoch, src, self.rank),
                         self.dump_path(src)):
                try:
                    with np.load(path, allow_pickle=False) as z:
                        imported = self._import_delta(z, shards)
                        self.migration_bytes += delta_wire_bytes(z)
                except (OSError, KeyError, ValueError):
                    continue
                if imported:   # a readable but irrelevant delta (zero
                    break      # rows for these shards) falls through
            if not imported:
                # no delta survived (rank died before its first dump):
                # the seeded rows re-learn, loudly logged
                log.warning("rank %d: no delta for shards %s from r%d; "
                            "seeding fresh", self.rank, shards, src)
            self.moves_applied += len(shards)

    def sync(self) -> List[dict]:
        """Adopt the currently published member table, called at the top
        of every step (the safe point).  Raises :class:`StaleEpochError`
        if the table regressed below what this worker already applied.
        Returns the sync decisions taken, newest last."""
        table = read_membership(self.dir)
        if table is None:
            return []
        if self.member_table is not None \
                and table.epoch < self.member_table.epoch:
            raise StaleEpochError(
                f"rank {self.rank}: published epoch {table.epoch} "
                f"regressed below adopted epoch {self.member_table.epoch}")
        same = (self.member_table is not None
                and table.epoch == self.member_table.epoch
                and table.state == self.member_table.state)
        if same:
            return []
        events: List[dict] = []
        if table.state == mem.PREPARE:
            self._export_moves(table)
            events.append({"kind": "prepare", "epoch": table.epoch,
                           "reason": table.reason})
        else:
            commit_of_mine = (self.member_table is not None
                              and self.member_table.state == mem.PREPARE
                              and table.epoch == self.member_table.epoch)
            rolled_back = (table.rolled_back is not None
                           and self.member_table is not None
                           and self.member_table.epoch == table.rolled_back)
            if rolled_back:
                # prepare undone: nothing was dropped; the exported mig
                # files of the dead epoch are inert (their epoch stamp can
                # never match again)
                events.append({"kind": "rollback", "epoch": table.epoch,
                               "undid": table.rolled_back})
            self._adopt_committed(table)
            events.append({"kind": "commit" if commit_of_mine
                           else "adopt", "epoch": table.epoch,
                           "reason": table.reason,
                           "owned": len(table.shards_of(self.rank))})
            if self.rank not in table.live:
                # a rolled-back rejoin evicted this rank again: the step
                # loop goes back through boot()
                events.append({"kind": "evicted", "epoch": table.epoch})
        # epoch-guard: table.epoch advance validated above (sync raises
        # StaleEpochError on regression before reaching here)
        self.member_table = table
        self.epoch = table.epoch
        self.write_census()
        self.events.extend(events)
        return events

    # -- boot / rejoin ------------------------------------------------------
    def resume_epoch(self) -> int:
        """Epoch stamp of this rank's last dump: what a restarted rank
        claims when it asks back in."""
        try:
            with np.load(self.dump_path(), allow_pickle=False) as z:
                return int(np.asarray(z["epoch"]))
        except (OSError, KeyError, ValueError):
            return 0

    def boot(self, timeout_s: float = 30.0,
             poll_s: float = 0.05) -> bool:
        """Join the world: adopt the table if this rank is live in it,
        else publish a join request (stamped with the resume epoch) and
        wait for re-admission at the supervisor's next safe point.
        Returns False on timeout; raises :class:`StaleEpochError` when the
        supervisor rejects the claimed epoch as stale."""
        deadline = time.monotonic() + timeout_s
        requested = False
        while time.monotonic() < deadline:
            table = read_membership(self.dir)
            if table is not None and self.rank in table.live:
                self.sync()
                if requested:
                    mem.clear_join(self.dir, self.rank)
                return True
            rej = mem.read_reject(self.dir, self.rank)
            if rej is not None:
                raise StaleEpochError(
                    f"rank {self.rank}: join rejected: "
                    f"{rej.get('reason')}")
            if table is not None and not requested:
                mem.request_join(self.dir, self.rank,
                                 self.resume_epoch())
                requested = True
            time.sleep(poll_s)
        return False
