"""Elastic membership: epoch-versioned shard ownership for a
multi-process world (counterpart of ``swiftmpi_tpu/cluster/
membership.py``: host-only, the same schema and file names, so either
package's supervisor reads the other's fleet directory).

The reference ships "without Replication, Fault Tolerance and Repair"
(reference cluster/hashfrag.h:13): its HashFrag owner map is frozen at
world start, so one dead node poisons every pull/push barrier forever.
The supervised launcher's restart-the-world is one answer; this module is
the elastic one, per-rank failure domains built on an **epoch-versioned
member table**:

* A :class:`MemberTable` names, for one epoch, the live ranks and the
  rank that owns each shard (``owner_of_shard``).  It is published
  atomically (tmp + rename) as ``membership.json`` in the fleet
  directory, the same shared-directory contract the fleet telemetry
  plane rides (``obs/collector.py``).
* Epochs only move **forward**.  :func:`write_membership` re-reads the
  current table and refuses a stale write with :class:`StaleEpochError`,
  the loud rejection every ownership mutation sits behind.
* Ownership changes come in two shapes:

  - **death** (:func:`plan_death`): a committed epoch that removes the
    dead rank and hands its shards to survivors in one step; the
    survivors adopt from the dead rank's last published row delta
    (staleness bounded by the dump cadence).
  - **rejoin** (:func:`plan_rejoin` -> :func:`commit_table` /
    :func:`rollback_table`): a two-phase epoch.  ``prepare`` names the
    moves; every source rank exports its rows as an encoded delta and
    acks; only when all acks land does the supervisor ``commit``
    (sources drop, the rejoiner imports).  A source dying mid-prepare
    triggers :func:`rollback_table`: nobody dropped anything yet, so
    ownership is all-or-nothing and every row stays owned by exactly one
    live rank.

Placement on membership change is the controller's
(:func:`~swiftmpi_tpu_torch.control.controller.plan_placement`): each
rank folds its :class:`~swiftmpi_tpu_torch.control.sketch.DecayedSketch`
into per-shard touch loads and publishes them here (:func:`publish_load`);
the supervisor reads them back and assigns a dead rank's shards to the
least-loaded survivors.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

MEMBERSHIP_SCHEMA = "smtpu-membership/1"
MEMBERSHIP_FILE = "membership.json"

#: membership table states.  ``committed`` tables are live ownership;
#: ``prepare`` tables are an in-flight two-phase move (sources must ack
#: before the same epoch is re-published as ``committed``).
COMMITTED = "committed"
PREPARE = "prepare"


class StaleEpochError(RuntimeError):
    """An ownership mutation carried an epoch that does not advance the
    current one — a rank acting on a world that has moved on.  Always a
    loud failure: silently applying a stale move would double-own (or
    orphan) rows."""


@dataclass(frozen=True)
class MemberTable:
    """One epoch's membership + shard ownership, as published to
    ``membership.json``.  Immutable — transitions produce new tables
    through the ``plan_*``/``commit``/``rollback`` functions below, and
    only :func:`write_membership` (the epoch-guarded choke point) lands
    them on disk."""

    epoch: int
    state: str                      # COMMITTED | PREPARE
    live: Tuple[int, ...]           # sorted live ranks
    owner_of_shard: Tuple[int, ...]  # shard -> owning rank
    world_size: int
    reason: str = "init"
    #: (shard, src_rank, dst_rank) rows this epoch moves.  For a death
    #: epoch src is the dead rank (adopt from its last delta); for a
    #: prepare epoch src must export + ack before commit.
    moves: Tuple[Tuple[int, int, int], ...] = ()
    #: rollback targets of a PREPARE epoch (None on committed tables)
    prev_owner: Optional[Tuple[int, ...]] = None
    prev_live: Optional[Tuple[int, ...]] = None
    #: epoch number a rollback undid (None otherwise)
    rolled_back: Optional[int] = None

    @property
    def n_shards(self) -> int:
        return len(self.owner_of_shard)

    def shards_of(self, rank: int) -> List[int]:
        return [s for s, r in enumerate(self.owner_of_shard) if r == rank]

    def validate(self) -> None:
        if self.state not in (COMMITTED, PREPARE):
            raise ValueError(f"bad membership state {self.state!r}")
        owners = set(self.owner_of_shard)
        dead_owners = owners - set(self.live)
        if dead_owners and self.state == COMMITTED:
            raise ValueError(
                f"committed table epoch {self.epoch} has shards owned by "
                f"non-live ranks {sorted(dead_owners)} — rows stranded")
        for s, src, dst in self.moves:
            if not 0 <= s < self.n_shards:
                raise ValueError(f"move names shard {s} out of range")

    def to_json(self) -> str:
        d = asdict(self)
        d["schema"] = MEMBERSHIP_SCHEMA
        return json.dumps(d)

    @classmethod
    def from_json(cls, blob: str) -> "MemberTable":
        d = json.loads(blob)
        d.pop("schema", None)
        d["live"] = tuple(d["live"])
        d["owner_of_shard"] = tuple(d["owner_of_shard"])
        d["moves"] = tuple(tuple(m) for m in d.get("moves", ()))
        for k in ("prev_owner", "prev_live"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


def initial_table(world_size: int, n_shards: int) -> MemberTable:
    """Epoch-0 committed table: all ranks live, shards round-robin —
    the same contiguous-block spirit as HashFrag's frag map, but
    per-shard so elastic moves stay cheap to name."""
    return MemberTable(
        epoch=0, state=COMMITTED, live=tuple(range(world_size)),
        owner_of_shard=tuple(s % world_size for s in range(n_shards)),
        world_size=world_size, reason="init")


def membership_path(dirpath: str) -> str:
    return os.path.join(dirpath, MEMBERSHIP_FILE)


def read_membership(dirpath: str) -> Optional[MemberTable]:
    """Current published table, or None before world start.  A torn
    read (mid-replace) cannot happen — writes go through tmp+rename —
    but a damaged file is surfaced, not swallowed: recovery policy
    belongs to the supervisor, not here."""
    path = membership_path(dirpath)
    try:
        with open(path) as f:
            return MemberTable.from_json(f.read())
    except FileNotFoundError:
        return None


def _atomic_write(path: str, blob: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".mem_")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_membership(dirpath: str, table: MemberTable) -> MemberTable:
    """Publish ``table`` — THE ownership mutation choke point.

    Epochs advance or the write is refused: a new table must either
    carry a strictly greater epoch, or re-publish the SAME epoch moving
    ``prepare`` → ``committed`` (the two-phase commit step).  Anything
    else raises :class:`StaleEpochError` loudly — a supervisor restart
    racing an old one, or a test replaying history, must never regress
    the member table.
    """
    # epoch-guard: table.epoch advances over read_membership(dirpath)
    cur = read_membership(dirpath)
    if cur is not None:
        ok = table.epoch > cur.epoch or (
            table.epoch == cur.epoch and cur.state == PREPARE
            and table.state == COMMITTED)
        if not ok:
            raise StaleEpochError(
                f"membership epoch {table.epoch} ({table.state}) does "
                f"not advance current epoch {cur.epoch} ({cur.state})")
    table.validate()
    _atomic_write(membership_path(dirpath), table.to_json())
    log.info("membership epoch %d (%s) published: live=%s reason=%s "
             "moves=%d", table.epoch, table.state, list(table.live),
             table.reason, len(table.moves))
    return table


# -- transitions ------------------------------------------------------------

def plan_death(table: MemberTable, dead_rank: int,
               assign: Dict[int, int]) -> MemberTable:
    """Committed epoch+1 removing ``dead_rank``: its shards go to the
    survivors named by ``assign`` (shard -> new owner, from the
    Controller's Parallax placement).  Single-phase — the source is
    dead, so survivors adopt from its last published delta; there is
    nothing to two-phase."""
    if table.state != COMMITTED:
        raise ValueError("cannot plan a death over an uncommitted epoch "
                         "— roll the prepare back first")
    if dead_rank not in table.live:
        raise ValueError(f"rank {dead_rank} is not live in epoch "
                         f"{table.epoch}")
    live = tuple(r for r in table.live if r != dead_rank)
    if not live:
        raise ValueError("cannot remove the last live rank")
    owners = list(table.owner_of_shard)
    moves = []
    for s in table.shards_of(dead_rank):
        dst = assign.get(s)
        if dst is None or dst not in live:
            raise ValueError(f"death plan for rank {dead_rank} leaves "
                             f"shard {s} without a live owner")
        owners[s] = dst
        moves.append((s, dead_rank, dst))
    return MemberTable(
        epoch=table.epoch + 1, state=COMMITTED, live=live,
        owner_of_shard=tuple(owners), world_size=table.world_size,
        reason=f"death:r{dead_rank}", moves=tuple(moves))


def plan_rejoin(table: MemberTable, rank: int,
                assign: Dict[int, int]) -> MemberTable:
    """PREPARE epoch+1 re-admitting ``rank``: ``assign`` names the
    shards handed (back) to it and their current owners become move
    sources.  Sources must export + ack before :func:`commit_table`;
    until then ownership is still ``prev_owner`` in every rank's eyes
    that matters (sources keep their rows)."""
    if rank in table.live:
        raise ValueError(f"rank {rank} is already live in epoch "
                         f"{table.epoch}")
    if table.state != COMMITTED:
        raise ValueError("cannot plan a rejoin over an uncommitted epoch")
    owners = list(table.owner_of_shard)
    moves = []
    for s, dst in sorted(assign.items()):
        if dst != rank:
            raise ValueError("rejoin plan may only assign to the "
                             "rejoining rank")
        moves.append((s, owners[s], rank))
        owners[s] = rank
    return MemberTable(
        epoch=table.epoch + 1, state=PREPARE,
        live=tuple(sorted(table.live + (rank,))),
        owner_of_shard=tuple(owners), world_size=table.world_size,
        reason=f"rejoin:r{rank}", moves=tuple(moves),
        prev_owner=table.owner_of_shard, prev_live=table.live)


def commit_table(table: MemberTable) -> MemberTable:
    """The committed twin of a PREPARE epoch (same epoch number) —
    published only after every move source acked its export."""
    if table.state != PREPARE:
        raise ValueError("commit_table needs a PREPARE table")
    return MemberTable(
        epoch=table.epoch, state=COMMITTED, live=table.live,
        owner_of_shard=table.owner_of_shard, world_size=table.world_size,
        reason=table.reason, moves=table.moves)


def rollback_table(table: MemberTable, reason: str = "rollback"
                   ) -> MemberTable:
    """Committed epoch+1 restoring a PREPARE epoch's ``prev_owner`` /
    ``prev_live`` — the all-or-nothing arm: sources never dropped rows
    during prepare, so restoring the old owner map strands nothing.
    A rank that additionally died during the prepare is then handled by
    a normal :func:`plan_death` on the rolled-back table."""
    if table.state != PREPARE or table.prev_owner is None:
        raise ValueError("rollback_table needs a PREPARE table")
    return MemberTable(
        epoch=table.epoch + 1, state=COMMITTED,
        live=table.prev_live or table.live,
        owner_of_shard=table.prev_owner, world_size=table.world_size,
        reason=reason, rolled_back=table.epoch)


# -- side files: loads, join requests, acks ---------------------------------

def publish_load(dirpath: str, rank: int,
                 shard_loads: Dict[int, float]) -> str:
    """Publish one rank's per-shard decayed touch loads (its
    DecayedSketch fold) — the Parallax placement signal the supervisor
    reads at the next membership change."""
    path = os.path.join(dirpath, f"load_r{rank}.json")
    _atomic_write(path, json.dumps(
        {str(s): float(v) for s, v in shard_loads.items()}))
    return path


def read_loads(dirpath: str, n_shards: int) -> Dict[int, List[float]]:
    """rank -> per-shard load vector, from every published load file.
    Missing/damaged files mean that rank just contributes nothing —
    placement degrades to balance-by-count, never blocks."""
    out: Dict[int, List[float]] = {}
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("load_r") and name.endswith(".json")):
            continue
        try:
            rank = int(name[len("load_r"):-len(".json")])
            with open(os.path.join(dirpath, name)) as f:
                d = json.load(f)
            vec = [0.0] * n_shards
            for k, v in d.items():
                s = int(k)
                if 0 <= s < n_shards:
                    vec[s] = float(v)
            out[rank] = vec
        except (ValueError, OSError, TypeError):
            continue
    return out


def request_join(dirpath: str, rank: int, epoch: int) -> str:
    """A restarted rank asking back in: it publishes the epoch its
    resume state was stamped with so the supervisor can admit it at the
    next safe point (and so a claim of CURRENT participation with an
    old epoch is visibly stale)."""
    path = os.path.join(dirpath, f"join_r{rank}.json")
    _atomic_write(path, json.dumps({"rank": rank, "epoch": int(epoch)}))
    return path


def pending_joins(dirpath: str) -> Dict[int, int]:
    """rank -> resume epoch for every outstanding join request."""
    out: Dict[int, int] = {}
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("join_r") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dirpath, name)) as f:
                d = json.load(f)
            out[int(d["rank"])] = int(d["epoch"])
        except (ValueError, OSError, TypeError, KeyError):
            continue
    return out


def clear_join(dirpath: str, rank: int) -> None:
    try:
        os.unlink(os.path.join(dirpath, f"join_r{rank}.json"))
    except OSError:
        pass


def judge_join(table: MemberTable, rank: int, claimed_epoch: int) -> str:
    """Admission verdict for a join request: ``"admit"`` normally,
    ``"stale"`` when the joiner claims an epoch NEWER than the current
    table — resume state from a different (or regressed) world.  A
    stale joiner must be rejected loudly (:func:`write_reject` +
    :class:`StaleEpochError` on the worker side), never silently
    re-seeded: its rows would collide with the survivors' adopted
    copies."""
    if claimed_epoch > table.epoch:
        return "stale"
    if rank in table.live:
        return "admit"           # already re-admitted (idempotent)
    return "admit"


def reject_path(dirpath: str, rank: int) -> str:
    return os.path.join(dirpath, f"reject_r{rank}.json")


def write_reject(dirpath: str, rank: int, reason: str) -> str:
    path = reject_path(dirpath, rank)
    _atomic_write(path, json.dumps({"rank": rank, "reason": reason}))
    log.error("join REJECTED for rank %d: %s", rank, reason)
    return path


def read_reject(dirpath: str, rank: int) -> Optional[dict]:
    try:
        with open(reject_path(dirpath, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def ack_path(dirpath: str, epoch: int, rank: int) -> str:
    return os.path.join(dirpath, f"ack_e{epoch}_r{rank}.json")


def write_ack(dirpath: str, epoch: int, rank: int,
              payload: Optional[dict] = None) -> str:
    """A move source's prepare ack: its export for ``epoch`` is on
    disk.  Epoch-stamped by filename so a stale ack from a rolled-back
    prepare can never satisfy a newer one."""
    path = ack_path(dirpath, epoch, rank)
    _atomic_write(path, json.dumps(payload or {}))
    return path


def acks_complete(dirpath: str, table: MemberTable) -> bool:
    """True when every live move source of a PREPARE table has acked."""
    srcs = {src for _, src, _ in table.moves if src in table.live}
    return all(os.path.exists(ack_path(dirpath, table.epoch, r))
               for r in srcs)


def missing_acks(dirpath: str, table: MemberTable) -> List[int]:
    srcs = sorted({src for _, src, _ in table.moves if src in table.live})
    return [r for r in srcs
            if not os.path.exists(ack_path(dirpath, table.epoch, r))]
