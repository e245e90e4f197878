"""Dense parameter table (counterpart of
``swiftmpi_tpu/parameter/sparse_table.py``).

The table is indexed by the dense slots a host-side :class:`KeyIndex`
assigns.  It has two layouts:

* **one device** (no ``mesh``; ``transfer: xla``): the state is a plain
  ``{field: Tensor}`` dict of ``(capacity, dim)`` tensors.  With
  ``server_num: n > 1`` the key index has n shards and the tensor is
  their ``n * capacity_per_shard`` rows in shard order (the JAX package's
  model-axis sharded array, laid out whole on the one card).
* **sharded** (``mesh``: a rank layout; ``transfer: tpu`` or ``hybrid``):
  the state is ``{field: [Tensor] * n}``, one contiguous
  ``(capacity_per_shard, dim)`` tensor per shard on its rank's device.
  Shard ``s`` holds the tail slots ``s * capacity_per_shard ... (s + 1) *
  capacity_per_shard - 1``, so the shards concatenated in order are
  exactly the JAX package's global array (:meth:`to_numpy`).  The shards
  of the ranks that share a device are the rank slices of one ``(R,
  capacity_per_shard, dim)`` block in the group's rank order
  (:func:`split_rows`), which :func:`shard_block` returns without a copy,
  so one kernel launch serves the whole group; each rank still reads and
  writes only its own slice.

Hybrid hot/cold placement: when the key index carries a
``HotColdPartition``, each field ``f`` also has a hot plane ``f@hot`` of
``(n_hot, dim)`` rows, indexed by the hot slot itself, while the plain
name holds the tail (indexed by ``slot - n_hot``).  :meth:`gather` and
:meth:`unified_rows_host` show the unified slot space ``concat(hot,
tail)``.  The JAX package replicates the hot plane on every device; the
port keeps one replica per *device*, not per rank: the ranks that share a
card read and write that one tensor, which is what a replica per rank
would hold anyway, since the hybrid push's reconcile makes every replica
equal.  With shards on several cards (ROADMAP A11d) there will be one per
card.

Every row is initialized eagerly with its field's distribution (eager-
random is lazy-random for every observable row), drawn in float32 and
cast to the field's dtype, as the JAX package does: a bfloat16 field
(``[server] dtype: bfloat16``) holds the rounded draw.  The hot planes
are drawn after every tail field, from the same stream, so a table with
``n_hot = 0`` is drawn exactly as before the planes existed.  Push paths
update the tensors in place; ``grow`` moves the tail to new, larger
tensors (the hot planes stay) and bumps ``generation``.

Two side planes ride the state beside the fields, laid out like the tail
(one tensor per shard on a sharded table), never pulled as fields nor
updated by the access rule: ``f@ef`` (:meth:`SparseTable.ensure_ef`), the
float32 error-feedback residual of ``f``'s quantized window pushes, and
``@rowver`` (:meth:`SparseTable.ensure_row_versions`), one int32 version
stamp a tail row that every push bumps and the pull cache reads.  Hot rows
carry neither.

``repartition`` swaps the hot/cold split online (the control plane's
``hot_k`` knob): it replays the key index's ``RepartitionPlan`` on the
rows with plain torch indexing, as ``grow`` moves them (the JAX package
does it with ``take`` / ``.at[].set`` outside Pallas).  The tail tensors
are written in place; the hot planes are new tensors, so it bumps
``generation`` as ``grow`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.access import AccessMethod
from swiftmpi_tpu_torch.parameter.key_index import KeyIndex

TableState = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]

#: suffix of a hot-head plane in a table state dict
HOT_SUFFIX = "@hot"


def hot_name(field: str) -> str:
    return field + HOT_SUFFIX


def is_hot_field(name: str) -> bool:
    return name.endswith(HOT_SUFFIX)


def base_field(name: str) -> str:
    """Strip the hot suffix: ``"v@hot" -> "v"``, plain names unchanged."""
    return name[:-len(HOT_SUFFIX)] if is_hot_field(name) else name


#: suffix of an error-feedback residual plane: ``"v@ef"`` holds, per tail
#: row, the quantization error of v's window pushes not yet applied
EF_SUFFIX = "@ef"


def ef_name(field: str) -> str:
    return field + EF_SUFFIX


def is_ef_field(name: str) -> bool:
    return name.endswith(EF_SUFFIX)


#: the per-row version plane: ``(capacity, 1)`` int32, the version of each
#: tail row's last apply (0: never applied), per shard monotonic
ROWVER_KEY = "@rowver"


def has_row_versions(state) -> bool:
    return ROWVER_KEY in state


def is_side_plane(name: str) -> bool:
    """An ``@ef`` or ``@rowver`` plane: state that is no access field."""
    return is_ef_field(name) or name == ROWVER_KEY


class SparseTable:
    def __init__(self, access: AccessMethod, key_index: KeyIndex,
                 device: torch.device, seed: int = 0, mesh=None):
        self.access = access
        self.key_index = key_index
        self.device = torch.device(device)
        self.seed = int(seed)
        self.mesh = mesh
        if mesh is not None and mesh.n != key_index.num_shards:
            raise ValueError(
                f"the layout has {mesh.n} ranks, the key index "
                f"{key_index.num_shards} shards")
        #: bumped by :meth:`grow` and :meth:`repartition`, which move
        #: fields to new tensors: a CUDA graph captured on the old ones
        #: is stale
        self.generation = 0
        self.state: TableState = self._init_state()

    @property
    def n_hot(self) -> int:
        return self.key_index.n_hot

    def _init_rows(self, hot: bool = True) -> Dict[str, torch.Tensor]:
        """Every field's ``(capacity, dim)`` rows on the table's device,
        in sorted name order, then (``hot`` and ``n_hot > 0``) every
        field's ``(n_hot, dim)`` hot plane, all drawn from one generator
        seeded with ``seed`` (the JAX package's order of key splits; the
        values differ, as torch and jax generators do)."""
        cap, n_hot = self.key_index.capacity, self.n_hot
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        fields = sorted(self.access.fields.items())
        out = {name: fs.init(gen, (cap, fs.dim), self.device).to(fs.dtype)
               for name, fs in fields}
        if hot and n_hot:
            out.update({hot_name(name): fs.init(
                gen, (n_hot, fs.dim), self.device).to(fs.dtype)
                for name, fs in fields})
        return out

    def ensure_ef(self, grad_fields) -> None:
        """Arm the error-feedback planes of ``grad_fields``: one zero
        ``(capacity, dim)`` float32 ``f@ef`` plane a field, laid out like
        the tail.  Planes already there (restored from a checkpoint) are
        left alone."""
        cap = self.key_index.capacity
        for f in grad_fields:
            if ef_name(f) not in self.state:
                self.state[ef_name(f)] = self._layout_tail(torch.zeros(
                    (cap, self.access.fields[f].dim), dtype=torch.float32,
                    device=self.device))

    @property
    def ef_fields(self) -> List[str]:
        """Names of the armed residual planes (``[]`` when EF is off)."""
        return [f for f in self.state if is_ef_field(f)]

    def ensure_row_versions(self) -> None:
        """Arm the ``@rowver`` plane: ``(capacity, 1)`` int32 zeros laid
        out like the tail.  A plane already there (restored from a
        checkpoint) is left alone, so versions keep counting up across a
        restart."""
        if ROWVER_KEY not in self.state:
            self.state[ROWVER_KEY] = self._layout_tail(torch.zeros(
                (self.key_index.capacity, 1), dtype=torch.int32,
                device=self.device))

    def _layout_tail(self, rows: torch.Tensor):
        """Tail-shaped ``rows`` as the table lays the tail out: the tensor
        itself on one device, dealt to the shards on a sharded table."""
        return rows if self.mesh is None else split_rows(rows, self.mesh)

    def _init_state(self) -> TableState:
        """The initial state: :meth:`_init_rows`, dealt to the shards'
        devices for a sharded table, so its initial values do not depend
        on the layout."""
        return self._layout(self._init_rows())

    def _layout(self, rows: Dict[str, torch.Tensor]) -> TableState:
        """Tail fields dealt to the shards of a sharded table; a hot plane
        stays one tensor on the table's device."""
        if self.mesh is None:
            return rows
        return {f: t if is_hot_field(f) else split_rows(t, self.mesh)
                for f, t in rows.items()}

    def global_rows(self, field: str) -> torch.Tensor:
        """``field``'s ``(capacity, dim)`` rows in global slot order on the
        table's device: the tensor itself on one device (and for a hot
        plane), a copy of the shards concatenated for a sharded table."""
        v = self.state[field]
        if not isinstance(v, list):
            return v
        return torch.cat([s.to(self.device) for s in v])

    def assign(self, field: str, rows: torch.Tensor) -> None:
        """Copy global-order ``(capacity, dim)`` rows into ``field``'s
        tensors in place (each shard's slice into its rank's tensor), cast
        to the field's dtype: the tensors' addresses do not move."""
        v = self.state[field]
        if not isinstance(v, list):
            v.copy_(rows)
            return
        cap = self.key_index.capacity_per_shard
        for r, t in enumerate(v):
            t.copy_(rows[r * cap:(r + 1) * cap])

    def read_rows(self, field: str, slots: np.ndarray) -> torch.Tensor:
        """Rows of ``field`` at global tail ``slots``, on the table's
        device: each shard's rows gathered from its rank's tensor."""
        v = self.state[field]
        slots = np.asarray(slots, np.int64)
        if not isinstance(v, list):
            return v[torch.from_numpy(slots).to(v.device)]
        shard, local = np.divmod(slots, self.key_index.capacity_per_shard)
        out = torch.empty((slots.size, *v[0].shape[1:]), dtype=v[0].dtype,
                          device=self.device)
        for r, t in enumerate(v):
            sel = np.flatnonzero(shard == r)
            if sel.size:
                out[torch.from_numpy(sel).to(self.device)] = t[
                    torch.from_numpy(local[sel]).to(t.device)].to(
                    self.device)
        return out

    def write_rows(self, field: str, slots: np.ndarray,
                   rows: torch.Tensor) -> None:
        """In place: the global ``slots`` of ``field`` take ``rows``, cast
        to the field's dtype (float32 -> bfloat16 rounds to nearest
        even, as numpy's bfloat16 does)."""
        v = self.state[field]
        slots = np.asarray(slots, np.int64)
        if not isinstance(v, list):
            v[torch.from_numpy(slots).to(v.device)] = rows.to(v.device,
                                                             v.dtype)
            return
        shard, local = np.divmod(slots, self.key_index.capacity_per_shard)
        for r, t in enumerate(v):
            sel = shard == r
            if sel.any():
                t[torch.from_numpy(local[sel]).to(t.device)] = \
                    rows[torch.from_numpy(sel).to(rows.device)].to(
                    t.device, t.dtype)

    def grow(self, new_capacity_per_shard: Optional[int] = None) -> None:
        """Re-lay the tail out at a larger per-shard capacity (default
        2x): every occupied tail row keeps its parameters and AdaGrad sums
        and moves to ``shard * new_cap + local``; the new rows are drawn
        from each field's init with a generator seeded ``seed + 1`` (a
        fresh stream per growth, as the JAX package folds its seed).  New
        tensors replace the old ones, a sharded table's as one new block
        per device (``split_rows``), so ``shard_block`` stays copy-free;
        both layouts coexist during the move.  Hot planes never move; the
        ``@ef`` and ``@rowver`` planes move with their rows, new rows at
        zero."""
        ki = self.key_index
        n_hot = self.n_hot
        old_per = ki.capacity_per_shard
        old_rows = np.fromiter((s - n_hot for _, s in ki.items()
                                if s >= n_hot), np.int64)
        tail = [f for f in self.state if not is_hot_field(f)]
        old = {f: self.global_rows(f) for f in tail}
        ki.grow(int(new_capacity_per_shard or 2 * old_per))
        new_rows = old_rows // old_per * ki.capacity_per_shard \
            + old_rows % old_per
        self.seed += 1
        rows = self._init_rows(hot=False)
        rows.update({f: old[f].new_zeros((ki.capacity, old[f].shape[1]))
                     for f in tail if is_side_plane(f)})
        src = torch.from_numpy(old_rows).to(self.device)
        dst = torch.from_numpy(new_rows).to(self.device)
        for f, t in rows.items():
            t[dst] = old[f][src]
        del old
        state = self._layout(rows)
        state.update({f: v for f, v in self.state.items()
                      if is_hot_field(f)})
        self.state = state
        self.generation += 1

    def repartition(self, new_partition):
        """Swap the hot/cold split to ``new_partition`` (a
        ``HotColdPartition`` or None), replaying the key index's
        :class:`~swiftmpi_tpu_torch.parameter.key_index.RepartitionPlan`
        on the rows (JAX ``SparseTable.repartition``): demoted hot rows
        are written into their tail rows, in place (each global tail row
        into its shard's tensor); staying keys' hot rows move to their
        new rank; promoted keys seed their hot row from their tail row,
        read before the demotions write.  The new hot planes are drawn
        fresh, one per field in sorted name order, from a generator
        seeded ``seed + 1`` (a fresh stream per change, as ``grow``), so
        only a promoted key without a tail slot keeps a drawn row.  The
        ``@ef`` planes are tail-indexed and carry through unchanged;
        ``@rowver`` stamps of the demoted rows are bumped past the global
        maximum, so a cached copy of a dormant tail row never hits.
        Raises ``CapacityError`` before touching anything when demoted
        keys cannot get tail slots.  Returns the plan."""
        plan = self.key_index.repartition(new_partition)
        new_n_hot = plan.new_n_hot
        fields = sorted(self.access.fields.items())
        # promoted keys' seed rows, read from the tail before any write
        seeds = {name: self.read_rows(name, plan.hot_from_tail_src)
                 for name, _ in fields}
        old_hot = {name: self.state.pop(hot_name(name), None)
                   for name, _ in fields}
        for name, _ in fields:
            if plan.demote_src.size:
                self.write_rows(name, plan.demote_dst, old_hot[name][
                    torch.from_numpy(plan.demote_src).to(self.device)])
        self.seed += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        for name, fs in fields:
            if not new_n_hot:
                continue
            hot = fs.init(gen, (new_n_hot, fs.dim), self.device).to(fs.dtype)
            if plan.hot_from_hot_src.size:
                hot[torch.from_numpy(plan.hot_from_hot_dst).to(
                    self.device)] = old_hot[name][torch.from_numpy(
                        plan.hot_from_hot_src).to(self.device)]
            if plan.hot_from_tail_src.size:
                hot[torch.from_numpy(plan.hot_from_tail_dst).to(
                    self.device)] = seeds[name]
            self.state[hot_name(name)] = hot
        if ROWVER_KEY in self.state and plan.demote_dst.size:
            ver = self.state[ROWVER_KEY]
            top = max(int(t.max()) for t in
                      (ver if isinstance(ver, list) else [ver]))
            self.write_rows(ROWVER_KEY, plan.demote_dst, torch.full(
                (plan.demote_dst.size, 1), top + 1, dtype=torch.int32,
                device=self.device))
        self.generation += 1
        return plan

    # -- the unified slot space (hot rows first) ---------------------------
    def unified_rows(self, field: str, slots) -> torch.Tensor:
        """Rows of ``field`` at unified ``slots`` (clipped into range, as
        JAX's ``take``), on the table's device."""
        slots = torch.as_tensor(slots, device=self.device).long()
        tail = self.global_rows(field)
        n_hot = self.n_hot
        if not n_hot:
            return tail[slots.clamp(0, tail.shape[0] - 1)]
        hot = self.state[hot_name(field)]
        hot_rows = hot[slots.clamp(0, n_hot - 1)]
        tail_rows = tail[(slots - n_hot).clamp(0, tail.shape[0] - 1)]
        return torch.where((slots < n_hot)[..., None], hot_rows, tail_rows)

    def gather(self, slots) -> Dict[str, torch.Tensor]:
        """Rows of the pull fields at unified ``slots``."""
        return {f: self.unified_rows(f, slots)
                for f in self.access.pull_fields}

    def gather_all_fields(self, slots) -> Dict[str, torch.Tensor]:
        return {f: self.unified_rows(f, slots) for f in self.access.fields}

    def unified_rows_host(self, field: str,
                          upcast: bool = False) -> np.ndarray:
        """Host copy of ``field`` indexed by unified slot: rows ``[0,
        n_hot)`` the hot plane, then the tail (see :func:`tensor_to_numpy`
        for ``upcast``).  Key-index slots index it directly."""
        tail = tensor_to_numpy(self.global_rows(field), upcast)
        if not self.n_hot:
            return tail
        return np.concatenate([tensor_to_numpy(
            self.state[hot_name(field)], upcast), tail])

    @property
    def capacity(self) -> int:
        return self.key_index.capacity

    @property
    def num_rows(self) -> int:
        """Occupied rows (reference SparseTable::size, sparsetable.h:135)."""
        return len(self.key_index)

    def rows_as_numpy(self) -> Dict[str, np.ndarray]:
        """Host copies of every field of the state, hot planes and side
        planes included, in its own dtype (bfloat16 as
        ``ml_dtypes.bfloat16``): :meth:`to_numpy` without the upcast."""
        return self.to_numpy()

    def to_numpy(self, upcast: bool = False) -> Dict[str, np.ndarray]:
        """Host copies of every field, indexed by global slot: a sharded
        table's shards concatenated in shard order (see
        :func:`state_to_numpy` for ``upcast``)."""
        return state_to_numpy(self.state, upcast=upcast)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SparseTable(fields={list(self.access.fields)}, "
                f"capacity={self.capacity}, rows={len(self.key_index)}, "
                f"shards={self.key_index.num_shards}, device={self.device})")


def tensor_to_numpy(t: torch.Tensor, upcast: bool = False) -> np.ndarray:
    """Host copy of ``t``.  numpy has no bfloat16 of its own: a bfloat16
    tensor comes back as an ``ml_dtypes.bfloat16`` array (the type JAX's
    arrays convert to) through a 16-bit view, its bits unchanged, or with
    ``upcast`` as float32, exactly (every bfloat16 is a float32)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    if upcast:
        return t.float().numpy()
    import ml_dtypes   # numpy's bfloat16; needed only for this case
    return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def state_to_numpy(state: TableState,
                   upcast: bool = False) -> Dict[str, np.ndarray]:
    """Global-row-order host copies of a state of either layout;
    bfloat16 fields as ``ml_dtypes.bfloat16`` arrays, or as float32 with
    ``upcast`` (:func:`tensor_to_numpy`)."""
    out = {}
    for f, v in state.items():
        parts = v if isinstance(v, (list, tuple)) else [v]
        out[f] = np.concatenate(
            [tensor_to_numpy(p, upcast) for p in parts], axis=0)
    return out


def split_rows(rows: torch.Tensor, mesh) -> List[torch.Tensor]:
    """``(n * cap_per_shard, ...)`` rows dealt to the ranks of ``mesh``:
    shard ``r`` is a contiguous tensor on rank ``r``'s device, and the
    shards of one device are the slices of one ``(R, cap_per_shard, ...)``
    block, in the device's rank order (a copy of ``rows``)."""
    if rows.shape[0] % mesh.n:
        raise ValueError(f"{rows.shape[0]} rows do not split over "
                         f"{mesh.n} shards")
    parts = rows.chunk(mesh.n, dim=0)
    out: List[torch.Tensor] = [None] * mesh.n
    for dev, ranks in mesh.device_groups:
        block = torch.stack([parts[r] for r in ranks]).to(dev)
        for i, r in enumerate(ranks):
            out[r] = block[i]
    return out


def shard_block(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ``(R, cap, ...)`` block whose rank slices are ``shards`` (the
    shards of one device group, in rank order), as a view: never a copy.
    Raises unless the shards are contiguous views of one storage, of one
    shape, dtype and device, at one positive stride that keeps them
    apart."""
    first = shards[0]
    for s in shards:
        if s.shape != first.shape or s.dtype != first.dtype \
                or s.device != first.device or not s.is_contiguous():
            raise ValueError("shard_block: the shards differ in shape, "
                             "dtype or device, or one is not contiguous")
    if len(shards) == 1:
        return first.unsqueeze(0)
    size = first.element_size()
    step = shards[1].data_ptr() - first.data_ptr()
    storage = first.untyped_storage().data_ptr()
    if step < first.numel() * size or step % size or any(
            s.untyped_storage().data_ptr() != storage
            or s.data_ptr() != first.data_ptr() + i * step
            for i, s in enumerate(shards)):
        raise ValueError("shard_block: the shards are not the slices of "
                         "one block at one stride (made by split_rows?)")
    return first.as_strided((len(shards), *first.shape),
                            (step // size, *first.stride()))
