"""Dense parameter table (counterpart of
``swiftmpi_tpu/parameter/sparse_table.py``).

The table is indexed by the dense slots a host-side :class:`KeyIndex`
assigns.  It has two layouts:

* **one device** (no ``mesh``; ``transfer: xla``): the state is a plain
  ``{field: Tensor}`` dict of ``(capacity, dim)`` tensors.
* **sharded** (``mesh``: a rank layout; ``transfer: tpu``): the state is
  ``{field: [Tensor] * n}``, one contiguous ``(capacity_per_shard, dim)``
  tensor per shard on its rank's device.  Shard ``s`` holds the global
  slots ``s * capacity_per_shard ... (s + 1) * capacity_per_shard - 1``,
  so the shards concatenated in order are exactly the JAX package's
  global array (:meth:`to_numpy`).  The shards of the ranks that share a
  device are the rank slices of one ``(R, capacity_per_shard, dim)``
  block in the group's rank order (:func:`split_rows`), which
  :func:`shard_block` returns without a copy, so one kernel launch serves
  the whole group; each rank still reads and writes only its own
  slice.

Every row is initialized eagerly with its field's distribution (eager-
random is lazy-random for every observable row), drawn in float32 and
cast to the field's dtype, as the JAX package does: a bfloat16 field
(``[server] dtype: bfloat16``) holds the rounded draw.  Push paths update
the tensors in place.  The ``@rowver``, ``@ef`` and ``@hot`` planes, ``grow``
and ``repartition`` are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.access import AccessMethod
from swiftmpi_tpu_torch.parameter.key_index import KeyIndex

TableState = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]


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
        if mesh is None and key_index.num_shards != 1:
            raise ValueError("a table of several shards needs a rank layout")
        self.state: TableState = self._init_state()

    def _init_state(self) -> TableState:
        """Fields in sorted name order, each drawn from one generator
        seeded with ``seed`` (the JAX package's order of key splits; the
        values differ, as torch and jax generators do).  A sharded table
        draws the same rows and deals them to the shards' devices, so its
        initial values do not depend on the layout."""
        cap = self.key_index.capacity
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        state = {name: fs.init(gen, (cap, fs.dim), self.device).to(fs.dtype)
                 for name, fs in sorted(self.access.fields.items())}
        if self.mesh is None:
            return state
        return {f: split_rows(t, self.mesh) for f, t in state.items()}

    @property
    def capacity(self) -> int:
        return self.key_index.capacity

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
