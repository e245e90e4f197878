"""Dense parameter table on one device (counterpart of
``swiftmpi_tpu/parameter/sparse_table.py``).

The table state is a plain ``{field: Tensor}`` dict of ``(capacity, dim)``
tensors on the device, indexed by the dense slots a host-side
:class:`KeyIndex` assigns.  Every row is initialized eagerly with its
field's distribution (eager-random is lazy-random for every observable
row).  Push paths update these tensors in place.  The ``@rowver``,
``@ef`` and ``@hot`` planes, ``grow`` and ``repartition`` are not ported
yet (ROADMAP A12).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.access import AccessMethod
from swiftmpi_tpu_torch.parameter.key_index import KeyIndex

TableState = Dict[str, torch.Tensor]


class SparseTable:
    def __init__(self, access: AccessMethod, key_index: KeyIndex,
                 device: torch.device, seed: int = 0):
        self.access = access
        self.key_index = key_index
        self.device = torch.device(device)
        self.seed = int(seed)
        self.state: TableState = self._init_state()

    def _init_state(self) -> TableState:
        """Fields in sorted name order, each drawn from one generator
        seeded with ``seed`` (the JAX package's order of key splits; the
        values differ, as torch and jax generators do)."""
        cap = self.key_index.capacity
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return {name: fs.init(gen, (cap, fs.dim), self.device).to(fs.dtype)
                for name, fs in sorted(self.access.fields.items())}

    @property
    def capacity(self) -> int:
        return self.key_index.capacity

    def rows_as_numpy(self) -> Dict[str, np.ndarray]:
        """Host copies of every field, indexed by slot."""
        return {f: v.detach().cpu().numpy() for f, v in self.state.items()}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SparseTable(fields={list(self.access.fields)}, "
                f"capacity={self.capacity}, rows={len(self.key_index)}, "
                f"device={self.device})")
