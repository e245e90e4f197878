"""Table state between the two frameworks, as numpy arrays.

The JAX package's state is a ``{field: jax.Array}`` dict of global
``(capacity, dim)`` arrays; the port's has the same names and slot layout,
as one tensor per field (one device) or one tensor per shard (the sharded
table, ``parameter/sparse_table.py``).  Pass ``{f: np.asarray(a)}`` of the
JAX state to :func:`state_from_jax`, with the rank layout of a sharded
table as ``mesh``; :func:`state_to_numpy` goes the other way and gives
global arrays for either layout.  Neither side imports the other
framework.

numpy has no bfloat16 of its own; JAX's bfloat16 arrays convert to
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` does not take.
Both directions go through a 16-bit integer view, so the bits cross
unchanged, with no float round trip.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.sparse_table import (  # noqa: F401
    TableState, split_rows, state_to_numpy, tensor_to_numpy)


def state_from_jax(np_state: Dict[str, np.ndarray], device,
                   mesh=None) -> TableState:
    """Copies of the numpy arrays as contiguous tensors on ``device``, or,
    with ``mesh``, as per-shard tensors on its ranks' devices (global row
    order: shard ``s`` takes rows ``s * cap_per_shard`` onwards)."""
    out = {}
    for f, a in np_state.items():
        t = tensor_from_numpy(a)
        out[f] = t.to(device) if mesh is None else split_rows(t, mesh)
    return out


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A contiguous CPU tensor copy of ``a``; an ``ml_dtypes.bfloat16``
    array becomes a ``torch.bfloat16`` tensor of the same bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)
