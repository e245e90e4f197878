"""Table state between the two frameworks, as numpy arrays.

The JAX package's state is a ``{field: jax.Array}`` dict of global
``(capacity, dim)`` arrays; the port's has the same names and slot layout,
as one tensor per field (one device) or one tensor per shard (the sharded
table, ``parameter/sparse_table.py``).  The side planes go as the tail
does, at their own dtypes: ``f@ef`` (float32 residuals) and ``@rowver``
(``(capacity, 1)`` int32 versions), dealt to the shards like a field.  Pass ``{f: np.asarray(a)}`` of the
JAX state to :func:`state_from_jax`, with the rank layout of a sharded
table as ``mesh``; :func:`state_to_numpy` goes the other way and gives
global arrays for either layout.  Neither side imports the other
framework.

numpy has no bfloat16 of its own; JAX's bfloat16 arrays convert to
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` does not take.
Both directions go through a 16-bit integer view, so the bits cross
unchanged, with no float round trip.

The transformer family: :func:`transformer_params_from_jax` takes the
JAX package's params pytree with numpy leaves (``jax.tree.map(np.asarray,
params)``, its ``MoEParams`` included) and gives the port's;
:func:`trainer_state_from_jax_npz` reads a JAX ``Trainer.save`` file into
a port ``TrainState`` by leaf order (params, adam's ``mu``/``nu`` and
counts, the step).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.sparse_table import (  # noqa: F401
    TableState, is_hot_field, split_rows, state_to_numpy, tensor_to_numpy)


def state_from_jax(np_state: Dict[str, np.ndarray], device,
                   mesh=None) -> TableState:
    """Copies of the numpy arrays as contiguous tensors on ``device``, or,
    with ``mesh``, as per-shard tensors on its ranks' devices (global row
    order: shard ``s`` takes rows ``s * cap_per_shard`` onwards); a hot
    plane (``f@hot``) stays one tensor on ``device`` either way."""
    out = {}
    for f, a in np_state.items():
        t = tensor_from_numpy(a)
        out[f] = (t.to(device) if mesh is None or is_hot_field(f)
                  else split_rows(t, mesh))
    return out


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A contiguous CPU tensor copy of ``a``; an ``ml_dtypes.bfloat16``
    array becomes a ``torch.bfloat16`` tensor of the same bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def transformer_params_from_jax(np_params, device):
    """The port's transformer params from the JAX package's pytree of
    numpy arrays: dicts stay dicts, a named tuple with ``MoEParams``'
    fields becomes the port's ``MoEParams``, every array a tensor copy on
    ``device`` (bfloat16 bits unchanged)."""
    from swiftmpi_tpu_torch.parallel.moe import MoEParams

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and getattr(t, "_fields", None) \
                == MoEParams._fields:
            return MoEParams(*(walk(v) for v in t))
        return tensor_from_numpy(np.asarray(t)).to(device)

    return walk(np_params)


def trainer_state_from_jax_npz(path: str, trainer, verify: bool = True):
    """A port ``TrainState`` for ``trainer`` from a JAX ``Trainer.save``
    file: the file's ``leaf_i`` in flatten order into a fresh state's
    leaves (their count, shapes and dtypes checked; the ``treedef``
    string is not compared, so a file of another optax version whose
    leaves line up loads too).  ``verify`` CRC-checks the file first."""
    from swiftmpi_tpu_torch.io.checkpoint import npz_path, verify_checkpoint
    from swiftmpi_tpu_torch.models.trainer import load_leaves
    dst = npz_path(path)
    if verify:
        verify_checkpoint(dst)
    state = trainer.init_state(0)
    with np.load(dst) as z:
        n = sum(1 for f in z.files if f.startswith("leaf_"))
        arrays = [z[f"leaf_{i}"] for i in range(n)]
    load_leaves(state, arrays)
    return state
