"""Table state between the two frameworks, as numpy arrays.

The JAX package's state is a ``{field: jax.Array}`` dict; the port's a
``{field: Tensor}`` dict with the same names, shapes and slot layout (one
shard, see ``parameter/key_index.py``).  Pass ``{f: np.asarray(a)}`` of
the JAX state to :func:`state_from_jax`; :func:`state_to_numpy` goes the
other way.  Neither side imports the other framework.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_from_jax(np_state: Dict[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """Copies of the numpy arrays as contiguous tensors on ``device``."""
    return {f: torch.from_numpy(np.array(a, copy=True)).to(device)
            for f, a in np_state.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {f: t.detach().cpu().numpy().copy() for f, t in state.items()}
