"""Worker-side minibatch parameter cache (counterpart of
``swiftmpi_tpu/parameter/cache.py``).

Equivalent of the reference ``LocalParamCache``
(the reference's ``src/parameter/param.h:13-68``): the pulled rows for the
current key working set plus accumulated gradients, with per-key
accumulation counts for the mean-normalization the reference applies when
staging a push (word2vec.h:120-132: ``grad /= count`` inside operator<<;
lr.cpp:32-38 same for LR).

Implementation is aligned-array, not map-of-rows: keys are positions in a
dense ``(n, d)`` block, so the worker compute path stays vectorized.  The
training steps bypass this class (their "cache" is the rows a step pulls
on the device); the serving plane's LRU front
(:class:`~swiftmpi_tpu_torch.serve.reader.LruTailFront`) stores its rows
in one.  Host numpy only: serving readers import it, and they never touch
the device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np


class LocalParamCache:
    def __init__(self, pull_fields: Dict[str, int],
                 grad_fields: Optional[Dict[str, int]] = None):
        """``pull_fields``/``grad_fields``: name -> row width."""
        self._pull_fields = dict(pull_fields)
        self._grad_fields = dict(grad_fields or pull_fields)
        self._keys = np.empty(0, dtype=np.uint64)
        self._pos: Dict[int, int] = {}
        self.params: Dict[str, np.ndarray] = {}
        self.grads: Dict[str, np.ndarray] = {}
        self.counts: Dict[str, np.ndarray] = {}

    # -- lifecycle (param.h:24-37) ----------------------------------------
    def init_keys(self, keys: Iterable[int]) -> None:
        self._keys = np.fromiter(
            dict.fromkeys(int(k) for k in keys), dtype=np.uint64)
        n = len(self._keys)
        self._pos = {int(k): i for i, k in enumerate(self._keys)}
        self.params = {f: np.zeros((n, d), np.float32)
                       for f, d in self._pull_fields.items()}
        self.reset_grads()

    def reset_grads(self) -> None:
        n = len(self._keys)
        self.grads = {f: np.zeros((n, d), np.float32)
                      for f, d in self._grad_fields.items()}
        self.counts = {f: np.zeros(n, np.int64) for f in self._grad_fields}

    def clear(self) -> None:
        self.init_keys([])

    # -- access -----------------------------------------------------------
    @property
    def keys(self) -> np.ndarray:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def position(self, key: int) -> int:
        return self._pos[int(key)]

    def positions(self, keys) -> np.ndarray:
        return np.fromiter((self._pos[int(k)] for k in keys),
                           dtype=np.int64, count=len(keys))

    def set_params(self, rows: Dict[str, np.ndarray]) -> None:
        """Install pulled rows (the pull-response write,
        global_pull_access.h:80-101)."""
        for f, block in rows.items():
            self.params[f][...] = block

    def accumulate(self, field: str, positions, grad_rows) -> None:
        """grads[field][pos] += row; counts[field][pos] += 1
        (reference WLocalGrad::accu_h/accu_v, word2vec.h:75-84)."""
        positions = np.asarray(positions, dtype=np.int64)
        np.add.at(self.grads[field], positions,
                  np.asarray(grad_rows, dtype=np.float32))
        np.add.at(self.counts[field], positions, 1)

    def normalized_grads(self) -> Dict[str, np.ndarray]:
        """Mean-normalized accumulated grads, the exact quantity the
        reference serializes into a push (word2vec.h:120-132)."""
        out = {}
        for f, g in self.grads.items():
            c = np.maximum(self.counts[f], 1).astype(np.float32)
            out[f] = g / c[:, None]
        return out
