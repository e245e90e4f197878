"""The reference's random number generator (counterpart of
``swiftmpi_tpu/utils/rng.py``).

``Random`` is the reference's word2vec-C linear congruential generator
(the reference's ``src/utils/random.h:20-42``): ``next = next * 25214903917 +
11`` over 64 bits, plus the separate float LCG (``* 4903917 + 11`` over 64
bits, seeded at ``ULONG_MAX/2``).  Host-side code that wants the
reference's own sampling streams (the numpy word2vec oracle's window
shrinks, negative draws and subsampling coin flips) uses it, including
the process singleton ``global_random()`` seeded 2008 (random.h:44-47).
Everything on the device draws from torch generators instead; loss
parity needs equality in distribution, not in stream.

``Random.batch`` materializes the next n LCG states with a plain
sequential loop: host callers only draw small batches.
"""

from __future__ import annotations

import numpy as np

_LCG_MUL = 25214903917
_LCG_INC = 11
_MASK64 = (1 << 64) - 1
_FLOAT_MUL = 4903917
_FLOAT_INC = 11
_ULONG_MAX = (1 << 64) - 1


class Random:
    """Reference-faithful scalar LCG (random.h:25-42)."""

    def __init__(self, seed: int = 2008):
        self.next_random = seed & _MASK64
        self.next_float_random = _ULONG_MAX // 2

    def __call__(self) -> int:
        self.next_random = (self.next_random * _LCG_MUL + _LCG_INC) & _MASK64
        return self.next_random

    def gen_float(self) -> float:
        self.next_float_random = (
            self.next_float_random * _FLOAT_MUL + _FLOAT_INC) & _MASK64
        return float(self.next_float_random) / _ULONG_MAX

    # -- batched draws ----------------------------------------------------
    def batch(self, n: int) -> np.ndarray:
        """Next ``n`` values of the integer LCG as uint64, advancing state."""
        out = np.empty(n, dtype=np.uint64)
        x = self.next_random
        for i in range(n):  # simple loop; n is small on host paths
            x = (x * _LCG_MUL + _LCG_INC) & _MASK64
            out[i] = x
        self.next_random = x
        return out

    def batch_float(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        x = self.next_float_random
        for i in range(n):
            x = (x * _FLOAT_MUL + _FLOAT_INC) & _MASK64
            out[i] = x / _ULONG_MAX
        self.next_float_random = x
        return out


_GLOBAL_RANDOM = None


def global_random() -> Random:
    """Singleton seeded 2008, mirroring reference random.h:44-47."""
    global _GLOBAL_RANDOM
    if _GLOBAL_RANDOM is None:
        _GLOBAL_RANDOM = Random(2008)
    return _GLOBAL_RANDOM


def reset_global_random(seed: int = 2008) -> None:
    global _GLOBAL_RANDOM
    _GLOBAL_RANDOM = Random(seed)
