"""Key hashing for shard routing (counterpart of
``swiftmpi_tpu/utils/hashing.py``).

``get_hash_code_np`` is the 64-bit MurmurHash3 finalizer (public-domain
avalanche constants) the reference routes keys with (reference
HashFunction.h:16-24, applied through hashfrag.h:51-55), over numpy
arrays.  It decides which
shard owns a key, so it must agree with the JAX package bit for bit.
Hashing happens on the host; device arrays are indexed by dense slot ids,
never by raw keys.
"""

from __future__ import annotations

import numpy as np

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_SHIFT = np.uint64(33)


def get_hash_code_np(keys: np.ndarray) -> np.ndarray:
    """Vectorized murmur64 finalizer over a uint64 array."""
    x = np.asarray(keys, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> _SHIFT
        x *= _M1
        x ^= x >> _SHIFT
        x *= _M2
        x ^= x >> _SHIFT
    return x
