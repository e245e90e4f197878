"""Key hashing (counterpart of ``swiftmpi_tpu/utils/hashing.py``).

``get_hash_code`` (a scalar) and ``get_hash_code_np`` (over numpy arrays)
are the 64-bit MurmurHash3 finalizer (public-domain avalanche constants)
the reference routes keys with (reference HashFunction.h:16-24, applied
through hashfrag.h:51-55).  It decides which shard owns a key, so it must
agree with the JAX package bit for bit.  ``bkdr_hash`` (and
``bkdr_hash_batch`` over a list) is the seed-13131 polynomial string hash
that maps words to integer keys (reference string.h:130-137).  Hashing
happens on the host; device arrays are indexed by dense slot ids, never
by raw keys.
"""

from __future__ import annotations

import numpy as np

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_SHIFT = np.uint64(33)
_MASK64 = (1 << 64) - 1


def get_hash_code(x: int) -> int:
    """Scalar murmur64 finalizer (reference HashFunction.h:16-24)."""
    x &= _MASK64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _MASK64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _MASK64
    x ^= x >> 33
    return x


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


def bkdr_hash(s: str, seed: int = 13131, bits: int = 32) -> int:
    """Polynomial string hash (reference string.h:130-137); ``bits`` is
    the wrap width, 32 (the apps' default key type) or 64 (async
    word2vec's ``size_t`` keys)."""
    mask = (1 << bits) - 1
    h = 0
    for ch in s.encode("utf-8"):
        h = (h * seed + ch) & mask
    return h


def bkdr_hash_batch(words, seed: int = 13131, bits: int = 32) -> np.ndarray:
    """:func:`bkdr_hash` of each of ``words``, as a uint64 array."""
    out = np.empty(len(words), dtype=np.uint64)
    for i, w in enumerate(words):
        out[i] = bkdr_hash(w, seed, bits)
    return out
