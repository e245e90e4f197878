"""Exponentially-decayed frequency sketch over the vocab index space
(counterpart of ``swiftmpi_tpu/control/sketch.py``).

The control plane's view of *recent* traffic.  The static calibration
(:func:`~swiftmpi_tpu_torch.parameter.key_index.calibrate_hot_k`) keys off the
corpus-wide frequency CDF; under drift (the hot set rotates mid-run) that
CDF goes stale while the live stream's does not.  :class:`DecayedSketch`
keeps an exponentially-decayed histogram of the ids actually flowing
through the training loop:

* :meth:`observe` is producer-side and cheap — it appends the raw id
  array to a pending list under a lock (the input pipeline renders
  batches on a producer thread, so the sketch is the one control-plane
  structure two threads touch).
* :meth:`fold` is consumer-side (the controller's evaluation tick): it
  drains the pending list, decays the histogram by ``decay`` and adds
  the fresh bincount.  One decay per fold — the half-life is measured in
  *evaluations*, matching the controller's cadence.

Seeding from the build-time vocab counts makes evaluation 0 a fixed
point: ``calibrate_hot_k`` depends only on the CDF shape, and a
uniformly-scaled histogram has the same CDF, so a freshly-seeded sketch
reproduces the build-time partition exactly — the tuner never flaps on
startup, it only moves when the observed stream actually diverges.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class DecayedSketch:
    """Decayed id-frequency histogram with thread-safe observation.

    ``size`` is the id-space width (vocab size); ids outside
    ``[0, size)`` are dropped at fold time (padding / sentinel rows in
    rendered batches must not pollute the histogram).  ``decay`` in
    ``(0, 1]`` is the per-fold retention factor (1.0 = cumulative, no
    forgetting).  ``seed_counts`` (optional) pre-loads the histogram —
    pass the build-time vocab counts so the first evaluations see the
    calibration distribution rather than an empty one.
    """

    def __init__(self, size: int, decay: float = 0.5,
                 seed_counts=None):
        size = int(size)
        if size < 1:
            raise ValueError(f"sketch size must be >= 1, got {size}")
        decay = float(decay)
        if not (0.0 < decay <= 1.0):
            raise ValueError(
                f"sketch decay must be in (0, 1], got {decay}")
        self.size = size
        self.decay = decay
        self._lock = threading.Lock()
        self._pending: list = []
        if seed_counts is not None:
            seed = np.asarray(seed_counts, np.float64).ravel()
            if seed.size != size:
                raise ValueError(
                    f"seed_counts has {seed.size} entries, sketch size "
                    f"is {size}")
            self._counts = seed.copy()
        else:
            self._counts = np.zeros(size, np.float64)
        #: total ids folded into the histogram (excludes the seed)
        self.observed = 0
        #: fold (evaluation) count — one decay has been applied per fold
        self.folds = 0

    # -- producer side -----------------------------------------------------
    def observe(self, ids) -> None:
        """Queue an id array (any shape) for the next fold.  Copies —
        the caller may reuse or mutate its buffer after this returns."""
        arr = np.asarray(ids)
        if arr.size == 0:
            return
        flat = np.array(arr.ravel(), dtype=np.int64, copy=True)
        with self._lock:
            self._pending.append(flat)

    def pending_ids(self) -> int:
        """Ids queued but not yet folded (observability/tests)."""
        with self._lock:
            return int(sum(a.size for a in self._pending))

    # -- consumer side -----------------------------------------------------
    def fold(self) -> np.ndarray:
        """Decay the histogram and fold in everything observed since the
        last fold.  Returns the live histogram (treat as read-only)."""
        with self._lock:
            pend, self._pending = self._pending, []
        fresh: Optional[np.ndarray] = None
        if pend:
            ids = np.concatenate(pend) if len(pend) > 1 else pend[0]
            ids = ids[(ids >= 0) & (ids < self.size)]
            if ids.size:
                fresh = np.bincount(ids, minlength=self.size).astype(
                    np.float64)
                self.observed += int(ids.size)
        self._counts *= self.decay
        if fresh is not None:
            self._counts += fresh
        self.folds += 1
        return self._counts

    @property
    def counts(self) -> np.ndarray:
        """The current histogram (as of the last fold; read-only)."""
        return self._counts

    def topk(self, k: int):
        """``[(id, decayed_count), ...]`` for the ``k`` hottest ids (as
        of the last fold), hottest first; zero-count ids are excluded.
        The wire tracer's hot-key attribution reads this to rank keys
        by decayed touch frequency (``obs/trace.py``)."""
        k = int(k)
        if k <= 0:
            return []
        c = self._counts
        n = min(k, c.size)
        idx = np.argpartition(c, -n)[-n:]
        idx = idx[np.argsort(c[idx])[::-1]]
        return [(int(i), float(c[i])) for i in idx if c[i] > 0]
