"""libSVM-format data pipeline (a9a-style) for logistic regression
(counterpart of ``swiftmpi_tpu/data/libsvm.py``, host-side numpy copied
from the JAX package so the port imports nothing of it).

Host-side equivalent of the reference's ``parse_instance2`` + minibatch
scan (the reference's `src/apps/logistic/lr.cpp:103-131,300-355`): lines are
``label feat:val feat:val ...``; ``#`` comments and blank lines skipped.

Reference labels arrive already converted to {0,1} by its
``tools/svm2fm.sh`` awk step; raw a9a uses {-1,+1}, so the parser maps
negative labels to 0 (the conversion the reference does out-of-band).

Batches are padded to static shapes (one CUDA graph per group length):
``(B, max_feats)`` feature-id and value matrices with a mask, matching the
transfer layer's padding convention.  :func:`load_data` takes the port's
native C++ parser (``data/native.py``) when its library builds, else the
Python parser, as the JAX package does, and names the one it took in
``CSRData.parser``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class LibSVMBatch:
    targets: np.ndarray    # (B,) float32 in {0,1}
    feat_ids: np.ndarray   # (B, F) uint64 feature keys; pad rows repeat 0
    feat_vals: np.ndarray  # (B, F) float32; 0 at padding
    mask: np.ndarray       # (B, F) bool, True where a real feature

    def __len__(self) -> int:
        return len(self.targets)

    def unique_keys(self) -> np.ndarray:
        return np.unique(self.feat_ids[self.mask])


def parse_line(line: str) -> Optional[Tuple[float, List[Tuple[int, float]]]]:
    """One instance, or None for blank/comment (lr.cpp:103-131)."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    parts = line.split()
    try:
        label = float(parts[0])
    except ValueError:
        raise ValueError(f"cannot parse label in line {line!r}")
    feats = []
    for tok in parts[1:]:
        if tok.startswith("#"):
            break
        f, _, v = tok.partition(":")
        feats.append((int(f), float(v)))
    return (1.0 if label > 0 else 0.0), feats


def load_file(path: str) -> List[Tuple[float, List[Tuple[int, float]]]]:
    out = []
    with open(path) as f:
        for line in f:
            ins = parse_line(line)
            if ins is not None and ins[1]:
                out.append(ins)
    return out


@dataclass
class CSRData:
    """Whole-dataset CSR arrays (the native parser's output shape); row i's
    features are ``feat_ids[offsets[i]:offsets[i+1]]``."""
    labels: np.ndarray     # (N,) float32 {0,1}
    offsets: np.ndarray    # (N+1,) int64
    feat_ids: np.ndarray   # (nnz,) uint64
    feat_vals: np.ndarray  # (nnz,) float32
    parser: str = "python"  # "native" when the C++ parser read the file

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def max_feats(self) -> int:
        if not len(self.labels):
            return 0
        return int(np.max(np.diff(self.offsets)))


def to_csr(instances) -> CSRData:
    """Python instance list -> CSR arrays (fallback for the native parser)."""
    labels = np.asarray([y for y, _ in instances], np.float32)
    offsets = np.zeros(len(instances) + 1, np.int64)
    ids, vals = [], []
    for i, (_, feats) in enumerate(instances):
        for f, v in feats:
            ids.append(f)
            vals.append(v)
        offsets[i + 1] = len(ids)
    return CSRData(labels, offsets, np.asarray(ids, np.uint64),
                   np.asarray(vals, np.float32))


def load_data(path: str) -> CSRData:
    """Load a libSVM file as CSR, via the native C++ parser when available
    (io.cpp smtpu_libsvm_parse) else the python line parser."""
    from swiftmpi_tpu_torch.data import native
    if native.available():
        labels, offsets, ids, vals = native.parse_libsvm_native(path)
        return CSRData(labels, offsets, ids, vals, parser="native")
    return to_csr(load_file(path))


def make_batch(instances, max_feats: Optional[int] = None) -> LibSVMBatch:
    B = len(instances)
    F = max_feats or max(len(f) for _, f in instances)
    targets = np.zeros(B, np.float32)
    ids = np.zeros((B, F), np.uint64)
    vals = np.zeros((B, F), np.float32)
    mask = np.zeros((B, F), bool)
    for i, (y, feats) in enumerate(instances):
        targets[i] = y
        for j, (f, v) in enumerate(feats[:F]):
            ids[i, j] = f
            vals[i, j] = v
            mask[i, j] = True
    return LibSVMBatch(targets, ids, vals, mask)


def _iter_csr(data: CSRData, batch_size: int, F: int,
              drop_remainder: bool) -> Iterator[LibSVMBatch]:
    """Vectorized minibatch assembly straight from CSR arrays — no
    per-instance python loop."""
    N = len(data)
    nnz = len(data.feat_ids)
    col = np.arange(F)
    for i in range(0, N, batch_size):
        j = min(i + batch_size, N)
        if j - i < batch_size and drop_remainder:
            return
        lens = (data.offsets[i + 1:j + 1] - data.offsets[i:j])
        lens = np.minimum(lens, F)
        mask = col[None, :] < lens[:, None]                  # (b, F)
        if nnz == 0:  # all-feature-less rows: nothing to gather
            ids = np.zeros((j - i, F), np.uint64)
            vals = np.zeros((j - i, F), np.float32)
        else:
            flat = data.offsets[i:j, None] + col[None, :]
            flat = np.clip(flat, 0, nnz - 1)
            ids = np.where(mask, data.feat_ids[flat], np.uint64(0))
            vals = np.where(mask, data.feat_vals[flat], np.float32(0))
        targets = data.labels[i:j]
        if j - i < batch_size:                               # pad tail
            pad = batch_size - (j - i)
            targets = np.concatenate([targets, np.zeros(pad, np.float32)])
            ids = np.concatenate([ids, np.zeros((pad, F), np.uint64)])
            vals = np.concatenate([vals, np.zeros((pad, F), np.float32)])
            mask = np.concatenate([mask, np.zeros((pad, F), bool)])
        yield LibSVMBatch(targets, ids, vals, mask)


def iter_minibatches(instances, batch_size: int,
                     max_feats: Optional[int] = None,
                     drop_remainder: bool = False
                     ) -> Iterator[LibSVMBatch]:
    """Fixed-size minibatches (reference [worker] minibatch config); the
    trailing short batch is padded up to ``batch_size`` with zero-mask rows
    so every step has one static shape (one XLA compilation).  Accepts a
    python instance list or ``CSRData``."""
    if isinstance(instances, CSRData):
        F = max_feats or instances.max_feats
        yield from _iter_csr(instances, batch_size, F, drop_remainder)
        return
    F = max_feats or max(len(f) for _, f in instances)
    for i in range(0, len(instances), batch_size):
        chunk = instances[i:i + batch_size]
        if len(chunk) < batch_size:
            if drop_remainder:
                return
            batch = make_batch(chunk, F)
            pad = batch_size - len(chunk)
            yield LibSVMBatch(
                np.concatenate([batch.targets, np.zeros(pad, np.float32)]),
                np.concatenate([batch.feat_ids,
                                np.zeros((pad, F), np.uint64)]),
                np.concatenate([batch.feat_vals,
                                np.zeros((pad, F), np.float32)]),
                np.concatenate([batch.mask, np.zeros((pad, F), bool)]))
            return
        yield make_batch(chunk, F)


def synthetic_dataset(n: int, dim: int, nnz: int, seed: int = 0,
                      noise: float = 0.0):
    """Linearly separable sparse synthetic data for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=dim)
    out = []
    for _ in range(n):
        feats_idx = rng.choice(dim, size=nnz, replace=False)
        vals = rng.normal(size=nnz).astype(np.float64)
        score = float(vals @ w[feats_idx]) + rng.normal() * noise
        label = 1.0 if score > 0 else 0.0
        out.append((label, [(int(f) + 1, float(v))
                            for f, v in zip(feats_idx, vals)]))
    return out
