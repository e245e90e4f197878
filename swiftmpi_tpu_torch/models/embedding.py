"""Cosine-similarity index over trained embeddings (counterpart of
``swiftmpi_tpu/models/embedding.py``; shared by the live-model query API
and the ``w2v_eval`` CLI).

The whole similarity pass is one normalized product ``(V, d) @ (d, Q)``
plus a top-k, on the index's device (``torch.matmul`` and
``torch.topk``; the JAX package computes both outside any Pallas kernel);
exclusions are handled on the host by over-fetch + drop, so no ``(Q, V)``
mask is ever materialized.  Rows are L2-normalized once, in numpy, as the
JAX package normalizes them.  The reference has no embedding eval at all
(its word2vec README ends at the text dump; row layout
word2vec.h:100-110).

Tied scores may come back in another order than JAX's ``lax.top_k``
gives them; the scores and the sets of keys above a tie agree.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from swiftmpi_tpu_torch.device import resolve_device


class EmbeddingIndex:
    """In-memory cosine-similarity index over dumped embeddings.

    Rows are L2-normalized once at construction and copied to ``device``
    (the CUDA device unless ``device="cpu"``); every query batch is a
    single ``(V, d) @ (d, Q)`` product + top-k there.
    """

    def __init__(self, keys: np.ndarray, vecs: np.ndarray, device=None):
        if len(keys) != len(vecs):
            raise ValueError(f"{len(keys)} keys vs {len(vecs)} vectors")
        self.device = resolve_device(device)
        self.keys = np.asarray(keys, np.uint64)
        vecs = np.asarray(vecs, np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        self.vecs = vecs / np.maximum(norms, 1e-12)
        self._vecs_dev = torch.from_numpy(
            np.ascontiguousarray(self.vecs)).to(self.device)
        self._row_of = {int(k): i for i, k in enumerate(self.keys)}

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def from_text(cls, path: str, field: str = "v",
                  device=None) -> "EmbeddingIndex":
        """Parse a ``dump_table_text`` w2v dump: ``key TAB v-floats TAB
        h-floats`` per row (reference WParam operator<< layout,
        word2vec.h:100-110).  ``field`` picks the input-side (``v``) or
        output-side (``h``) vectors.  Single-vector dumps — sent2vec's
        ``sent_id TAB vec`` output (sent2vec.cpp:82-86), GloVe's ``key TAB
        (w + wt)`` or an LR weight dump — parse as ``v`` (requesting
        ``h`` from one is an error).  Read through the native C++ reader
        (``data/native.py``) when its library builds, else in Python."""
        if field not in ("v", "h"):
            raise ValueError(f"field must be 'v' or 'h', got {field!r}")
        col = 1 if field == "v" else 2
        dims = None
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) > col:
                    dims = [len(p.split()) for p in parts[1:]]
                break
        if dims:
            from swiftmpi_tpu_torch.data import native

            if native.available():
                try:
                    keys_np, arrs = native.load_rows_native(path, dims)
                    if len(keys_np):
                        return cls(keys_np, arrs[col - 1], device=device)
                except (OSError, ValueError, RuntimeError):
                    pass          # fall through to the python parser
        keys: List[int] = []
        rows: List[np.ndarray] = []
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                if len(parts) <= col:
                    raise ValueError(
                        f"{path}:{ln}: expected key\\tv\\th layout")
                keys.append(int(parts[0]) & ((1 << 64) - 1))
                rows.append(np.array(parts[col].split(), np.float32))
        if not rows:
            raise ValueError(f"{path}: no embedding rows")
        return cls(np.array(keys, np.uint64), np.stack(rows), device=device)

    def row(self, key: int) -> Optional[int]:
        return self._row_of.get(int(key) & ((1 << 64) - 1))

    def _topk_scores(self, q: np.ndarray, k: int):
        """One ``(V, d) @ (d, Q)`` product + top-k on the index's device:
        ``(scores (Q, k), rows (Q, k))`` on the host."""
        qt = torch.from_numpy(np.ascontiguousarray(q.T)).to(self.device)
        scores, idx = torch.topk((self._vecs_dev @ qt).T, k, dim=1)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def topk(self, queries: np.ndarray, k: int = 10,
             exclude_rows: Sequence[Sequence[int]] = ()) -> Tuple[
                 np.ndarray, np.ndarray]:
        """Top-k cosine neighbors for each query VECTOR.

        ``queries``: (Q, d).  ``exclude_rows``: per-query row indices to
        mask out (e.g. the query word itself).  Returns (keys (Q, k'),
        scores (Q, k')) with ``k' = min(k, rows)``.  A query with fewer
        survivors than k' (its exclusions ate into the fetch, or every
        fetched row was excluded) pads its tail with -inf scores —
        callers drop those by score, and the batched wrappers below do
        so automatically."""
        q = np.asarray(queries, np.float32)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        # no dense (Q, V) exclusion mask: over-fetch k + max_excl, drop
        # the excluded rows on the host
        max_excl = max((len(r) for r in exclude_rows), default=0)
        k_fetch = min(k + max_excl, len(self))
        scores, idx = self._topk_scores(q, k_fetch)
        Q = q.shape[0]
        k_out = min(k, len(self))
        out_i = np.zeros((Q, k_out), np.int64)
        out_s = np.full((Q, k_out), -np.inf, np.float32)
        for qi in range(Q):
            excl = set(exclude_rows[qi]) if qi < len(exclude_rows) \
                else set()
            keep = [j for j in range(k_fetch)
                    if idx[qi, j] not in excl][:k_out]
            if keep:
                out_i[qi, :len(keep)] = idx[qi, keep]
                out_s[qi, :len(keep)] = scores[qi, keep]
        return self.keys[out_i], out_s

    def neighbors(self, key: int, k: int = 10) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Top-k neighbors of one stored key (itself excluded)."""
        ks, ss = self.neighbors_batch([key], k)
        return ks[0], ss[0]

    def neighbors_batch(self, keys: Sequence[int], k: int = 10) -> Tuple[
            List[np.ndarray], List[np.ndarray]]:
        """Neighbors for MANY stored keys in ONE product + top-k (each
        query's own row excluded); -inf (masked-out) entries are dropped
        per query."""
        rows = []
        for key in keys:
            r = self.row(key)
            if r is None:
                raise KeyError(f"key {int(key)} not in embeddings")
            rows.append(r)
        ks, ss = self.topk(self.vecs[np.array(rows)], k,
                           exclude_rows=[[r] for r in rows])
        kept = [np.isfinite(s) for s in ss]
        return ([kk[m] for kk, m in zip(ks, kept)],
                [s[m] for s, m in zip(ss, kept)])

    def analogy(self, a: int, b: int, c: int, k: int = 5) -> Tuple[
            np.ndarray, np.ndarray]:
        """``a - b + c`` in embedding space (a:b :: result:c), query
        words excluded from candidates."""
        rows = [self.row(x) for x in (a, b, c)]
        missing = [x for x, r in zip((a, b, c), rows) if r is None]
        if missing:
            raise KeyError(f"keys not in embeddings: {missing}")
        q = (self.vecs[rows[0]] - self.vecs[rows[1]] + self.vecs[rows[2]])
        ks, ss = self.topk(q[None, :], k, exclude_rows=[rows])
        m = np.isfinite(ss[0])
        return ks[0][m], ss[0][m]
