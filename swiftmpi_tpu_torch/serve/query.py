"""Batched top-k neighbor queries over a snapshot (counterpart of
``swiftmpi_tpu/serve/query.py``).

The serving default is HOST-side: one normalized ``(Q, d) @ (d, V)``
numpy matmul + ``argpartition`` over the snapshot's host replica.
Reader threads must never launch device work — they share the process
and the card with the trainer, and serving load should not steal
device time from it.

``device=...`` opts into the torch path on a device: the snapshot's
rows uploaded, ONE ``(V, d) @ (d, Q)`` product and ``torch.topk``
under ``torch.profiler.record_function("serve/topk")`` (the JAX package
computes this with ``jnp`` and ``lax.top_k``, outside any Pallas
kernel, so it stays a library call here).  It is for TRAINER-THREAD
bulk queries only (offline sweeps between epochs).  The module imports
``torch`` only inside that path.

Self-exclusion is handled host-side by over-fetching one extra neighbor
and dropping the query's own slot — no ``(Q, V)`` mask, same idiom as
``EmbeddingIndex.topk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _topk_unified_device(hot, tail, qt, k, device):  # smtpu-lint: disable=READER-PURE-HOST
    """The torch twin of :func:`_topk_unified_host` on ``device`` (None:
    the CUDA device, raising without one): the same normalization in
    float32 and the same ``(scores, slots)`` contract, sorted by
    descending score.  ``hot`` may be a ``(0, d)`` placeholder."""
    import torch
    from swiftmpi_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    with torch.profiler.record_function("serve/topk"):
        vecs = torch.from_numpy(np.concatenate(
            [np.asarray(hot, np.float32), np.asarray(tail, np.float32)],
            axis=0)).to(dev)
        norms = torch.linalg.norm(vecs, dim=1, keepdim=True)
        vecs = vecs / torch.clamp(norms, min=1e-12)
        scores = (vecs @ torch.from_numpy(np.ascontiguousarray(qt)).to(
            dev)).T                                 # (Q, V)
        top, idx = torch.topk(scores, k, dim=1)
    return top.cpu().numpy(), idx.cpu().numpy()


def _topk_unified_host(hot, tail, qt, k):
    """Host twin of the device kernel: same normalization, same
    (scores, slots) contract, pure numpy."""
    vecs = np.concatenate(
        [np.asarray(hot, np.float32), np.asarray(tail, np.float32)],
        axis=0)
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = vecs / np.maximum(norms, 1e-12)
    scores = (vecs @ qt).T                      # (Q, V)
    V = scores.shape[1]
    if k >= V:
        idx = np.argsort(-scores, axis=1)
    else:
        part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(scores, part, axis=1),
                           axis=1)
        idx = np.take_along_axis(part, order, axis=1)
    return np.take_along_axis(scores, idx, axis=1), idx


def snapshot_topk(snap, query_vecs: np.ndarray, k: int = 10,
                  exclude_slots: Optional[np.ndarray] = None,
                  device=False
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k neighbors of ``query_vecs`` (Q, d) over snapshot ``snap``.

    Returns ``(keys (Q, k), slots (Q, k), scores (Q, k))`` in unified
    slot space; vacant slots can only surface for near-empty tables (a
    vacant row's init vector is a legal neighbor of nothing meaningful
    but is still a valid row).  ``exclude_slots``: one slot per query to
    drop (the query word itself); the fetch over-provisions by one.
    ``device``: False for the host path; True (the CUDA device) or a
    device name for the torch path — trainer thread only (see module
    docstring).
    """
    field = snap.meta.get("query_field", "v")
    tail = snap.tail_array(field)
    hot = snap.hot_array(field)
    if hot is None:
        hot = np.zeros((0, tail.shape[1]), np.float32)
    q = np.asarray(query_vecs, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    k_fetch = min(k + (1 if exclude_slots is not None else 0),
                  snap.total_capacity)
    if device is False:
        scores, idx = _topk_unified_host(hot, tail, q.T, k_fetch)
    else:
        scores, idx = _topk_unified_device(hot, tail, q.T, k_fetch,
                                           None if device is True
                                           else device)
    idx, scores = np.asarray(idx), np.asarray(scores)
    k_out = min(k, snap.total_capacity)
    Q = q.shape[0]
    out_slots = np.zeros((Q, k_out), np.int64)
    out_scores = np.full((Q, k_out), -np.inf, np.float32)
    for qi in range(Q):
        row_idx, row_sc = idx[qi], scores[qi]
        if exclude_slots is not None and exclude_slots[qi] >= 0:
            keep = row_idx != exclude_slots[qi]
            row_idx, row_sc = row_idx[keep], row_sc[keep]
        n = min(k_out, len(row_idx))
        out_slots[qi, :n] = row_idx[:n]
        out_scores[qi, :n] = row_sc[:n]
    keys = snap.key_of_slot()[out_slots]
    return keys, out_slots, out_scores
