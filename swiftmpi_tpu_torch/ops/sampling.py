"""Negative sampling and subsampling for word2vec (counterpart of
``swiftmpi_tpu/ops/sampling.py``).

The alias tables and the subsampling keep-rule are numpy, copied from the
JAX package so the port imports nothing of it.  The device-side draw is
split in two so the parity tests can replay the JAX package's draws:

* :func:`alias_draws` makes the raw draws ``(j, u)`` — a bucket in
  ``[0, V)`` and a uniform in ``[0, 1)`` per sample — from a
  ``torch.Generator``;
* :func:`sample_alias_slots_from_draws` resolves them, as a pure function
  of ``(j, u)``, exactly as ``_alias_draw_packed``/``sample_alias_slots``
  do: accept bucket ``j`` when ``u < prob[j]``, else take ``alias[j]``,
  and map the vocab index to its table slot;
  :func:`sample_alias_from_draws` is the same resolution without the slot
  map (``sample_alias``).

``torch.Generator`` and ``jax.random`` never produce the same stream, so
the draws themselves differ between the frameworks; the resolution of a
given ``(j, u)`` is identical.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def build_unigram_alias(counts: np.ndarray, power: float = 0.75
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables for the unigram^power distribution.

    Returns (prob, alias): float32 (V,) acceptance thresholds and int32
    (V,) alias targets.  Sampling: draw bucket j ~ U[0,V), accept j if
    u < prob[j] else take alias[j]."""
    counts = np.asarray(counts, np.float64)
    if counts.ndim != 1 or len(counts) == 0:
        raise ValueError("counts must be a non-empty 1-D array")
    w = counts ** power
    p = w / w.sum() * len(w)  # mean 1
    prob = np.ones(len(w), np.float64)
    alias = np.arange(len(w), dtype=np.int32)
    small = [i for i, x in enumerate(p) if x < 1.0]
    large = [i for i, x in enumerate(p) if x >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def subsample_keep_prob(counts: np.ndarray, sample: float) -> np.ndarray:
    """P(keep) per word (reference to_sample, word2vec.h:621-630):
    keep iff uniform > 1 - sqrt(sample/freq), i.e.
    P(keep) = min(1, sqrt(sample/freq)).  sample < 0 disables."""
    counts = np.asarray(counts, np.float64)
    if sample < 0:
        return np.ones(len(counts), np.float32)
    freq = counts / max(counts.sum(), 1.0)
    with np.errstate(divide="ignore"):
        keep = np.sqrt(sample / np.where(freq > 0, freq, 1.0))
    return np.minimum(keep, 1.0).astype(np.float32)


def alias_draws(generator: torch.Generator, V: int,
                shape: Tuple[int, ...],
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw alias draws ``(j, u)``: ``j`` int64 buckets in ``[0, V)`` and
    ``u`` float32 uniforms in ``[0, 1)``, both of ``shape``, on the
    generator's device unless ``device`` says otherwise."""
    device = generator.device if device is None else device
    j = torch.randint(0, int(V), tuple(shape), generator=generator,
                      device=device)
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return j, u


def sample_alias_from_draws(j: torch.Tensor, u: torch.Tensor,
                            prob: torch.Tensor,
                            alias: torch.Tensor) -> torch.Tensor:
    """Resolve draws ``(j, u)`` into int64 vocab indices, as
    ``sample_alias`` does: bucket ``j`` when ``u < prob[j]``, else
    ``alias[j]``.  The shared-negative renderings draw their one pool
    through it."""
    j = j.long()
    return torch.where(u < prob[j], j, alias[j].long())


def sample_alias_slots_from_draws(j: torch.Tensor, u: torch.Tensor,
                                  prob: torch.Tensor, alias: torch.Tensor,
                                  slot_of_vocab: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve draws ``(j, u)`` into ``(negs, neg_slots)``: vocab indices
    from the alias tables and their table slots, with
    ``neg_slots == slot_of_vocab[negs]``.  ``negs`` is int64;
    ``neg_slots`` has ``slot_of_vocab``'s type."""
    negs = sample_alias_from_draws(j, u, prob, alias)
    return negs, slot_of_vocab[negs]


def sample_alias(generator: torch.Generator, prob: torch.Tensor,
                 alias: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Categorical draws of ``shape`` from the alias tables, on their
    device: :func:`alias_draws` from ``generator``, resolved by
    :func:`sample_alias_from_draws` (int64 vocab indices).  JAX draws
    ``(j, u)`` from a ``jax.random`` key instead; the same ``(j, u)``
    resolve to the same indices in both packages."""
    j, u = alias_draws(generator, prob.shape[0], shape, device=prob.device)
    return sample_alias_from_draws(j, u, prob, alias)


def sample_alias_slots(generator: torch.Generator, prob: torch.Tensor,
                       alias: torch.Tensor, slot_of_vocab: torch.Tensor,
                       shape: Tuple[int, ...]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_alias` fused with the vocab -> slot map:
    ``(negs, neg_slots)`` with ``neg_slots == slot_of_vocab[negs]``, from
    the same draws :func:`sample_alias` takes from the generator."""
    j, u = alias_draws(generator, prob.shape[0], shape, device=prob.device)
    return sample_alias_slots_from_draws(j, u, prob, alias, slot_of_vocab)
