"""Context parallelism for long sequences: ring attention and Ulysses
(counterpart of ``swiftmpi_tpu/parallel/ring_attention.py``).

The ``seq`` axis of a :class:`~swiftmpi_tpu_torch.cluster.mesh.Mesh` runs
as n logical ranks on one device, rank ``r`` holding the ``r``-th block of
the sequence:

* :func:`ring_attention` — each rank folds its query block against the
  K/V blocks as they rotate around the ring (:func:`ring_permute`, one
  hop a step), into an online-softmax accumulator with float32
  statistics.  Under ``causal`` a rank skips the blocks from its future
  (``src > my``), as JAX's ``lax.cond`` does.
* :func:`ulysses_attention` — an all-to-all turns the sequence-sharded
  q, k, v into head-sharded ones, each rank attends over the whole
  sequence for its heads, and an all-to-all turns the output back.  The
  all-to-alls are :func:`rank_all_to_all`, so B5 on the card, forward
  and backward.  Needs ``heads % n == 0``.

:func:`full_attention` spells out JAX's math rather than calling
``scaled_dot_product_attention``, whose backends sum in another order and
precision: float32 scores, the ``-1e30`` causal mask, a float32 softmax,
the probabilities cast to ``v``'s dtype before the PV product.  A score
product takes float32 inputs (a bfloat16 product is exact in float32, so
this is JAX's bf16 product with float32 accumulation); the PV product of
:func:`full_attention` runs in ``v``'s dtype, whose float32 accumulation
and one final rounding are JAX's ``preferred_element_type`` and cast.
Layout: ``(batch, seq, heads, head_dim)``.
"""

from __future__ import annotations

import math

import torch

from swiftmpi_tpu_torch.parallel.collectives import (rank_all_to_all,
                                                     ring_permute)

SEQ_AXIS = "seq"
_NEG = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``einsum("bqhd,bkhd->bhqk")`` in float32, times ``scale``."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _causal(sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril()


def full_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Single-device softmax attention, ``(B, S, H, D)``: float32 scores
    and softmax whatever the input dtype, the probabilities cast back to
    ``v``'s dtype for the PV product."""
    s = _scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    if causal:
        s = torch.where(_causal(s.shape[-2], s.shape[-1], s.device), s,
                        _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(v.dtype)


def _fold_block(q, k, v, m, l, o, scale: float, mask):
    """One online-softmax accumulation step (the flash-attention
    recurrence).  q: (B, Sq, H, D); k, v: (B, Sk, H, D); m, l: (B, H, Sq)
    float32; o: (B, Sq, H, D) float32; mask: (Sq, Sk) bool or None.  The
    running statistics stay float32 across the ring's steps."""
    s = _scores(q, k, scale)
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])              # (B, H, Sq, Sk) f32
    corr = torch.exp(m - m_new)                      # (B, H, Sq) f32
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _seq_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, S, ...)`` -> ``(n, B, S/n, ...)``: rank r's sequence block."""
    B, S = x.shape[:2]
    if S % n:
        raise ValueError(f"sequence {S} does not split over {n} ranks")
    return x.reshape(B, n, S // n, *x.shape[2:]).movedim(1, 0)


def _from_seq_blocks(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_seq_blocks`."""
    n, B, s = x.shape[:3]
    return x.movedim(0, 1).reshape(B, n * s, *x.shape[3:])


def ring_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                   causal: bool = False) -> torch.Tensor:
    """Attention with q, k, v sequence-sharded over ``axis``: global
    ``(B, S, H, D)`` in and out; each rank folds its S/n query block
    against every K/V block as the blocks rotate around the ring."""
    n = int(mesh.shape[axis])
    scale = 1.0 / math.sqrt(q.shape[-1])
    q_l = _seq_blocks(q, n)
    k_cur, v_cur = _seq_blocks(k, n), _seq_blocks(v, n)
    B, Sq, H, _ = q_l.shape[1:]
    diag = _causal(Sq, Sq, q.device) if causal else None
    stats = []
    for my in range(n):
        # step 0: my own (diagonal) block, with the within-block mask
        m0 = torch.full((B, H, Sq), _NEG, dtype=torch.float32,
                        device=q.device)
        l0 = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
        o0 = torch.zeros(q_l.shape[1:], dtype=torch.float32,
                         device=q.device)
        stats.append(_fold_block(q_l[my], k_cur[my], v_cur[my], m0, l0, o0,
                                 scale, diag))
    for step in range(1, n):
        # permute first, then fold: the last rotation is never wasted
        k_cur, v_cur = ring_permute(k_cur), ring_permute(v_cur)
        for my in range(n):
            src = (my - step) % n           # whose block rank my now holds
            if causal and src > my:
                continue                    # entirely in the future
            stats[my] = _fold_block(q_l[my], k_cur[my], v_cur[my],
                                    *stats[my], scale, None)
    out = []
    for m, l, o in stats:
        l = torch.clamp(l, min=1e-20)
        out.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return _from_seq_blocks(torch.stack(out))


def ulysses_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                      causal: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses pattern):
    sequence-sharded -> head-sharded, full-sequence attention for each
    rank's heads, head-sharded -> sequence-sharded.  Needs ``H % n ==
    0``."""
    n = int(mesh.shape[axis])
    H = q.shape[2]
    if H % n:
        raise ValueError(f"heads={H} must be divisible by axis size {n}")

    def fwd(x):
        # (n, B, S/n, H, D) -> (n, B, S, H/n, D)
        return rank_all_to_all(_seq_blocks(x, n), split_axis=2,
                               concat_axis=1)

    qh, kh, vh = fwd(q), fwd(k), fwd(v)
    _, B, S, Hn, D = qh.shape
    # every rank's heads at once: the rank dim folds into the batch
    o = full_attention(*(t.reshape(n * B, S, Hn, D) for t in (qh, kh, vh)),
                       causal=causal)
    o = rank_all_to_all(o.reshape(n, B, S, Hn, D), split_axis=1,
                        concat_axis=2)
    return _from_seq_blocks(o)
