"""Expert parallelism: top-k routed mixture-of-experts over a rank axis
(counterpart of ``swiftmpi_tpu/parallel/moe.py``).

GShard/Switch style, as in the JAX package: a router gives each token
its top-k experts with renormalized gates and the load-balance auxiliary
loss; each expert takes at most ``capacity`` tokens of a rank (first come
first served; a dropped token's combine weight is zero, so the residual
carries it); a one-hot ``(T, E, C)`` dispatch tensor fills per-expert
buffers, an all-to-all over the ``expert`` axis brings every rank's
tokens for its experts to the rank that owns them, the expert FFN runs,
and the reverse all-to-all and the gates' combine bring the outputs back.

The ``expert`` axis runs as n logical ranks on one device: rank ``r``
holds tokens ``r * T/n ...`` and experts ``r * E/n ...``, and every
per-rank tensor is stacked over the ranks (leading dim n), so the rank
dim is a batch dim of each product.  Both all-to-alls are
:func:`~swiftmpi_tpu_torch.parallel.collectives.rank_all_to_all`, so B5
on the card, forward and backward; the aux densities are ``pmean``-ed
over the ranks before their product, which makes the distributed aux
exactly the global one.  In a run of several processes (the
transformer trainer's data axis, each process with its own rows of the
global batch) the densities are also averaged over the processes, forward
and backward (``collectives.process_pmean``, B5's cross-process form on
the card), so the aux term is the global batch's, as JAX's is over its
global arrays.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from swiftmpi_tpu_torch.device import DeviceLike, resolve_device
from swiftmpi_tpu_torch.parallel.collectives import (process_pmean,
                                                     rank_all_to_all,
                                                     rank_pmean)

EXPERT_AXIS = "expert"


class MoEParams(NamedTuple):
    """Router and stacked expert FFN weights; ``w_in``/``w_out``'s leading
    dim is E, the global expert count (sharded over the ``expert`` axis:
    rank r owns experts ``r * E/n`` onwards)."""
    router: torch.Tensor   # (d_model, E)
    w_in: torch.Tensor     # (E, d_model, d_ff)
    w_out: torch.Tensor    # (E, d_ff, d_model)


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32,
                    device: DeviceLike = None) -> MoEParams:
    """Normal weights scaled by ``1/sqrt(fan_in)``, drawn on the CPU from
    ``gen`` (so a card and the CPU get the same values), then moved to
    ``device`` (the current CUDA card unless ``"cpu"``)."""
    device = resolve_device(device)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    router = normal(d_model, n_experts) * s_in
    w_in = normal(n_experts, d_model, d_ff) * s_in
    w_out = normal(n_experts, d_ff, d_model) * s_out
    return MoEParams(*(t.to(device=device, dtype=dtype)
                       for t in (router, w_in, w_out)))


def _top_k_gating(logits: torch.Tensor, k: int):
    """(..., T, E) logits -> gates (..., T, E) with k nonzeros a row
    (renormalized), and the two per-expert densities (..., E) whose
    product is GShard's load-balance aux loss, ``E * sum_e density_e *
    density_proxy_e``.  The densities are token means, so ranks
    ``pmean`` them before the product."""
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)           # (..., T, k)
    gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = (gates > 0).to(probs.dtype).mean(dim=-2)          # (..., E)
    density_proxy = probs.mean(dim=-2)                          # (..., E)
    return gates, density, density_proxy


def _dispatch_mask(gates: torch.Tensor, capacity: int):
    """(..., T, E) gates -> one-hot (..., T, E, C) dispatch tensor,
    positions assigned first come first served per expert; tokens beyond
    capacity get an all-zero row (dropped).  Also the gate-weighted
    combine."""
    assigned = gates > 0                                    # (..., T, E)
    pos = torch.cumsum(assigned.to(torch.int32), dim=-2) - 1
    keep = assigned & (pos < capacity)
    # position ``capacity`` is one past the buffer: its one-hot row is
    # all zero, as jax.nn.one_hot gives for an index out of range
    idx = torch.where(keep, pos, capacity).long()
    onehot = F.one_hot(idx, capacity + 1)[..., :capacity].to(gates.dtype)
    dispatch = onehot * keep[..., None].to(gates.dtype)
    combine = dispatch * gates[..., None]
    return dispatch, combine


def moe_ffn(params: MoEParams, x: torch.Tensor, mesh, *,
            axis: str = EXPERT_AXIS, k: int = 2,
            capacity_factor: float = 2.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN over ``axis``: ``x`` the global ``(T,
    d_model)`` tokens, rank r taking rows ``r * T/n`` onwards (dp and ep
    share the axis, the standard layout).  Returns ``(y, aux_loss)``,
    ``y`` like ``x``."""
    n = int(mesh.shape[axis])
    E = params.router.shape[1]
    if E % n:
        raise ValueError(f"experts={E} must divide over axis size {n}")
    T, d = x.shape
    if T % n:
        raise ValueError(f"tokens={T} must divide over axis size {n}")
    t_local = T // n
    capacity = max(1, int(math.ceil(t_local * k / E * capacity_factor)))

    xl = x.reshape(n, t_local, d)                               # (n, t, d)
    gates, dens, proxy = _top_k_gating(xl @ params.router, k)   # (n, t, E)
    dens, proxy = process_pmean(rank_pmean(dens), rank_pmean(proxy))
    aux = (dens * proxy).sum() * E
    dispatch, combine = _dispatch_mask(gates, capacity)         # (n,t,E,C)
    # per-expert buffers, then route ranks -> owners over the axis
    buf = torch.einsum("rtec,rtd->recd", dispatch, xl)          # (n,E,C,d)
    buf = rank_all_to_all(buf, split_axis=0, concat_axis=1)
    # now (n, E/n, n*C, d): every rank's tokens for my experts
    w_in = params.w_in.reshape(n, E // n, *params.w_in.shape[1:])
    w_out = params.w_out.reshape(n, E // n, *params.w_out.shape[1:])
    h = torch.relu(torch.einsum("recd,redf->recf", buf, w_in))
    out = torch.einsum("recf,refd->recd", h, w_out)
    out = rank_all_to_all(out, split_axis=1, concat_axis=0)      # (n,E,C,d)
    y = torch.einsum("rtec,recd->rtd", combine, out)             # (n, t, d)
    return y.reshape(T, d), aux


def moe_ffn_reference(params: MoEParams, x: torch.Tensor, *, k: int = 2):
    """Dense single-device golden: every token through its top-k experts,
    no capacity drops.  For tests (a high capacity factor must match)."""
    gates, dens, proxy = _top_k_gating(x @ params.router, k)
    dens, proxy = process_pmean(dens, proxy)
    aux = (dens * proxy).sum() * params.router.shape[1]
    h = torch.relu(torch.einsum("td,edf->tef", x, params.w_in))
    per_e = torch.einsum("tef,efd->ted", h, params.w_out)
    return torch.einsum("te,ted->td", gates, per_e), aux
