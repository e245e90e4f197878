"""One word2vec step's model FLOPs and its B1 and B2 launches' bytes,
from the batch, its negatives and the table's capacity.

The model FLOPs are the arithmetic of the logits, their gradients to h
and to the input, and the CBOW context sum, counted over live examples:
per live (example, target) ``2d`` for the logit, ``d`` for the h
gradient and ``2d`` for the input's; per live context word ``d`` for the
sum (CBOW).  The optimizer is not counted.

The launches are those of the ``xla`` transfer's gather rendering: one
B2 a family (h at the targets, v at the inputs) and, for a family whose
push is sparse (fewer rows than half the capacity, the transfer's
crossover), one row-indexed B1 over its rows, of which its distinct
live slots are kept."""

from __future__ import annotations

import torch

from benchmark.roofline import adagrad, gather


def _structure(sg: bool, centers, contexts, mask, negs):
    K = negs.shape[-1]
    if sg:
        B, W2 = contexts.shape
        live = mask.reshape(-1)
        c = centers[:, None].expand(B, W2).reshape(-1)
        negs = negs.reshape(-1, K)
        inputs, in_mask = contexts.reshape(-1), live
    else:
        live = mask.any(dim=1)
        c = centers
        inputs, in_mask = contexts.reshape(-1), mask.reshape(-1)
    t = torch.cat([c[:, None], negs], dim=1)
    t_valid = torch.cat([torch.ones_like(c[:, None], dtype=torch.bool),
                         negs != c[:, None]], dim=1) & live[:, None]
    return t, t_valid, inputs, in_mask


def flops(sg: bool, d: int, centers, contexts, mask, negs) -> int:
    t, t_valid, _, in_mask = _structure(sg, centers, contexts, mask, negs)
    live_targets = int(t_valid.sum())
    return live_targets * 5 * d + (0 if sg else int(in_mask.sum()) * d)


def launch_bytes(sg: bool, d: int, cap: int, centers, contexts, mask,
                 negs) -> dict:
    """``{"gather": bytes, "adagrad": bytes}`` of the step's sparse-push
    families (a dense family's B1 runs over the whole table, L2-resident
    at small capacities, and is not counted here)."""
    t, t_valid, inputs, in_mask = _structure(sg, centers, contexts, mask,
                                             negs)
    out = {"gather": 0, "adagrad": 0}
    for rows, live in ((t.reshape(-1), t_valid.reshape(-1)),
                       (inputs, in_mask)):
        n = rows.numel()
        uniq = int(rows[live].unique().numel())
        out["gather"] += gather.bytes_moved(n, uniq, d)
        if n < cap // 2:
            out["adagrad"] += adagrad.bytes_moved_rows(n, uniq, d)
    return out
