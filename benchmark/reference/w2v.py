"""Plain float32 PyTorch reference of word2vec training steps: CBOW or
skip-gram with negative sampling, each gradient family mean-normalized
per row, and the server's AdaGrad on both embedding fields and both
accumulators (reference ``word2vec.h:550-615`` and ``:167-191``).

It imports nothing of the program.  It is handed what the benchmark
made (the initial rows, the corpus' counts, the batches the program's
input stage rendered, which ``reference/batches.py`` checks against the
corpus on their own) and the seed of the program's negative draws, and
works out again what the program derives from them: the unigram^0.75
alias tables, the draws ``(j, u)`` (a device ``torch.Generator`` seeded
``seed ^ 0x5EED``, ``randint`` then ``rand`` of the step's draw shape,
the program's documented draw), the negatives, the logits, the
gradients, the per-row means and the updates.

One step, per center (CBOW) or per (center, context) pair (skip-gram),
with ``t`` the center then ``negative`` negatives, a negative equal to
its center skipped:

    x      = sum of the context rows of v       (CBOW)   v[context] (sg)
    f_k    = x . h[t_k]
    g_k    = (label_k - sigmoid_clipped(f_k)) * alpha,  label 1 for k = 0
    dh[t_k] += g_k x ;  dx = sum_k g_k h[t_k]
    dv[c]  += dx for each context c (CBOW)      dv[context] += dx (sg)
    loss   = sum 1e4 g^2 / round(count of live (pair, target))

then each field's rows get the mean of their contributions, and
``accum += g^2; param += lr * g / sqrt(accum + 1e-6)``.  The dot products
are ``torch.bmm`` of float32 tensors: TF32 off unless ``tf32`` (the
control)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_EXP = 6.0
FUDGE = 1e-6
DRAW_SEED_XOR = 0x5EED


def sigmoid_clipped(f: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(f.clamp(-MAX_EXP, MAX_EXP))
    s = torch.where(f > MAX_EXP, 1.0, s)
    return torch.where(f < -MAX_EXP, 0.0, s)


def unigram_alias(counts: np.ndarray, power: float = 0.75
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables of counts^power: accept bucket j when u <
    prob[j], else take alias[j].  Built small/large stack by stack, in the
    order the program's sampler builds them, since a draw resolves to
    the same word only through the same table."""
    w = np.asarray(counts, np.float64) ** power
    p = w / w.sum() * len(w)
    prob = np.ones(len(w), np.float64)
    alias = np.arange(len(w), dtype=np.int64)
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


class Draws:
    """The program's negative draws, step after step: ``(j, u)`` of the
    step's draw shape from a generator seeded as the program's."""

    def __init__(self, model_seed: int, V: int, shape: Tuple[int, ...],
                 device):
        self.V, self.shape, self.device = int(V), tuple(shape), device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(model_seed) ^ DRAW_SEED_XOR)

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        j = torch.randint(0, self.V, self.shape, generator=self.gen,
                          device=self.device)
        u = torch.rand(self.shape, generator=self.gen, device=self.device)
        return j, u

    def skip(self, n: int) -> None:
        for _ in range(n):
            self.next()


def draw_shape(cfg: dict, B: int) -> Tuple[int, ...]:
    K, W = int(cfg["negative"]), int(cfg["window"])
    return (B, 2 * W, K) if int(cfg["sg"]) else (B, K)


class Model:
    """The configuration's step arithmetic over vocabulary indices."""

    def __init__(self, cfg: dict, counts: np.ndarray, device,
                 tf32: bool = False):
        self.sg = bool(int(cfg["sg"]))
        self.K, self.W = int(cfg["negative"]), int(cfg["window"])
        self.d = int(cfg["len_vec"])
        self.alpha = float(cfg["learning_rate"])
        self.lr = float(cfg["server_learning_rate"])
        self.device, self.tf32 = device, tf32
        prob, alias = unigram_alias(counts)
        self.prob = torch.as_tensor(prob, device=device)
        self.alias = torch.as_tensor(alias, device=device)

    def negatives(self, j: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.where(u < self.prob[j], j, self.alias[j])

    def pairs(self, centers, contexts, mask, negs):
        """``(x_rows, x_mask, t, t_valid)``: the v rows each example's
        input sums (``(E, C)`` vocabulary indices and mask, C = 2W for
        CBOW, 1 for skip-gram's pairs) and its targets ``(E, K + 1)``."""
        if self.sg:
            B, W2 = contexts.shape
            x_rows = contexts.reshape(-1, 1)
            x_mask = mask.reshape(-1, 1)
            c = centers[:, None].expand(B, W2).reshape(-1)
            negs = negs.reshape(-1, self.K)
            live = x_mask[:, 0]
        else:
            x_rows, x_mask, c = contexts, mask, centers
            live = mask.any(dim=1)
        t = torch.cat([c[:, None], negs], dim=1)
        t_valid = torch.cat([torch.ones_like(c[:, None], dtype=torch.bool),
                             negs != c[:, None]], dim=1) & live[:, None]
        return x_rows, x_mask, t, t_valid

    def touched(self, centers, contexts, mask, negs) -> torch.Tensor:
        x_rows, x_mask, t, t_valid = self.pairs(centers, contexts, mask,
                                                negs)
        return torch.cat([x_rows[x_mask], t[t_valid]]).unique()

    def grads(self, H, Vt, loc, centers, contexts, mask, negs, keep=None):
        """Mean gradients of one step on local tables ``H``, ``Vt`` (rows
        at ``loc(vocab index)``): ``(gh, gv, err_sum, err_cnt)``.
        ``keep`` (a bool per center) leaves the other centers out."""
        if keep is not None:
            mask = mask & keep[:, None]
        x_rows, x_mask, t, t_valid = self.pairs(centers, contexts, mask,
                                                negs)
        xl, tl = loc(x_rows), loc(t)
        xin = (Vt[xl] * x_mask[..., None]).sum(dim=1)           # (E, d)
        ht = H[tl]                                              # (E,K+1,d)
        with _tf32(self.tf32):
            f = torch.bmm(ht, xin[:, :, None])[..., 0]          # (E, K+1)
        label = torch.zeros_like(f)
        label[:, 0] = 1.0
        g = torch.where(t_valid, (label - sigmoid_clipped(f)) * self.alpha,
                        0.0)
        with _tf32(self.tf32):
            dx = torch.bmm(g[:, None, :], ht)[:, 0]             # (E, d)
        dh = g[..., None] * xin[:, None, :]
        gh = _row_mean(H.shape, tl[t_valid], dh[t_valid])
        dv = dx[:, None, :].expand(-1, x_rows.shape[1], -1)
        gv = _row_mean(Vt.shape, xl[x_mask], dv[x_mask])
        return gh, gv, torch.sum(1e4 * g * g), t_valid.sum()

    def adagrad(self, param, accum, g) -> None:
        accum += g * g
        param += self.lr * g / torch.sqrt(accum + FUDGE)


def _row_mean(shape, rows, contrib) -> torch.Tensor:
    acc = torch.zeros(shape, dtype=torch.float32, device=contrib.device)
    acc.index_add_(0, rows, contrib)
    cnt = torch.zeros(shape[0], dtype=torch.float32, device=contrib.device)
    cnt.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float32))
    return acc / cnt.clamp(min=1.0)[:, None]


class _tf32:
    """TF32 for float32 products on the card while the block runs."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def run_steps(model: Model, batches: Sequence[tuple], negs: List,
              init_rows, keep: Optional[torch.Tensor] = None,
              calls: Optional[Sequence[int]] = None) -> dict:
    """The steps over ``batches`` (``(centers, contexts, mask)`` tensors)
    with their resolved negatives, from the initial rows
    ``init_rows(field, sorted vocab indices)``.  Returns the rows touched
    (``rows``, sorted vocabulary indices), the loss of each ``train``
    call (``calls``: the steps of each, in order; default one a step) as
    the program reports it, the sum of the calls' error over the rounded
    sum of their counts, the accumulators after the first step and the
    fields before the first and after the last, on those rows."""
    touched = torch.cat([model.touched(*b, n) for b, n in zip(batches, negs)
                         ]).unique()

    def loc(idx):
        # a dead target or padding input reads some row; its g is 0
        return torch.searchsorted(touched, idx).clamp(max=len(touched) - 1)
    H0, V0 = init_rows("h", touched), init_rows("v", touched)
    H, Vt = H0.clone(), V0.clone()
    Ha, Va = torch.zeros_like(H), torch.zeros_like(Vt)
    err, acc1 = [], None
    for i, (b, n) in enumerate(zip(batches, negs)):
        gh, gv, es, ec = model.grads(H, Vt, loc, *b, n, keep=keep)
        model.adagrad(H, Ha, gh)
        model.adagrad(Vt, Va, gv)
        err.append((float(es), float(ec)))
        if i == 0:
            acc1 = {"h": Ha.clone(), "v": Va.clone()}
    losses, at = [], 0
    for n in (calls if calls is not None else [1] * len(err)):
        es = sum(e for e, _ in err[at:at + n])
        ec = sum(c for _, c in err[at:at + n])
        losses.append(es / max(int(round(ec)), 1))
        at += n
    return {"rows": touched, "losses": losses, "acc1": acc1,
            "init": {"h": H0, "v": V0}, "final": {"h": H, "v": Vt}}
