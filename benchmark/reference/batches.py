"""The input stage checked on its own: every row of the batches the
program's batcher rendered is a real window of the benchmark's corpus.

A row is a center and its ``n`` context words, the mask a prefix of
``n`` ones and the padding zero.  It is found when some sentence holds,
at a position ``p``, the center with its ``k`` left and ``n - k`` right
neighbours in order, where ``k = min(h, p)`` and ``n - k = min(h, L - 1
- p)`` for one half-window ``h`` in ``1..window``: the reference's
shrunken window (``word2vec.h:555``) cut at the sentence's ends.  Each
row is looked for at the next positions of the sentence the row before
it was found in, else anywhere in the corpus, through the row's rarest
word (the highest vocabulary index, since the vocabulary is in count
order).  A short window can sit in several sentences, so the walk's
order is not held.  Which centers the batcher's subsampling kept, and
the shuffled sentence order, come from its own generator and are not
checked."""

from __future__ import annotations

from typing import Iterable

import numpy as np


def _row_ok(row_ctx: np.ndarray, n: int, W: int, mask: np.ndarray) -> bool:
    return (1 <= n <= 2 * W and bool(mask[:n].all())
            and not mask[n:].any() and not row_ctx[n:].any())


def _matches(tokens, starts, ends, seq_of_k, p, n, W):
    """Which candidate positions ``p`` (global, in sentences ``[starts,
    ends)``) hold the row: for some ``k``, the window tokens equal
    ``seq_of_k[k]`` and ``k`` fits a half-window."""
    ok = np.zeros(len(p), bool)
    left, right = p - starts, ends - 1 - p
    for k in range(n + 1):
        r = n - k
        fit = (left >= k) & (right >= r)
        hs = np.arange(1, W + 1)
        half_ok = ((np.minimum(hs[None, :], left[:, None]) == k)
                   & (np.minimum(hs[None, :], right[:, None]) == r)
                   ).any(axis=1)
        cand = np.flatnonzero(fit & half_ok & ~ok)
        if cand.size == 0:
            continue
        win = tokens[(p[cand] - k)[:, None] + np.arange(n + 1)[None, :]]
        ok[cand[(win == seq_of_k[k][None, :]).all(axis=1)]] = True
    return ok


def _at(sent: list, p: int, c: int, ctx: list, W: int) -> bool:
    """Whether position ``p`` of ``sent`` (a token list) holds the row."""
    n = len(ctx)
    left, right = p, len(sent) - 1 - p
    if sent[p] != c:
        return False
    for h in range(1, W + 1):
        k, r = min(h, left), min(h, right)
        if k + r == n and sent[p - k:p] + sent[p + 1:p + 1 + r] == ctx:
            return True
    return False


def unlocated_rows(batches: Iterable[tuple], tokens: np.ndarray,
                   offsets: np.ndarray, window: int) -> int:
    """How many rows of ``batches`` (``(centers, contexts, mask)`` host
    arrays, in the order the batcher rendered them from an epoch's
    start) are not a window of the corpus."""
    W = int(window)
    tokens = np.asarray(tokens)
    bad = 0
    cur = None                      # (sentence's token list, position)
    for centers, contexts, mask in batches:
        for c, ctx, m in zip(centers.tolist(), contexts, mask):
            n = int(m.sum())
            if not _row_ok(ctx, n, W, m):
                bad += 1
                continue
            ctx = ctx[:n].tolist()
            if cur is not None:
                sent, pos = cur
                nxt = next((p for p in range(pos + 1, len(sent))
                            if _at(sent, p, c, ctx, W)), None)
                if nxt is not None:
                    cur = (sent, nxt)
                    continue
            seq = [np.array(ctx[:k] + [c] + ctx[k:], tokens.dtype)
                   for k in range(n + 1)]
            rare = max(c, *ctx)
            occ = np.flatnonzero(tokens == rare)
            # where the row's window starts, for each place the rare word
            # can take in it, and so where its center is
            found = None
            for k in range(n + 1):
                for slot, tok in enumerate(seq[k].tolist()):
                    if tok != rare:
                        continue
                    p = occ - slot + k
                    p = p[(p >= 0) & (p < len(tokens))]
                    sid = np.searchsorted(offsets, p, side="right") - 1
                    ok = _matches(tokens, offsets[sid], offsets[sid + 1],
                                  seq, p, n, W)
                    hit = np.flatnonzero(ok)
                    if hit.size:
                        found = (int(sid[hit[0]]), int(p[hit[0]]))
                        break
                if found:
                    break
            if found is None:
                bad += 1
                continue
            s, pos = found
            lo, hi = int(offsets[s]), int(offsets[s + 1])
            cur = (tokens[lo:hi].tolist(), pos - lo)
    return bad
