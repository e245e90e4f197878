"""The numbers that decide ``correct``: the program's checked steps against
the reference's, by the worst leaf (a leaf is an embedding field, h or
v), and the input stage and the window's word count on their own.

* ``loss_gap``: each checked ``train`` call's loss, ``|program -
  reference| / reference``, the largest of the calls;
* ``grad_norm_gap``: the norm of the first step's gradient as the
  optimizer got it (the square root of the program's accumulators after
  one step, which started at zero), against the reference's;
* ``update_norm_gap``: the norm of each field's change over all the
  checked steps;
* each gap is ``|norm_p - norm_r|`` over the larger of the reference's
  norm of that leaf and of the median leaf; a leaf whose reference
  gradient is under a thousandth of the median leaf's is left out;
* ``rows_outside_vocab``: rows the program's steps touched that hold no
  vocabulary word;
* ``unlocated_rows``: rows of the checked batches that are no window of
  the corpus (``reference/batches.py``);
* ``window_words_gap``: the words the window's ``train`` call reports
  against the words the feed handed it."""

from __future__ import annotations

import statistics
from typing import Dict

import torch

LEAVES = ("h", "v")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               kept) -> float:
    med = statistics.median(ref[f] for f in kept)
    return max(abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30)
               for f in kept)


def numbers(prog: dict, refr: dict, init_rows) -> Dict[str, float]:
    """``prog``: the program's ``losses``, ``acc1`` and ``final`` (field ->
    ``(vocabulary indices, rows)``) and ``stray``; ``refr``:
    ``reference.w2v.run_steps``'s result; ``init_rows(field, idx)`` the
    benchmark's initial rows."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], refr["losses"])]
    if len(prog["losses"]) != len(refr["losses"]):
        losses = [float("inf")]
    rows = refr["rows"].cpu()
    p_grad = {f: (prog["acc1"][f][0], torch.sqrt(prog["acc1"][f][1]))
              for f in LEAVES}
    r_grad = {f: (rows, torch.sqrt(refr["acc1"][f]).cpu()) for f in LEAVES}
    p_upd = {f: (idx, rf - init_rows(f, idx).to(rf.device).cpu())
             for f, (idx, rf) in prog["final"].items()}
    r_upd = {f: (rows, (refr["final"][f] - refr["init"][f]).cpu())
             for f in LEAVES}
    ref_grad = {f: _norm(r_grad[f][1]) for f in LEAVES}
    med = statistics.median(ref_grad.values())
    kept = [f for f in LEAVES if ref_grad[f] >= 1e-3 * med]
    norms = {k: {f: _norm(side[f][1]) for f in LEAVES}
             for k, side in (("pg", p_grad), ("pu", p_upd), ("ru", r_upd))}
    return {"loss_gap": max(losses),
            "grad_norm_gap": _leaf_gaps(norms["pg"], ref_grad, kept),
            "update_norm_gap": _leaf_gaps(norms["pu"], norms["ru"], kept),
            "rows_outside_vocab": float(prog["stray"])}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number with a limit is at or under it, and none is missing
    or not a number."""
    for k, lim in limits.items():
        v = nums.get(k)
        if v is None or v != v or v > lim:
            return False
    return True
