"""The port's train-loop spans in the profiled window (``ctx["window"]``,
a ``benchmark.trace.Window``): their intervals on the consumer thread,
the thread of the ``dispatch`` spans, each span's self time (its
intervals less the loop's spans nested in them) and the device's idle
time inside a set of intervals.  Times are the trace's microseconds;
the readers give ms a step of the window."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

from benchmark.trace import _merge as merge

#: the spans of ``Word2Vec.train``'s loop: ``bound_wait`` nests in
#: ``dispatch``, the rest follow one another on the consumer thread
LOOP = ("input_wait", "dispatch", "bound_wait", "step_hooks", "epoch_end")
ANNOTATION = "user_annotation"

Intervals = List[Tuple[float, float]]


def subtract(xs: Intervals, ys: Intervals) -> Intervals:
    """Merged ``xs`` less merged ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cur:
                out.append((cur, ys[k][0]))
            cur = max(cur, ys[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def overlap(xs: Intervals, ys: Intervals) -> float:
    """The length of the intersection of two merged lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def consumer(w) -> Optional[int]:
    """The thread id that holds the most ``dispatch`` spans, or None where
    the window holds none (a program without the loop's spans)."""
    tids = Counter(e.get("tid") for e in w.host
                   if e.get("cat") == ANNOTATION and e["name"] == "dispatch")
    return tids.most_common(1)[0][0] if tids else None


def loop_spans(w, tid) -> Dict[str, Intervals]:
    """Each loop span's intervals on ``tid``, as the trace has them."""
    out: Dict[str, Intervals] = {n: [] for n in LOOP}
    for e in w.host:
        if e.get("cat") == ANNOTATION and e.get("tid") == tid \
                and e["name"] in out:
            out[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return out


def self_time(spans: Dict[str, Intervals], name: str) -> Intervals:
    """``name``'s intervals less the other loop spans nested in one of
    them (the guide's self time: a span's duration less its children's)."""
    own = merge(spans[name])
    inner = [(a, b) for other in LOOP if other != name
             for a, b in spans[other]
             if any(x <= a and b <= y for x, y in own)]
    return subtract(own, merge(inner))


def idle(w) -> Intervals:
    """The window's idle intervals: ``[t0, t1]`` less its busy ones."""
    return subtract([(w.t0, w.t1)], w.busy)


def context(ctx):
    """``(window, the loop's spans on the consumer thread)``, or None
    where there is no device window or no loop span in it."""
    w = ctx.get("window")
    if w is None:
        return None
    tid = consumer(w)
    if tid is None:
        return None
    return w, loop_spans(w, tid)


def idle_ms_per_step(ctx, name: str) -> Optional[float]:
    """The device's idle ms a step inside ``name``'s self time."""
    got = context(ctx)
    if got is None:
        return None
    w, spans = got
    return overlap(idle(w), self_time(spans, name)) / 1e3 / ctx["steps"]
