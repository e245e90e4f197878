"""The host's own work a step: the profiled window's wall time less the
consumer thread's ``input_wait`` and ``bound_wait`` spans in it, in ms a
step.  Beside the device's busy ms a step it tells whether a cell is
paced by its host."""

from benchmark.metrics._spans import context, merge, overlap


def read(ctx):
    got = context(ctx)
    if got is None:
        return None
    w, spans = got
    waits = merge(spans["input_wait"] + spans["bound_wait"])
    busy = (w.t1 - w.t0) - overlap([(w.t0, w.t1)], waits)
    return busy / 1e3 / ctx["steps"]
