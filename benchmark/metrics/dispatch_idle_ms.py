"""The device's idle time inside the self time of the train loop's
``dispatch`` spans (staging, the group's graph replay or steps and the
loss accumulators, less the ``bound_wait`` nested in them) on the
consumer thread, in ms a step of the profiled window."""

from benchmark.metrics._spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "dispatch")
