"""The device's idle time inside the self time of the train loop's
``input_wait`` spans (the consumer's wait for its next batch) on the
consumer thread, in ms a step of the profiled window."""

from benchmark.metrics._spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "input_wait")
