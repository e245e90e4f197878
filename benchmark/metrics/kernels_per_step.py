"""Device operations (kernels and copies; a graph replay's own kernels
each) in the profiled window, a step."""


def read(ctx):
    w = ctx.get("window")
    return None if w is None else w.count_ops() / ctx["steps"]
