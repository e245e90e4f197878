"""The device's idle share of the profiled window: one minus the union of
its operations' intervals over the window's wall time."""


def read(ctx):
    w = ctx.get("window")
    return None if w is None else 100.0 * (1.0 - w.busy_s / w.window_s)
