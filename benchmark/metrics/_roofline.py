"""A kernel's share of its memory roofline in the profiled window: the
bytes its launches need (``benchmark/roofline``) at the card's peak
bandwidth, over its summed device time."""


def share(ctx, kind, kernel):
    w = ctx.get("window")
    if w is None or not ctx.get("peaks") \
            or not ctx.get("bytes", {}).get(kind):
        return None
    seconds = w.op_seconds(kernel)
    if seconds <= 0:
        return None
    return 100.0 * ctx["bytes"][kind] / ctx["peaks"]["hbm_bytes_per_s"] \
        / seconds
