"""Bytes the transfer's pushes booked (``traffic()["wire_bytes"]``: a
dense push every table row without its index, a sparse push its valid
rows with theirs) over a counted call, a trained word."""


def read(ctx):
    tr = ctx.get("traffic")
    if not tr or not tr["words"]:
        return None
    return tr["delta"]["wire_bytes"] / tr["words"]
