"""Rows the transfer's pulls booked (``traffic()["pull_rows"]``, valid
slots) over a counted call, a trained word."""


def read(ctx):
    tr = ctx.get("traffic")
    if not tr or not tr["words"]:
        return None
    return tr["delta"]["pull_rows"] / tr["words"]
