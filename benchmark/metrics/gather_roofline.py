"""B2's share of its memory roofline (see ``_roofline.py``)."""

from benchmark.metrics._roofline import share
from benchmark.roofline import gather


def read(ctx):
    return share(ctx, "gather", gather.KERNEL)
