"""B1's share of its memory roofline (see ``_roofline.py``); its
row-indexed launches only."""

from benchmark.metrics._roofline import share
from benchmark.roofline import adagrad


def read(ctx):
    return share(ctx, "adagrad", adagrad.KERNEL)
