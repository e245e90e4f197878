"""B2, the masked row gather (``kernels/gather.py``, ``csrc/gather.cu``):
``(N, d)`` rows of a ``(cap, d)`` table at ``N`` int32 slots with a bool
mask; masked rows are written as zeros."""

#: the substring of the kernel's name in a device trace
KERNEL = "masked_gather"


def bytes_moved(n_slots: int, n_unique_rows: int, d: int,
                elem: int = 4) -> int:
    """The slots and the mask read, each distinct unmasked table row read
    once, every output row written."""
    return n_slots * (4 + 1) + n_unique_rows * d * elem + n_slots * d * elem
