"""B1, the AdaGrad update (``kernels/adagrad.py``, ``csrc/adagrad.cu``)
in its row-indexed form: ``B`` pushed rows of which ``kept`` (distinct
slots) update ``param`` and ``accum`` in place, each grad row times its
per-row factor."""

#: the substring of the kernel's name in a device trace
KERNEL = "adagrad_update"


def bytes_moved_rows(n_rows: int, n_kept: int, d: int,
                     elem: int = 4) -> int:
    """Per pushed row its slot (4 B), mask (1 B) and factor (4 B); per
    kept row its grad, param and accumulator read and param and
    accumulator written."""
    return n_rows * (4 + 1 + 4) + n_kept * d * elem * 5


def bytes_moved_table(cap: int, d: int, elem: int = 4) -> int:
    """The whole-table form: grad, param and accumulator read, param and
    accumulator written, and one divisor a row."""
    return cap * (d * elem * 5 + 4)
