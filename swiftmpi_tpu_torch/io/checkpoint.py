"""Text table dumps (counterpart of the text half of
``swiftmpi_tpu/io/checkpoint.py``).

``key\\t<value>`` lines, one per occupied row, the reference's checkpoint
format (reference sparsetable.h:119-132), with the value laid out by the
caller's formatter (for word2vec ``models.word2vec.w2v_formatter``:
``v... \\t h...``).  Written by Python; the npz checkpoints, text loading
and the native writer are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from swiftmpi_tpu_torch.parameter.sparse_table import SparseTable

Formatter = Callable[[Dict[str, np.ndarray]], str]


def dump_table_text(table: SparseTable, path: str,
                    formatter: Formatter) -> int:
    """Write ``key\\tformatter(row)`` lines for every occupied row, in
    key-index insertion order; ``row`` maps every field of the table to
    the slot's vector.  Returns the count."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # bfloat16 fields upcast to float32, exactly: the formatter then
    # prints the same values as the JAX dump of the same state
    rows = table.to_numpy(upcast=True)
    n = 0
    with open(path, "w") as f:
        for key, slot in table.key_index.items():
            row = {name: arr[slot] for name, arr in rows.items()}
            f.write(f"{key}\t{formatter(row)}\n")
            n += 1
    return n
