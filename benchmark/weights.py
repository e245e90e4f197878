"""The initial table, made by the benchmark from the seed and handed to
both sides: the program gets it written into its table, the reference
makes the rows it needs again.

Each embedding field is ``(U(0, 1) - 0.5) / d`` per element, the
reference's ``Vec::randInit`` (the program's own initial distribution),
drawn on the device in blocks of ``BLOCK`` vocabulary rows, each block
from a generator of its own seed, so any block can be made again alone.
The AdaGrad accumulators start at zero."""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from benchmark.traffic import sub_seed

BLOCK = 1 << 18
FIELDS = ("h", "v")


def blocks(seed: int, field: str, V: int, d: int, device
           ) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(first row, (rows, d) float32 block)`` over the ``V`` vocabulary
    rows of ``field``."""
    fid = FIELDS.index(field)
    for b, lo in enumerate(range(0, V, BLOCK)):
        g = torch.Generator(device=device)
        g.manual_seed(sub_seed(seed, 10 + fid, b))
        n = min(BLOCK, V - lo)
        yield lo, (torch.rand((n, d), generator=g, device=device) - 0.5) / d


def rows(seed: int, field: str, V: int, d: int, idx: torch.Tensor
         ) -> torch.Tensor:
    """The initial rows ``idx`` (sorted vocabulary indices) of ``field``."""
    out = torch.empty((len(idx), d), dtype=torch.float32, device=idx.device)
    for lo, blk in blocks(seed, field, V, d, idx.device):
        sel = (idx >= lo) & (idx < lo + len(blk))
        if sel.any():
            out[sel] = blk[idx[sel] - lo]
    return out


def hand_to_program(table, model, slots: torch.Tensor, seed: int, V: int,
                    d: int) -> None:
    """Write the initial rows into the program's table at each vocabulary
    word's slot, and zero its accumulators (``table``: the transfer's
    module under ``benchmark/tables``)."""
    for field in FIELDS:
        for lo, blk in blocks(seed, field, V, d, slots.device):
            table.write_rows(model, field, slots[lo:lo + len(blk)], blk)
        table.zero(model, f"{field}2sum")
