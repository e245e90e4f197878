"""The ``xla`` transfer's table: one unsharded ``SparseTable`` whose
``state`` maps each field to a ``(capacity, d)`` tensor.  Reads go
through blocks of ``BLOCK`` rows, so that what the harness reads adds
little to the device's peak memory."""

from __future__ import annotations

import torch

BLOCK = 1 << 16


def slots(model, keys) -> torch.Tensor:
    table = model.table
    out = torch.as_tensor(table.key_index.lookup(keys, create=False),
                          dtype=torch.int64)
    return out.to(table.state["h"].device)


def capacity(model) -> int:
    return int(model.table.capacity)


def write_rows(model, field: str, slots: torch.Tensor,
               rows: torch.Tensor) -> None:
    t = model.table.state[field]
    t.index_copy_(0, slots, rows.to(t.dtype))


def zero(model, field: str) -> None:
    model.table.state[field].zero_()


def touched(model, field: str) -> torch.Tensor:
    t = model.table.state[field]
    return torch.cat([lo + torch.nonzero((t[lo:lo + BLOCK] != 0).any(
        dim=1)).view(-1) for lo in range(0, t.shape[0], BLOCK)])


def read_rows(model, field: str, slots: torch.Tensor) -> torch.Tensor:
    """The rows on the host."""
    t = model.table.state[field]
    return torch.cat([t[slots[lo:lo + BLOCK]].float().cpu()
                      for lo in range(0, len(slots), BLOCK)]) \
        if len(slots) else torch.empty((0, t.shape[1]))
