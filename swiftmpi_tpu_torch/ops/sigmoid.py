"""Clipped sigmoid matching the reference ExpTable semantics (counterpart
of ``swiftmpi_tpu/ops/sigmoid.py``).

The reference precomputes sigmoid on [-MAX_EXP, MAX_EXP] and hard-clips
outside (reference ``word2vec.h:237-267,591-598``): beyond +MAX_EXP the
sigmoid is exactly 1, below -MAX_EXP exactly 0, and in between the exact
sigmoid stands in for the table lookup.
"""

from __future__ import annotations

import torch

MAX_EXP = 6.0


def sigmoid_clipped(f: torch.Tensor) -> torch.Tensor:
    """sigma(f) with saturation to exactly 0/1 beyond +/-MAX_EXP."""
    s = 1.0 / (1.0 + torch.exp(-f.clamp(-MAX_EXP, MAX_EXP)))
    s = torch.where(f > MAX_EXP, 1.0, s)
    return torch.where(f < -MAX_EXP, 0.0, s)
