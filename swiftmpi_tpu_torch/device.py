"""Device selection for the port's entry points.

The port runs on the CUDA device.  The CPU is taken only when the caller
asks for it by name (``device="cpu"``, CLI ``-device cpu``), as the tests
do; with no CUDA device and no explicit CPU request an entry point raises
rather than carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises when there is none);
    ``"cpu"`` / ``"cuda[:n]"`` / a ``torch.device`` -> that device, after
    checking that a requested CUDA device exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: -device cpu) to run the plain PyTorch versions on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
