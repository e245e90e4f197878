"""Async-dispatch bounding (counterpart of
``swiftmpi_tpu/utils/pipeline.py``).

PyTorch enqueues CUDA work and returns, so a training loop that never
reads the device can run any number of steps ahead of it, each holding
its inputs and temporaries.  ``DispatchWindow`` bounds that as a ROLLING
window: it records one ``torch.cuda.Event`` per tracked step and, past
``bound`` outstanding events, synchronizes the OLDEST (its completion
implies every earlier step ran, and ~``bound`` newer steps stay queued,
so there is no pipeline bubble).  On the CPU every op has finished when
it returns, so the window holds nothing there.

``resolve_dispatch_bound`` turns the ``[worker] dispatch_depth`` knob
into a bound exactly as the JAX package does; ``"auto"`` on a CUDA
device means no bound (a card runs its stream in order, as a TPU chip
runs one program at a time).  ``LossAccum`` keeps a train loop's loss
sums on the device behind such a window, read once an epoch.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Union

import torch

from swiftmpi_tpu_torch import obs

AUTO_BOUND = 16


class DispatchWindow:
    def __init__(self, bound: Union[str, int, None] = "auto",
                 device: Optional[torch.device] = None):
        if bound == "auto":
            bound = None
        if device is None or torch.device(device).type != "cuda":
            bound = None            # CPU ops are synchronous
        self._bound: Optional[int] = bound
        self._device = device
        self._window: deque = deque()

    def push(self) -> None:
        """Track the work enqueued so far on the current stream; block on
        the oldest tracked event once more than ``bound`` are
        outstanding."""
        if self._bound is None:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        self._window.append(ev)
        if len(self._window) > self._bound:
            # the host waits for the card here, not in the step
            with obs.span("bound_wait"):
                self._window.popleft().synchronize()

    def clear(self) -> None:
        self._window.clear()

    def __len__(self) -> int:
        return len(self._window)


def resolve_dispatch_bound(depth: Union[str, int, None],
                           pipelined: bool = False) -> Union[str, int, None]:
    """Resolve the ``[worker] dispatch_depth`` knob into a
    ``DispatchWindow`` bound, as the JAX package does.

    ``"auto"`` keeps the device policy above — EXCEPT when the input
    pipeline is on: with prefetched batches the consumer can enqueue as
    fast as it renders nothing, so pipelined ``"auto"`` bounds every
    device at ``AUTO_BOUND``.  An explicit integer (or ``0`` meaning
    unbounded) always wins.
    """
    if depth == "auto" or depth is None:
        return AUTO_BOUND if pipelined else "auto"
    depth = int(depth)
    return None if depth <= 0 else depth


class LossAccum:
    """Non-blocking loss accumulator (JAX word2vec's ``_LossAccum``; every
    model's train loop of the port uses it): queues the
    steps' device scalars and folds every ``fold`` into ONE device scalar
    (a stacked sum, no host read), so an epoch holds O(1) scalars and the
    epoch-end read is one round trip, not one per step.  Folds in
    float32: exact up to 2^24 per fold, and beyond that the loss
    denominator's relative error is below 1e-7.

    ``bound`` feeds a ``utils.pipeline.DispatchWindow`` on ``device``:
    the steps the host may run ahead of the card.  ``peak_queued`` shows
    the retention bound: never more than ``fold`` scalars."""

    _FOLD = 256

    def __init__(self, bound="auto", device=None, fold: int = _FOLD):
        if fold < 2:
            raise ValueError(f"LossAccum fold must be >= 2, got {fold}")
        self._q: List[torch.Tensor] = []
        self._fold = fold
        self.peak_queued = 0
        self._window = DispatchWindow(bound, device)

    def add(self, x: torch.Tensor) -> None:
        self._q.append(x.to(torch.float32).reshape(()))
        self._window.push()
        self.peak_queued = max(self.peak_queued, len(self._q))
        if len(self._q) >= self._fold:
            self._q = [torch.stack(self._q).sum()]

    def total(self) -> float:
        """The sum, read to the host: the accumulator's one host read."""
        if not self._q:
            return 0.0
        self._window.clear()
        return float(torch.stack(self._q).sum())
