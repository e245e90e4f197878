"""Asynchronous input pipeline: prefetch-rendered, pre-transferred batches
(counterpart of ``swiftmpi_tpu/io/pipeline.py``).

:class:`PrefetchIterator` is the producer/consumer primitive:

* a **producer thread** walks the source iterator ``depth`` items ahead
  into a bounded FIFO queue.  Rendering (batcher ``next``, ``np.stack``)
  and the optional ``transfer`` hook (:class:`CudaTransfer`: pinned
  copies and an asynchronous H2D copy on a side stream, so the copy
  overlaps the previous steps' compute) both run on the producer's clock;
* the **consumer** iterates as usual.  Order is exactly the source
  iterator's order — single producer, FIFO queue — and the producer owns
  NO RNG (the negative-sampling generator stays with the consumer, drawn
  in consumption order), so a pipelined run is bit-identical to the
  synchronous one;
* time the consumer spends blocked on an empty queue is recorded as
  **host stall** (``stats()["stall_s"]``), the quantity the pipeline
  exists to drive to zero; the producer's time in the source
  (``render_s``) and in ``transfer`` (``transfer_s``) beside it.

A producer exception is captured and re-raised at the consumer's next
``__next__`` as :class:`PipelineError` with the original as
``__cause__``.  ``close()`` (also the context-manager exit and the GC
hook) unblocks and joins the producer, so a consumer that dies mid-epoch
never leaks a thread that keeps rendering into a dead queue.

The producer's ``render`` and ``h2d`` are ``obs.span`` phases: with
telemetry on they book ``phase_ms`` samples, and they reach a
``torch.profiler`` trace only when the profiler records every thread
(``profile_all_threads``), since it records the ranges of the thread
that started it.  The consumer's ``input_wait`` span is the train loop's
(``Throughput.stalling``).  With telemetry on the queue books
``pipeline/produced``, ``pipeline/consumed`` and
``pipeline/queue_depth``, as in the JAX package.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch import obs

_DONE = object()          # producer sentinel: source exhausted
_CLOSED = object()        # close() sentinel: wake a blocked consumer


class PipelineError(RuntimeError):
    """Producer-side failure, re-raised on the consumer thread with the
    original exception chained (``__cause__``)."""


class PrefetchIterator:
    """Iterate ``source`` through a ``depth``-bounded background queue.

    ``transfer`` (optional) maps each item on the producer thread.
    ``depth`` counts fully rendered and transferred items the producer
    may run ahead; the slot the producer is rendering *into* is not yet
    visible to the consumer, so peak host memory is ``depth + 1`` items.
    """

    def __init__(self, source: Iterable, depth: int = 2,
                 transfer: Optional[Callable[[Any], Any]] = None,
                 name: str = "input-pipeline"):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._source = iter(source)
        self._transfer = transfer
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._produced = 0
        self._consumed = 0
        self._stall_s = 0.0
        self._render_s = 0.0
        self._transfer_s = 0.0
        self._peak_depth = 0
        self._thread = threading.Thread(
            target=self._produce, name=name, daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _produce(self) -> None:
        try:
            src = self._source
            while not self._stop.is_set():
                # the "render" and "h2d" phase spans: the producer thread
                # is where batches are rendered and copied to the device
                t0 = time.monotonic()
                with obs.span("render"):
                    item = next(src, _DONE)
                self._render_s += time.monotonic() - t0
                if item is _DONE:
                    break
                if self._transfer is not None:
                    t0 = time.monotonic()
                    with obs.span("h2d"):
                        item = self._transfer(item)
                    self._transfer_s += time.monotonic() - t0
                # a bounded put that stays responsive to close(): a plain
                # blocking put on a full queue would deadlock the join
                # once the consumer is gone
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        self._produced += 1
                        self._peak_depth = max(self._peak_depth,
                                               self._q.qsize())
                        reg = obs.get_registry()
                        if reg.enabled:
                            reg.counter("pipeline/produced").inc()
                            reg.gauge("pipeline/queue_depth").set(
                                self._q.qsize())
                        break
                    except queue.Full:
                        continue
        except BaseException as e:            # noqa: BLE001 — re-raised
            self._error = e                   # on the consumer thread
        finally:
            # land _DONE AFTER every real item (never displace one), unless
            # close() already took over wake-up duty
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.monotonic()
        item = self._q.get()
        self._stall_s += time.monotonic() - t0
        if item is _DONE or item is _CLOSED:
            # _DONE lands after every real item
            if self._error is not None:
                err, self._error = self._error, None
                self.close()
                raise PipelineError(
                    f"input-pipeline producer failed: {err!r}") from err
            self.close()
            raise StopIteration
        self._consumed += 1
        reg = obs.get_registry()
        if reg.enabled:
            reg.counter("pipeline/consumed").inc()
        return item

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop the producer and join it.  Idempotent; safe to call from
        ``finally`` around a consumer loop that may have crashed."""
        if self._stop.is_set():
            return
        self._stop.set()
        while True:                 # unblock a producer on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        try:
            self._q.put_nowait(_CLOSED)       # wake any blocked consumer
        except queue.Full:
            pass

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover — GC backstop
        try:
            self.close()
        except Exception:
            pass

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Counters for train metrics."""
        return {"depth": self.depth,
                "produced": self._produced,
                "consumed": self._consumed,
                "peak_queue_depth": self._peak_depth,
                "stall_s": self._stall_s,
                "render_s": self._render_s,
                "transfer_s": self._transfer_s}


class Staged:
    """A work item whose numpy leaves were copied to the card on
    :class:`CudaTransfer`'s side stream: the item with those leaves
    replaced by CUDA tensors, and the event that completes the copies."""

    def __init__(self, item, tensors: List[torch.Tensor],
                 event: "torch.cuda.Event"):
        self.item = item
        self.tensors = tensors
        self.event = event


def _map_leaves(item, fn):
    """``fn`` over the numpy leaves of nested tuples and lists."""
    if isinstance(item, np.ndarray):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map_leaves(x, fn) for x in item)
    return item


class CudaTransfer:
    """Producer ``transfer`` hook for a CUDA device (in place of the JAX
    package's ``device_put_transfer``).  For each numpy leaf of an item
    it copies the leaf into pinned host memory, issues a ``non_blocking``
    H2D copy on a side stream, and records one event after the item's
    copies; the item comes back as a :class:`Staged`.

    The consumer calls :meth:`ready` on its own thread before the step:
    its stream waits on the event (the device waits, not the host) and
    ``record_stream`` tells the caching allocator that the consumer's
    stream uses each tensor.  A pinned buffer is kept alive until its
    copy's event has completed (polled as new items are staged; the
    rest are waited for by :meth:`close`), so no buffer is freed or
    reused under an async copy.

    Also usable inline (``pipeline: 0``): the same copies, issued on the
    consumer's thread.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._inflight: deque = deque()   # (event, pinned buffers)

    def _reap(self) -> None:
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()

    def __call__(self, item) -> Staged:
        self._reap()
        pinned, tensors = [], []

        def leaf(x: np.ndarray) -> torch.Tensor:
            host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            pinned.append(host)
            t = host.to(self.device, non_blocking=True)
            tensors.append(t)
            return t

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = _map_leaves(item, leaf)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._inflight.append((ev, pinned))
        return Staged(out, tensors, ev)

    def ready(self, staged: Staged):
        """The item of ``staged``, usable on the caller's current
        stream."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(cur)
        return staged.item

    def pending(self) -> int:
        """Items whose pinned buffers are still held."""
        self._reap()
        return len(self._inflight)

    def close(self) -> None:
        """Wait for every outstanding copy, then drop its buffers."""
        while self._inflight:
            ev, _ = self._inflight.popleft()
            ev.synchronize()
