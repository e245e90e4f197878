"""The program's native prefetching batcher (``data/native.py``'s
``PrefetchingCBOWBatcher``, whose C++ executor renders
``batcher_depth`` batches ahead on a thread of its own) over the
corpus, epoch after epoch.  Only full batches of ``batch_centers`` are
handed out: an epoch's short last batch is left out, so every group of
``inner_steps`` batches is one CUDA graph replay and no call ends in a
group of another length.  A closed loop: ``train`` takes a batch when it
is ready for it."""

from __future__ import annotations

import time
from typing import Iterator, List, Optional

from benchmark.traffic import sub_seed


class Batches:
    """One ``train`` call's batch source: ``epoch(batch_size)`` yields the
    batches ``next_batch`` hands out while ``more()`` says so."""

    def __init__(self, feed: "Feed", more, record: Optional[list]):
        self.vocab = feed.vocab
        self._feed, self._more, self._record = feed, more, record
        self.words = 0
        self.batches = 0
        #: the host clock as each group's first batch is handed out
        self.group_times: List[float] = []

    def epoch(self, batch_size: int) -> Iterator:
        if batch_size != self._feed.batch:
            raise ValueError(f"the feed renders batches of "
                             f"{self._feed.batch} centers, not {batch_size}")
        while self._more(self.batches):
            if self.batches % self._feed.group == 0:
                self.group_times.append(time.perf_counter())
            b = self._feed.next_batch()
            if self._record is not None:
                self._record.append((b.centers.copy(), b.contexts.copy(),
                                     b.ctx_mask.copy()))
            self.words += b.n_words
            self.batches += 1
            yield b


class Feed:
    def __init__(self, tokens, offsets, vocab, cfg: dict, mix: dict,
                 seed: int):
        from swiftmpi_tpu_torch.data.native import PrefetchingCBOWBatcher
        self.vocab = vocab
        self.batch = int(mix["batch_centers"])
        self.group = int(mix["inner_steps"])
        self._native = PrefetchingCBOWBatcher(
            tokens, offsets, vocab, int(cfg["window"]),
            float(cfg["sample"]), seed=sub_seed(seed, 3),
            depth=int(mix["batcher_depth"]))
        self._epoch = None

    def next_batch(self):
        while True:
            if self._epoch is None:
                self._epoch = self._native.epoch(self.batch)
            b = next(self._epoch, None)
            if b is None:
                self._epoch = None
                continue
            if b.n_words == self.batch:
                return b

    def take(self, n: int, record: Optional[list] = None) -> Batches:
        """The next ``n`` batches (``record``: their arrays appended)."""
        return Batches(self, lambda k: k < n, record)

    def until(self, seconds: float) -> Batches:
        """Whole groups of batches until ``seconds`` have passed since the
        first was asked for."""
        start: List[float] = []

        def more(k):
            if not start:
                start.append(time.perf_counter())
            return k % self.group or time.perf_counter() - start[0] < seconds
        return Batches(self, more, None)

    def close(self) -> None:
        """Stop the native batcher's producer thread and wait for it."""
        if self._epoch is not None:
            self._epoch.close()
            self._epoch = None
