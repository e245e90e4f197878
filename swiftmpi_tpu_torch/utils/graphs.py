"""Groups of training steps as CUDA graphs (the counterpart of the JAX
package's fused multi-step programs: ``lax.scan`` over N batches in one
dispatch, ``_build_multi_step`` in word2vec, ``_build_scan`` in logistic
regression, the fused step of GloVe).

A model hands :func:`run_group` a step callable (one batch's fields in,
a tuple of device scalars out, nothing read back to the host) and a
group of batches stacked as ``(N, ...)`` tensors on the card; with
``whole=True`` the callable takes the whole group's stacked fields at
once (word2vec's window-coalesced groups, whose steps share one push a
window) and returns the group's summed outputs.  The first
group of a length runs its steps eagerly on a side stream (the warm-up a
capture needs), then :class:`StepGraph` captures the N steps once; every
later group of that length is one replay.

The graph reads the batches from static ``(N, ...)`` buffers, filled with
``copy_`` before each replay; a registered ``torch.Generator`` advances on
each replay as N eager steps would advance it; the step outputs, summed
over the group, are static outputs cloned after the replay.  A replay
calls no kernel wrapper, so the launches (and the transfer's push paths)
recorded while capturing are added to the counters on every replay, and
the capture's own calls are taken back.

A graph writes the addresses it was captured on: the table's tensors and
whatever else the step reads.  The caller keys its cache of graphs on
those (``SparseTable.generation`` changes when the table grows and moves
to new tensors) and drops the cache when the key changes.  A
:class:`StepGraph` holds no reference to the model (no reference cycle):
a graph is then freed when its model is, never by a garbage collection,
which may run while another graph is being captured, where freeing a
graph is not permitted; collections are also off during the capture
itself.
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from swiftmpi_tpu_torch import kernels

Step = Callable[[tuple], Tuple[torch.Tensor, ...]]

_CAPTURES = 0


def capture_count() -> int:
    """The graphs :func:`run_group` has captured in this process, as
    ``kernels.launch_counts`` counts launches: a caller reads it before
    and after its work."""
    return _CAPTURES


class StepGraph:
    """``n`` calls of ``step`` as one CUDA graph, ``n`` the leading length
    of ``fields`` (``whole``: one call of ``step`` on all ``n``); the
    static buffers take ``dtypes`` (default: the fields' own)."""

    def __init__(self, step: Step, fields: Sequence[torch.Tensor],
                 dtypes: Optional[Sequence[torch.dtype]] = None,
                 generator: Optional[torch.Generator] = None,
                 push_paths: Optional[Counter] = None,
                 whole: bool = False):
        dev = fields[0].device
        n = fields[0].shape[0]
        self.n = n
        dtypes = dtypes or [f.dtype for f in fields]
        self.static = [torch.empty(f.shape, dtype=dt, device=dev)
                       for f, dt in zip(fields, dtypes)]
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        launches0 = kernels.launch_counts()
        self._paths = push_paths if push_paths is not None else Counter()
        paths0 = Counter(self._paths)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                total = step(tuple(self.static)) if whole else None
                for i in range(0 if whole else n):
                    out = step(tuple(s[i] for s in self.static))
                    total = out if total is None else tuple(
                        a + b for a, b in zip(total, out))
        finally:
            if collecting:
                gc.enable()
        self.out = total
        self.launches = {k: v - launches0[k]
                         for k, v in kernels.launch_counts().items()}
        kernels.add_launches({k: -v for k, v in self.launches.items()})
        self.push_paths = self._paths - paths0
        self._paths.clear()
        self._paths.update(paths0)

    def replay(self, fields) -> Tuple[torch.Tensor, ...]:
        """Run the ``n`` steps on ``fields`` (``(n, ...)`` tensors on the
        device); returns the step outputs summed over the group, on the
        device."""
        for s, f in zip(self.static, fields):
            s.copy_(f)
        self.graph.replay()
        kernels.add_launches(self.launches)
        self._paths.update(self.push_paths)
        return tuple(o.clone() for o in self.out)


def graph_key(table, *tensors: torch.Tensor) -> tuple:
    """What a graph captured on ``table`` (and on ``tensors``, such as a
    sampler's) stays valid for: the table's growth generation and the
    addresses of its tensors and of ``tensors``."""
    flat = [t for v in table.state.values()
            for t in (v if isinstance(v, list) else [v])]
    return (table.generation,
            *(t.data_ptr() for t in (*flat, *tensors)))


def run_group(cache: Dict[int, StepGraph], fields, step: Step,
              graphs: bool, capture: Callable[[tuple], StepGraph],
              whole: bool = False) -> Tuple[List[tuple], bool]:
    """The steps of one group, in order: one replay of the group length's
    graph from ``cache`` when ``graphs`` and it exists, else the steps one
    by one through ``step`` (``whole``: one call on the group).  With
    ``graphs``, the first group of a length is the capture's warm-up: its
    steps run on a side stream, then ``capture(fields)`` captures the
    graph into ``cache`` (the capture runs nothing).  Returns the outputs
    (one summed tuple for a replay or a whole group, one tuple a step
    otherwise) and whether the group was a replay."""
    global _CAPTURES
    L = fields[0].shape[0]
    fused = cache.get(L) if graphs else None
    if fused is not None:
        return [fused.replay(fields)], True

    def eager():
        if whole:
            return [step(tuple(fields))]
        return [step(tuple(f[i] for f in fields)) for i in range(L)]

    if not graphs:
        return eager(), False
    dev = fields[0].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = eager()
    cur.wait_stream(side)
    for res in out:               # used on this stream from here on
        for t in res:
            t.record_stream(cur)
    cache[L] = capture(fields)
    _CAPTURES += 1
    return out, False
