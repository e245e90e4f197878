"""The port's span gate and ``Word2Vec.train``'s loop spans on the CPU.

``obs.span`` opens a ``record_function`` range whenever a
``torch.profiler`` records, telemetry or not, and nothing at all when
neither does.  Under a CPU profiler a short ``train`` leaves its loop's
phases (``input_wait``, ``dispatch`` with ``bound_wait`` nested in it,
``step_hooks``, ``epoch_end``) as ``user_annotation`` events on one
thread, one after another; the stall meter and its span book one
interval; the producer's ``render_s`` and the call's ``graph_captures``
count.
"""

import contextlib
import json
import time
import types

import numpy as np
import pytest
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.io.pipeline import PrefetchIterator
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import ConfigParser
from swiftmpi_tpu_torch.utils import graphs
from swiftmpi_tpu_torch.utils import pipeline as utils_pipeline
from swiftmpi_tpu_torch.utils.timers import Throughput

LOOP = ("input_wait", "dispatch", "bound_wait", "step_hooks", "epoch_end")
CONF = {"word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                     "learning_rate": 0.05, "min_sentence_length": 2},
        "server": {"initial_learning_rate": 0.3},
        "worker": {"minibatch": 256}}


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _corpus(n=30, vocab=50, length=12, seed=8):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, length)]
            for _ in range(n)]


def _model(**worker):
    c = ConfigParser().update(CONF)
    for k, v in worker.items():
        c.set("worker", k, v)
    return Word2Vec(config=c, device="cpu", seed=3)


def _annotations(prof, tmp_path) -> list:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


class _Event:
    """A CUDA event's host side on the CPU: the blocking wait takes a
    little time, so its span has a length."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        time.sleep(0.001)


class _Bounded(utils_pipeline.DispatchWindow):
    """A dispatch window bounded at one outstanding step on the CPU."""

    def __init__(self, bound="auto", device=None):
        super().__init__(bound, device)
        self._bound = None if bound is None else 1


def _bound_on_the_cpu(monkeypatch):
    monkeypatch.setattr(utils_pipeline, "DispatchWindow", _Bounded)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)


@pytest.mark.parametrize("knobs", [{}, {"pipeline": 2},
                                   {"inner_steps": 2, "pipeline": 2}])
def test_train_loop_spans_on_one_thread(tmp_path, monkeypatch, knobs):
    """Every loop span is on the thread that called ``train``; on it the
    spans follow one another, and only ``bound_wait`` nests, in
    ``dispatch``.  One ``input_wait`` more than there are dispatches (the
    epoch's end is a wait too), one ``step_hooks`` a dispatch, one
    ``epoch_end`` an iteration."""
    _bound_on_the_cpu(monkeypatch)
    model = _model(**knobs)
    prof = _profiled(lambda: model.train(_corpus(), niters=2,
                                         batch_size=32))
    evs = [e for e in _annotations(prof, tmp_path) if e["name"] in LOOP]
    assert {e["name"] for e in evs} == set(LOOP)
    assert len({e["tid"] for e in evs}) == 1
    by = {n: sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                    if e["name"] == n) for n in LOOP}
    n_dispatch = len(by["dispatch"])
    assert n_dispatch >= 2
    assert len(by["step_hooks"]) == n_dispatch
    assert len(by["input_wait"]) == n_dispatch + 2
    assert len(by["epoch_end"]) == 2
    assert by["bound_wait"]          # one a step past the first
    for a, b in by["bound_wait"]:
        assert any(x <= a and b <= y for x, y in by["dispatch"])
    flat = sorted(iv for n in LOOP if n != "bound_wait" for iv in by[n])
    for (a0, b0), (a1, b1) in zip(flat, flat[1:]):
        assert b0 <= a1, (a0, b0, a1, b1)


def test_no_telemetry_no_profiler_enters_no_range(monkeypatch):
    """Off and unprofiled, ``span`` is the shared no-op and no
    ``record_function`` is entered, through a whole ``train`` too."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert obs.span("dispatch") is obs._NULL_SPAN
    _model(pipeline=2, inner_steps=2).train(_corpus(), niters=1,
                                            batch_size=32)
    assert calls == []
    # under a profiler, with telemetry still off: the range alone
    seen = []
    _profiled(lambda: seen.append(obs.span("dispatch")))
    assert seen[0] is not obs._NULL_SPAN and calls == ["dispatch"]
    assert obs.get_registry().snapshot()["hists"] == {}


def test_span_under_a_profiler_lands_in_the_trace(tmp_path):
    def body():
        with obs.span("step_hooks"):
            time.sleep(0.002)
    names = [e["name"] for e in _annotations(_profiled(body), tmp_path)]
    assert names.count("step_hooks") == 1


def test_stall_meter_and_its_span_book_one_interval(tmp_path):
    """The ``input_wait`` span opens before the meter's clock and closes
    after it: the two agree to the span's own overhead, in the registry
    and in a profiler's trace."""
    obs.set_enabled(True)
    meter = Throughput()
    with meter.stalling():
        time.sleep(0.02)
    h = obs.get_registry().snapshot()["hists"]["phase_ms{phase=input_wait}"]
    assert h["count"] == 1
    assert 0.0 <= h["sum"] - meter.host_stall_ms() < 2.0
    obs.set_enabled(False)
    traced = Throughput()

    def body():
        with traced.stalling():
            time.sleep(0.02)
    [ev] = [e for e in _annotations(_profiled(body), tmp_path)
            if e["name"] == "input_wait"]
    assert 0.0 <= ev["dur"] / 1e3 - traced.host_stall_ms() < 2.0


def test_prefetch_iterator_counts_render_time():
    def slow():
        for i in range(5):
            time.sleep(0.01)
            yield i
    with PrefetchIterator(slow(), depth=2) as pipe:
        assert list(pipe) == list(range(5))
    s = pipe.stats()
    assert 0.05 <= s["render_s"] < 5.0
    assert s["transfer_s"] == 0.0


def test_train_metrics_carry_render_s_and_graph_captures():
    model = _model(pipeline=2, inner_steps=2)
    model.train(_corpus(), niters=2, batch_size=32)
    m = model.train_metrics
    assert m["graph_captures"] == 0 and not m["fused"]   # no graph on a CPU
    assert m["pipeline"]["render_s"] > 0.0
    assert m["unstalled_ms"] >= 0.0 and "device_ms" not in m


def test_run_group_counts_its_captures(monkeypatch):
    """``capture_count`` rises by one for each graph ``run_group``
    captures, and not for a replay or an eager group (the CUDA calls
    around the warm-up stand in on the CPU)."""
    class _Out:
        def record_stream(self, stream):
            pass
    fake_cuda = types.SimpleNamespace(
        current_stream=lambda dev=None: types.SimpleNamespace(
            wait_stream=lambda s: None),
        Stream=lambda dev=None: types.SimpleNamespace(
            wait_stream=lambda s: None),
        stream=lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "torch",
                        types.SimpleNamespace(cuda=fake_cuda))
    replays = []
    graph = types.SimpleNamespace(replay=lambda f: replays.append(f) or
                                  (torch.zeros(()),))
    cache = {}
    fields = (torch.zeros(3, 2),)
    step = lambda f: (_Out(),)                              # noqa: E731
    before = graphs.capture_count()
    _, replayed = graphs.run_group(cache, fields, step, True,
                                   lambda f: graph)
    assert not replayed and graphs.capture_count() == before + 1
    _, replayed = graphs.run_group(cache, fields, step, True,
                                   lambda f: graph)
    assert replayed and graphs.capture_count() == before + 1
    graphs.run_group({}, fields, step, False, lambda f: graph)
    assert graphs.capture_count() == before + 1 and len(replays) == 1
