"""The readers of the port's loop spans and counters on a synthetic
``trace.Window``: the device's idle time inside nested spans' self time,
a gap no span covers, the consumer thread chosen by its ``dispatch``
spans, the host's own time, and the counters of the window call."""

import pytest

from benchmark import spec, trace
from benchmark.metrics import _spans

CONSUMER, PRODUCER = 7, 9
STEPS = 16


def _kernel(corr, a, b):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a,
            "dur": b - a, "args": {"correlation": corr}}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": trace.GRAPH_LAUNCH,
            "ts": ts, "dur": 5, "tid": CONSUMER,
            "args": {"correlation": corr}}


def _span(name, a, b, tid=CONSUMER):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a, "tid": tid}


def window(spans=True):
    """Three launches busy over [100, 200], [300, 400] and [500, 600]:
    idle [200, 300] and [400, 500].  The consumer's spans cover the first
    gap only; a producer thread's spans cover everything."""
    events = [_launch(1, 90), _launch(2, 290), _launch(3, 490),
              _kernel(1, 100, 200), _kernel(2, 300, 400),
              _kernel(3, 500, 600)]
    if spans:
        events += [
            _span("input_wait", 150, 230),
            _span("dispatch", 230, 320),
            _span("bound_wait", 240, 260),      # nested in dispatch
            _span("step_hooks", 320, 340),
            _span("input_wait", 0, 1000, tid=PRODUCER),
            _span("render", 0, 1000, tid=PRODUCER)]
    w = trace.reduce(events, 0)
    assert w is not None and (w.t0, w.t1) == (100, 600)
    return w


def ctx_of(w, **more):
    return {"window": w, "steps": STEPS, **more}


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_consumer_is_the_thread_of_the_dispatch_spans():
    w = window()
    assert _spans.consumer(w) == CONSUMER
    spans = _spans.loop_spans(w, CONSUMER)
    assert spans["input_wait"] == [(150, 230)]


def test_idle_inside_nested_spans_self_time():
    ctx = ctx_of(window())
    # idle [200, 230] under input_wait; [230, 240] and [260, 300] under
    # dispatch's self time; [240, 260] under its nested bound_wait
    assert read("input_idle_ms", ctx) == pytest.approx(30 / 1e3 / STEPS)
    assert read("dispatch_idle_ms", ctx) == pytest.approx(50 / 1e3 / STEPS)
    assert _spans.idle_ms_per_step(ctx, "bound_wait") == \
        pytest.approx(20 / 1e3 / STEPS)
    assert _spans.idle_ms_per_step(ctx, "step_hooks") == 0.0


def test_a_gap_no_span_covers_is_left_out():
    w = window()
    ctx = ctx_of(w)
    covered = sum(_spans.idle_ms_per_step(ctx, n) for n in _spans.LOOP)
    idle_ms = (w.window_s - w.busy_s) * 1e3 / STEPS
    assert idle_ms == pytest.approx(200 / 1e3 / STEPS)
    assert covered == pytest.approx(100 / 1e3 / STEPS)


def test_host_busy_is_the_window_less_the_consumers_waits():
    # 500 us of window less input_wait [150, 230] and bound_wait
    # [240, 260]; the producer's spans do not count
    assert read("host_busy_ms", ctx_of(window())) == \
        pytest.approx(400 / 1e3 / STEPS)


@pytest.mark.parametrize("name", ["input_idle_ms", "dispatch_idle_ms",
                                  "host_busy_ms"])
def test_span_readers_read_nothing_without_the_spans(name):
    assert read(name, ctx_of(window(spans=False))) is None
    assert read(name, {"window": None}) is None


def test_self_time_subtracts_only_nested_spans():
    spans = {n: [] for n in _spans.LOOP}
    spans["dispatch"] = [(0, 100), (200, 300)]
    spans["bound_wait"] = [(10, 20), (150, 160)]    # the second is outside
    assert _spans.self_time(spans, "dispatch") == [(0, 10), (20, 100),
                                                   (200, 300)]
    assert _spans.self_time(spans, "bound_wait") == [(10, 20), (150, 160)]


def test_counters_of_the_window_call():
    train = {"steps": 40, "graph_captures": 0,
             "pipeline": {"render_s": 0.03, "transfer_s": 0.01}}
    assert read("producer_ms", {"train": train}) == pytest.approx(1.0)
    assert read("graph_captures", {"train": train}) == 0.0
    old = {"steps": 40, "pipeline": {"stall_s": 0.0, "transfer_s": 0.01}}
    for name in ("producer_ms", "graph_captures"):
        assert read(name, {"train": old}) is None
        assert read(name, {}) is None
