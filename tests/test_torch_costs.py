"""The port's compile catalog (``swiftmpi_tpu_torch/obs/costs.py``) and
triggered profiler windows (``obs/profiler.py``) against the JAX
package's, on the CPU.

A compile in the port is a CUDA graph capture, which this machine cannot
do; the catalog's funnel is tested on capture handles
(``obs.costs.Captures``) around plain callables, the models' own captures
on the card (``tests/test_torch_cuda.py``).  The profiler's trace parse
runs on a torch CPU profile of a small word2vec train.
"""

import gzip
import json
import os

import numpy as np
import pytest

from swiftmpi_tpu.obs import costs as jax_costs
from swiftmpi_tpu.obs import profiler as jax_profiler
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.obs import costs
from swiftmpi_tpu_torch.obs import profiler as port_profiler
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import ConfigParser


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def test_disarmed_tracked_fn_is_a_passthrough():
    calls = []

    def capture(x, k=1):
        calls.append((x, k))
        return x * k
    capture.extra = "attr"
    handle = costs.Captures(capture)
    fn = costs.track("w2v_multi", handle, steps_per_call=4)
    assert costs.track("other", fn) is fn             # idempotent
    assert fn(3, k=2) == 6 and calls == [(3, 2)]
    assert fn._compiles == 0 and fn.steps_per_call == 4
    assert costs.get_catalog().entries() == {}
    assert obs.get_registry().snapshot()["counters"] == {}
    plain = costs.track("eager", lambda: 5)
    assert plain() == 5 and plain._cache_size() == -1
    assert repr(fn).startswith("TrackedFn('w2v_multi'")


def test_armed_catalog_books_captures_and_retraces(tmp_path):
    """Armed: a handle's first capture is a compile, the same handle
    capturing again a retrace, a plain callable nothing; the registry and
    the ``smtpu-costs/1`` artifact say so, in the JAX package's
    schema."""
    path = str(tmp_path / "runs" / "compile_catalog.json")
    cfg = ConfigParser().update({"obs": {"costs": 1, "costs_path": path}})
    cat = costs.configure_costs(cfg, run="word2vec")
    obs.set_enabled(True)
    assert cat is costs.get_catalog() and cat.enabled and cat.memory
    h8 = costs.track("w2v_multi", costs.Captures(lambda f: f), 8)
    h3 = costs.track("w2v_multi", costs.Captures(lambda f: f), 3)
    costs.track("w2v_step", lambda f: f)(1)
    h8("a")
    h3("b")
    e = cat.entry("w2v_multi")
    assert e["compiles"] == 2 and e["retraces"] == 0
    assert e["steps_per_call"] == 3 and "flops" not in e
    assert "peak_bytes" not in e        # no CUDA device here
    h8("a")                              # the same handle again
    e = cat.entry("w2v_multi")
    assert e["compiles"] == 3 and e["retraces"] == 1
    assert cat.entry("w2v_step") is None
    c = obs.get_registry().snapshot()["counters"]
    assert c["compile/compiles{fn=w2v_multi}"] == 3
    assert c["compile/retraces{fn=w2v_multi}"] == 1
    assert c["compile/compile_ms{fn=w2v_multi}"] >= 0
    doc = json.load(open(path))
    assert doc["schema"] == costs.COSTS_SCHEMA == jax_costs.COSTS_SCHEMA
    assert doc["run"] == "word2vec" and set(doc["fns"]) == {"w2v_multi"}
    want_keys = {"fn", "compiles", "retraces", "compile_ms_total",
                 "last_compile_ms", "steps_per_call"}
    assert set(doc["fns"]["w2v_multi"]) == want_keys
    jcat = jax_costs.CostCatalog(enabled=True)
    jcat._fns["w2v_multi"] = dict(doc["fns"]["w2v_multi"])
    jdoc = jcat.snapshot()
    assert set(jdoc) == set(doc) and jdoc["fns"] == doc["fns"]


def test_env_arms_the_catalog(monkeypatch):
    assert costs.configure_costs(ConfigParser()) is None
    monkeypatch.setenv(costs.ENV_COSTS, "1")
    cat = costs.configure_costs(ConfigParser())
    assert cat.enabled and cat.path == os.path.join(
        "runs", "compile_catalog.json")


@pytest.mark.parametrize("flops,hand_flops,bytes_,hand_bytes", [
    (None, 2e6, None, 4e6), (1e6, 1.2e6, 5e5, 4e5), (3.0, 3.0, 0.0, 1.0)])
def test_hand_model_drift_matches_jax(flops, hand_flops, bytes_,
                                      hand_bytes):
    """``note_hand_model`` records the per-call hand model; the drift
    percentages (present only beside a measured number, which the port's
    captures do not give) are JAX's formula."""
    cat = costs.CostCatalog(enabled=True)
    cat.note_hand_model("w2v_multi", flops=hand_flops,
                        bytes_accessed=hand_bytes)
    e = cat.entry("w2v_multi")
    assert e["hand_flops"] == hand_flops and e["hand_bytes"] == hand_bytes
    assert "flops_drift_pct" not in cat.snapshot()["fns"]["w2v_multi"]
    entry = {"flops": flops, "hand_flops": hand_flops,
             "bytes_accessed": bytes_, "hand_bytes": hand_bytes}
    got, want = dict(entry), dict(entry)
    costs._add_drift(got)
    jax_costs._add_drift(want)
    assert got == want


def test_parse_trace_dir_splits_device_by_category(tmp_path):
    """torch's chrome trace has no ``/device:`` processes: device events
    are told by their category; both packages' parsers read the JAX-style
    process names alike."""
    d = tmp_path / "prof"
    d.mkdir()
    events = [
        {"ph": "X", "name": "dispatch", "cat": "user_annotation",
         "dur": 900, "pid": 1},
        {"ph": "X", "name": "gather_rows_kernel", "cat": "kernel",
         "dur": 300, "pid": 0},
        {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy",
         "dur": 50, "pid": 0},
        {"ph": "X", "name": "window_dedup", "cat": "gpu_user_annotation",
         "dur": 120, "pid": 0},
        {"ph": "X", "name": "$frame", "dur": 5, "pid": 1},
        {"ph": "i", "name": "marker", "pid": 1}]
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    s = port_profiler.parse_trace_dir(str(d))
    assert s["schema"] == "smtpu-profile/1" and s["events"] == 4
    assert s["host_ms"] == {"dispatch": 0.9}
    assert s["device_ms"] == {"other": 0.35, "window_dedup": 0.12}
    jev = [dict(e, pid=9 if e.get("cat", "").startswith(("kernel", "gpu"))
                else 1) for e in events]
    jev.append({"ph": "M", "name": "process_name", "pid": 9,
                "args": {"name": "/device:GPU:0"}})
    j = tmp_path / "jax"
    j.mkdir()
    with gzip.open(j / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": jev}, f)
    assert port_profiler.parse_trace_dir(str(j)) == \
        jax_profiler.parse_trace_dir(str(j))


W2V = {"word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                    "learning_rate": 0.05, "min_sentence_length": 2},
       "server": {"initial_learning_rate": 0.3},
       "worker": {"minibatch": 256, "inner_steps": 2, "telemetry": 1}}


def test_profile_window_of_a_small_train(tmp_path, monkeypatch):
    """``[obs] profile_at: 2, profile_steps: 2`` on a word2vec train: one
    capture under ``profile_step<k>_r0/`` with the chrome trace and a
    ``smtpu-profile/1`` summary attributing host time to ``dispatch``;
    the registry and the stream carry the capture."""
    monkeypatch.chdir(tmp_path)
    c = ConfigParser().update(W2V)
    c.set("obs", "profile_at", 2)
    c.set("obs", "profile_steps", 2)
    c.set("worker", "telemetry_path", "t.jsonl")
    rng = np.random.default_rng(0)
    sents = [[int(x) for x in rng.integers(1, 40, 12)] for _ in range(30)]
    m = Word2Vec(config=c, device="cpu")
    m.train(sents, niters=2, batch_size=32)
    sess = obs.get_profiler()
    assert sess is not None and len(sess.captures) == 1
    cap = sess.captures[0]
    assert cap["reason"] == "profile_at" and cap["steps"] == 2
    assert cap["start_step"] == 2 and cap["files"] == 1
    assert cap["host_ms"].get("dispatch", 0) > 0
    assert cap["device_ms"] == {}                 # no card here
    run_dir = cap["run_dir"]
    assert os.path.basename(run_dir) == "profile_step2_r0"
    assert any(f.endswith(".trace.json.gz") for f in os.listdir(run_dir))
    summary = json.load(open(os.path.join(run_dir, "profile_summary.json")))
    assert summary["schema"] == jax_profiler.PROFILE_SCHEMA
    # the JAX parser reads the same file the same way on the host side,
    # given its phases: the port names the train loop's other spans too
    assert jax_profiler.parse_trace_dir(run_dir)["host_ms"] == \
        port_profiler.parse_trace_dir(
            run_dir, phases=jax_profiler.KNOWN_PHASES)["host_ms"]
    assert cap["host_ms"].get("step_hooks", 0) > 0
    lines = [json.loads(x) for x in open("t.jsonl")]
    assert any(r["kind"] == "profile/capture" for r in lines)
    assert lines[-1]["counters"]["profile/sessions"] == 1
    assert lines[-1]["counters"]["profile/steps"] == 2


def test_profile_triggers(tmp_path):
    """The fleet trigger file (one id replays once), a critical anomaly
    with ``profile_on_anomaly``, and the step funnel's accounting."""
    fleet = str(tmp_path / "fleet")
    sess = obs.install_profiler(port_profiler.ProfileSession(
        profile_dir=str(tmp_path / "p"), steps=1, fleet_dir=fleet,
        poll_s=0.0, capture_on_anomaly=True))
    assert port_profiler.request_profile(fleet, steps=1)["id"] == 1
    assert jax_profiler.request_profile(fleet, steps=1)["id"] == 2
    obs.record_step(1)                  # picks up trigger 2, starts
    obs.record_step(1)                  # ends
    obs.record_step(1)
    assert [c["reason"] for c in sess.captures] == ["trigger:2"]
    port_profiler.on_critical_anomaly({"anomaly": "nonfinite"})
    obs.record_step(1)
    obs.record_step(1)
    assert [c["reason"] for c in sess.captures] == [
        "trigger:2", "anomaly:nonfinite"]
    assert port_profiler.main([fleet, "--steps", "2"]) == 0
    assert json.load(open(os.path.join(
        fleet, port_profiler.TRIGGER_FILENAME)))["id"] == 3
