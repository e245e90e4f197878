"""The port's wire tracer (``swiftmpi_tpu_torch/obs/trace.py`` and its taps
in ``transfer/api.py``) against the JAX package's, on the CPU: the same
taps give the same records (apart from the clock), window pushes on all
four backends give records whose encoded bytes are the ledger's
``wire_bytes`` and the same records JAX's backends give, and the flight
recorder keeps its ring bound, replays a trigger file once and dumps on
a crash.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from swiftmpi_tpu import obs as jax_obs
from swiftmpi_tpu.obs import trace as jax_trace
from swiftmpi_tpu.transfer import plan as jax_plan
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.obs import trace as port_trace
from swiftmpi_tpu_torch.transfer import plan as port_plan
from tests.test_torch_window import (JACC, PACC, _jax_table, _sides,
                                     window_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: record keys that carry a clock (or a host-timing lift)
VOLATILE = ("t", "ts", "phase_ms", "pid")


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_for_tests()
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()
    yield
    obs.reset_for_tests()
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()


def _mask(rec):
    return {k: v for k, v in rec.items() if k not in VOLATILE}


def _feed(tr, backend="tpu"):
    """One fixed tap sequence: a priced sparse_q window with EF mass and
    keys, a dense window, a per-step exchange (no record), a bitmap
    window, steps in between."""
    tr.on_decision(backend, "sparse_q", {"dense": 4096.0, "sparse": 900.0,
                                         "sparse_q": 300.0}, 128, 64, 36,
                   quant="int8")
    tr.on_decision(backend, "dense", {"dense": 100.0}, 128, 64, 36)
    tr.stage_ef(backend, 1.5, 0.25)
    tr.stage_keys(backend, np.array([3, -1, 9, 12]), np.array([2, 1]))
    tr.on_window(backend, "sparse_q", 128, 40)
    tr.on_exchange(backend, 40, 21, base_bytes=0)
    tr.on_step(2)
    tr.on_exchange(backend, 10, 36)
    tr.on_exchange(backend, 64, 32, decision="dense")
    tr.on_step(2)
    tr.stage(backend, hot_rows=5, hot_collective="psum")
    tr.on_window(backend, "bitmap", 100, 30)
    tr.on_exchange(backend, 30, 36, base_bytes=8)
    tr.on_step(1)


def test_records_and_dump_equal_jax_for_the_same_taps(tmp_path):
    recs, dumps = {}, {}
    for name, mod in (("jax", jax_trace), ("port", port_trace)):
        tr = mod.WindowTracer(trace_dir=str(tmp_path / name), ring=8,
                              keys=4, topk=3)
        _feed(tr)
        recs[name] = [_mask(r) for r in tr.records()]
        path = tr.dump(reason="manual")
        dumps[name] = [_mask(json.loads(x)) for x in open(path)]
        assert tr.hot_keys() == (recs.setdefault(name + "_hot",
                                                 tr.hot_keys()))
    assert recs["port"] == recs["jax"]
    assert recs["port_hot"] == recs["jax_hot"]
    assert dumps["port"] == dumps["jax"]
    r = recs["port"]
    assert [x["decision"] for x in r] == ["sparse_q", "dense", "bitmap"]
    assert r[0]["enc_bytes"] == 40 * 21 and r[0]["ef_drained"] == 1.5
    assert r[0]["shard_bytes"] == [2 * 21, 1 * 21]
    assert r[2]["hot_rows"] == 5 and r[2]["base_bytes"] == 8


def test_ring_bound_and_sampling():
    tr = port_trace.WindowTracer(ring=16, sample=3, keys=0)
    for i in range(3000):
        tr.on_window("xla", "sparse", 10, 5)
        tr.on_exchange("xla", 5, 36)
    assert len(tr.records()) == 16 and tr.window_id == 3000
    wins = [r["win"] for r in tr.records()]
    assert wins == sorted(wins) and all(w % 3 == 0 for w in wins)
    with pytest.raises(ValueError):
        port_trace.WindowTracer(ring=0)


def test_trigger_file_replays_once(tmp_path):
    fleet = str(tmp_path / "fleet")
    tr = port_trace.WindowTracer(trace_dir=str(tmp_path / "tr"),
                                 fleet_dir=fleet, poll_s=0.0)
    tr.on_window("xla", "sparse", 10, 5)
    tr.on_exchange("xla", 5, 36)
    req = port_trace.request_trace(fleet)
    assert req["id"] == 1
    assert jax_trace.request_trace(fleet)["id"] == 2   # one file format
    tr.on_step(1)
    tr.on_step(1)
    assert len(tr.dumps) == 1
    meta = json.loads(open(tr.dumps[0]).readline())
    assert meta["reason"] == "trigger:2" and meta["records"] == 1
    port_trace.request_trace(fleet)
    tr.on_step(1)
    assert len(tr.dumps) == 2


def test_crash_dump_on_sigterm(tmp_path):
    """A SIGTERM-killed traced process leaves a ``reason=crash`` dump of
    its ring (the recorder module's signal hook); it still dies of the
    signal."""
    code = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {ROOT!r})
        from swiftmpi_tpu_torch import obs
        from swiftmpi_tpu_torch.obs.trace import WindowTracer
        tr = obs.install_tracer(WindowTracer(trace_dir={str(tmp_path)!r}))
        for i in range(5):
            tr.on_window("tpu", "sparse", 10, 4)
            tr.on_exchange("tpu", 4, 36)
        os.kill(os.getpid(), signal.SIGTERM)
        """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == -signal.SIGTERM, r.stderr
    dumps = [p for p in os.listdir(tmp_path) if p.startswith("trace_r0_p")]
    assert len(dumps) == 1
    lines = [json.loads(x) for x in open(tmp_path / dumps[0])]
    assert lines[0]["reason"] == "crash" and len(lines) == 6
    # a clean uninstall dumps nothing
    tr = obs.install_tracer(port_trace.WindowTracer(
        trace_dir=str(tmp_path / "clean")))
    tr.on_window("tpu", "sparse", 10, 4)
    obs.uninstall_tracer()
    obs.reset_for_tests()
    assert not os.path.exists(tmp_path / "clean")


@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_records_match_wire_ledger_and_jax(name, devices8, tmp_path):
    """int8-armed window pushes with a tracer installed in both packages:
    one record per window decision, the records' encoded bytes the
    ledger's ``wire_bytes`` (the hybrid's head push books more), the
    dedup rows the ledger's ``coalesced_rows_*``, and the records equal
    JAX's apart from the clock."""
    ptr = obs.install_tracer(port_trace.WindowTracer(
        trace_dir=str(tmp_path / "p"), keys=8), crash_flush=False)
    jtr = jax_obs.install_tracer(jax_trace.WindowTracer(
        trace_dir=str(tmp_path / "j"), keys=8), crash_flush=False)
    jtable, ki = _jax_table()
    jtable.ensure_ef(("h", "v"))
    rng = np.random.default_rng(7)
    jt, jstate, pt, pstate, conv = _sides(name, jtable)
    for t in (jt, pt):
        t.count_traffic = True
        t.wire_quant = "int8"
    try:
        for _ in range(3):
            slots, grads, _ = window_batch(ki, rng, W=2, B=64)
            jstate = jt.push_window(jstate, slots, grads, JACC, mean=True)
            pstate = pt.push_window(pstate, conv(slots),
                                    {f: conv(g) for f, g in grads.items()},
                                    PACC, mean=True)
            obs.record_step(2)
            jax_obs.record_step(2)
        traffic = pt.traffic()
        jt.traffic()
    finally:
        obs.uninstall_tracer()
        jax_obs.uninstall_tracer()
    recs = ptr.records()
    assert recs
    fmt = {}
    for r in recs:
        fmt[r["decision"]] = fmt.get(r["decision"], 0) + 1
        assert "prices" in r and r["exchanges"] >= 1
    ledger = {"dense": traffic["window_fmt_dense"],
              "sparse": traffic["window_fmt_sparse"],
              "sparse_q": traffic["window_fmt_q"],
              "bitmap": traffic["window_fmt_bitmap"]}
    assert fmt == {k: v for k, v in ledger.items() if v}
    enc = sum(r["enc_bytes"] for r in recs)
    if name == "hybrid":
        assert all(r["backend"] == "tpu" for r in recs)
        assert 0 < enc <= traffic["wire_bytes"]
    else:
        assert enc == traffic["wire_bytes"]
    deduped = [r for r in recs if r["decision"] != "dense"]
    if deduped and name != "hybrid":
        assert sum(r["rows_in"] for r in deduped) \
            == traffic["coalesced_rows_in"]
        assert sum(r["rows_out"] for r in deduped) \
            == traffic["coalesced_rows_out"]
    got = [_mask(r) for r in recs]
    want = [_mask(r) for r in jtr.records()]
    for g, w in zip(got, want):
        for k in ("ef_drained", "ef_rebanked"):     # float sums
            if k in w:
                np.testing.assert_allclose(g.pop(k), w.pop(k), rtol=1e-4,
                                           atol=1e-5)
    assert got == want
