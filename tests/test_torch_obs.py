"""The port's telemetry plane (``swiftmpi_tpu_torch/obs/``) against the JAX
package's, on the CPU: the registry, the StepRecorder's JSONL lines, the
spans, the crash hooks, the transfer ledger's registry mirror on all four
backends, the other registry writers (faults, health, checkpoints, the
input pipeline, the logger), the repo's own stdlib reader
(``scripts/telemetry_report.py``) over a port word2vec stream, and the
set of series names a tiny word2vec run writes.

The same operations go to both packages; snapshots and JSONL lines must
be equal, masked only where a clock or the process enters (``ts``,
``t``, ``pid``, ``elapsed_s``, histogram sums of timed spans).
"""

import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from swiftmpi_tpu import obs as jax_obs
from swiftmpi_tpu.obs.micro import MicroTelemetry as JaxMicro
from swiftmpi_tpu.obs.recorder import StepRecorder as JaxRecorder
from swiftmpi_tpu.obs.registry import MetricsRegistry as JaxRegistry
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu.utils.profiler import StepTimer as JaxStepTimer
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.obs import catalog
from swiftmpi_tpu_torch.obs import recorder as recorder_mod
from swiftmpi_tpu_torch.obs.micro import MicroTelemetry
from swiftmpi_tpu_torch.obs.recorder import StepRecorder
from swiftmpi_tpu_torch.obs.registry import (MetricsRegistry,
                                             parse_series_key)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import ConfigParser
from swiftmpi_tpu_torch.utils.profiler import StepTimer
from tests.test_torch_window import PACC, _jax_table, _sides, window_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: keys that carry a clock or the process, masked in line comparisons
VOLATILE = ("ts", "t", "pid", "elapsed_s")


@pytest.fixture(autouse=True)
def _fresh_obs():
    """The port's obs globals (registry, recorder, tracer, profiler, crash
    hooks) start and end each test clean; the repo conftest resets the
    JAX package's."""
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _mask(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in VOLATILE}


def _ops(reg):
    """One sequence of instrument writes, run on either package's
    registry."""
    reg.counter("transfer/wire_bytes", backend="tpu").inc(100)
    reg.counter("transfer/wire_bytes", backend="tpu").set_total(50)
    reg.counter("transfer/wire_bytes", backend="tpu").set_total(400)
    reg.counter("faults/step_events").inc()
    reg.gauge("pipeline/queue_depth").set(3)
    h = reg.histogram("phase_ms", phase="render")
    for v in (0.01, 0.2, 3.0, 70.0, 1e6):
        h.observe(v)
    reg.histogram("serve/latency_ms", buckets=(1.0, 2.0, 4.0)).observe(2.5)


@pytest.mark.parametrize("enabled", [True, False])
def test_registry_snapshots_equal_jax(enabled):
    jr, pr = JaxRegistry(enabled=enabled), MetricsRegistry(enabled=enabled)
    _ops(jr)
    _ops(pr)
    assert pr.snapshot() == jr.snapshot()
    assert sorted(pr.series_keys()) == sorted(jr.series_keys())
    for q in (0.5, 0.95, 0.99):
        assert pr.quantile("phase_ms", q, phase="render") == \
            jr.quantile("phase_ms", q, phase="render")
    s0 = jr.snapshot()
    _ops(jr)
    _ops(pr)
    assert MetricsRegistry.delta(s0, pr.snapshot()) == \
        JaxRegistry.delta(s0, jr.snapshot())


@pytest.mark.parametrize("every,ring", [(1, 1024), (3, 2)])
def test_recorder_jsonl_equals_jax(tmp_path, every, ring):
    """The same registry writes and steps through both recorders give the
    same JSONL lines (meta, step, event, summary), masked on the clock
    and the pid, and the same ring."""
    lines = {}
    recs = {}
    for name, Reg, Rec in (("jax", JaxRegistry, JaxRecorder),
                           ("port", MetricsRegistry, StepRecorder)):
        reg = Reg(enabled=True)
        path = str(tmp_path / f"{name}.jsonl")
        rec = Rec(reg, path=path, run="r", ring=ring, every=every,
                  flush_every=2, meta={"cell": "x"})
        rec.add_sampler(lambda r: r.gauge("train/words_per_sec").set(7.0))
        for i in range(7):
            reg.counter("transfer/dispatches", backend="xla").inc(i)
            reg.histogram("phase_ms", phase="dispatch").observe(0.5 * i)
            rec.on_steps(1 + i % 2)
            if i == 3:
                rec.event("numerics/anomaly", {"severity": "warning"})
        rec.close()
        lines[name] = [_mask(json.loads(x)) for x in open(path)]
        recs[name] = [_mask(r) for r in rec.records()]
    assert lines["port"] == lines["jax"]
    assert recs["port"] == recs["jax"]
    assert lines["port"][0]["schema"] == obs.SCHEMA == jax_obs.SCHEMA


def test_micro_telemetry_equals_jax(tmp_path):
    out = {}
    for name, Micro in (("jax", JaxMicro), ("port", MicroTelemetry)):
        path = str(tmp_path / f"{name}.jsonl")
        mt = Micro(path, run="gather_micro")
        mt.cell("gather/cap100_d8", 0.25, gbps=12.5)
        mt.cell("scatter/cap100_d8", 3.0)
        mt.close()
        out[name] = [_mask(json.loads(x)) for x in open(path)]
    assert out["port"] == out["jax"]


def test_span_off_is_the_shared_null_and_on_feeds_phase_ms():
    assert obs.span("dispatch") is obs._NULL_SPAN
    with obs.span("dispatch"):
        pass
    assert obs.get_registry().snapshot()["hists"] == {}
    obs.set_enabled(True)
    for _ in range(3):
        with obs.span("dispatch"):
            torch.ones(4).sum()
    snap = obs.get_registry().snapshot()["hists"]
    assert snap["phase_ms{phase=dispatch}"]["count"] == 3
    with obs.named_scope("apply"):          # a record_function range
        pass


def test_step_timer_equals_jax():
    samples = [0.003, 0.001, 0.002, 0.010, 0.0015]
    pt, jt = StepTimer(), JaxStepTimer()
    pt._times, jt._times = list(samples), list(samples)
    assert pt.summary_ms() == jt.summary_ms()
    pt.start()
    assert pt.stop(torch.zeros(2)) >= 0 and len(pt) == 6


def test_crash_hooks_install_and_reset_removes_them(tmp_path):
    """A crash-flushed recorder installs the atexit flush and the signal
    handlers; ``reset_for_tests`` restores the previous handlers, so no
    test leaves them behind in its worker."""
    before = {s: signal.getsignal(s) for s in recorder_mod._CRASH_SIGNALS}
    obs.set_enabled(True)
    rec = StepRecorder(obs.get_registry(), path=str(tmp_path / "t.jsonl"),
                       crash_flush=True)
    assert recorder_mod._crash_hooks_installed
    assert signal.getsignal(signal.SIGTERM) is \
        recorder_mod._crash_signal_handler
    assert rec in recorder_mod._CRASH_RECORDERS
    recorder_mod._flush_all_recorders()       # the atexit path
    assert rec._closed and json.loads(open(rec.path).readlines()[-1])[
        "kind"] == "summary"
    obs.reset_for_tests()
    assert not recorder_mod._crash_hooks_installed
    assert not list(recorder_mod._CRASH_RECORDERS)
    assert {s: signal.getsignal(s)
            for s in recorder_mod._CRASH_SIGNALS} == before


def test_fleet_dir_stream_and_heartbeats(tmp_path, monkeypatch):
    """``[obs] fleet_dir`` sends one process's stream to
    ``telemetry_r<rank>_p<pid>.jsonl`` with heartbeats; the port's
    FleetCollector and the JAX package's read it alike."""
    from swiftmpi_tpu.obs.collector import FleetCollector as JaxCollector
    monkeypatch.setenv("SMTPU_PROCESS_ID", "3")
    fleet = tmp_path / "fleet"
    cfg = ConfigParser().update({"obs": {"fleet_dir": str(fleet),
                                         "heartbeat_s": 0.001}})
    rec = obs.configure(cfg, run="word2vec")
    assert rec is not None and obs.get_registry().enabled
    for _ in range(3):
        obs.get_registry().counter("transfer/wire_bytes",
                                   backend="xla").inc(10)
        obs.record_step(1)
    rec.close()
    name = obs.stream_filename(3, os.getpid())
    assert os.path.basename(rec.path) == name == f"telemetry_r3_p{os.getpid()}.jsonl"
    kinds = [json.loads(x)["kind"] for x in open(rec.path)]
    assert kinds[0] == "meta" and "heartbeat" in kinds
    assert kinds[-1] == "summary"
    sums = []
    for Coll in (obs.FleetCollector, JaxCollector):
        c = Coll(str(fleet))
        c.poll(final=True)
        sums.append(json.loads(json.dumps(c.summary(), sort_keys=True,
                                          default=str)))
    assert sums[0] == sums[1]
    assert sums[0]


# -- the transfer ledger's registry mirror ---------------------------------

def _registry_backend_sum(reg, key):
    """``transfer/<key>`` summed over the backend labels (the hybrid
    splits its ledger between its own label and its tail's)."""
    total = 0.0
    for skey, c in reg._counters.items():
        name, labels = parse_series_key(skey)
        fam = {"window_fmt": "fmt", "collective": "kind",
               "pull_fmt": "fmt"}
        for f, lab in fam.items():
            if name == "transfer/" + f and key == f"{f}_{labels.get(lab)}":
                total += c.value
        if name == "transfer/" + key:
            total += c.value
    return total


@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_ledger_mirror_equals_traffic(name, devices8):
    """After window pushes (int8-armed, so the decisions, collectives and
    plan counters move) and a pull, the registry equals ``traffic()`` key
    for key, summed over backend labels; and after a registry reset the
    next mirror brings the new registry to the same totals."""
    jtable, ki = _jax_table()
    rng = np.random.default_rng(3)
    _, _, pt, pstate, conv = _sides(name, jtable)
    pt.count_traffic = True
    pt.wire_quant = "int8"
    obs.set_enabled(True)
    for _ in range(2):
        slots, grads, _ = window_batch(ki, rng, W=2, B=64)
        pstate = pt.push_window(pstate, conv(slots),
                                {f: conv(g) for f, g in grads.items()},
                                PACC, mean=True)
    pt.pull(pstate, conv(slots.reshape(-1)), PACC)
    reg = obs.get_registry()
    pt.mirror_traffic(reg)
    tr = pt.traffic()
    assert tr["wire_bytes"] > 0
    for k, v in tr.items():
        assert _registry_backend_sum(reg, k) == v, k
    reg2 = obs.reset_for_tests()
    obs.set_enabled(True)
    pt.mirror_traffic(reg2)
    for k, v in pt.traffic().items():
        assert _registry_backend_sum(reg2, k) == v, k
    names = {parse_series_key(s)[0] for s in reg2.series_keys()}
    assert all(catalog.declared(n) for n in names), names


# -- the other writers -----------------------------------------------------

def test_faults_health_checkpoint_pipeline_write_the_registry(tmp_path):
    from swiftmpi_tpu_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from swiftmpi_tpu_torch.io.pipeline import PrefetchIterator
    from swiftmpi_tpu_torch.testing import faults
    from swiftmpi_tpu_torch.utils.health import check_devices
    from swiftmpi_tpu_torch.utils.timers import Throughput
    obs.set_enabled(True)
    reg = obs.get_registry()
    faults.step_event(0)
    faults.step_event(1)
    assert check_devices(["cpu"], timeout_s=30.0)[0].ok
    m = Word2Vec(config=ConfigParser().update(
        {"word2vec": {"len_vec": 4}}), device="cpu")
    m.build([[1, 2, 3], [2, 3, 4]])
    save_checkpoint(m.table, str(tmp_path / "ck"))
    load_checkpoint(m.table, str(tmp_path / "ck"))
    got, meter = [], Throughput()
    with PrefetchIterator(iter(range(5)), depth=2) as it:
        while True:
            # the consumer's input_wait span is the train loop's stall
            # region, no longer the queue's
            with meter.stalling():
                x = next(it, None)
            if x is None:
                break
            got.append(x)
    assert got == list(range(5))
    snap = reg.snapshot()
    c, h = snap["counters"], snap["hists"]
    assert c["faults/step_events"] == 2
    assert c["health/probe_ok"] == 1 and h["health/probe_ms"]["count"] == 1
    assert c["checkpoint/saves"] == c["checkpoint/restores"] == 1
    assert h["phase_ms{phase=checkpoint_save}"]["count"] == 1
    assert h["phase_ms{phase=checkpoint_restore}"]["count"] == 1
    assert c["pipeline/produced"] == c["pipeline/consumed"] == 5
    assert h["phase_ms{phase=render}"]["count"] == 6        # + the end
    assert h["phase_ms{phase=input_wait}"]["count"] == 6
    names = {parse_series_key(k)[0] for k in reg.series_keys()}
    assert all(catalog.declared(n) for n in names), names


def test_logger_ident_follows_env(monkeypatch):
    from swiftmpi_tpu_torch.utils.logger import _IdentFilter
    import logging
    rec = logging.LogRecord("x", 20, "f", 1, "m", (), None)
    monkeypatch.setenv("SMTPU_PROCESS_ID", "5")
    _IdentFilter().filter(rec)
    assert rec.ident == "r5" == jax_obs.process_ident()
    monkeypatch.delenv("SMTPU_PROCESS_ID")
    _IdentFilter().filter(rec)
    assert rec.ident == f"p{os.getpid()}" == obs.process_ident()


# -- a word2vec stream: the series names and the repo's reader -------------

W2V = {"word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                    "learning_rate": 0.05, "min_sentence_length": 2},
       "server": {"initial_learning_rate": 0.3},
       "worker": {"minibatch": 256, "inner_steps": 2, "telemetry": 1,
                  "telemetry_flush": 1},
       "obs": {"numerics": 1, "trace": 1}}


def _corpus(seed=8, n=30, vocab=50, length=12):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, length)]
            for _ in range(n)]


#: JAX series name -> the port's name for the same series
PORT_SERIES = {"train/device_ms_total": "train/unstalled_ms_total"}


def _names(path):
    out = set()
    for line in open(path):
        rec = json.loads(line)
        for sec in ("counters", "gauges", "hists"):
            out |= {parse_series_key(k)[0] for k in rec.get(sec) or {}}
    return out


@pytest.mark.parametrize("transfer", ["xla", "tpu"])
def test_w2v_series_names_equal_jax(tmp_path, monkeypatch, transfer,
                                    devices8):
    """A tiny word2vec run with telemetry, numerics and the tracer writes
    the same set of series names as the JAX package's for the same
    config, every one of them declared in the port's catalog; the
    stream's schema and run name are JAX's, and the tracer's window
    records do not change what the registry says."""
    monkeypatch.chdir(tmp_path)
    sents = _corpus()
    paths = {}
    for name, Model, Conf in (("jax", JaxWord2Vec, JaxConfig),
                              ("port", Word2Vec, ConfigParser)):
        c = Conf().update(W2V)
        c.set("cluster", "transfer", transfer)
        c.set("cluster", "server_num", 8 if transfer == "tpu" else 1)
        c.set("obs", "trace_dir", str(tmp_path / f"tr_{name}"))
        paths[name] = str(tmp_path / f"{name}.jsonl")
        c.set("worker", "telemetry_path", paths[name])
        kw = {} if name == "jax" else {"device": "cpu"}
        m = Model(config=c, **kw)
        try:
            m.train(sents, niters=2, batch_size=32)
        finally:
            (jax_obs if name == "jax" else obs).uninstall_tracer()
    got, want = _names(paths["port"]), _names(paths["jax"])
    # the port's meter names its wall time less input stall for what it is
    want = {PORT_SERIES.get(n, n) for n in want}
    assert got == want, (got ^ want)
    assert all(catalog.declared(n) for n in got), got
    meta = json.loads(open(paths["port"]).readline())
    assert meta["schema"] == "smtpu-telemetry/1"
    assert meta["run"] == "word2vec"


def test_telemetry_report_reads_a_port_stream(tmp_path, monkeypatch):
    """``scripts/telemetry_report.py`` (stdlib only, run unchanged) reads a
    port word2vec stream: the dispatch phase, the traffic summary and the
    numerics section; ``check_traffic_budget.py`` gates it against
    itself."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "telemetry.jsonl")
    c = ConfigParser().update(W2V)
    c.set("worker", "telemetry_path", path)
    c.set("obs", "trace_dir", str(tmp_path / "tr"))
    m = Word2Vec(config=c, device="cpu")
    try:
        m.train(_corpus(), niters=2, batch_size=32)
    finally:
        obs.uninstall_tracer()
    assert obs.get_recorder() is None
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["kind"] == "meta" and lines[-1]["kind"] == "summary"
    steps = [r for r in lines if r["kind"] == "step"]
    assert sum(r["steps"] for r in steps) == lines[-1]["steps"] \
        == m.train_metrics["steps"]
    tr = m.train_metrics["transfer_traffic"]
    for k in ("wire_bytes", "dispatches", "pull_bytes", "pull_rows"):
        assert lines[-1]["counters"][f"transfer/{k}{{backend=xla}}"] == tr[k]
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import check_traffic_budget
        import telemetry_report
        rep = telemetry_report.report(telemetry_report.load(path))
        assert any(r["phase"] == "dispatch" for r in rep["phases"])
        assert rep["traffic"]["steps"] == lines[-1]["steps"]
        assert check_traffic_budget.main([path, path]) == 0
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    import subprocess
    for flags, want in (([], "dispatch"), (["--numerics"],
                                           "numerics health")):
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts",
                                          "telemetry_report.py"), path,
             *flags], capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert want in r.stdout, r.stdout
