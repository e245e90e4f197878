"""The port's numerics health plane (``swiftmpi_tpu_torch/obs/numerics.py``)
against the JAX package's, on the CPU: the bundle statistics, the
quantization-error accumulator, the anomaly detector and its checkpoint
bytes, one bundle a dispatch in word2vec, a resume that carries the
baselines, and every observation plane (numerics, costs, the tracer)
leaving the tables bit-identical to a run without it.

Tolerances: statistics within ``|a - b| <= 1e-5 + 1e-3 |b|`` (float32
reductions in another order than XLA's); nonfinite counts, the detector's
anomalies and the quant accumulator over the same ``err_sq`` values
exactly; the tables of ON and OFF runs bit for bit.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu import obs as jax_obs
from swiftmpi_tpu.obs import numerics as jnum
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.transfer import api as jax_api
from swiftmpi_tpu.transfer.api import PushSpec as JaxPushSpec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.convert import state_to_numpy
from swiftmpi_tpu_torch.obs import numerics as pnum
from swiftmpi_tpu_torch.obs.registry import MetricsRegistry
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.transfer import api as port_api
from swiftmpi_tpu_torch.transfer.api import PushSpec
from swiftmpi_tpu_torch.utils import ConfigParser
from tests.test_torch_window import (JACC, PACC, _jax_table, _sides,
                                     window_batch)


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _envelope(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-3,
                               atol=1e-5, err_msg=str(what))


def _arrays(seed, shape, poison=True, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape).astype(np.float32)
    if poison:
        a.flat[3] = np.nan
        a.flat[11] = np.inf
        a.flat[-2] = -np.inf
    return a.astype(dtype)


def _t(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_hot", [0, 7])
@pytest.mark.parametrize("bf16", [False, True])
def test_push_and_spec_stats_match_jax(n_hot, bf16):
    dt = jnp.bfloat16 if bf16 else np.float32
    slots = np.random.default_rng(1).integers(-1, 30, 48).astype(np.int32)
    gh = _arrays(2, (48, 8), dtype=dt)
    gv = _arrays(3, (48, 8), poison=False, dtype=dt)
    want = jnum.push_stats(jnp.asarray(slots),
                           {"h": jnp.asarray(gh), "v": jnp.asarray(gv)},
                           n_hot)
    got = pnum.push_stats(torch.from_numpy(slots),
                          {"h": _t(gh), "v": _t(gv)}, n_hot)
    for g, w, what in zip(got, want, ("sq", "sq_hot", "nonfinite")):
        if what == "nonfinite":
            assert int(g) == int(w) == 3
        else:
            _envelope(float(g), float(w), what)
    dense = np.abs(_arrays(4, (30, 8), poison=False))
    jspecs = [JaxPushSpec(jnp.asarray(slots), {"h": jnp.asarray(gh)}),
              JaxPushSpec(None, {"h": jnp.asarray(dense)}, dense=True)]
    pspecs = [PushSpec(torch.from_numpy(slots), {"h": _t(gh)}),
              PushSpec(None, {"h": torch.from_numpy(dense)}, dense=True)]
    want = jnum.spec_stats(jspecs, n_hot)
    got = pnum.spec_stats(pspecs, n_hot)
    _envelope(float(got[0]), float(want[0]), "spec sq")
    _envelope(float(got[1]), float(want[1]), "spec hot")
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("sharded", [False, True])
def test_state_stats_match_jax(sharded):
    """Update and parameter mass over the updated fields and their hot
    planes, the EF residual mass by base field, nonfinite counts; a
    sharded field (a list of shards) sums over its shards."""
    before = {"h": _arrays(5, (32, 4), poison=False),
              "v": _arrays(6, (32, 4), poison=False),
              "h@hot": _arrays(7, (6, 4), poison=False),
              "h@ef": _arrays(8, (32, 4)),
              "h2sum": np.ones((32, 4), np.float32)}
    after = {k: v + 0.25 * _arrays(9 + i, v.shape, poison=False)
             for i, (k, v) in enumerate(before.items())}
    after["v"][2, 1] = np.nan
    after["h@ef"] = before["h@ef"]
    jb = {k: jnp.asarray(v) for k, v in before.items()}
    ja = {k: jnp.asarray(v) for k, v in after.items()}
    want = jnum.state_stats(jb, ja, ("h", "v"))

    def port(x):
        if sharded and not x.shape[0] == 6:
            return [torch.from_numpy(s.copy()) for s in np.split(x, 4)]
        return torch.from_numpy(x.copy())
    got = pnum.state_stats({k: port(v) for k, v in before.items()},
                           {k: port(v) for k, v in after.items()},
                           ("h", "v"))
    _envelope(float(got[0]), float(want[0]), "upd_sq")
    _envelope(float(got[1]), float(want[1]), "par_sq")
    assert set(got[2]) == set(want[2]) == {"h"}
    _envelope(float(got[2]["h"]), float(want[2]["h"]), "ef_mass")
    assert int(got[3]) == int(want[3]) == 4


def _bundle_args(seed):
    rng = np.random.default_rng(seed)
    return {k: float(v) for k, v in zip(
        ("gsq", "gsq_hot", "upd_sq", "par_sq", "loss_sum", "loss_n"),
        np.abs(rng.normal(size=6)) + 0.5)}


def test_collector_sampler_and_quant_accumulator_match_jax():
    """The same bundles and the same ``err_sq`` sequence (NaN, inf, a
    negative, zeros) through both collectors: the same nonfinite and
    quant-error totals (exactly: JAX's float32 value summed in float64)
    and the same sampled series."""
    jc, pc = jnum.NumericsCollector(), pnum.NumericsCollector()
    errs = [0.25, 3.0e-7, float("nan"), 2.5, -1e-9, float("inf"), 0.0,
            1.0 / 3.0, 123.456]
    for e in errs:
        jc._on_quant(np.float32(e))
        pc.quant_tap(torch.tensor(e, dtype=torch.float32))
    pc.quant_tap(np.float32(0.5))                 # the oracle's host path
    jc._on_quant(np.float32(0.5))
    for seed in range(3):
        b = _bundle_args(seed)
        jc._on_bundle(dict(b, nonfinite=seed), {"h": 0.5 * seed})
        pc.stage_traced({k: torch.tensor(v) for k, v in
                         dict(b, nonfinite=seed).items()},
                        {"h": torch.tensor(0.5 * seed)})
    r = pc.read()
    assert r["quant_err"] == jc._quant_err
    assert r["nonfinite"] == jc._nonfinite == 2 + 3
    assert r["bundles"] == jc.bundles == pc.bundles == 3
    jr, pr = jax_obs.MetricsRegistry(True), MetricsRegistry(True)
    jc.sampler(jr)
    pc.sampler(pr)
    js, ps = jr.snapshot(), pr.snapshot()
    assert set(ps["gauges"]) == set(js["gauges"])
    for k, v in js["gauges"].items():
        _envelope(ps["gauges"][k], v, k)
    assert ps["counters"] == js["counters"]


def _detector_run(mod):
    det = mod.AnomalyDetector(alpha=0.2, k=3.0, warmup=4, patience=2)
    fired = []
    det.add_demote_hook(fired.append)
    rng = np.random.default_rng(0)
    reg = MetricsRegistry(True)
    out = []
    for i in range(40):
        v = {"numerics/grad_norm": 1.0 + 0.05 * rng.normal(),
             "numerics/loss": 3.0 - 0.01 * i,
             "numerics/ef_mass{field=h}": 0.1 + (5.0 * i if i > 30 else 0)}
        if i == 20:
            v["numerics/grad_norm"] = 50.0
        if i == 25:
            v["numerics/loss"] = float("nan")
        out += det.on_sample(reg, v, float(i // 10))
    return out, fired, det


def test_detector_anomalies_and_state_bytes_cross_with_jax():
    """The same samples give the same anomalies, severities, evidence and
    demote-hook firing; each package's ``state_bytes`` loads into the
    other's detector and reproduces its state."""
    jout, jfired, jdet = _detector_run(jnum)
    pout, pfired, pdet = _detector_run(pnum)
    # (NaN values: compared through their JSON text)
    assert json.dumps(pout) == json.dumps(jout) and pfired == jfired
    assert any(a["severity"] == "critical" for a in pout)
    assert pfired and pfired[0]["anomaly"] == "ef_residual_runaway"
    assert pdet.state() == jdet.state()
    # load_state restores the baselines, not the knobs (as in JAX)
    knobs = dict(alpha=0.2, k=3.0, warmup=4, patience=2)
    fresh_p = pnum.AnomalyDetector(**knobs)
    fresh_j = jnum.AnomalyDetector(**knobs)
    assert fresh_p.load_state_bytes(jdet.state_bytes())
    assert fresh_j.load_state_bytes(pdet.state_bytes())
    assert fresh_p.state() == jdet.state() == fresh_j.state()
    assert bytes(pdet.state_bytes()) == bytes(jdet.state_bytes())
    assert not fresh_p.load_state_bytes(np.frombuffer(b"\xff\x00", np.uint8))
    assert pnum.cross_rank_divergence({1: {"0": 1.0, "1": 40.0}}) == \
        jnum.cross_rank_divergence({1: {"0": 1.0, "1": 40.0}})


@pytest.mark.parametrize("name", ["xla", "tpu", "hybrid", "local"])
def test_quant_tap_matches_jax_over_windows(name, devices8):
    """``wire_quant: int8`` windows through each backend with the numerics
    tap armed in both packages: the same number of quantized windows and
    quantization-error totals within the envelope."""
    jtable, ki = _jax_table()
    jtable.ensure_ef(("h", "v"))
    rng = np.random.default_rng(11)
    jt, jstate, pt, pstate, conv = _sides(name, jtable)
    for t in (jt, pt):
        t.wire_quant = "int8"
    jcol, pcol = jnum.NumericsCollector(), pnum.NumericsCollector()
    jax_api.set_numerics_tap(jcol.quant_tap)
    port_api.set_numerics_tap(pcol.quant_tap)
    try:
        for _ in range(3):
            slots, grads, _ = window_batch(ki, rng, W=2, B=64)
            jstate = jt.push_window(jstate, slots, grads, JACC, mean=True)
            pstate = pt.push_window(pstate, conv(slots),
                                    {f: conv(g) for f, g in grads.items()},
                                    PACC, mean=True)
    finally:
        jax_api.clear_numerics_tap()
        port_api.clear_numerics_tap()
    jcol.sync()
    r = pcol.read()
    assert jcol._quant_err > 0
    _envelope(r["quant_err"], jcol._quant_err, name)
    assert r["nonfinite"] == jcol._nonfinite == 0


# -- word2vec: one bundle a dispatch, resume, ON vs OFF ----------------------

W2V = {"word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                    "learning_rate": 0.05, "min_sentence_length": 2},
       "server": {"initial_learning_rate": 0.3},
       "worker": {"minibatch": 256, "inner_steps": 3}}


def _corpus(seed=8, n=36, vocab=50, length=12):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, length)]
            for _ in range(n)]


@pytest.mark.parametrize("transfer,window", [("xla", 1), ("tpu", 2)])
def test_one_bundle_a_dispatch_as_jax(tmp_path, monkeypatch, transfer,
                                      window, devices8):
    """A group is one dispatch (one bundle), a lone step another: the
    port stages as many bundles as the JAX package's callbacks deliver,
    windows or not; the sampled loss is finite."""
    monkeypatch.chdir(tmp_path)
    bundles = {}
    for name, Model, Conf in (("jax", JaxWord2Vec, JaxConfig),
                              ("port", Word2Vec, ConfigParser)):
        c = Conf().update(W2V)
        c.set("cluster", "transfer", transfer)
        c.set("cluster", "server_num", 8 if transfer == "tpu" else 1)
        c.set("cluster", "push_window", window)
        c.set("worker", "telemetry", 1)
        c.set("worker", "telemetry_path", str(tmp_path / f"{name}.jsonl"))
        c.set("obs", "numerics", 1)
        m = Model(config=c, **({} if name == "jax" else {"device": "cpu"}))
        m.train(_corpus(), niters=2, batch_size=32)
        bundles[name] = m.train_metrics["numerics"]["bundles"]
    assert bundles["port"] == bundles["jax"] > 0
    last = json.loads(open(tmp_path / "port.jsonl").readlines()[-1])
    assert math.isfinite(last["gauges"]["numerics/loss"])
    assert last["gauges"]["numerics/grad_norm"] > 0
    assert last["gauges"]["numerics/update_ratio"] > 0


def test_resume_carries_the_baseline(tmp_path, monkeypatch):
    """The detector's baselines ride the checkpoint (``extra__numerics``,
    the JAX package's bytes): a fresh model that resumes it arms a
    detector with the saved state, and the JAX package's model loads the
    same bytes."""
    monkeypatch.chdir(tmp_path)
    c = ConfigParser().update(W2V)
    c.set("worker", "telemetry", 1)
    c.set("obs", "numerics", 1)
    c.set("obs", "numerics_warmup", 2)
    sents = _corpus()
    m = Word2Vec(config=c, device="cpu")
    ck = str(tmp_path / "ck")
    m.train(sents, niters=2, batch_size=32, checkpoint_path=ck)
    with np.load(ck + ".npz") as z:
        blob = z["extra__numerics"]
    saved = json.loads(blob.tobytes().decode())
    assert saved["series"]["numerics/grad_norm"][2] >= 2
    # the recorder's close scores one more sample after the last save
    assert m._numerics.detector.state()["series"][
        "numerics/grad_norm"][2] == saved["series"][
            "numerics/grad_norm"][2] + 1
    m2 = Word2Vec(config=c, device="cpu")
    m2.build(sents)
    assert m2.resume(ck) == 2
    det = pnum.detector_from_config(c)
    det.load_state_bytes(m2._numerics_restore)
    assert det.state() == saved
    jdet = jnum.AnomalyDetector(warmup=2)
    assert jdet.load_state_bytes(m2._numerics_restore)
    assert jdet.state() == saved


PLANES = {"numerics": {"worker": {"telemetry": 1},
                       "obs": {"numerics": 1}},
          "costs": {"obs": {"costs": 1, "costs_path": "cat.json"}},
          "trace": {"obs": {"trace": 1, "trace_dir": "tr"}}}


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("transfer", ["xla", "tpu", "hybrid"])
def test_planes_on_are_bit_identical_to_off(tmp_path, monkeypatch, plane,
                                            transfer):
    """Each observation plane on versus every plane off: the same
    losses and the same tables, bit for bit, with groups, windows and
    int8 wire windows on ``tpu``/``hybrid``."""
    monkeypatch.chdir(tmp_path)
    sents = _corpus(n=40)
    runs = []
    for armed in (False, True):
        c = ConfigParser().update(W2V)
        c.set("cluster", "transfer", transfer)
        c.set("cluster", "server_num", 1 if transfer == "xla" else 4)
        if transfer != "xla":
            c.set("cluster", "push_window", 3)
            c.set("cluster", "wire_quant", "int8")
        if armed:
            for sec, kv in PLANES[plane].items():
                for k, v in kv.items():
                    c.set(sec, k, v)
        m = Word2Vec(config=c, device="cpu", seed=3)
        try:
            losses = m.train(sents, niters=2, batch_size=32)
        finally:
            obs.uninstall_tracer()
        runs.append((losses, state_to_numpy(m.table.state), m))
    assert runs[0][0] == runs[1][0]
    assert set(runs[0][1]) == set(runs[1][1])
    for f in runs[0][1]:
        np.testing.assert_array_equal(runs[1][1][f], runs[0][1][f],
                                      err_msg=f)
    on = runs[1][2]
    if plane == "numerics":
        assert on.train_metrics["numerics"]["bundles"] > 0
    if plane == "trace":
        assert on.transfer.count_traffic
