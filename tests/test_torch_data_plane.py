"""``[cluster] data_plane`` and the device-kind verdict store
(``swiftmpi_tpu_torch/ops/calibration.py``).

``data_plane: xla`` runs the JAX package's library routes: the sharded
exchange as the stacked ranks' transpose on ``tpu`` (held against JAX's
``data_plane: xla`` on the 8-device CPU mesh within the repo envelope
``|a - b| <= 1e-5 + 1e-3 |b|``, and bit for bit against the port's B5
route), and the stencil's neu1 as JAX's XLA chain (held against JAX's
``data_plane: xla`` step within the envelope, ``err_cnt`` exact).  The
store: record, lookup, stale and clear as JAX's; the port's default is
the kernel, there is no default store, and ``auto`` takes the library
route only in a process that named a store holding a current verdict
that the library is at least 10% faster than a correct kernel at every
shape its sweep measured.
"""

import json

import numpy as np
import pytest

import jax

from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.ops import calibration as jcal
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.ops import calibration as cal
from swiftmpi_tpu_torch.utils import ConfigParser

from tests import test_torch_sharded as tsh
from tests import test_torch_stencil as tst

CARD = "NVIDIA H100 80GB HBM3"


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A fresh store file as the process default, the memo dropped."""
    path = str(tmp_path / "calibration.json")
    prev = cal.use_store(path)
    cal.reset_cache()
    yield path
    cal.use_store(prev)
    cal.reset_cache()


# -- tpu: the library exchange --------------------------------------------------

def _tpu_models(sents, data_plane, cap=80):
    jc = JaxConfig().update(tsh.CONF)
    pc = ConfigParser().update(tsh.CONF)
    jc.set("cluster", "data_plane", data_plane)
    pc.set("cluster", "data_plane", data_plane)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    return jm, pm


def _replayed(pm, steps):
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(tst._jax_draws(sub, len(pm.vocab), (tsh.B,
                                                         pm.negative)))
    return draws


def test_tpu_library_route_tracks_jax_data_plane_xla(devices8):
    """A 3-step ``train`` on tpu@8 with ``data_plane: xla`` on both sides
    and JAX's draws replayed: losses within 1e-4, tables in the
    envelope, every exchange on the library route."""
    sents = tsh.corpus(n_sent=5, vocab=300, length=12, seed=4)
    jm, pm = _tpu_models(sents, "xla")
    assert pm.data_plane_routes == {"ring_push": "library"}
    want = jm.train(sents, niters=3, batch_size=tsh.B)
    got = pm.train(sents, niters=3, batch_size=tsh.B,
                   draws=iter(_replayed(pm, 3)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))
    assert pm.train_metrics["data_plane"] == {"ring_push": "library"}


def test_tpu_library_route_is_bit_equal_to_the_kernel_route(devices8):
    """The same 3 steps on ``auto`` (B5's route) and on ``xla`` (the
    transpose) from one table: the same losses and tables bit for bit,
    since both routes move the same bits."""
    sents = tsh.corpus(n_sent=5, vocab=300, length=12, seed=4)
    runs = []
    for plane in ("auto", "xla"):
        _, pm = _tpu_models(sents, plane)
        losses = pm.train(sents, niters=3, batch_size=tsh.B,
                          draws=iter(_replayed(pm, 3)))
        runs.append((pm.transfer.exchange_route, losses,
                     state_to_numpy(pm.table.state)))
    (ra, la, ta), (rb, lb, tb) = runs
    assert (ra, rb) == ("kernel", "library")
    assert la == lb
    for f in ta:
        np.testing.assert_array_equal(ta[f], tb[f])


# -- stencil: the XLA chain ----------------------------------------------------

def _stencil_models(sents, data_plane):
    jc = JaxConfig().update(tst.CONF)
    pc = ConfigParser().update(tst.CONF)
    for c in (jc, pc):
        c.set("word2vec", "stencil", 1)
        c.set("cluster", "data_plane", data_plane)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=tst.CAP).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=tst.CAP)
    pm.build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    return jm, pm


@pytest.mark.parametrize("B", [24, 512])
def test_stencil_library_route_matches_jax_step(monkeypatch, B):
    """One stencil step with ``data_plane: xla`` on both sides (JAX's
    XLA chain, no env override) and JAX's draws replayed, full batch and
    padded tail: ``err_cnt`` exact, ``err_sum`` within 1e-5, every table
    field in the envelope."""
    monkeypatch.delenv("SMTPU_STENCIL_FUSED", raising=False)
    sents = tst.corpus(seed=3)
    jm, pm = _stencil_models(sents, "xla")
    assert pm.stencil_route == "library"
    bat = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=13)
    batch = next(iter(bat.epoch_stencil(B)))
    key = jax.random.key(7)
    out, es, ec = tst._jax_step(jm, batch, key)
    got_es, got_ec = pm.step_batch(
        batch, draws=tst._jax_draws(key, len(pm.vocab), (B, pm.negative)))
    assert isinstance(got_ec, int) and got_ec == int(ec)
    np.testing.assert_allclose(got_es, es, rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in got:
        _envelope(got[f], np.asarray(out[f]))


def test_stencil_library_route_trains_like_the_kernel_route():
    """3 epochs of a stencil batch each on ``auto`` (B4) and on ``xla``
    (the chain): the losses within 1e-5 and the tables in the envelope
    (the two sum a context in another order); B4 runs only on the
    kernel route."""
    from swiftmpi_tpu_torch.models import word2vec as w2v
    sents = tst.corpus(n_sent=5, vocab=300, length=12, seed=4)
    calls = []
    orig = w2v.stencil_context_sum

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    runs = []
    for plane in ("auto", "xla"):
        _, pm = _stencil_models(sents, plane)
        key = jax.random.key(0 ^ 0x5EED)
        draws = []
        for _ in range(3):
            key, sub = jax.random.split(key)
            draws.append(tst._jax_draws(sub, len(pm.vocab),
                                        (64, pm.negative)))
        calls.clear()
        w2v.stencil_context_sum = spy
        try:
            losses = pm.train(sents, niters=3, batch_size=64,
                              draws=iter(draws))
        finally:
            w2v.stencil_context_sum = orig
        runs.append((len(calls), losses, state_to_numpy(pm.table.state)))
    (ca, la, ta), (cb, lb, tb) = runs
    assert (ca, cb) == (3, 0)
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    for f in ta:
        _envelope(tb[f], ta[f])


# -- the verdict store ---------------------------------------------------------

def test_record_lookup_stale_and_clear_as_jax(store, capsys):
    """A verdict round-trips under ``name:kind`` with the current stack
    stamped in; one from another stack (or with no stamp) is ignored
    with JAX's loud message, once, and listed by ``stale_keys``; ``clear``
    removes every kind of one name and nothing else."""
    cal.record("ring_push", CARD, {"kernel_ms": 1.0, "library_ms": 2.0})
    v = cal.lookup("ring_push", CARD)
    assert v["kernel_ms"] == 1.0 and v["stack"] == cal.stack_key()
    assert set(v["stack"]) == {"torch", "cuda", "kernels"}
    assert cal.lookup("ring_push", "other card") is None
    assert cal.lookup("vmem_gather", CARD) is None
    old = dict(cal.stack_key(), torch="0.0.0")
    cal.record("vmem_gather", CARD, {"library_win": True, "stack": old})
    cal.record("vmem_scatter", CARD, {"library_win": True,
                                      "stack": "unstamped"})
    assert cal.lookup("vmem_gather", CARD) is None
    assert cal.lookup("vmem_gather", CARD) is None
    err = capsys.readouterr().err
    assert err.count("STALE verdict ignored for vmem_gather") == 1
    assert "torch 0.0.0 ->" in err
    stale = dict(cal.stale_keys())
    assert set(stale) == {f"vmem_gather:{CARD}", f"vmem_scatter:{CARD}"}
    assert "without a stack stamp" in stale[f"vmem_scatter:{CARD}"]
    cal.record("ring_push", "another card", {"kernel_ms": 3.0})
    cal.clear("ring_push")
    data = json.loads(open(store).read())
    assert not [k for k in data if k.startswith("ring_push:")]
    assert f"vmem_gather:{CARD}" in data
    # the memo follows the file; reset_cache drops it
    cal.reset_cache()
    assert cal.lookup("ring_push", CARD) is None


def test_the_default_is_the_kernel(store):
    """No verdict, a kernel win, a tie, a library win by less than 10%
    or from an incorrect kernel: ``auto`` runs the kernel (JAX's default
    is the library route); only a current library win flips it.
    ``pallas`` ignores verdicts, ``xla`` always takes the library."""
    assert cal.gated("ring_push", kind=CARD)
    for kernel_ms, library_ms, correct, want in [
            (1.0, 2.0, True, True), (1.0, 1.0, True, True),
            (1.0, 0.95, True, True), (1.0, 0.5, False, True),
            (1.0, 0.5, True, False)]:
        v = cal.ab_verdict("ring_push", library_ms, kernel_ms, correct,
                           record_it=False)
        cal.record("ring_push", CARD, v)
        assert cal.gated("ring_push", kind=CARD) is want, v
        assert cal.data_plane_gated("auto", "ring_push", kind=CARD) is want
        assert cal.data_plane_gated("pallas", "ring_push", kind=CARD)
        assert not cal.data_plane_gated("xla", "ring_push", kind=CARD)
    with pytest.raises(ValueError, match="data_plane"):
        cal.data_plane_gated("bogus", "ring_push")
    assert cal.DATA_PLANE_MODES == jcal.DATA_PLANE_MODES


def test_ab_verdict_records_only_on_a_card(store, capsys):
    """The verdict's fields and JAX's ``win`` rule (a correct kernel 10%
    faster); off a card nothing is recorded, and an error is a loud
    non-win that leaves the kernel route."""
    v = cal.ab_verdict("stencil_fused", library_ms=0.0236, kernel_ms=0.0080,
                       correct=True, shape="5000x9", device="cpu")
    assert v["win"] and not v["library_win"] and v["shape"] == "5000x9"
    assert not cal.stale_keys() and cal.lookup("stencil_fused",
                                               cal.CPU_KIND) is None
    assert "NOT recorded" in capsys.readouterr().out
    e = cal.ab_verdict("stencil_fused", 1.0, error="nvcc failed",
                       device="cpu")
    assert e == {"win": False, "library_win": False, "error": "nvcc failed",
                 "library_ms": 1.0}
    assert cal.gated("stencil_fused", kind=CARD)
    assert cal.kernel_status(CARD) == "unmeasured-on-card"
    cal.record("ring_push", CARD, cal.ab_verdict(
        "ring_push", 0.28, 0.277, True, record_it=False))
    cal.record("vmem_gather", CARD, cal.ab_verdict(
        "vmem_gather", 0.069, 0.023, True, record_it=False))
    cal.record("adagrad_update", CARD, cal.ab_verdict(
        "adagrad_update", 0.01, 0.06, True, record_it=False))
    assert cal.kernel_status(CARD) == ("measured: kernel wins (B2); "
                                       "library wins (B1)")


def test_a_sweep_verdict_holds_at_every_shape(store):
    """A sweep's verdict over several shapes: the library wins only
    where it is at least 10% faster at each of them (one shape where the
    kernel holds keeps ``auto`` on the kernel), and likewise the kernel's
    ``win``; the shapes and times are kept unrounded."""
    mixed = cal.ab_verdict("ring_push", [0.05, 0.40, 0.90],
                           [0.10, 0.30, 1.00], True,
                           shape=["8x8x10x100", "8x8x10x101", "8x8x10"],
                           record_it=False)
    assert not mixed["library_win"] and not mixed["win"]
    assert mixed["shape"] == ["8x8x10x100", "8x8x10x101", "8x8x10"]
    cal.record("ring_push", CARD, mixed)
    assert cal.gated("ring_push", kind=CARD)
    every = cal.ab_verdict("ring_push", [0.05, 0.20], [0.10, 0.3000001],
                           True, record_it=False)
    assert every["library_win"] and every["kernel_ms"] == [0.10, 0.3000001]
    cal.record("ring_push", CARD, every)
    assert not cal.gated("ring_push", kind=CARD)
    assert cal.ab_verdict("ring_push", [1.0, 1.0], [0.5, 0.8], True,
                          record_it=False)["win"]
    with pytest.raises(ValueError, match="kernel times"):
        cal.ab_verdict("ring_push", [1.0, 1.0], [0.5], True,
                       record_it=False)


def test_no_store_is_read_or_written_unless_named(tmp_path, monkeypatch,
                                                  capsys):
    """There is no default store: a process that names none reads no
    verdict (a library win in a file it did not name leaves ``auto`` on
    the kernel), records nothing from a card's sweep, and refuses a bare
    ``record``; ``use_store`` names one, and ``None`` forgets it."""
    path = str(tmp_path / "calibration.json")
    cal.reset_cache()
    assert cal.use_store(None) is None
    monkeypatch.setattr(cal, "device_key", lambda device=None: CARD)
    lib = cal.ab_verdict("ring_push", 0.5, 1.0, True)
    assert "NOT recorded" in capsys.readouterr().out
    cal.record("ring_push", CARD, lib, path=path)
    assert cal.lookup("ring_push", CARD) is None
    assert cal.gated("ring_push", kind=CARD)
    assert cal.route("auto", "ring_push") == "kernel"
    with pytest.raises(ValueError, match="no verdict store named"):
        cal.record("ring_push", CARD, lib)
    with pytest.raises(ValueError, match="no verdict store named"):
        cal.clear("ring_push")
    assert cal.main(["--stale-check"]) == 0
    assert "no verdict store named" in capsys.readouterr().out
    try:
        assert cal.use_store(path) is None
        assert cal.lookup("ring_push", CARD)["library_win"]
        assert not cal.gated("ring_push", kind=CARD)
    finally:
        assert cal.use_store(None) == path
        cal.reset_cache()


def test_auto_follows_a_planted_library_verdict(store, monkeypatch):
    """On a card (its kind stood in for here), ``auto`` takes the
    library route of the stencil and of the exchange when a current
    verdict records the library at least 10% faster, and the kernel
    when the verdict comes from another stack; ``pallas`` keeps the
    kernel either way.  A route a verdict turns is logged as a warning
    that names the store."""
    import logging
    monkeypatch.setattr(cal, "device_key", lambda device=None: CARD)
    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger("swiftmpi_tpu_torch.ops.calibration").addHandler(
        handler)
    lib = cal.ab_verdict("x", 0.5, 1.0, True, record_it=False)
    for name in ("stencil_fused", "ring_push"):
        cal.record(name, CARD, lib)

    def routes(plane, **w2v):
        c = ConfigParser().update(tsh.CONF)
        c.set("cluster", "data_plane", plane)
        for k, v in w2v.items():
            c.set("word2vec", k, v)
        if w2v.get("stencil"):
            c.set("cluster", "transfer", "xla")
            c.set("cluster", "server_num", 1)
        return Word2Vec(config=c, device="cpu").data_plane_routes

    try:
        assert routes("auto") == {"ring_push": "library"}
        assert routes("auto", stencil=1) == {"stencil_fused": "library"}
        assert routes("pallas") == {"ring_push": "kernel"}
    finally:
        logging.getLogger("swiftmpi_tpu_torch.ops.calibration"
                          ).removeHandler(handler)
    assert len(warned) == 2 and all(store in w for w in warned)
    assert "ring_push runs the library route" in warned[0]
    stale = dict(lib, stack=dict(cal.stack_key(), cuda="0.0"))
    for name in ("stencil_fused", "ring_push"):
        cal.record(name, CARD, stale)
    assert routes("auto") == {"ring_push": "kernel"}
    assert routes("auto", stencil=1) == {"stencil_fused": "kernel"}


def test_cpu_auto_reads_no_verdict_and_the_route_is_logged_once(store):
    """A CPU model runs the plain versions whatever a store says, and the
    route is logged once a process for each (kernel, mode, route)."""
    import logging
    cal.record("ring_push", CARD, cal.ab_verdict("x", 0.5, 1.0, True,
                                                 record_it=False))
    cal.record("ring_push", cal.CPU_KIND, {"library_win": True})
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    log = logging.getLogger("swiftmpi_tpu_torch.ops.calibration")
    log.addHandler(handler)
    try:
        assert cal.route("auto", "ring_push", "cpu") == "kernel"
        assert cal.route("auto", "ring_push", "cpu") == "kernel"
        assert cal.route("xla", "ring_push", "cpu") == "library"
    finally:
        log.removeHandler(handler)
    assert seen == ["data_plane auto: ring_push runs the kernel route "
                    "(cpu)", "data_plane xla: ring_push runs the library "
                    "route (cpu)"]


def test_stale_check_cli(store, capsys):
    """``--stale-check`` is advisory (exit 0) and ``=strict`` a gate
    (exit 1) on a stale verdict; a store of current verdicts passes
    both; a missing file is no error."""
    assert cal.main(["--stale-check", "--path", store + ".none"]) == 0
    assert "no verdict file" in capsys.readouterr().out
    cal.record("ring_push", CARD, {"kernel_ms": 1.0, "library_ms": 1.1})
    assert cal.main(["--stale-check=strict"]) == 0
    assert "1 verdict(s)" in capsys.readouterr().out
    cal.record("vmem_gather", CARD, {"stack": {"torch": "0"}})
    cal.reset_cache()
    assert cal.main(["--stale-check"]) == 0
    out = capsys.readouterr().out
    assert "ADVISORY: 1/2" in out and f"vmem_gather:{CARD}" in out
    assert cal.main(["--stale-check=strict", "--path", store]) == 1
    assert "GATE" in capsys.readouterr().out
    assert cal.main(["--stale-check", "--path"]) == 2
