"""The port's failure recovery (``swiftmpi_tpu_torch/io/resilience.py``,
``testing/faults.py``, ``utils/health.py``) against the JAX package's, on
the CPU, at the sizes of ``tests/test_resilience.py``.

Resume parity: the JAX package trains with a checkpoint every iteration;
the port resumes from its npz after two and trains the third with JAX's
batch and draws replayed, landing inside the repo's envelope ``|a - b|
<= 1e-5 + 1e-3 * |b|`` of JAX's third iteration with ``err_cnt`` exact.
Fault plans cross as JSON, corrupt the same bytes, and drive the chaos
cases through ``train_with_resume``: a crash, an exhausted restart budget,
a continued checkpoint, a crash before the first checkpoint, a corrupted
latest checkpoint that falls back a generation, and the hang watchdog
(its deadline a few times a tiny epoch, the injected stall a few times
the deadline).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from swiftmpi_tpu.io.resilience import \
    load_checkpoint_elastic as jax_elastic
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.testing import faults as jax_faults
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher, synthetic_corpus
from swiftmpi_tpu_torch.io.checkpoint import (load_checkpoint, npz_path,
                                              save_checkpoint)
from swiftmpi_tpu_torch.io.resilience import (load_checkpoint_elastic,
                                              train_with_resume)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.testing.faults import (Fault, FaultPlan,
                                               InjectedFault,
                                               corrupt_file_bytes)
from swiftmpi_tpu_torch.utils import ConfigParser
from swiftmpi_tpu_torch.utils import health
from swiftmpi_tpu_torch.utils.health import (DeviceHangError, all_healthy,
                                             check_devices)

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                 "learning_rate": 0.05},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 128},
}


@pytest.fixture(autouse=True)
def _clean_fault_bus():
    """No fault plan may leak between tests (each bus is process-wide)."""
    yield
    faults.clear()
    jax_faults.clear()


def _model(**kw) -> Word2Vec:
    return Word2Vec(config=ConfigParser().update(CONF), device="cpu", **kw)


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


# -- resume parity ------------------------------------------------------------

def test_port_resumes_a_jax_checkpoint_and_trains_like_jax(tmp_path):
    """JAX trains three iterations of one batch each, a checkpoint after
    every one; the port resumes from the one after iteration 2 and trains
    iteration 3 on JAX's third batch with JAX's third draws: every field
    within the envelope of JAX's final table, the loss within 1e-4 and
    ``err_cnt`` equal to JAX's step on the same state."""
    rng = np.random.default_rng(4)
    sents = [list(map(int, rng.integers(1, 300, 12))) for _ in range(5)]
    B, cap = 64, 600
    ck = str(tmp_path / "ck")
    jc = JaxConfig().update(CONF)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap)
    want = jm.train(sents, niters=3, batch_size=B, checkpoint_path=ck,
                    checkpoint_every=1, checkpoint_retain=3)
    after2 = str(tmp_path / "ck.g2.npz")
    pm = _model(capacity_per_shard=cap).build(sents)
    assert pm.resume(after2) == 2
    V, K = len(pm.vocab), pm.negative
    key = jax.random.key(0 ^ 0x5EED)          # Word2Vec(seed=0)'s stream
    for _ in range(3):
        key, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    draws = (np.array(jax.random.randint(k1, (B, K), 0, V)),
             np.array(jax.random.uniform(k2, (B, K))))
    batcher = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=2008)
    epochs = [list(batcher.epoch(B)) for _ in range(3)]
    assert len(epochs[2]) == 1
    third = SimpleNamespace(epoch=lambda batch_size: iter(epochs[2]))
    got = pm.train(batcher=third, niters=1, batch_size=B,
                   draws=iter([draws]), start_iter=2)
    np.testing.assert_allclose(got[0], want[2], rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))
    # JAX's own step from the same checkpoint: its err_cnt
    jm2 = JaxWord2Vec(config=JaxConfig().update(CONF),
                      capacity_per_shard=cap).build(sents)
    jm2.resume(after2)
    b = epochs[2][0]
    _, _, ec = jm2._build_step()(
        jm2.table.state, jm2._slot_of_vocab, jm2._alias_prob,
        jm2._alias_idx, jax.numpy.asarray(b.centers),
        jax.numpy.asarray(b.contexts), jax.numpy.asarray(b.ctx_mask), sub)
    assert round(pm.train_metrics["epoch_err"][0][1]) == int(ec)


def test_train_reports_every_iteration_and_save_to_the_bus(tmp_path):
    """``step_event(start_iter + it)`` at the top of each iteration, a
    checkpoint every ``checkpoint_every`` iterations with ``extra__iter``
    cumulative, and ``checkpoint_event`` right after each save."""
    seen = []
    faults.add_observer(lambda ev, payload: seen.append((ev, payload)))
    m = _model()
    ck = str(tmp_path / "ck")
    m.train(synthetic_corpus(20, 30, 10, seed=8), niters=4, batch_size=64,
            checkpoint_path=ck, checkpoint_every=2, start_iter=5)
    path = npz_path(ck)
    assert seen == [("step", 5), ("step", 6), ("checkpoint", path),
                    ("step", 7), ("step", 8), ("checkpoint", path)]
    with np.load(path) as z:
        assert int(z["extra__iter"]) == 9


def test_nan_fault_poisons_row_zero_as_jax_does():
    """``nan_at_step(1)``: the iteration-1 top sets row 0 of h to NaN, in
    place; the loss of that iteration is NaN on both sides."""
    sents = synthetic_corpus(20, 30, 10, seed=8)
    jax_faults.install(jax_faults.FaultPlan().nan_at_step(1))
    jl = JaxWord2Vec(config=JaxConfig().update(CONF)).train(
        sents, niters=2, batch_size=64)
    faults.install(FaultPlan().nan_at_step(1))
    m = _model()
    pl = m.train(sents, niters=2, batch_size=64)
    assert np.isfinite(pl[0]) and np.isfinite(jl[0])
    assert np.isnan(pl[1]) and np.isnan(jl[1])
    assert torch.isnan(m.table.state["h"][0]).all()
    assert not faults.consume_nan()


# -- fault plans ----------------------------------------------------------------

def test_fault_plan_json_crosses_both_packages(tmp_path):
    marker = str(tmp_path / "m")
    plan = (FaultPlan()
            .crash_at_step(3, rank=1, times=2)
            .hang_at_step(5, seconds=7.5)
            .corrupt_checkpoint(at_save=2, nbytes=8, offset=100)
            .kill_rank(0, at_step=4, signum=15, marker=marker)
            .nan_at_step(6))
    jplan = (jax_faults.FaultPlan()
             .crash_at_step(3, rank=1, times=2)
             .hang_at_step(5, seconds=7.5)
             .corrupt_checkpoint(at_save=2, nbytes=8, offset=100)
             .kill_rank(0, at_step=4, signum=15, marker=marker)
             .nan_at_step(6))
    assert json.loads(plan.to_json()) == json.loads(jplan.to_json())
    back = FaultPlan.from_json(jplan.to_json())
    assert back.to_json() == plan.to_json()
    assert jax_faults.FaultPlan.from_json(plan.to_json()).to_json() \
        == jplan.to_json()


def test_fault_plan_activates_from_env(monkeypatch):
    monkeypatch.setenv(faults.ENV_FAULT_PLAN,
                       FaultPlan().crash_at_step(9).to_json())
    faults.clear()
    plan = faults.active()
    assert plan is not None
    assert plan.faults[0].kind == "crash" and plan.faults[0].step == 9
    with pytest.raises(InjectedFault):
        faults.step_event(9)
    faults.step_event(9)               # fired once


def test_fault_rank_filter_and_marker(tmp_path, monkeypatch):
    marker = str(tmp_path / "fired")
    plan = FaultPlan().crash_at_step(1, rank=1, marker=marker)
    plan.on_step(1)                   # rank 0: no fire
    monkeypatch.setenv("SMTPU_PROCESS_ID", "1")
    with pytest.raises(InjectedFault):
        plan.on_step(1)
    assert os.path.exists(marker)
    FaultPlan.from_json(plan.to_json()).on_step(1)   # a restart: quiet


@pytest.mark.parametrize("nbytes,offset", [(4, 10), (16, None), (9, 60)])
def test_corrupt_file_bytes_flips_the_bytes_jax_flips(tmp_path, nbytes,
                                                      offset):
    data = bytes(range(64))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for p in (a, b):
        with open(p, "wb") as f:
            f.write(data)
    assert corrupt_file_bytes(a, nbytes, offset) == \
        jax_faults.corrupt_file_bytes(b, nbytes, offset)
    assert open(a, "rb").read() == open(b, "rb").read() != data


# -- train_with_resume -----------------------------------------------------------

class FlakyBatcher:
    """A CBOWBatcher that raises partway through a chosen epoch."""

    def __init__(self, inner, fail_on_epoch):
        self.inner, self.fail_on_epoch, self.epoch_i = inner, fail_on_epoch, 0

    def epoch(self, batch_size):
        self.epoch_i += 1
        for i, b in enumerate(self.inner.epoch(batch_size)):
            if self.epoch_i == self.fail_on_epoch and i == 1:
                raise RuntimeError("injected device failure")
            yield b


def test_train_with_resume_recovers_from_crash(tmp_path):
    corpus = synthetic_corpus(30, 50, 12, seed=6)
    m = _model().build(corpus)
    flaky = FlakyBatcher(CBOWBatcher(corpus, m.vocab, m.window),
                         fail_on_epoch=3)
    losses = train_with_resume(m, niters=5, checkpoint_path=str(
        tmp_path / "ck"), checkpoint_every=1, max_restarts=2, batcher=flaky,
        batch_size=64)
    # the crash in epoch 3 rewinds to the checkpoint after iteration 2
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_train_with_resume_gives_up_after_max_restarts(tmp_path):
    m = _model().build(synthetic_corpus(10, 20, 10, seed=7))

    class AlwaysFails:
        def epoch(self, batch_size):
            raise RuntimeError("dead on arrival")
            yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="dead on arrival"):
        train_with_resume(m, niters=2, checkpoint_path=str(tmp_path / "ck"),
                          max_restarts=1, batcher=AlwaysFails())


def test_chaos_restart_budget_exhaustion_raises(tmp_path):
    corpus = synthetic_corpus(10, 20, 10, seed=7)
    m = _model().build(corpus)
    with pytest.raises(InjectedFault):
        train_with_resume(m, corpus, niters=3,
                          checkpoint_path=str(tmp_path / "ck"),
                          checkpoint_every=1, max_restarts=1,
                          fault_plan=FaultPlan().crash_at_step(1, times=100),
                          batch_size=64)
    assert faults.active() is None       # the plan is uninstalled


def test_train_with_resume_continues_existing_checkpoint(tmp_path):
    corpus = synthetic_corpus(20, 30, 10, seed=8)
    ck = str(tmp_path / "cont_ck")
    _model().train(corpus, niters=2, batch_size=64, checkpoint_path=ck,
                   checkpoint_every=1)
    m2 = _model().build(corpus)
    losses = train_with_resume(m2, corpus, niters=5, checkpoint_path=ck,
                               checkpoint_every=1, batch_size=64)
    assert len(losses) == 3
    assert train_with_resume(m2, corpus, niters=5, checkpoint_path=ck,
                             checkpoint_every=1, batch_size=64) == []


def test_train_with_resume_crash_before_first_checkpoint(tmp_path):
    """A crash before any periodic checkpoint rewinds to the iteration-0
    snapshot: the rerun starts from the initial table."""
    corpus = synthetic_corpus(30, 50, 12, seed=10)
    m = _model().build(corpus)
    start = {f: t.clone() for f, t in m.table.state.items()}
    flaky = FlakyBatcher(CBOWBatcher(corpus, m.vocab, m.window),
                         fail_on_epoch=1)
    ck = str(tmp_path / "ck0")
    losses = train_with_resume(m, niters=2, checkpoint_path=ck,
                               checkpoint_every=10, max_restarts=1,
                               batcher=flaky, batch_size=64, retain=1)
    assert len(losses) == 2
    snap = _model().build(corpus)
    assert snap.resume(ck) == 0
    for f, t in start.items():
        assert torch.equal(snap.table.state[f], t)


def test_chaos_crash_and_corrupt_resume_to_uninterrupted_loss(tmp_path):
    """A crash at step 3 with the third save corrupted: the run restarts
    from the iteration-2 generation (4 iterations rerun) and lands within
    20% of the uninterrupted run's last loss."""
    corpus = synthetic_corpus(30, 50, 12, seed=6)
    clean = _model().build(corpus)
    clean_losses = clean.train(corpus, niters=6, batch_size=64)
    m = _model().build(corpus)
    losses = train_with_resume(
        m, corpus, niters=6, checkpoint_path=str(tmp_path / "ck"),
        checkpoint_every=1, max_restarts=2, retain=3,
        fault_plan=FaultPlan().crash_at_step(3).corrupt_checkpoint(
            at_save=3), batch_size=64)
    assert len(losses) == 4
    assert abs(losses[-1] - clean_losses[-1]) / abs(clean_losses[-1]) < 0.2
    assert losses[-1] < clean_losses[0]


def test_chaos_hang_watchdog_recovers(tmp_path):
    """A 1.5 s stall at step 2 against a 0.5 s deadline (an epoch here
    takes milliseconds): the watchdog trips, the cancelled attempt stops
    at its next step event, and training restarts from the last
    checkpoint: 1-2 iterations rerun, never all 4."""
    corpus = synthetic_corpus(20, 30, 10, seed=9)
    m = _model().build(corpus)
    losses = train_with_resume(
        m, corpus, niters=4, checkpoint_path=str(tmp_path / "ck"),
        checkpoint_every=1, max_restarts=2, retain=2,
        fault_plan=FaultPlan().hang_at_step(2, seconds=1.5),
        hang_timeout_s=0.5, probe_timeout_s=5.0, batch_size=64)
    assert 1 <= len(losses) <= 2 and np.isfinite(losses).all()


def test_hang_budget_exhaustion_raises(tmp_path):
    """A stall at every step event trips the watchdog on every attempt
    and exhausts the budget with ``DeviceHangError``."""
    corpus = synthetic_corpus(10, 20, 10, seed=11)
    m = _model().build(corpus)
    with pytest.raises(DeviceHangError):
        train_with_resume(
            m, corpus, niters=3, checkpoint_path=str(tmp_path / "ck"),
            checkpoint_every=1, max_restarts=1,
            fault_plan=FaultPlan([Fault("hang", seconds=0.6,
                                        max_fires=100)]),
            hang_timeout_s=0.2, batch_size=64)


# -- elastic reshard and health ---------------------------------------------------

def test_elastic_reshard_8_to_4_matches_jax(tmp_path):
    """A checkpoint of 8 shards restores into 4 (the port's and the JAX
    package's elastic loads from one file): the same key -> slot map and
    the same rows, AdaGrad sums included, behind every key."""
    t8 = SparseTable(w2v_access(0.3, 8), KeyIndex(8, 32), "cpu",
                     mesh=ps_mesh(8, ["cpu"]))
    keys = np.arange(100, 160, dtype=np.uint64)
    slots = t8.key_index.lookup(keys)
    t8.write_rows("h", slots, torch.arange(60 * 8.).reshape(60, 8))
    t8.write_rows("h2sum", slots, torch.full((60, 8), 7.0))
    path = str(tmp_path / "ck")
    save_checkpoint(t8, path, extra={"iter": np.int64(3)})
    t4 = SparseTable(w2v_access(0.3, 8), KeyIndex(4, 64), "cpu",
                     mesh=ps_mesh(4, ["cpu"]), seed=1)
    j4 = JaxSparseTable(jax_w2v_access(0.3, 8), JaxKeyIndex(4, 64), seed=1)
    with pytest.raises(ValueError):
        load_checkpoint(t4, path)
    assert int(load_checkpoint_elastic(t4, path)["iter"]) == 3
    assert int(jax_elastic(j4, path)["iter"]) == 3
    assert dict(t4.key_index.items()) == dict(j4.key_index.items())
    got = t4.to_numpy()
    new = np.array([t4.key_index.slot(k) for k in keys.tolist()])
    for f, a in j4.state.items():
        np.testing.assert_array_equal(got[f][new], np.asarray(a)[new])
    np.testing.assert_array_equal(got["h2sum"][new], 7.0)


def test_device_health(monkeypatch):
    """The probe on the CPU when named; no CUDA device and no list means
    nothing to probe; a failing or hung probe is reported unhealthy, the
    hung one within the deadline."""
    assert check_devices([]) == [] and all_healthy([])
    report = check_devices(["cpu"], timeout_s=30)
    assert len(report) == 1 and report[0].ok and report[0].latency_s >= 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert check_devices() == []

    def broken(device):
        raise RuntimeError("dead")
    monkeypatch.setattr(health, "_probe", broken)
    bad = check_devices(["cpu"])
    assert not bad[0].ok and "dead" in bad[0].error

    import threading
    release = threading.Event()
    monkeypatch.setattr(health, "_probe", lambda d: release.wait(5) or 0.0)
    hung = check_devices(["cpu", "cpu"], timeout_s=0.2)
    release.set()
    assert [h.error for h in hung] == ["probe timed out"] * 2


def test_jax_checkpoint_of_a_trained_model_resumes_in_the_port(tmp_path):
    """A JAX ``train(checkpoint_path=...)`` file continues in the port's
    ``train_with_resume`` to the iteration count (the counter is
    cumulative), from JAX's table bit for bit."""
    corpus = synthetic_corpus(20, 30, 10, seed=8)
    ck = str(tmp_path / "ck")
    jm = JaxWord2Vec(config=JaxConfig().update(CONF))
    jm.train(corpus, niters=2, batch_size=64, checkpoint_path=ck,
             checkpoint_every=1)
    m = _model().build(corpus)
    seen = []
    orig = m.resume

    def spy(path):
        it = orig(path)
        seen.append({f: t.clone() for f, t in m.table.state.items()})
        return it

    m.resume = spy
    losses = train_with_resume(m, corpus, niters=3, checkpoint_path=ck,
                               batch_size=64)
    assert len(losses) == 1
    want = state_from_jax({f: np.asarray(a)
                           for f, a in jm.table.state.items()}, "cpu")
    for f, t in want.items():
        assert torch.equal(seen[0][f], t)
