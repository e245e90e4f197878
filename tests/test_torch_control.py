"""The port's control plane (``swiftmpi_tpu_torch/control/``, the
``[control]`` knobs of ``models/word2vec.py``, ``KeyIndex.repartition``
and ``SparseTable.repartition``) against the JAX package, mirroring
``tests/test_control.py`` and the demote test of ``tests/test_numerics.py``
at small sizes; sharded tables use 8 ranks on the CPU against the
``devices8`` mesh.

Tolerances: the sketch's counts, the plans' arrays, ``CapacityError``'s
atomicity and the controllers' decision logs (knob, action, evaluation,
``moved_rows``) are held exactly, ``win`` within 1e-6 relative; a
repartition's moved rows bit for bit; a trained table and each of its
snapshots within ``|a - b| <= 1e-5 + 1e-3 * |b|`` with ``err_cnt``
exact, JAX's draws replayed.  ``control: off`` and a controller that
never clears its margin are held bit for bit against a run without the
section.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swiftmpi_tpu.models.word2vec as jax_w2v_mod
from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.control import Controller as JaxController
from swiftmpi_tpu.control import ControlSettings as JaxSettings
from swiftmpi_tpu.control import DecayedSketch as JaxSketch
from swiftmpi_tpu.control import Knob as JaxKnob
from swiftmpi_tpu.control import Proposal as JaxProposal
from swiftmpi_tpu.data.text import build_vocab as jax_build_vocab
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.parameter.key_index import CapacityError as JaxCapErr
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.control import (Controller, ControlSettings,
                                        DecayedSketch, Knob, Proposal)
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher, build_vocab
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.parameter.key_index import (CapacityError,
                                                    HotColdPartition)
from swiftmpi_tpu_torch.parameter.sparse_table import (ROWVER_KEY, ef_name,
                                                       hot_name)
from swiftmpi_tpu_torch.serve import EmbeddingReader, SnapshotPublisher
from swiftmpi_tpu_torch.transfer.api import Transfer
from swiftmpi_tpu_torch.utils import ConfigParser

N = 8


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _envelope(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-3,
                               atol=1e-5, err_msg=what)


# -- the sketch ----------------------------------------------------------------

def test_sketch_seed_decay_fold_and_range_filter():
    seed = np.array([8.0, 4.0, 2.0, 1.0])
    sides = [DecayedSketch(4, decay=0.5, seed_counts=seed),
             JaxSketch(4, decay=0.5, seed_counts=seed)]
    for sk in sides:
        sk.observe(np.array([[0, 1], [1, 3]]))        # any shape
        sk.observe(np.array([-1, 4, 99]))             # all out of range
        assert sk.pending_ids() == 7
    np.testing.assert_array_equal(sides[0].fold(), sides[1].fold())
    np.testing.assert_array_equal(sides[0].counts, [5.0, 4.0, 1.0, 1.5])
    np.testing.assert_array_equal(sides[0].fold(), sides[1].fold())
    for a in ("observed", "folds"):
        assert getattr(sides[0], a) == getattr(sides[1], a)
    assert sides[0].topk(3) == sides[1].topk(3)
    for bad in (dict(size=0), dict(size=4, decay=0.0),
                dict(size=4, decay=1.5),
                dict(size=4, seed_counts=np.ones(3))):
        with pytest.raises(ValueError):
            DecayedSketch(**bad)


def test_sketch_counts_match_jax_on_a_stream():
    rng = np.random.default_rng(3)
    seed = rng.integers(0, 50, size=300).astype(np.float64)
    p, j = (DecayedSketch(300, decay=0.3, seed_counts=seed),
            JaxSketch(300, decay=0.3, seed_counts=seed))
    for _ in range(5):
        for _ in range(4):
            ids = rng.integers(-3, 310, size=(7, 64))
            p.observe(ids)
            j.observe(ids)
        np.testing.assert_array_equal(p.fold(), j.fold())
    assert p.observed == j.observed


def test_sketch_concurrent_observe_loses_nothing():
    sk = DecayedSketch(64, decay=1.0)             # decay 1: exact totals
    per_thread, n_threads = 100, 8

    def work(seed):
        r = np.random.default_rng(seed)
        for _ in range(per_thread):
            sk.observe(r.integers(0, 64, size=16))

    threads = [threading.Thread(target=work, args=(s,))
               for s in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    counts = sk.fold()
    assert counts.sum() == sk.observed == per_thread * n_threads * 16


# -- the controller's hysteresis ----------------------------------------------

def _scripted(pkg, script, applied, ok=True):
    knob, proposal = (Knob, Proposal) if pkg == "port" else (JaxKnob,
                                                             JaxProposal)
    it = iter(script)

    def propose(counts, delta):
        step = next(it)
        return None if step is None else proposal(*step)

    def apply(value, evidence):
        applied.append(value)
        return ok

    return knob("k", current=lambda: "cur", propose=propose, apply=apply)


def _log(ctl):
    return [(d.knob, d.action, d.old, d.new, d.streak, d.evaluation)
            for d in ctl.decisions]


@pytest.mark.parametrize("script,ok", [
    ([("A", 0.2), ("B", 0.2)], True),
    ([("A", 0.2), ("A", 0.05), ("A", 0.2), ("A", 0.2)], True),
    ([("A", 0.2), None, ("A", 0.3), ("B", 0.4)], True),
    ([("A", 0.2), ("A", 0.2)], False)])
def test_hysteresis_decision_log_matches_jax(script, ok):
    """Defer, then apply the LATEST proposal; a sub-margin evaluation or a
    steady state resets the streak; a failing applier rejects.  The two
    packages' decision logs agree entry for entry."""
    runs = []
    for pkg, (settings, ctl_cls) in {
            "port": (ControlSettings, Controller),
            "jax": (JaxSettings, JaxController)}.items():
        applied = []
        ctl = ctl_cls(settings(enabled=True, every=1, margin=0.1,
                               consecutive=2),
                      knobs=[_scripted(pkg, script, applied, ok)])
        for _ in script:
            ctl.on_steps(1)
        runs.append((_log(ctl), [d.win for d in ctl.decisions], applied,
                     ctl.summary()))
    (log_p, win_p, app_p, sum_p), (log_j, win_j, app_j, sum_j) = runs
    assert log_p == log_j and app_p == app_j and sum_p == sum_j
    np.testing.assert_allclose(win_p, win_j, rtol=1e-6)
    if ok:
        assert app_p and sum_p["applied"] == 1
    else:
        assert sum_p["rejected"] == 1


def test_cadence_and_disabled():
    ctl = Controller(ControlSettings(enabled=True, every=4))
    assert ctl.on_steps(1) is None and ctl.on_steps(2) is None
    assert ctl.on_steps(1) == []           # 4th step: evaluation ran
    assert ctl.evaluations == 1
    assert ctl.on_steps(8) == []           # one evaluation per trigger
    assert ctl.evaluations == 2
    off = Controller(ControlSettings(enabled=False, every=1))
    assert off.on_steps(100) is None and off.evaluations == 0
    for bad in (dict(every=0), dict(consecutive=0), dict(margin=-1.0)):
        with pytest.raises(ValueError):
            ControlSettings(**bad)
    c = ConfigParser().update({"control": {"control": "on", "every": 8,
                                           "margin": 0.02, "decay": 0.3}})
    st = ControlSettings.from_config(c)
    jst = JaxSettings.from_config(JaxConfig().update(
        {"control": {"control": "on", "every": 8, "margin": 0.02,
                     "decay": 0.3}}))
    assert vars(st) == vars(jst)


class _Ledger:
    traffic_delta = Transfer.traffic_delta

    def __init__(self):
        self.t = {"push_rows": 0}

    def traffic(self):
        return dict(self.t)


def test_traffic_delta_contract_and_controller_intervals():
    led = _Ledger()
    led.t = {"push_rows": 10, "push_bytes": 400}
    assert led.traffic_delta(None) == led.traffic()    # the totals
    snap = led.traffic()
    led.t = {"push_rows": 15, "push_bytes": 600, "wire_bytes": 32}
    assert led.traffic_delta(snap) == {"push_rows": 5, "push_bytes": 200,
                                       "wire_bytes": 32}
    led, seen = _Ledger(), []

    def propose(counts, delta):
        seen.append(dict(delta))

    ctl = Controller(ControlSettings(enabled=True, every=1), transfer=led,
                     knobs=[Knob("k", lambda: 0, propose)])
    led.t["push_rows"] = 7
    ctl.evaluate()
    led.t["push_rows"] = 10
    ctl.evaluate()
    assert seen == [{"push_rows": 7}, {"push_rows": 3}]   # per interval


def test_decisions_reach_the_recorder(tmp_path):
    """Every evaluation a ``control/evaluation`` event, every decision a
    ``control/decision`` event with its evidence, through the port's
    StepRecorder; the ``control/*`` counters mirror them."""
    import json
    path = str(tmp_path / "tel.jsonl")
    rec = obs.configure(ConfigParser().update(
        {"worker": {"telemetry": 1, "telemetry_path": path}}), run="t")
    applied = []
    ctl = Controller(ControlSettings(enabled=True, every=1, margin=0.1,
                                     consecutive=2),
                     knobs=[_scripted("port", [("A", 0.2), ("B", 0.3)],
                                      applied)])
    ctl.on_steps(1)
    ctl.on_steps(1)
    reg = obs.get_registry().snapshot()
    rec.close()
    obs.uninstall_recorder()
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    kinds = [ln.get("kind") for ln in lines]
    assert kinds.count("control/evaluation") == 2
    decisions = [ln for ln in lines if ln.get("kind") == "control/decision"]
    assert [d["action"] for d in decisions] == ["defer", "apply"]
    assert all("evidence" in d and "traffic_delta" in d for d in decisions)
    assert reg["counters"]["control/decisions"] == 2
    assert reg["counters"]["control/decisions_applied"] == 1


# -- KeyIndex.repartition --------------------------------------------------------

def _plan_arrays(plan):
    return [plan.old_n_hot, plan.new_n_hot, plan.moved_rows] + [
        getattr(plan, k).tolist() for k in (
            "demote_src", "demote_dst", "hot_from_hot_src",
            "hot_from_hot_dst", "hot_from_tail_src", "hot_from_tail_dst")]


def test_keyindex_repartition_atomic_on_capacity_error():
    hot = np.array([100, 101, 102, 103], np.uint64)
    tail = np.array([1, 2, 3], np.uint64)
    sides = []
    for ki_cls, part_cls, err in ((KeyIndex, HotColdPartition,
                                   CapacityError),
                                  (JaxKeyIndex, JaxPart, JaxCapErr)):
        ki = ki_cls(num_shards=1, capacity_per_shard=3,
                    partition=part_cls(hot))
        tail_slots = np.asarray(ki.lookup(tail))        # the tail is full
        hot_slots = np.asarray(ki.lookup(hot))
        with pytest.raises(err, match="grow the table"):
            ki.repartition(None)                        # 4 demotions
        # all or nothing: the index is as it was
        assert ki.n_hot == 4 and ki.partition is not None
        np.testing.assert_array_equal(ki.lookup(tail, create=False),
                                      tail_slots)
        np.testing.assert_array_equal(ki.lookup(hot, create=False),
                                      hot_slots)
        plan = ki.repartition(part_cls(hot[::-1].copy()))   # ranks only
        np.testing.assert_array_equal(ki.lookup(hot, create=False),
                                      [3, 2, 1, 0])
        sides.append((_plan_arrays(plan), list(ki.items())))
    assert sides[0] == sides[1]


@pytest.mark.parametrize("case", ["swap", "grow_head", "drop_head",
                                  "from_none"])
def test_keyindex_repartition_plan_matches_jax(case):
    """Demotions (with and without a tail slot), stays at new ranks,
    promotions with a tail slot and without one: the plan's arrays, the
    slots of every key and ``shard_fill`` equal JAX's."""
    rng = np.random.default_rng(7)
    keys = rng.choice(50_000, size=160, replace=False).astype(np.uint64)
    fresh = np.array([60_001, 60_002], np.uint64)
    first = None if case == "from_none" else keys[:40]
    new = {"swap": np.concatenate([keys[20:70], fresh]),
           "grow_head": np.concatenate([keys[:40], keys[90:100]]),
           "drop_head": None,
           "from_none": keys[5:35]}[case]
    out = []
    for ki_cls, part_cls in ((KeyIndex, HotColdPartition),
                             (JaxKeyIndex, JaxPart)):
        ki = ki_cls(N, 40, partition=None if first is None
                    else part_cls(first))
        ki.lookup(keys[30:])                 # a tail for the rest
        plan = ki.repartition(None if new is None else part_cls(new))
        all_keys = np.concatenate([keys, fresh])
        out.append((_plan_arrays(plan), ki.n_hot,
                    np.asarray(ki.lookup(all_keys, create=False)).tolist(),
                    ki.shard_fill().tolist(), list(ki.items())))
    assert out[0] == out[1]
    assert out[0][0][2] > 0


# -- SparseTable.repartition -----------------------------------------------------

def _stamped_tables(n_keys=100, n_hot=30, d=8, side_planes=False):
    """A hybrid table stamped with each key's value in every field, on
    both sides (8 shards of 32), the port's state a copy of JAX's; with
    ``side_planes`` also ``v@ef`` and ``@rowver`` planes of random
    values."""
    keys = np.arange(1, 1 + n_keys, dtype=np.uint64)
    jt = JaxSparseTable(jax_w2v_access(learning_rate=0.3, len_vec=d),
                        JaxKeyIndex(N, 32, partition=JaxPart(keys[:n_hot])),
                        mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    slots = np.asarray(jt.key_index.lookup(keys), np.int64)
    for f in jt.access.fields:
        uni = jt.unified_rows_host(f).copy()
        uni[slots] = np.asarray(keys, np.float64)[:, None]
        jt.state[f] = jax.device_put(uni[jt.n_hot:],
                                     jt.field_sharding(f))
        jt.state[hot_name(f)] = jax.device_put(
            uni[:jt.n_hot], jt.field_sharding(hot_name(f)))
    if side_planes:
        rng = np.random.default_rng(5)
        jt.ensure_ef(("v",))
        jt.ensure_row_versions()
        cap = jt.key_index.capacity
        jt.state[ef_name("v")] = jax.device_put(
            rng.normal(size=(cap, d)).astype(np.float32),
            jt.field_sharding("v"))
        jt.state[ROWVER_KEY] = jax.device_put(
            rng.integers(0, 50, size=(cap, 1)).astype(np.int32),
            jt.field_sharding("v"))
    layout = ps_mesh(N, ["cpu"])
    pt = SparseTable(w2v_access(0.3, d), KeyIndex(
        N, 32, partition=HotColdPartition(keys[:n_hot])), "cpu",
        mesh=layout)
    np.testing.assert_array_equal(pt.key_index.lookup(keys), slots)
    pt.state = state_from_jax({f: np.asarray(a)
                               for f, a in jt.state.items()}, "cpu",
                              mesh=layout)
    return jt, pt, keys


def test_sparse_table_repartition_moves_rows_as_jax():
    """Demote 10, keep 20 (re-ranked), promote 30 keys with a tail slot
    and 2 without one: every moved row bit for bit JAX's, every key reads
    its stamp back at its new slot, the fresh rows in their init range;
    the tail tensors stay in place and ``generation`` moves."""
    jt, pt, keys = _stamped_tables()
    fresh = np.array([900, 901], np.uint64)
    new_hot = np.concatenate([keys[10:60], fresh])
    tail_ptrs = [t.data_ptr() for t in pt.state["v"]]
    gen0 = pt.generation
    jplan = jt.repartition(JaxPart(new_hot))
    plan = pt.repartition(HotColdPartition(new_hot))
    assert _plan_arrays(plan) == _plan_arrays(jplan)
    assert pt.n_hot == jt.n_hot == 52 and plan.moved_rows > 0
    assert pt.generation == gen0 + 1
    assert [t.data_ptr() for t in pt.state["v"]] == tail_ptrs
    slots = np.asarray(pt.key_index.lookup(keys, create=False))
    np.testing.assert_array_equal(
        slots, jt.key_index.lookup(keys, create=False))
    fslots = np.asarray(pt.key_index.lookup(fresh, create=False))
    for f in pt.access.fields:
        got, want = pt.unified_rows_host(f), jt.unified_rows_host(f)
        np.testing.assert_array_equal(got[slots], want[slots])
        np.testing.assert_array_equal(
            got[slots], np.repeat(np.asarray(keys, np.float32)[:, None],
                                  8, axis=1))
        # every row a move wrote, in the new frames
        hot_dst = np.concatenate([plan.hot_from_hot_dst,
                                  plan.hot_from_tail_dst])
        np.testing.assert_array_equal(got[hot_dst], want[hot_dst])
        tail = pt.n_hot + plan.demote_dst
        np.testing.assert_array_equal(got[tail], want[tail])
        rows = got[fslots]
        if f.endswith("2sum"):
            np.testing.assert_array_equal(rows, 0.0)
        else:
            assert np.isfinite(rows).all() and rows.std() > 0
            assert (np.abs(rows) <= 0.5 / 8).all()


def test_repartition_carries_ef_and_bumps_rowver_as_jax():
    """``@ef`` is tail-indexed and carries through unchanged; the
    demoted rows' ``@rowver`` stamps go to the global max + 1, the rest
    stay: both planes equal JAX's after the change."""
    jt, pt, keys = _stamped_tables(side_planes=True)
    before = state_to_numpy(pt.state)
    new_hot = keys[12:40]
    jplan = jt.repartition(JaxPart(new_hot))
    plan = pt.repartition(HotColdPartition(new_hot))
    assert plan.demote_dst.size == jplan.demote_dst.size == 12
    got = state_to_numpy(pt.state)
    for f in (ef_name("v"), ROWVER_KEY):
        np.testing.assert_array_equal(got[f], np.asarray(jt.state[f]))
    np.testing.assert_array_equal(got[ef_name("v")], before[ef_name("v")])
    ver = got[ROWVER_KEY][:, 0]
    assert (ver[plan.demote_dst] == before[ROWVER_KEY].max() + 1).all()


def test_repartition_to_no_head_and_back():
    """Down to no hot head (every hot row written into the tail, the hot
    planes gone) and back: each key keeps its stamp, as JAX's table."""
    jt, pt, keys = _stamped_tables()
    for part in (None, keys[50:70]):
        jplan = jt.repartition(None if part is None else JaxPart(part))
        plan = pt.repartition(None if part is None
                              else HotColdPartition(part))
        assert _plan_arrays(plan) == _plan_arrays(jplan)
        assert (hot_name("v") in pt.state) == (part is not None)
        slots = np.asarray(pt.key_index.lookup(keys, create=False))
        for f in ("h", "v"):
            np.testing.assert_array_equal(
                pt.unified_rows_host(f)[slots],
                jt.unified_rows_host(f)[slots])


def test_repartition_capacity_error_leaves_table_untouched():
    access = w2v_access(0.3, 4)
    hot = np.array([100, 101, 102], np.uint64)
    t = SparseTable(access, KeyIndex(1, 2, partition=HotColdPartition(hot)),
                    "cpu")
    t.key_index.lookup(np.array([1, 2], np.uint64))     # the tail is full
    before = state_to_numpy(t.state)
    gen = t.generation
    with pytest.raises(CapacityError):
        t.repartition(None)
    after = state_to_numpy(t.state)
    assert set(after) == set(before) and t.generation == gen
    for f in before:
        np.testing.assert_array_equal(after[f], before[f])


def test_no_torn_serve_reads_during_repartition():
    """Readers over the publisher never see a torn row while the trainer
    thread repartitions back and forth: every read is the stamp of its
    key (any mix of two layouts would show as a mismatch)."""
    _, table, keys = _stamped_tables()
    pub = SnapshotPublisher(every=1)

    def publish():
        pub.publish(table, keys=keys, slots=np.asarray(
            table.key_index.lookup(keys, create=False), np.int64))

    publish()
    stop, failures = threading.Event(), []

    def query_stream(seed):
        rng = np.random.default_rng(seed)
        reader = EmbeddingReader(pub, field="v", cache_rows=32)
        while not stop.is_set():
            ks = rng.choice(keys, size=16)
            rows = reader.read(ks)
            if not (rows == np.asarray(ks, np.float64)[:, None]).all():
                failures.append(f"torn read at version {pub.version}")
                return

    threads = [threading.Thread(target=query_stream, args=(s,),
                                daemon=True) for s in range(3)]
    for t in threads:
        t.start()
    parts = [HotColdPartition(keys[20:60]), HotColdPartition(keys[:30])]
    for i in range(6):
        table.repartition(parts[i % 2])
        publish()
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert pub.version == 7


# -- word2vec's control plane ----------------------------------------------------

V_DRIFT = 200


def _zipf_stream(perm, n_sent=60, length=50, seed=1, v=V_DRIFT):
    ranks = np.arange(1, v + 1, dtype=np.float64)
    p = ranks ** -1.2
    p /= p.sum()
    r = np.random.default_rng(seed)
    keys = perm[r.choice(v, size=(n_sent, length), p=p)] + 1
    return [list(map(int, row)) for row in keys]


def _drift_setup(n_sent=60):
    """JAX's ``_drift_setup``: phase A, phase B with half of the vocab's
    ids rotated (the hot head moves), and a vocab counted on phase A."""
    ident = np.arange(V_DRIFT)
    rot = (ident + V_DRIFT // 2) % V_DRIFT
    a = _zipf_stream(ident, n_sent=n_sent, seed=1)
    b = _zipf_stream(rot, n_sent=n_sent, seed=2)
    return a, b, a + [list(range(1, V_DRIFT + 1))]


DRIFT_CONF = {
    "cluster": {"transfer": "hybrid", "server_num": N},
    "word2vec": {"len_vec": 16, "window": 3, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 256},
}
CONTROL = {"control": "on", "every": 8, "margin": 0.02, "consecutive": 2,
           "decay": 0.3}


def _confs(base, sections):
    jc, pc = JaxConfig().update(base), ConfigParser().update(base)
    for c in (jc, pc):
        for sec, kv in sections.items():
            for k, v in kv.items():
                c.set(sec, k, v)
    return jc, pc


def _model_pair(base, sections, vocab_sents, cap=None):
    """A JAX and a port model on one vocab, the port's table a copy of
    JAX's."""
    jc, pc = _confs(base, sections)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap)
    jm.build_from_vocab(jax_build_vocab(vocab_sents))
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build_from_vocab(build_vocab(vocab_sents))
    assert pm.table.n_hot == jm.table.n_hot
    np.testing.assert_array_equal(pm._slot_of_vocab.numpy(),
                                  np.asarray(jm._slot_of_vocab))
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    return jm, pm


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _replayed_draws(pm, sents, niters, batch_size, key):
    """JAX ``train``'s draws for ``niters`` epochs of ``sents`` from
    ``key`` (its ``_key``): one split a dispatch, a group's keys split
    from it, each step's ``(j, u)`` at its batch's shape.  Returns the
    draws in the port's consumption order and the key after them."""
    bat = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=2008)
    fuse, L = pm.inner_steps > 1, pm.inner_steps
    out, V = [], len(pm.vocab)

    def dispatch(sizes):
        nonlocal key
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(sizes)) if len(sizes) > 1 \
            else [sub]
        out.extend(_jax_draws(k, V, pm.draw_shape(b))
                   for k, b in zip(keys, sizes))

    for _ in range(niters):
        group = []
        for b in bat.epoch(batch_size):
            B = len(b.centers)
            if fuse and B == batch_size:
                group.append(B)
                if len(group) == L:
                    dispatch(group)
                    group = []
                continue
            if group:
                dispatch(group)
                group = []
            dispatch([B])
        if group:
            dispatch(group)
    return out, key


class _Totals:
    """Records JAX ``train``'s per-epoch loss sums (``_LossAccum.total``
    is called for err_sum, then err_cnt)."""

    def __init__(self, monkeypatch):
        self.values = []
        orig = jax_w2v_mod._LossAccum.total

        def total(acc):
            v = orig(acc)
            self.values.append(v)
            return v
        monkeypatch.setattr(jax_w2v_mod._LossAccum, "total", total)

    def err_cnt(self):
        return [int(round(v)) for v in self.values[1::2]]


def _decision_log(ctl):
    return [(d.knob, d.action, d.evaluation, d.streak,
             d.evidence.get("moved_rows"), d.evidence.get("new_n_hot"),
             d.evidence.get("old_w"), d.evidence.get("new_w"))
            for d in ctl.decisions]


def _port_train(pm, sents, niters, key, batch_size=256):
    """The port's ``train`` with JAX's draws from ``key``: ``(losses,
    err_cnt per epoch, the key after)``."""
    draws, key = _replayed_draws(pm, sents, niters, batch_size, key)
    losses = pm.train(sents, niters=niters, batch_size=batch_size,
                      draws=iter(draws))
    return losses, [int(round(c)) for _, c in
                    pm.train_metrics["epoch_err"]], key


def _hold_runs(jm, pm, totals, losses_j, losses_p, cnt_p):
    assert _decision_log(pm.controller) == _decision_log(jm.controller)
    np.testing.assert_allclose([d.win for d in pm.controller.decisions],
                               [d.win for d in jm.controller.decisions],
                               rtol=1e-6)
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert cnt_p == totals.err_cnt()
    final = state_to_numpy(pm.table.state)
    assert set(final) == set(jm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


def test_drift_control_and_serve_track_jax(devices8, monkeypatch):
    """``[control]`` on ``hybrid`` under drift with ``[serve] every: 4``,
    JAX's draws replayed: the same decision log (a ``hot_k`` repartition
    with ``moved_rows`` > 0 among them), ``err_cnt`` exact, the table and
    every published snapshot (planes, key map, version, step) within the
    envelope of JAX's."""
    sents_a, sents_b, vocab_sents = _drift_setup()
    jm, pm = _model_pair(DRIFT_CONF, {"control": CONTROL,
                                      "serve": {"every": 4, "depth": 64}},
                         vocab_sents)
    assert pm.controller is not None and pm.table.n_hot > 0
    totals = _Totals(monkeypatch)
    losses_j = jm.train(sents_a, niters=2) + jm.train(sents_b, niters=3)
    key, losses_p, cnt_p = jax.random.key(0 ^ 0x5EED), [], []
    for sents, n in ((sents_a, 2), (sents_b, 3)):
        losses, cnt, key = _port_train(pm, sents, n, key)
        losses_p, cnt_p = losses_p + losses, cnt_p + cnt
    _hold_runs(jm, pm, totals, losses_j, losses_p, cnt_p)
    applied = [d for d in pm.controller.decisions
               if d.action == "apply" and d.knob == "hot_k"]
    assert applied and applied[0].evidence["moved_rows"] > 0
    assert pm.train_metrics["control"]["recompiles"] >= 1
    pj, pp = jm.serve_publisher._history, pm.serve_publisher._history
    assert len(pp) == len(pj) == pm.serve_publisher.version > 2
    for sj, sp in zip(pj, pp):
        assert (sp.version, sp.step, sp.n_hot) == (sj.version, sj.step,
                                                   sj.n_hot)
        np.testing.assert_array_equal(sp.keys, sj.keys)
        np.testing.assert_array_equal(sp.slots, sj.slots)
        assert set(sp.state) == set(sj.state)
        for f, a in sj.state.items():
            assert isinstance(sp.state[f], np.ndarray)
            _envelope(sp.state[f], np.asarray(a), f"v{sp.version} {f}")


XLA_CONF = {
    "cluster": {"transfer": "xla", "server_num": 1},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512, "inner_steps": 2},
}


def test_push_window_apply_one_to_two_tracks_jax(devices8, monkeypatch):
    """``xla``, ``inner_steps: 2`` at ``push_window: 1`` with the
    controller on: the sketch's cost model moves W from 1 to 2 (the edge
    where the build armed no window), JAX's draws replayed; the same
    decisions, losses, ``err_cnt`` and table."""
    sents_a, _, vocab_sents = _drift_setup(n_sent=30)
    jm, pm = _model_pair(XLA_CONF, {"control": {
        "control": "on", "every": 4, "margin": 0.01, "consecutive": 1}},
        vocab_sents)
    assert pm.push_window_size == 1
    assert pm.transfer.window_expected_unique is None
    totals = _Totals(monkeypatch)
    losses_j = jm.train(sents_a, niters=1, batch_size=64)
    losses_p, cnt_p, _ = _port_train(pm, sents_a, 1,
                                     jax.random.key(0x5EED), 64)
    _hold_runs(jm, pm, totals, losses_j, losses_p, cnt_p)
    assert pm.push_window_size == jm.push_window_size == 2
    assert pm.transfer.window_expected_unique == pytest.approx(
        jm.transfer.window_expected_unique, rel=1e-12)
    assert any(d.knob == "push_window" and d.action == "apply"
               for d in pm.controller.decisions)


def test_push_window_apply_two_to_one_tracks_jax(devices8, monkeypatch):
    """The other edge: W = 2 applied down to 1 through the applier at a
    safe point (the cost model never proposes a narrower window), then a
    train; JAX's draws replayed."""
    sents_a, _, vocab_sents = _drift_setup(n_sent=30)
    jm, pm = _model_pair(XLA_CONF, {
        "cluster": {"push_window": 2},
        "control": {"control": "on", "every": 1000}}, vocab_sents)
    assert pm.transfer.window_expected_unique > 0
    for m in (jm, pm):
        assert m._apply_push_window(1, {})
        assert m.push_window_size == 1
        assert m.transfer.window_expected_unique is None
    totals = _Totals(monkeypatch)
    losses_j = jm.train(sents_a, niters=1, batch_size=64)
    losses_p, cnt_p, _ = _port_train(pm, sents_a, 1,
                                     jax.random.key(0x5EED), 64)
    _hold_runs(jm, pm, totals, losses_j, losses_p, cnt_p)


def test_graph_key_holds_the_window_width():
    """The window width is part of the graphs' key: a W changed between
    two ``train`` calls (or by the controller) keys new graphs, and an
    apply re-keys the model's cache at once."""
    sents, _, vocab_sents = _drift_setup(n_sent=10)
    _, pc = _confs(XLA_CONF, {"control": {"control": "on",
                                          "every": 1000}})
    m = Word2Vec(config=pc, device="cpu")
    m.build_from_vocab(build_vocab(vocab_sents))
    k1 = m._graph_key()
    m.push_window_size = 2
    k2 = m._graph_key()
    assert k1 != k2
    m._fused_cache[2] = object()            # a captured graph
    assert m._apply_push_window(1, {})
    assert m._fused_cache == {} and m._captures == {}
    assert m._fused_key == m._graph_key() == k1
    assert m._control_recompiles == 1


def test_wire_and_collective_knobs_match_jax(devices8):
    """``hybrid`` windows with ``collective: auto``: the four knobs are
    registered as JAX registers them, and on a drifted sketch the
    ``wire_format`` and ``collective`` proposals (value, win, evidence)
    equal JAX's."""
    sents_a, sents_b, vocab_sents = _drift_setup(n_sent=20)
    jm, pm = _model_pair(DRIFT_CONF, {
        "worker": {"inner_steps": 4},
        "cluster": {"push_window": 2, "collective": "auto",
                    "wire_quant": "int8"},
        "control": {"control": "on", "every": 1000}}, vocab_sents)
    assert [k.name for k in pm.controller.knobs] \
        == [k.name for k in jm.controller.knobs] \
        == ["hot_k", "push_window", "wire_format", "collective"]
    ids = np.asarray([pm.vocab.index_of(k) for s in sents_b for k in s])
    for m in (jm, pm):
        m._control_sketch.observe(ids)
    counts = pm._control_sketch.fold()
    np.testing.assert_array_equal(counts, jm._control_sketch.fold())
    proposers = {"hot_k": "_propose_hot_k",
                 "push_window": "_propose_push_window",
                 "wire_format": "_propose_wire",
                 "collective": "_propose_collective"}
    for name, method in proposers.items():
        pp = getattr(pm, method)(counts, {})
        pj = getattr(jm, method)(counts, {})
        assert (pp is None) == (pj is None), name
        if pp is None:
            continue
        np.testing.assert_allclose(pp.win, pj.win, rtol=1e-6)
        assert pp.evidence.keys() == pj.evidence.keys()
        for k, v in pj.evidence.items():
            if isinstance(v, float):
                assert pp.evidence[k] == pytest.approx(v, rel=1e-9), k
            else:
                assert pp.evidence[k] == v, k
        if name == "hot_k":
            np.testing.assert_array_equal(pp.value.hot_keys,
                                          pj.value.hot_keys)
        else:
            assert pp.value == pytest.approx(pj.value, rel=1e-9)
    for m in (jm, pm):
        assert m._apply_wire(123.0, {}) and m._apply_collective(0.25, {})
        assert m.transfer.window_expected_unique == 123.0
        assert m.transfer.hot_touched_fraction == 0.25


def test_ef_runaway_demotes_wire_quant(tmp_path, devices8):
    """tests/test_numerics.py::test_ef_runaway_demotes_wire_quant on the
    port: a sustained EF-residual runaway parks in the controller and is
    applied at the next safe point (``on_steps``): ``wire_quant`` and
    ``pull_quant`` go to ``off`` on the model and the transfer, the graphs
    are dropped, and the decision event carries the anomaly; a second
    runaway books nothing new.  The JAX package's model takes the same
    decision."""
    sents, _, _ = _drift_setup(n_sent=20)
    sections = {"cluster": {"wire_quant": "int8", "push_window": 2,
                            "pull_quant": "int8"},
                "worker": {"inner_steps": 2, "telemetry": 1,
                           "telemetry_path": str(tmp_path / "t.jsonl")},
                "obs": {"numerics": 1},
                "control": {"control": "on", "every": 1000000}}
    jc, pc = _confs(XLA_CONF, sections)
    logs = []
    for m in (JaxWord2Vec(config=jc), Word2Vec(config=pc, device="cpu")):
        m.train(sents, niters=1, batch_size=64)
        det = m._numerics.detector
        assert det is not None and m.controller is not None
        assert m.controller._numerics_pending is None
        det.warmup, det.patience = 2, 2
        s = "numerics/ef_mass{field=synthetic}"
        for _ in range(4):
            det.observe(s, 1.0)
        det.observe(s, 500.0)
        det.observe(s, 500.0)
        assert m.controller._numerics_pending is not None
        assert m.wire_quant == "int8"          # parked, not applied inline
        m.controller.on_steps(1)
        assert m.wire_quant == m.pull_quant == "off"
        assert m.transfer.wire_quant == m.transfer.pull_quant == "off"
        d = m.controller.decisions[-1]
        assert d.evidence["numerics"]["anomaly"] == "ef_residual_runaway"
        n = len(m.controller.decisions)
        m.controller._on_numerics_anomaly(d.evidence["numerics"])
        m.controller.on_steps(1)
        assert len(m.controller.decisions) == n
        logs.append([(d.knob, d.action, d.old, d.new)
                     for d in m.controller.decisions])
        obs.reset_for_tests()
    assert logs[0] == logs[1] == [("wire_quant", "apply", "int8", "off")]


def _plain_run(sections, sents, vocab_sents):
    _, pc = _confs(DRIFT_CONF, sections)
    m = Word2Vec(config=pc, device="cpu", seed=3)
    m.build_from_vocab(build_vocab(vocab_sents))
    losses = m.train(sents, niters=2)
    return m, losses, state_to_numpy(m.table.state)


def test_control_off_is_bit_identical_and_passive_on_is_free():
    """``control: off`` is the section's absence, bit for bit; an armed
    controller that never clears its margin evaluates and leaves the
    trajectory bit for bit unchanged."""
    sents_a, _, vocab_sents = _drift_setup(n_sent=30)
    m0, l0, s0 = _plain_run({}, sents_a, vocab_sents)
    m1, l1, s1 = _plain_run({"control": {"control": "off"}}, sents_a,
                            vocab_sents)
    m2, l2, s2 = _plain_run({"control": {"control": "on", "every": 4,
                                         "margin": 1e9,
                                         "consecutive": 99}},
                            sents_a, vocab_sents)
    assert m1.controller is None and m1._control_sketch is None
    assert m2.controller.evaluations > 0
    assert m2.controller.summary()["applied"] == 0
    assert "control" not in m0.train_metrics
    assert l0 == l1 == l2
    for s in (s1, s2):
        assert set(s) == set(s0)
        for f in s0:
            np.testing.assert_array_equal(s[f], s0[f])


@pytest.mark.slow
def test_autotune_tracks_statically_retuned_oracle():
    """tests/test_control.py::test_autotune_tracks_statically_retuned_oracle
    on the port: under drift the autotuned arm's loss tracks an oracle
    whose partition was set to phase B's counts up front (rtol 5e-2), and
    its routed rows over the same stream stay within 10% of the
    oracle's."""
    sents_a, sents_b, vocab_sents = _drift_setup()
    vocab = build_vocab(vocab_sents)
    freq = {}
    for row in sents_b:
        for w in row:
            freq[w] = freq.get(w, 0) + 1
    counts_b = np.array([freq.get(int(k), 0) + 1 for k in vocab.keys],
                        np.int64)
    _, pc_auto = _confs(DRIFT_CONF, {"control": CONTROL})
    _, pc_oracle = _confs(DRIFT_CONF, {})
    auto = Word2Vec(config=pc_auto, device="cpu")
    auto.build_from_vocab(vocab)
    oracle = Word2Vec(config=pc_oracle, device="cpu")
    oracle.build_from_vocab(vocab)
    assert oracle._apply_hot_k(HotColdPartition.from_counts(
        vocab.keys, counts_b, batch_rows=oracle.minibatch), {})
    keys = vocab.keys
    src = np.asarray(auto.table.key_index.lookup(keys))
    dst = np.asarray(oracle.table.key_index.lookup(keys))
    for f in oracle.access.fields:
        rows = torch.from_numpy(auto.table.unified_rows_host(f)[src])
        hot = dst < oracle.table.n_hot
        oracle.table.state[hot_name(f)][torch.from_numpy(dst[hot])] = \
            rows[torch.from_numpy(hot)]
        oracle.table.write_rows(f, dst[~hot] - oracle.table.n_hot,
                                rows[torch.from_numpy(~hot)])
    for m in (auto, oracle):
        m.transfer.count_traffic = True
        m.train(sents_a, niters=2)
        m.train(sents_b, niters=2)
    assert any(d.action == "apply" for d in auto.controller.decisions)
    tra0, tro0 = auto.transfer.traffic(), oracle.transfer.traffic()
    l_auto = auto.train(sents_b, niters=2)
    l_oracle = oracle.train(sents_b, niters=2)
    np.testing.assert_allclose(l_auto, l_oracle, rtol=5e-2)
    tra = auto.transfer.traffic_delta(tra0)
    tro = oracle.transfer.traffic_delta(tro0)
    assert tro["routed_rows"] > 0
    assert tra["routed_rows"] <= 1.10 * tro["routed_rows"]
