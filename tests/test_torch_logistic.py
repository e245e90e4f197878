"""The port's logistic regression (``swiftmpi_tpu_torch/models/logistic.py``,
``data/libsvm.py``, ``apps/lr_main.py``) against the JAX package's, on the
CPU, on the same numpy inputs and the same initial table.

``jax.random`` and ``torch.Generator`` never give the same numbers, so the
port starts from the JAX model's initial table (``convert.state_from_jax``,
slot for slot: both key indexes assign the same slots).  Tolerances: the
table within the repo's envelope ``|a - b| <= 1e-5 + 1e-3 * |b|``; losses
within 1e-4 relative (float32 sums in another grouping than JAX's float64
host sum); parsing, batching and dumps exactly.  The capacity picks the
push path: B·F slots at or above half of it push dense (B3, B1's table
form), below it sparse (B1's row form).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu.apps import lr_main as jax_lr_main
from swiftmpi_tpu.data import libsvm as jax_libsvm
from swiftmpi_tpu.models.logistic import LogisticRegression as JaxLR
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import lr_main
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data import libsvm
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.parameter import lr_access
from swiftmpi_tpu_torch.parameter.key_index import CapacityError
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "worker": {"minibatch": 32},
    "server": {"initial_learning_rate": 0.1},
}
#: 300 rows of 5 features over 40: B·F = 160 slots a batch, which pushes
#: dense at capacity 64 and sparse at 1024; 10 batches, the last padded
DATA = dict(n=300, dim=40, nnz=5, seed=1)
DENSE_PUSH, SPARSE_PUSH = 64, 1024


def _envelope(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                               err_msg=what)


def _configs(**worker):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for k, v in worker.items():
        jc.set("worker", k, v)
        pc.set("worker", k, v)
    return jc, pc


def _models(cap, **worker):
    """A JAX model and the port's on the CPU, from JAX's initial table."""
    jc, pc = _configs(**worker)
    jm = JaxLR(config=jc, capacity_per_shard=cap)
    pm = LogisticRegression(config=pc, capacity_per_shard=cap, device="cpu")
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    return jm, pm


def _hold(pm, jm, what=""):
    want = {f: np.asarray(a) for f, a in jm.table.state.items()}
    got = state_to_numpy(pm.table.state)
    assert set(got) == set(want) == {"val", "grad2sum"}
    for f in want:
        _envelope(got[f], want[f], f"{what} {f}")


def _write_svm(path, data):
    with open(path, "w") as f:
        f.write("# a comment line\n\n")
        for y, feats in data:
            f.write(f"{1 if y > 0 else -1} " + " ".join(
                f"{k}:{v:.6g}" for k, v in feats) + "\n")


# -- parsing and batching -------------------------------------------------------

@pytest.mark.parametrize("line", [
    "1 3:1 11:0.5 14:2", "-1 5:1", "0 7:-0.25 9:1e-3", "# comment", "   ",
    "1 2:3 # trailing", "+1 18446744073709551615:2.5", ""])
def test_parse_line_equals_jax(line):
    assert libsvm.parse_line(line) == jax_libsvm.parse_line(line)


def test_synthetic_dataset_and_csr_equal_jax():
    port = libsvm.synthetic_dataset(**DATA)
    jax_ = jax_libsvm.synthetic_dataset(**DATA)
    assert port == jax_
    a, b = libsvm.to_csr(port), jax_libsvm.to_csr(jax_)
    for f in ("labels", "offsets", "feat_ids", "feat_vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.max_feats == b.max_feats == 5 and a.parser == "python"


def test_load_data_takes_the_native_parser_and_equals_jax(tmp_path):
    """The file through the port's native C++ parser, through the Python
    parser, and through the JAX package's ``load_data``: the same CSR
    arrays; ``parser`` names the native one."""
    path = str(tmp_path / "train.svm")
    _write_svm(path, libsvm.synthetic_dataset(**DATA))
    got = libsvm.load_data(path)
    want = jax_libsvm.load_data(path)
    py = libsvm.to_csr(libsvm.load_file(path))
    assert got.parser == "native"
    for f in ("labels", "offsets", "feat_ids", "feat_vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(py, f), getattr(want, f))
    assert libsvm.load_file(path) == jax_libsvm.load_file(path)


@pytest.mark.parametrize("form", ["list", "csr", "csr_drop", "list_f3"])
def test_minibatches_equal_jax(form):
    """``iter_minibatches`` over an instance list and over CSR arrays
    (``_iter_csr``), the padded tail, ``drop_remainder`` and a cut
    ``max_feats``: array for array."""
    data = libsvm.synthetic_dataset(45, 30, 4, seed=2)
    data[3] = (data[3][0], data[3][1][:2])           # a short row
    jdata = jax_libsvm.synthetic_dataset(45, 30, 4, seed=2)
    jdata[3] = (jdata[3][0], jdata[3][1][:2])
    kw = {"drop_remainder": form == "csr_drop"}
    if form == "list_f3":
        kw["max_feats"] = 3
    if form.startswith("csr"):
        data, jdata = libsvm.to_csr(data), jax_libsvm.to_csr(jdata)
    got = list(libsvm.iter_minibatches(data, 16, **kw))
    want = list(jax_libsvm.iter_minibatches(jdata, 16, **kw))
    assert len(got) == len(want) == (2 if form == "csr_drop" else 3)
    for a, b in zip(got, want):
        for f in ("targets", "feat_ids", "feat_vals", "mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype
        np.testing.assert_array_equal(a.unique_keys(), b.unique_keys())
    batch = libsvm.make_batch(libsvm.synthetic_dataset(5, 9, 3))
    jb = jax_libsvm.make_batch(jax_libsvm.synthetic_dataset(5, 9, 3))
    np.testing.assert_array_equal(batch.feat_ids, jb.feat_ids)


def test_lr_access_schema():
    acc = lr_access(0.05)
    assert acc.pull_fields == ("val",)
    assert {f: s.dim for f, s in acc.fields.items()} == {"val": 1,
                                                          "grad2sum": 1}
    m = LogisticRegression(config=ConfigParser().update(CONF),
                           capacity_per_shard=256, device="cpu", seed=3)
    val = m.table.state["val"]
    assert val.shape == (256, 1) and float(val.min()) >= 0.0 \
        and float(val.max()) < 1.0 and float(val.std()) > 0.2
    assert not m.table.state["grad2sum"].any()


# -- one step ----------------------------------------------------------------------

def _first_batch(jm, pm):
    data = libsvm.synthetic_dataset(**DATA)
    batch = next(libsvm.iter_minibatches(data, 32, 5))
    keys = np.where(batch.mask, batch.feat_ids, 0)
    slots = pm.table.key_index.lookup(keys)
    np.testing.assert_array_equal(slots, jm.table.key_index.lookup(keys))
    return slots, batch


@pytest.mark.parametrize("rendering", ["sparse", "dense"])
@pytest.mark.parametrize("cap", [DENSE_PUSH, SPARSE_PUSH])
def test_one_step_matches_jax(rendering, cap):
    """One minibatch step in each rendering, on both push paths: the table
    within the envelope, the loss and the row count alike."""
    jm, pm = _models(cap)
    slots, b = _first_batch(jm, pm)
    cols = (slots, b.feat_vals, b.mask, b.targets)
    if rendering == "dense":
        jstate, jloss, jn = jm._build_dense_step()(
            dict(jm.table.state), *(jnp.asarray(c)
                                    for c in jm._densify(*cols)))
        X, cnt, t, v = pm._densify(*cols)
        num, n = pm._dense_core(*(torch.from_numpy(a) for a in (X, cnt, t,
                                                                v)))
    else:
        jstate, jloss, jn = jm._build_step()(
            dict(jm.table.state), *(jnp.asarray(c) for c in cols))
        num, n = pm._step_core(*(torch.from_numpy(np.asarray(c))
                                 for c in cols))
        push = "dense" if 32 * 5 >= cap // 2 else "sparse"
        assert dict(pm.transfer.push_paths) == {f"val:{push}": 1}
    jm.table.state = jstate
    assert int(n) == int(jn) == 32
    np.testing.assert_allclose(float(num) / float(n), float(jloss),
                               rtol=1e-5)
    _hold(pm, jm, f"{rendering} step at cap {cap}")


# -- training ----------------------------------------------------------------------

@pytest.mark.parametrize("rendering", ["sparse", "dense"])
@pytest.mark.parametrize("cap", [DENSE_PUSH, SPARSE_PUSH])
def test_train_matches_jax(rendering, cap):
    """``train(niters=3)`` with ``inner_steps: 3`` over 10 batches: three
    groups and a tail of one eager step an epoch.  Per-epoch errors within
    1e-4 relative; the table within the envelope."""
    dense = "1" if rendering == "dense" else "0"
    jm, pm = _models(cap, inner_steps=3, dense_features=dense)
    data = libsvm.synthetic_dataset(**DATA)
    want = jm.train(data, niters=3)
    got = pm.train(data, niters=3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    m = pm.train_metrics
    assert m["rendering"] == rendering and m["steps"] == 30
    assert m["records"] == 900 and m["growths"] == 0
    assert not m["fused"] and m["graph_replays"] == 0     # CPU: eager
    if rendering == "sparse":
        push = "dense" if cap == DENSE_PUSH else "sparse"
        assert m["push_paths"] == {f"val:{push}": 30}
    else:
        assert m["push_paths"] == {}
    _hold(pm, jm, f"{rendering} train at cap {cap}")


def test_dense_features_auto_is_sparse():
    """``auto`` flips to dense only on a TPU (the JAX rule): sparse here,
    as in JAX on the CPU; ``1`` is dense, ``0`` sparse."""
    for mode, want in (("auto", False), ("0", False), ("1", True),
                       ("on", True), ("off", False)):
        jc, pc = _configs(dense_features=mode)
        assert LogisticRegression(config=pc, device="cpu").dense_enabled() \
            is want
        assert JaxLR(config=jc, capacity_per_shard=256).dense_enabled() \
            is want


def test_scan_unroll_changes_nothing():
    """``scan_unroll`` is read and has no effect (no loop to unroll)."""
    runs = []
    for unroll in (1, 4):
        jm, pm = _models(SPARSE_PUSH, inner_steps=3, scan_unroll=unroll)
        assert pm.scan_unroll == unroll
        runs.append((pm.train(libsvm.synthetic_dataset(**DATA), niters=2),
                     state_to_numpy(pm.table.state)))
    assert runs[0][0] == runs[1][0]
    for f in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][f], runs[1][1][f])


def _grow_replay(seed, cap, data, minibatch, F):
    """A fresh port model whose key index and table go through exactly
    the lookups and growths a training run makes, with no step: every
    slot holds the row that run draws for it."""
    pc = ConfigParser().update(CONF)
    m = LogisticRegression(config=pc, capacity_per_shard=cap, device="cpu",
                           seed=seed)
    for batch in libsvm.iter_minibatches(data, minibatch, F):
        keys = np.where(batch.mask, batch.feat_ids, 0)
        while True:
            try:
                m.table.key_index.lookup(keys)
                break
            except CapacityError:
                m.table.grow()
    return m


def test_growth_slot_layout_and_moved_rows_equal_jax():
    """Growth against the JAX package, part one: the same batches grow
    both tables at the same lookups; every key keeps the same slot on both
    sides and every occupied row keeps its values bit for bit, on the port
    and against JAX (the new rows are each framework's own draws, so the
    port takes JAX's table again after each growth)."""
    jm, pm = _models(16)
    data = libsvm.synthetic_dataset(200, 60, 5, seed=4)
    grows = 0
    for batch in libsvm.iter_minibatches(data, 8, 5):
        keys = np.where(batch.mask, batch.feat_ids, 0)
        while True:
            try:
                got = pm.table.key_index.lookup(keys)
                want = jm.table.key_index.lookup(keys)
                np.testing.assert_array_equal(got, want)
                break
            except CapacityError:
                with pytest.raises(Exception, match="full"):
                    jm.table.key_index.lookup(keys)
                _, old = _index_arrays(pm.table.key_index)
                before = state_to_numpy(pm.table.state)
                pm.table.grow()
                jm.table.grow()
                grows += 1
                assert pm.table.generation == grows
                assert list(pm.table.key_index.items()) == \
                    list(jm.table.key_index.items())
                _, new = _index_arrays(pm.table.key_index)
                after = state_to_numpy(pm.table.state)
                for f, a in jm.table.state.items():
                    np.testing.assert_array_equal(after[f][new],
                                                  before[f][old])
                    np.testing.assert_array_equal(after[f][new],
                                                  np.asarray(a)[new])
                # the new rows are each side's own draws: start the next
                # growth from JAX's again
                pm.table.state = state_from_jax(
                    {f: np.asarray(a) for f, a in jm.table.state.items()},
                    "cpu")
    assert grows == 2 and pm.table.capacity == jm.table.capacity == 64


def test_growing_train_matches_a_run_that_needs_no_growth():
    """Growth, part two: a run that grows from 16 rows mid-epoch (with
    ``inner_steps: 3``, so queued groups flush before each growth) against
    a run at the final capacity that starts with the same row for every
    slot (the lookups and growths replayed with no step): per-epoch errors
    within 1e-4 relative, the table within the envelope (the push path of
    the small table is dense, the large one's sparse: another rounding of
    the mean)."""
    data = libsvm.synthetic_dataset(200, 60, 5, seed=4)
    pc = ConfigParser().update(CONF)
    pc.set("worker", "minibatch", 4)
    pc.set("worker", "inner_steps", 3)
    growing = LogisticRegression(config=pc, capacity_per_shard=16,
                                 device="cpu", seed=7)
    got = growing.train(data, niters=2)
    assert growing.train_metrics["growths"] == 2
    assert growing.train_metrics["capacity"] == 64
    assert set(growing.train_metrics["push_paths"]) == {"val:dense",
                                                        "val:sparse"}
    replay = _grow_replay(7, 16, data, 4, 5)
    ref = LogisticRegression(config=pc, capacity_per_shard=64, device="cpu")
    ref.table.state = {f: t.clone() for f, t in replay.table.state.items()}
    ref.table.key_index.restore(*_index_arrays(replay.table.key_index))
    assert list(replay.table.key_index.items()) == \
        list(growing.table.key_index.items())
    want = ref.train(data, niters=2)
    assert ref.train_metrics["growths"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for f in ref.table.state:
        _envelope(growing.table.state[f].numpy(),
                  ref.table.state[f].numpy(), f)


def _index_arrays(key_index):
    keys = np.fromiter(key_index.keys(), np.uint64, len(key_index))
    slots = np.fromiter((s for _, s in key_index.items()), np.int64,
                        len(key_index))
    return keys, slots


def test_predict_and_error_rate_match_jax():
    jm, pm = _models(SPARSE_PUSH)
    data = libsvm.synthetic_dataset(**DATA)
    jm.train(data, niters=2)
    pm.train(data, niters=2)
    got, want = pm.predict(data), jm.predict(data)
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pm.error_rate(data) == jm.error_rate(data)
    unseen = libsvm.synthetic_dataset(20, 80, 5, seed=9)  # new keys too
    np.testing.assert_allclose(pm.predict(unseen), jm.predict(unseen),
                               rtol=1e-5, atol=1e-6)


def test_save_is_jax_byte_for_byte_and_loads_back(tmp_path):
    jm, pm = _models(SPARSE_PUSH)
    data = libsvm.synthetic_dataset(**DATA)
    jm.train(data, niters=1)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    pm.table.key_index.restore(*_index_arrays(jm.table.key_index))
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert pm.save(str(a)) == jm.save(str(b)) == len(jm.table.key_index)
    assert a.read_bytes() == b.read_bytes()
    fresh = LogisticRegression(config=ConfigParser().update(CONF),
                               capacity_per_shard=16, device="cpu")
    assert fresh.load(str(a)) == len(jm.table.key_index)
    assert fresh.table.capacity >= len(jm.table.key_index)
    np.testing.assert_array_equal(fresh.predict(data), pm.predict(data))


# -- the sharded server --------------------------------------------------------------

def test_sharded_train_matches_xla_by_key():
    """``transfer: tpu`` with 8 ranks against ``transfer: xla`` from the
    same initial rows (each key's row copied to its slot on either
    layout): per-epoch errors within 1e-4 relative, every key's row within
    the envelope."""
    data = libsvm.synthetic_dataset(256, 40, 5, seed=6)
    one = LogisticRegression(config=ConfigParser().update(CONF),
                             capacity_per_shard=SPARSE_PUSH, device="cpu")
    pc = ConfigParser().update(CONF)
    pc.set("cluster", "transfer", "tpu")
    pc.set("cluster", "server_num", 8)
    pc.set("worker", "inner_steps", 2)
    eight = LogisticRegression(config=pc, capacity_per_shard=128,
                               device="cpu")
    keys = np.unique(np.concatenate(
        [np.asarray([0], np.uint64)]
        + [np.asarray([k for k, _ in f], np.uint64) for _, f in data]))
    s1 = one.table.key_index.lookup(keys)
    s8 = eight.table.key_index.lookup(keys)
    for f in ("val", "grad2sum"):
        eight.table.write_rows(f, s8, one.table.state[f][s1.astype(np.int64)])
    want = one.train(data, niters=2)
    got = eight.train(data, niters=2)
    assert eight.transfer.name == "tpu" and eight.cluster.n_servers == 8
    assert set(eight.train_metrics["push_paths"]) == {"val:routed"}
    np.testing.assert_allclose(got, want, rtol=1e-4)
    a = state_to_numpy(eight.table.state)
    for f in ("val", "grad2sum"):
        _envelope(a[f][s8], one.table.state[f].numpy()[s1], f)


# -- the CLI ------------------------------------------------------------------------

def test_lr_main_train_predict_eval_on_cpu(tmp_path, capsys):
    """``lr_main`` end to end with ``-device cpu``: train through the
    native parser, predict and eval with the weights; the port's predict
    and eval on the JAX CLI's weights file equal the JAX CLI's."""
    data = libsvm.synthetic_dataset(80, 20, 4, seed=5)
    svm = tmp_path / "train.svm"
    _write_svm(svm, data)
    conf = tmp_path / "lr.conf"
    conf.write_text("[cluster]\nserver_num: 1\ntransfer: xla\n"
                    "[worker]\nminibatch: 16\ninner_steps: 2\n"
                    "[server]\ninitial_learning_rate: 0.5\n")
    weights, preds = str(tmp_path / "w.txt"), str(tmp_path / "p.txt")
    common = ["lr", "-config", str(conf), "-dataset", str(svm), "-device",
              "cpu"]
    reset_global_config()
    assert lr_main.main(common + ["-mode", "train", "-niters", "20",
                                  "-output", weights]) == 0
    assert len(open(weights).readlines()) == len(
        {k for _, f in data for k, _ in f})
    reset_global_config()
    assert lr_main.main(common + ["-mode", "predict", "-param", weights,
                                  "-output", preds]) == 0
    assert len(open(preds).readlines()) == 80
    reset_global_config()
    capsys.readouterr()
    assert lr_main.main(common + ["-mode", "eval", "-param", weights]) == 0
    err = float(capsys.readouterr().out.split()[-1])
    assert 0.0 <= err < 0.4
    reset_global_config()
    assert lr_main.main(common + ["-mode", "eval"]) == 1
    assert lr_main.main(common + ["-mode", "nope"]) == 1

    # the JAX CLI's weights through both CLIs' predict and eval
    jweights = str(tmp_path / "jw.txt")
    jconf = tmp_path / "jlr.conf"
    jconf.write_text(conf.read_text())
    assert jax_lr_main.main(["lr", "-mode", "train", "-config", str(jconf),
                             "-dataset", str(svm), "-niters", "5",
                             "-output", jweights]) == 0
    outs = {}
    for name, main, extra in (("jax", jax_lr_main.main, []),
                              ("port", lr_main.main, ["-device", "cpu"])):
        reset_global_config()
        p = str(tmp_path / f"{name}_p.txt")
        assert main(["lr", "-mode", "predict", "-config", str(jconf),
                     "-dataset", str(svm), "-param", jweights, "-output", p]
                    + extra) == 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["lr", "-mode", "eval", "-config", str(jconf),
                         "-dataset", str(svm), "-param", jweights]
                        + extra) == 0
        outs[name] = (np.loadtxt(p), buf.getvalue())
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], atol=2e-6)
    assert outs["port"][1] == outs["jax"][1]


def test_unported_config_raises(tmp_path, monkeypatch):
    """The sections the JAX package's LR does not read ([obs], [worker]
    telemetry, [control]) no longer raise: the port trains with each key
    set, as the JAX model does, and the two agree (per-epoch errors within
    1e-4 relative, the table within the envelope)."""
    from swiftmpi_tpu_torch import obs
    monkeypatch.chdir(tmp_path)
    data = libsvm.synthetic_dataset(**DATA)
    try:
        for sec, key in (("obs", "numerics"), ("worker", "telemetry"),
                         ("control", "control")):
            jm, pm = _models(SPARSE_PUSH, inner_steps=3)
            for m in (jm, pm):
                m.config.set(sec, key, 1)
            want = jm.train(data, niters=2)
            got = pm.train(data, niters=2)
            np.testing.assert_allclose(got, want, rtol=1e-4)
            _hold(pm, jm, f"[{sec}] {key}")
    finally:
        obs.reset_for_tests()
