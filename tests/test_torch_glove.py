"""The port's GloVe (``swiftmpi_tpu_torch/models/glove.py``,
``apps/glove_main.py``) against the JAX package's, on the CPU, on the same
corpus, the same initial table (``convert.state_from_jax``) and the same
numpy permutations (both draw them from ``np.random.default_rng(seed)``).

Tolerances: tables within the repo's envelope ``|a - b| <= 1e-5 + 1e-3 *
|b|``; losses within 1e-4 relative (float32 device sums against JAX's
float64 host sum of group losses); ``cooccurrence``, staging and the
dumps exactly.  The capacity picks the push path: a batch of B slots at or
above half of it pushes dense (B3 and B1's table form per family), below
it sparse (B1's row form per family, the mean's reciprocal inside the
launch: the rounding JAX's sparse push gives two families).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu.data.text import build_vocab as jax_build_vocab
from swiftmpi_tpu.models.glove import GloVe as JaxGloVe
from swiftmpi_tpu.models.glove import cooccurrence as jax_cooccurrence
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import glove_main, w2v_eval
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import build_vocab
from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex
from swiftmpi_tpu_torch.models.glove import GloVe, cooccurrence, glove_access
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config

CONF = {
    "cluster": {"transfer": "xla", "server_num": 1},
    "glove": {"len_vec": 16, "window": 4, "learning_rate": 0.05,
              "minibatch": 64},
}
#: capacities: a batch of 64 slots pushes dense at 96 rows, sparse at 256
DENSE_PUSH, SPARSE_PUSH = 96, 256


def make_corpus(seed=0, vocab=60, n=80, length=20):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, length)]
            for _ in range(n)]


def _envelope(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                               err_msg=what)


def _models(sents, cap, **worker):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for k, v in worker.items():
        jc.set("worker", k, v)
        pc.set("worker", k, v)
    jm = JaxGloVe(config=jc, capacity_per_shard=cap).build(sents)
    pm = GloVe(config=pc, capacity_per_shard=cap, device="cpu").build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    return jm, pm


def _hold(pm, jm, what=""):
    got = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(got[f], np.asarray(a), f"{what} {f}")


@pytest.mark.parametrize("window", [1, 3, 10])
def test_cooccurrence_equals_jax(window):
    sents = make_corpus(seed=window, vocab=40, n=30, length=15)
    sents += [[5], [], [7, 7, 7], [999, 1000]]   # short, repeated, new keys
    pv, jv = build_vocab(sents), jax_build_vocab(sents)
    np.testing.assert_array_equal(pv.keys, jv.keys)
    for k in (5, 999, 123456, -1):
        assert pv.index_of(k) == jv.index_of(k)
    got = cooccurrence(sents, pv, window)
    want = jax_cooccurrence(sents, jv, window)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # OOV tokens drop out of the sentence, as in JAX
    held = [[1, 2, 3], [2, 3, 4]]
    probe = [[1, 77, 2, 3]]
    got = cooccurrence(probe, build_vocab(held), 2)
    want = jax_cooccurrence(probe, jax_build_vocab(held), 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_glove_access_schema():
    acc = glove_access(0.05, 8)
    assert acc.pull_fields == ("w", "wt", "b", "bt")
    assert {f: s.dim for f, s in acc.fields.items()} == {
        "w": 8, "wt": 8, "b": 1, "bt": 1, "w2sum": 8, "wt2sum": 8,
        "b2sum": 1, "bt2sum": 1}


def test_stage_host_equals_jax():
    """Slots, log x and f(x) of a selection, cycled to ``inner * B``."""
    sents = make_corpus(seed=1)
    jm, pm = _models(sents, SPARSE_PUSH)
    np.testing.assert_array_equal(pm._slot_of_vocab,
                                  np.asarray(jm._slot_of_vocab))
    sel = np.random.default_rng(3).permutation(len(pm._coo[2]))[:100]
    for inner, B in ((1, 64), (3, 50)):
        got = pm.stage_host(sel, inner, B)
        want = jm.stage_host(sel, inner, B)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype and a.shape == (inner, B)


@pytest.mark.parametrize("cap", [DENSE_PUSH, SPARSE_PUSH])
def test_one_step_matches_jax(cap):
    """One minibatch: two pulls and two mean pushes of two families; the
    table within the envelope, the loss within 1e-5 relative."""
    sents = make_corpus(seed=2)
    jm, pm = _models(sents, cap)
    sel = np.random.default_rng(4).permutation(len(pm._coo[2]))[:64]
    jstate, jloss = jm._build_step()(
        dict(jm.table.state), *(jnp.asarray(a)
                                for a in jm.stage_host(sel, 1, 64)))
    jm.table.state = jstate
    fields = pm.stage(sel, 1, 64)
    (loss,) = pm._step(*(f[0] for f in fields))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    push = "dense" if 64 >= cap // 2 else "sparse"
    assert dict(pm.transfer.push_paths) == {f"w,b:{push}": 1,
                                            f"wt,bt:{push}": 1}
    _hold(pm, jm, f"step at cap {cap}")


@pytest.mark.parametrize("cap,pipeline", [(DENSE_PUSH, 0), (SPARSE_PUSH, 0),
                                          (SPARSE_PUSH, 2)])
def test_train_matches_jax(cap, pipeline):
    """``train(niters=3)`` with ``inner_steps: 3`` from the same table and
    the same permutations: per-epoch losses within 1e-4 relative, tables
    within the envelope; ``pipeline: 2`` changes nothing but when staging
    happens."""
    sents = make_corpus(seed=5)
    jm, pm = _models(sents, cap, inner_steps=3, pipeline=pipeline)
    want = jm.train(niters=3)
    got = pm.train(niters=3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    m = pm.train_metrics
    n = len(pm._coo[2])
    groups = -(-n // (64 * 3))
    assert m["steps"] == 3 * 3 * groups and not m["fused"]
    push = "dense" if cap == DENSE_PUSH else "sparse"
    assert m["push_paths"] == {f"w,b:{push}": m["steps"],
                               f"wt,bt:{push}": m["steps"]}
    if pipeline:
        assert m["pipeline"]["produced"] == m["pipeline"]["consumed"] \
            == 3 * groups
    _hold(pm, jm, f"train at cap {cap}")


def test_tiny_set_with_large_inner_steps_cycles():
    """A group larger than the whole co-occurrence set pads by cycling,
    as in JAX (tests/test_glove.py's tiny set)."""
    conf = {"cluster": {"transfer": "xla", "server_num": 1},
            "glove": {"len_vec": 4, "window": 2, "learning_rate": 0.05,
                      "minibatch": 16},
            "worker": {"inner_steps": 4}}
    sents = [[1, 2, 3], [2, 3, 1]]
    jm = JaxGloVe(config=JaxConfig().update(conf)).build(sents)
    pm = GloVe(config=ConfigParser().update(conf), device="cpu").build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    np.testing.assert_allclose(pm.train(niters=2), jm.train(niters=2),
                               rtol=1e-4)
    _hold(pm, jm, "tiny")


def test_save_and_save_full_are_jax_byte_for_byte(tmp_path):
    sents = make_corpus(seed=6)
    jm, pm = _models(sents, SPARSE_PUSH)
    jm.train(niters=1)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    for name in ("save", "save_full"):
        a, b = tmp_path / f"port_{name}.txt", tmp_path / f"jax_{name}.txt"
        assert getattr(pm, name)(str(a)) == getattr(jm, name)(str(b)) \
            == len(pm.vocab)
        assert a.read_bytes() == b.read_bytes(), name
    np.testing.assert_array_equal(pm._vectors(), jm._vectors())
    idx = pm.embedding_index()
    assert idx.device == torch.device("cpu") and len(idx) == len(pm.vocab)


def test_sharded_train_matches_xla_by_key():
    """``transfer: tpu`` with 8 ranks against ``transfer: xla`` from the
    same initial rows, key by key: losses within 1e-4 relative, every
    word's row within the envelope."""
    sents = make_corpus(seed=7)
    conf = ConfigParser().update(CONF)
    conf.set("worker", "inner_steps", 2)
    one = GloVe(config=conf, capacity_per_shard=SPARSE_PUSH,
                device="cpu").build(sents)
    c8 = ConfigParser().update(CONF)
    c8.update({"cluster": {"transfer": "tpu", "server_num": 8},
               "worker": {"inner_steps": 2}})
    eight = GloVe(config=c8, capacity_per_shard=32, device="cpu").build(sents)
    s1 = one._slot_of_vocab.astype(np.int64)
    for f in one.access.fields:
        eight.table.write_rows(f, eight._slot_of_vocab,
                               one.table.state[f][s1])
    want = one.train(niters=2)
    got = eight.train(niters=2)
    assert eight.transfer.name == "tpu"
    assert set(eight.train_metrics["push_paths"]) == {"w,b:routed",
                                                      "wt,bt:routed"}
    np.testing.assert_allclose(got, want, rtol=1e-4)
    a = state_to_numpy(eight.table.state)
    for f in one.access.fields:
        _envelope(a[f][eight._slot_of_vocab], one.table.state[f].numpy()[s1],
                  f)


def test_glove_main_then_w2v_eval_on_cpu(tmp_path, capsys):
    """``glove_main`` end to end with ``-device cpu`` (both dumps), then
    ``w2v_eval`` queries its dump on the CPU."""
    data = tmp_path / "corpus.txt"
    with open(data, "w") as f:
        for s in make_corpus(seed=8, vocab=30, n=40):
            f.write(" ".join(map(str, s)) + "\n")
    conf = tmp_path / "glove.conf"
    conf.write_text("[cluster]\ntransfer: xla\nserver_num: 1\n"
                    "[glove]\nlen_vec: 8\nwindow: 3\nminibatch: 128\n"
                    "[worker]\ninner_steps: 2\n")
    out, full = str(tmp_path / "emb.txt"), str(tmp_path / "full.txt")
    reset_global_config()
    assert glove_main.main(["glove", "-config", str(conf), "-data",
                            str(data), "-niters", "3", "-output", out,
                            "-output-full", full, "-device", "cpu"]) == 0
    idx = EmbeddingIndex.from_text(out, device="cpu")
    assert idx.vecs.shape[1] == 8 and len(idx) == 29
    assert len(open(full).readline().split("\t")) == 5   # key w wt b bt
    key = int(idx.keys[0])
    capsys.readouterr()
    assert w2v_eval.main(["eval", "-embeddings", out, "-query", str(key),
                          "-topk", "3", "-device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"{key}:" and len(lines) == 4
    reset_global_config()


def test_unported_config_raises(tmp_path, monkeypatch):
    """[obs] numerics and [worker] telemetry no longer raise: the port's
    GloVe trains with each set, as the JAX model does, and the two agree
    (losses within 1e-4 relative, tables within the envelope).  With
    telemetry on both write a telemetry stream."""
    from swiftmpi_tpu_torch import obs
    monkeypatch.chdir(tmp_path)
    sents = make_corpus(seed=5)
    try:
        for sec, key in (("obs", "numerics"), ("worker", "telemetry")):
            jm, pm = _models(sents, SPARSE_PUSH, inner_steps=3)
            for m, name in ((jm, "jax"), (pm, "port")):
                m.config.set(sec, key, 1)
                m.config.set("worker", "telemetry_path",
                             str(tmp_path / f"{name}_{key}.jsonl"))
            want = jm.train(niters=2)
            got = pm.train(niters=2)
            np.testing.assert_allclose(got, want, rtol=1e-4)
            _hold(pm, jm, f"[{sec}] {key}")
            tel = key == "telemetry"
            for name in ("jax", "port"):
                assert (tmp_path / f"{name}_{key}.jsonl").exists() == tel
    finally:
        obs.reset_for_tests()
