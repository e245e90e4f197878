"""The port's embedding index (``swiftmpi_tpu_torch/models/embedding.py``)
and ``w2v_eval`` CLI against the JAX package's, on the CPU, on the same
vectors and dumps.

``torch.topk`` and ``jax.lax.top_k`` may order tied scores differently, so
neighbours are compared as key sets where the scores are distinct by more
than 1e-6, and the scores within the envelope ``1e-6 + 1e-5 * |b|`` (float32
products of d terms summed in another order); where no score ties, keys
and scores come back in the same order.
"""

import numpy as np
import pytest

from swiftmpi_tpu.apps import w2v_eval as jax_w2v_eval
from swiftmpi_tpu.models.embedding import EmbeddingIndex as JaxIndex
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import w2v_eval
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.data.text import synthetic_corpus
from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex


def _vectors(V=200, d=12, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.choice(10 ** 6, V, replace=False).astype(np.uint64)
    return keys, rng.normal(size=(V, d)).astype(np.float32)


def _close_scores(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _same_neighbours(gk, gs, wk, ws):
    """Keys in the same order where the scores are 1e-6 apart; scores
    within the envelope."""
    _close_scores(gs, ws)
    gk, wk, ws = np.asarray(gk), np.asarray(wk), np.asarray(ws)
    distinct = np.ones(len(ws), bool)
    distinct[1:] &= np.abs(np.diff(ws)) > 1e-6
    distinct[:-1] &= np.abs(np.diff(ws)) > 1e-6
    np.testing.assert_array_equal(gk[distinct], wk[distinct])


def test_topk_neighbours_and_analogies_match_jax():
    keys, vecs = _vectors()
    port, jax_ = EmbeddingIndex(keys, vecs, device="cpu"), JaxIndex(keys,
                                                                   vecs)
    np.testing.assert_array_equal(port.vecs, jax_.vecs)
    q = np.random.default_rng(1).normal(size=(7, 12)).astype(np.float32)
    excl = [[0, 1, 2], [], [5], [9, 9], [], [3], [199]]
    gk, gs = port.topk(q, 10, exclude_rows=excl)
    wk, ws = jax_.topk(q, 10, exclude_rows=excl)
    assert gk.shape == wk.shape == (7, 10)
    for i in range(7):
        _same_neighbours(gk[i], gs[i], wk[i], ws[i])
    some = [int(k) for k in keys[[0, 17, 42]]]
    for a, b in zip(zip(*port.neighbors_batch(some, 5)),
                    zip(*jax_.neighbors_batch(some, 5))):
        _same_neighbours(a[0], a[1], b[0], b[1])
    _same_neighbours(*port.neighbors(some[1], 8), *jax_.neighbors(some[1], 8))
    _same_neighbours(*port.analogy(*some, k=6), *jax_.analogy(*some, k=6))
    with pytest.raises(KeyError):
        port.neighbors(12345678901)
    with pytest.raises(KeyError):
        port.analogy(some[0], some[1], 12345678901)


def test_ties_compare_as_sets():
    """Duplicated rows tie: the tied keys may come back in either order,
    the scores and the key sets agree."""
    keys, vecs = _vectors(V=40, d=6, seed=2)
    vecs[10:20] = vecs[5]                 # ten rows tied with row 5
    port, jax_ = EmbeddingIndex(keys, vecs, device="cpu"), JaxIndex(keys,
                                                                   vecs)
    gk, gs = port.neighbors(int(keys[5]), 12)
    wk, ws = jax_.neighbors(int(keys[5]), 12)
    _close_scores(gs, ws)
    assert set(gk[:10].tolist()) == set(wk[:10].tolist()) \
        == set(keys[10:20].tolist())


def test_exclusions_pad_and_clamp_like_jax():
    keys, vecs = _vectors(V=5, d=3, seed=3)
    port, jax_ = EmbeddingIndex(keys, vecs, device="cpu"), JaxIndex(keys,
                                                                   vecs)
    q = vecs[:2]
    for k, excl in ((3, [[0, 1, 2, 3, 4], [1]]), (10, [[0], []])):
        gk, gs = port.topk(q, k, exclude_rows=excl)
        wk, ws = jax_.topk(q, k, exclude_rows=excl)
        assert gk.shape == wk.shape
        np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
        np.testing.assert_array_equal(gk[np.isfinite(gs)],
                                      wk[np.isfinite(ws)])


@pytest.fixture(scope="module")
def w2v_dump(tmp_path_factory):
    """A JAX word2vec model's dump (``key TAB v TAB h``) and its vocab."""
    conf = {"cluster": {"server_num": 1, "transfer": "xla"},
            "word2vec": {"len_vec": 10, "window": 2, "negative": 3,
                         "sample": -1, "min_sentence_length": 2},
            "worker": {"minibatch": 64}}
    jm = JaxWord2Vec(config=JaxConfig().update(conf))
    jm.train(synthetic_corpus(40, vocab_size=60, length=12, seed=4),
             niters=1, batch_size=64)
    path = str(tmp_path_factory.mktemp("eval") / "vectors.txt")
    jm.save(path)
    return path, jm.vocab.keys


@pytest.mark.parametrize("field", ["v", "h"])
@pytest.mark.parametrize("reader", ["native", "python"])
def test_from_text_equals_jax(w2v_dump, field, reader, monkeypatch):
    path, vocab_keys = w2v_dump
    if reader == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    port = EmbeddingIndex.from_text(path, field=field, device="cpu")
    jax_ = JaxIndex.from_text(path, field=field)
    np.testing.assert_array_equal(port.keys, jax_.keys)
    np.testing.assert_array_equal(port.vecs, jax_.vecs)
    assert set(port.keys.tolist()) == set(vocab_keys.tolist())
    with pytest.raises(ValueError):
        EmbeddingIndex.from_text(path, field="x", device="cpu")


def test_single_vector_dump_refuses_h(tmp_path):
    path = tmp_path / "one.txt"
    path.write_text("7\t1 2 3\n8\t3 2 1\n")
    idx = EmbeddingIndex.from_text(str(path), device="cpu")
    assert len(idx) == 2 and idx.vecs.shape == (2, 3)
    with pytest.raises(ValueError):
        EmbeddingIndex.from_text(str(path), field="h", device="cpu")


@pytest.mark.parametrize("args", [
    ["-query", "{a},{b}", "-topk", "4"],
    ["-analogy", "{a}:{b}::{c}", "-topk", "3"],
    ["-query", "{a}", "-field", "h", "-topk", "5"],
    ["-query", "nosuchword"],
    ["-query", "{a}", "-hash", "nope"],
    ["-query", "{a}", "-topk", "x"]])
def test_cli_prints_what_jax_prints(w2v_dump, args, capsys):
    """The port's ``w2v_eval`` (``-device cpu``) and the JAX CLI on the
    same dump: the same exit code and, on a set with no tied scores, the
    same lines."""
    path, keys = w2v_dump
    fill = {"a": int(keys[0]), "b": int(keys[3]), "c": int(keys[7])}
    argv = ["eval", "-embeddings", path] + [a.format(**fill) for a in args]
    capsys.readouterr()
    rc_port = w2v_eval.main(argv + ["-device", "cpu"])
    out_port = capsys.readouterr().out
    rc_jax = jax_w2v_eval.main(argv)
    out_jax = capsys.readouterr().out
    assert rc_port == rc_jax
    assert out_port == out_jax


def test_cli_names_bkdr_neighbours_like_jax(tmp_path, capsys):
    words = ["apple", "pear", "plum", "fig", "kiwi", "lime"]
    from swiftmpi_tpu_torch.data.text import bkdr_hash
    rng = np.random.default_rng(5)
    path = tmp_path / "bkdr.txt"
    with open(path, "w") as f:
        for w in words:
            f.write(f"{bkdr_hash(w)}\t"
                    + " ".join(f"{x:.6f}" for x in rng.normal(size=4))
                    + "\n")
    vocab = tmp_path / "words.txt"
    vocab.write_text(" ".join(words) + "\n")
    argv = ["eval", "-embeddings", str(path), "-query", "apple,fig",
            "-hash", "bkdr", "-words", str(vocab), "-topk", "3"]
    capsys.readouterr()
    assert w2v_eval.main(argv + ["-device", "cpu"]) == 0
    out_port = capsys.readouterr().out
    assert jax_w2v_eval.main(argv) == 0
    assert out_port == capsys.readouterr().out
    assert "pear" in out_port or "plum" in out_port
