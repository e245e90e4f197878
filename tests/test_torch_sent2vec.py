"""The port's sent2vec (``swiftmpi_tpu_torch/models/sent2vec.py``) and its
CLI against the JAX package's, on the CPU, at the sizes of
``tests/test_sent2vec.py`` (len_vec 12, window 2, negative 4, a few
sentences, niters 3).

The port replays the JAX package's draws: per batch the key split JAX
takes, ``sent0`` from its ``k_init``, and per pass the window shrink
``b`` and the ``(j, u)`` that ``_alias_draw_packed`` derives from its
``kn``.  Tolerance: every element within ``1e-6 + 1e-4 * |b|`` of JAX's
vector — 3 passes of up to 16 sequential updates in float32, where
XLA's and torch's reductions differ only in the order of a few terms
(the largest gap seen is ~1.5e-8 on values of ~0.1).  ``write`` is the
JAX package's format byte for byte, and the word table stays frozen.
"""

import numpy as np
import pytest
import torch

import jax

from swiftmpi_tpu.data.text import synthetic_corpus as jax_synthetic
from swiftmpi_tpu.models.sent2vec import Sent2Vec as JaxSent2Vec
from swiftmpi_tpu.models.sent2vec import \
    build_word_model_from_dump as jax_build
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import sent2vec_main
from swiftmpi_tpu_torch.data.text import bkdr_hash
from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 12, "window": 2, "negative": 4, "sample": -1,
                 "learning_rate": 0.1, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 8},
}
NITERS = 3
#: sentence lengths: two batches of 8, L bucketed to 16 and 8
LENGTHS = [12, 3, 7, 12, 5, 12, 9, 2, 12, 4, 6]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A JAX word model trained two iterations, dumped by its ``save``;
    the corpus it trained on."""
    corpus = jax_synthetic(30, vocab_size=50, length=12, seed=3)
    jm = JaxWord2Vec(config=JaxConfig().update(CONF))
    jm.train(corpus, niters=2, batch_size=64)
    path = str(tmp_path_factory.mktemp("s2v") / "words.txt")
    jm.save(path)
    return path, corpus


def _lines(corpus):
    lines = [" ".join(map(str, s[:n])) for s, n in zip(corpus, LENGTHS)]
    return lines + ["999991 999992"]                 # all out of vocab


def _jax_draws(seed, lines, vocab_size, S=8, W=2, K=4, d=12):
    """The draws ``Sent2Vec(seed=seed).infer_sentences`` takes in JAX, per
    batch of the kept lines."""
    key = jax.random.key(seed ^ 0xD0C)
    out = []
    for start in range(0, len(lines), S):
        chunk = lines[start:start + S]
        L = 1 << (max(len(ln.split()) for ln in chunk) - 1).bit_length()
        key, sub = jax.random.split(key)
        k_init, k = jax.random.split(sub)
        sent0 = np.asarray((jax.random.uniform(k_init, (S, d)) - 0.5) / d)
        passes = []
        for _ in range(NITERS):
            k, kb, kn = jax.random.split(k, 3)
            k1, k2 = jax.random.split(kn)
            passes.append((
                np.asarray(jax.random.randint(kb, (S, L), 0, W)),
                np.asarray(jax.random.randint(k1, (S, L, K), 0, vocab_size)),
                np.asarray(jax.random.uniform(k2, (S, L, K)))))
        out.append((sent0, passes))
    return out


def _port_model(path, **conf):
    c = ConfigParser().update(CONF)
    for sec, kv in conf.items():
        for k, v in kv.items():
            c.set(sec, k, v)
    return build_word_model_from_dump(path, c, device="cpu")


@pytest.mark.parametrize("shards", [1, 8])
def test_vectors_match_jax_with_replayed_draws(dump, shards):
    """JAX's vectors within 1e-6 + 1e-4|b| (the all-OOV line skipped on
    both sides, ids the BKDR hash of the line); over a word table of 8
    shards the port gives the same bits as over one."""
    path, corpus = dump
    lines = _lines(corpus)
    js = JaxSent2Vec(jax_build(path, JaxConfig().update(CONF)), seed=1)
    want = js.infer_sentences(lines, niters=NITERS)
    conf = ({"cluster": {"server_num": 8, "transfer": "tpu"}}
            if shards == 8 else {})
    pm = _port_model(path, **conf)
    assert pm.cluster.n_servers == shards
    draws = _jax_draws(1, lines[:-1], len(pm.vocab))
    got = Sent2Vec(pm, seed=1).infer_sentences(lines, niters=NITERS,
                                               draws=iter(draws))
    assert [s for s, _ in got] == [s for s, _ in want] \
        == [bkdr_hash(ln) for ln in lines[:-1]]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == (12,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    if shards == 1:
        one = Sent2Vec(_port_model(path), seed=1).infer_sentences(
            lines, niters=NITERS, draws=iter(draws))
        for (_, a), (_, b) in zip(got, one):
            np.testing.assert_array_equal(a, b)


def test_write_is_the_jax_format_and_ids_are_bkdr(dump, tmp_path):
    path, corpus = dump
    lines = _lines(corpus)
    want = JaxSent2Vec(jax_build(path, JaxConfig().update(CONF)),
                       seed=1).infer_sentences(lines, niters=NITERS)
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    JaxSent2Vec.write(None, want, a)
    Sent2Vec(_port_model(path)).write(want, b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_word_table_stays_frozen_and_seed_repeats(dump):
    path, corpus = dump
    pm = _port_model(path)
    before = {f: t.clone() for f, t in pm.table.state.items()}
    lines = _lines(corpus)[:4]
    a = Sent2Vec(pm, seed=1).infer_sentences(lines, niters=NITERS)
    b = Sent2Vec(pm, seed=1).infer_sentences(lines, niters=NITERS)
    for f, t in pm.table.state.items():
        assert torch.equal(before[f], t)
    for (sa, va), (sb, vb) in zip(a, b):
        assert sa == sb
        np.testing.assert_array_equal(va, vb)
        assert np.isfinite(va).all() and np.abs(va).max() > 0.5 / 12


def test_dump_load_grows_an_undersized_table_like_jax(dump):
    """At 8 rows a shard the dump's 50 words do not fit: both packages
    grow the table to the same capacity, with the same key -> slot map
    and the same rows, and the vocab is the dump's keys in order."""
    path, _ = dump
    jm = jax_build(path, JaxConfig().update(CONF), capacity_per_shard=8)
    pm = build_word_model_from_dump(path, ConfigParser().update(CONF),
                                    capacity_per_shard=8, device="cpu")
    assert pm.table.capacity == jm.table.capacity == 64
    assert list(pm.table.key_index.items()) == \
        list(jm.table.key_index.items())
    np.testing.assert_array_equal(pm.vocab.keys, jm.vocab.keys)
    np.testing.assert_array_equal(pm._slot_of_vocab.numpy(),
                                  np.asarray(jm._slot_of_vocab))
    occ = pm._slot_of_vocab.long().numpy()
    got = pm.table.to_numpy()
    for f in ("h", "v"):
        np.testing.assert_array_equal(got[f][occ],
                                      np.asarray(jm.table.state[f])[occ])


def test_snapshot_and_serving_are_refused(dump):
    path, corpus = dump
    s2v = Sent2Vec(_port_model(path))
    with pytest.raises(NotImplementedError, match="A13"):
        s2v.infer_sentences(_lines(corpus), snapshot=object())
    s2v.serve_publisher = object()
    with pytest.raises(NotImplementedError, match="A13"):
        s2v.infer_sentences(_lines(corpus))


def test_sent2vec_cli(dump, tmp_path):
    """``sent2vec_main`` end to end on the CPU: one vector per kept line,
    keyed by the line's BKDR hash, the values the library call's."""
    path, corpus = dump
    lines = _lines(corpus)
    data = tmp_path / "sents.txt"
    data.write_text("\n".join(lines) + "\n\n")
    conf = tmp_path / "s2v.conf"
    conf.write_text("[word2vec]\nlen_vec: 12\nwindow: 2\nnegative: 4\n"
                    "learning_rate: 0.1\n[worker]\nminibatch: 8\n")
    out = tmp_path / "vecs.txt"
    reset_global_config()
    try:
        assert sent2vec_main.main(
            ["s2v", "-config", str(conf), "-data", str(data), "-niters",
             "3", "-wordvec", path, "-output", str(out), "-device",
             "cpu"]) == 0
    finally:
        reset_global_config()
    rows = [ln.split("\t") for ln in out.read_text().splitlines()]
    assert [int(r[0]) for r in rows] == [bkdr_hash(ln) for ln in lines[:-1]]
    want = Sent2Vec(_port_model(path)).infer_sentences(lines, niters=3)
    for r, (_, v) in zip(rows, want):
        np.testing.assert_array_equal(np.array(r[1].split(), np.float64),
                                      v.astype(np.float64))
    assert sent2vec_main.main(["s2v", "-help"]) == 0


def test_sent2vec_cli_without_device_needs_cuda(dump, tmp_path, monkeypatch):
    """No ``-device``: the CUDA device or an error, never a silent CPU
    run."""
    path, corpus = dump
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "sents.txt"
    data.write_text("\n".join(_lines(corpus)) + "\n")
    reset_global_config()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sent2vec_main.main(["s2v", "-data", str(data), "-wordvec", path])
    finally:
        reset_global_config()
