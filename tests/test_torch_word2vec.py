"""The port's word2vec CBOW sync path (swiftmpi_tpu_torch.models.word2vec)
against the JAX package's, on the same corpus, table state and draws.

``jax.random`` and ``torch.Generator`` never give the same numbers, so
the step-level tests start the port from the JAX model's initial table
(``convert.state_from_jax``) and replay the ``(j, u)`` alias draws JAX
derives from each step's key.  Table envelope ``|a - b| <= 1e-5 +
1e-3 * |b|``; ``err_cnt`` exact.  A run with the port's own RNG is held to
the bands of ``test_w2v_oracle.py::test_loss_parity_vs_reference_oracle``.

The capacity is set to 600 slots on both sides so that, as at the full
demo.conf shape, the h push (B*(K+1) = 384 rows >= 300) goes dense and
the v push (B*2W = 256 rows < 300) goes sparse.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swiftmpi_tpu.data.text import CBOWBatcher as JaxBatcher
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter.key_index import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.testing import W2VOracle
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher, build_vocab
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter.key_index import KeyIndex
from swiftmpi_tpu_torch.utils import ConfigParser

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
CAP = 600
B = 64


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def corpus(n_sent=40, vocab=30, length=12, seed=0):
    """The oracle test's corpus: Zipf-ish keys 1..vocab."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _models(sents, cap=CAP, **conf):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for sec, kv in conf.items():
        for k, v in kv.items():
            jc.set(sec, k, v)
            pc.set(sec, k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    # the port starts from JAX's initial table: a plain copy, slot for slot
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    return jm, pm


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def test_key_index_assigns_jax_slots():
    """Same keys in the same lookup batches -> the same slots, so a table
    state carries across as a plain copy."""
    rng = np.random.default_rng(0)
    jk, pk = JaxKeyIndex(1, 500), KeyIndex(1, 500)
    for _ in range(4):
        keys = rng.integers(0, 2 ** 63, 40, dtype=np.uint64)
        keys = np.concatenate([keys, keys[:7], rng.integers(1, 60, 30)
                               .astype(np.uint64)])
        np.testing.assert_array_equal(pk.lookup(keys), jk.lookup(keys))
    assert list(pk.items()) == list(jk.items())
    assert pk.capacity == jk.capacity == 500 and len(pk) == len(jk)
    miss = np.array([2 ** 62 + 5], np.uint64)
    assert pk.lookup(miss, create=False)[0] == jk.lookup(
        miss, create=False)[0] == -1


def test_vocab_batches_and_slots_equal_jax():
    """Same vocab, the same slot per vocab index, and the same batches
    from the same batcher seed (subsampling on)."""
    sents = corpus(n_sent=60, vocab=300, length=16, seed=5)
    jm, pm = _models(sents)
    np.testing.assert_array_equal(pm.vocab.keys, jm.vocab.keys)
    np.testing.assert_array_equal(pm.vocab.counts, jm.vocab.counts)
    np.testing.assert_array_equal(pm._slot_of_vocab.numpy(),
                                  np.asarray(jm._slot_of_vocab))
    assert pm.table.capacity == jm.table.capacity == CAP
    jb = JaxBatcher(sents, jm.vocab, 2, sample=1e-2, seed=9)
    pb = CBOWBatcher(sents, pm.vocab, 2, sample=1e-2, seed=9)
    for _ in range(2):                                 # two epochs
        jbs, pbs = list(jb.epoch(B)), list(pb.epoch(B))
        assert len(jbs) == len(pbs) > 1
        for a, b in zip(jbs, pbs):
            np.testing.assert_array_equal(a.centers, b.centers)
            np.testing.assert_array_equal(a.contexts, b.contexts)
            np.testing.assert_array_equal(a.ctx_mask, b.ctx_mask)
            assert a.n_words == b.n_words


@pytest.mark.parametrize("form", ["lists", "array"])
def test_build_vocab_matches_jax(form):
    """Keys and counts equal to the JAX package's per-key counter, for key
    lists (negative and > 2**63 keys wrap to uint64) and for a token
    array such as ``synthetic_corpus_bulk`` gives."""
    from swiftmpi_tpu.data.text import build_vocab as jax_build_vocab
    from swiftmpi_tpu_torch.data.text import synthetic_corpus_bulk
    if form == "lists":
        sents = corpus(n_sent=50, vocab=300, length=20, seed=1)
        sents.append([-5, 2 ** 64 - 3, 7, -5])
        got = build_vocab(sents)
    else:
        arr = synthetic_corpus_bulk(30, 500, 40, seed=3)
        sents = [list(map(int, row)) for row in arr]
        got = build_vocab(arr)
    want = jax_build_vocab(sents)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_one_step_matches_jax_step():
    """One sync step with JAX's draws replayed == ``Word2Vec._step``
    (mirrors test_w2v_oracle.py::test_w2v_cbow_grads_match_numpy)."""
    sents = corpus(n_sent=60, vocab=300, length=16, seed=3)
    jm, pm = _models(sents)
    V, K, W2 = len(jm.vocab), jm.negative, 2 * jm.window
    rng = np.random.default_rng(1)
    centers = rng.integers(0, V, size=B).astype(np.int32)
    contexts = rng.integers(0, V, size=(B, W2)).astype(np.int32)
    ctx_mask = rng.random((B, W2)) < 0.8
    ctx_mask[0] = False          # one empty row: contributes nothing
    ctx_mask[1] = True
    key = jax.random.key(7)

    state0 = {f: np.array(a) for f, a in jm.table.state.items()}
    step = jm._build_step()
    out, es, ec = step(jm.table.state, jm._slot_of_vocab, jm._alias_prob,
                       jm._alias_idx, jnp.asarray(centers),
                       jnp.asarray(contexts), jnp.asarray(ctx_mask), key)
    got_es, got_ec = pm.step(centers, contexts, ctx_mask,
                             draws=_jax_draws(key, V, (B, K)))
    assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, float(es), rtol=1e-5)
    assert dict(pm.transfer.push_paths) == {"h:dense": 1, "v:sparse": 1}
    got = state_to_numpy(pm.table.state)
    for f in state0:
        _envelope(got[f], np.asarray(out[f]))
        assert not np.array_equal(got[f], state0[f])    # the step moved


def test_three_step_train_tracks_jax():
    """``train`` with per-step replayed draws: one batch per epoch, three
    epochs, so the per-iteration losses are the per-step losses."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents)
    V, K = len(jm.vocab), jm.negative
    want = jm.train(sents, niters=3, batch_size=B)
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, V, (B, K)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    assert pm.train_metrics["steps"] == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))


def test_loss_parity_vs_reference_oracle():
    """Own RNG on both sides: the port and the reference-faithful numpy
    oracle track the same trajectory inside the JAX test's bands."""
    sents = corpus(n_sent=40, vocab=30, length=12, seed=3)
    niters = 3
    oracle = W2VOracle(len_vec=16, window=2, negative=5, alpha=0.05,
                       server_lr=0.3, sample=-1.0, minibatch_lines=10,
                       table_size=200_000, seed=2008, init_seed=0)
    ref = oracle.train(sents, niters=niters)
    model = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    losses = model.train(sents, niters=niters, batch_size=132)
    assert losses[-1] < losses[0], losses
    assert abs(losses[-1] - ref[-1]) / ref[-1] < 0.125, (losses, ref)
    assert losses[0] < 10.0 and ref[0] < 10.0, (losses, ref)
    for a, b in zip(losses[1:], ref[1:]):
        assert abs(a - b) / b < 0.25, (losses, ref)


def test_inner_steps_runs_ordinary_steps():
    """``[worker] inner_steps: N`` is N ordinary steps in a row: the same
    losses and table as inner_steps 1 from the same start and seed."""
    sents = corpus(n_sent=30, vocab=50, length=12, seed=6)
    runs = []
    for inner in (1, 3):
        c = ConfigParser().update(CONF)
        c.set("worker", "inner_steps", inner)
        m = Word2Vec(config=c, device="cpu", seed=3)
        m.build(sents)
        runs.append((m.train(sents, niters=2, batch_size=32),
                     state_to_numpy(m.table.state)))
    assert runs[0][0] == runs[1][0]
    for f in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][f], runs[1][1][f])


@pytest.mark.parametrize("settings", [
    {"control": {"every": 8}},
    {"serve": {"quant": "int8"}},
    {"control": {"margin": 0.02}},
    {"cluster": {"transfer": "tpu", "server_num": 2, "data_plane": "xla"}},
    {"serve": {"depth": 2}},
    {"control": {"wire_format": "on"}}, {"control": {"collective": "on"}},
    {"serve": {"replicas": 2}}, {"serve": {"port": 0}},
    {"cluster": {"server_num": 2}},
    {"control": {"control": "on"}},
    {"serve": {"every": 4}}])
def test_unported_config_raises(settings):
    """What the port still refuses: ``server_num > 1`` on ``xla`` (A11)
    and ``data_plane: xla`` with ``transfer: tpu`` (A16).  ``[control]``
    and ``[serve]``, refused until ROADMAP A13a was ported, now build and
    train: the model reads the keys JAX's model reads (``every``,
    ``depth``, ``control``, ``margin``) and ignores the others, as JAX's
    does."""
    c = ConfigParser().update(CONF)
    for sec, kv in settings.items():
        for key, val in kv.items():
            c.set(sec, key, val)
    if not ({"control", "serve"} & set(settings)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Word2Vec(config=c, device="cpu")
        return
    m = Word2Vec(config=c, device="cpu")
    sents = corpus(n_sent=10, vocab=20, length=8, seed=2)
    assert np.isfinite(m.train(sents, niters=1, batch_size=32)).all()
    serve = settings.get("serve", {})
    assert m.serve_every == int(serve.get("every", 0))
    assert (m.serve_publisher is not None) == ("every" in serve)
    on = settings.get("control", {}).get("control") == "on"
    assert (m.controller is not None) == on


@pytest.mark.parametrize("key,val,rendering", [
    ("sg", 1, "sg"), ("dense_logits", 1, "dense"),
    ("local_steps", 2, "gather"), ("async_mode", "hogwild", "gather")])
def test_formerly_refused_modes_run(key, val, rendering):
    """The word2vec modes earlier slices refused now build and train:
    skip-gram, dense logits, the snapshot async mode and hogwild."""
    sents = corpus(n_sent=30, vocab=50, length=12, seed=6)
    c = ConfigParser().update(CONF)
    c.set("word2vec", key, val)
    m = Word2Vec(config=c, device="cpu", seed=1)
    assert m.resolved_rendering == rendering
    losses = m.train(sents, niters=2, batch_size=32)
    assert np.isfinite(losses).all() and m.train_metrics["steps"] > 0
    assert m.train_metrics["rendering"] == rendering
    assert m.train_metrics["local_steps"] == (val if key == "local_steps"
                                              else 1)
    assert m.train_metrics["async_mode"] == (val if key == "async_mode"
                                             else "")


def test_save_dumps_reference_layout(tmp_path):
    from swiftmpi_tpu_torch.models.word2vec import w2v_parser
    sents = corpus(n_sent=10, vocab=20, length=8, seed=2)
    m = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    m.build(sents)
    path = str(tmp_path / "out" / "vec.txt")
    assert m.save(path) == len(m.vocab)
    lines = open(path).read().splitlines()
    assert len(lines) == len(m.vocab)
    state = state_to_numpy(m.table.state)
    for line in lines:
        key, _, rest = line.partition("\t")
        row = w2v_parser(rest)
        slot = m.table.key_index.slot(int(key))
        np.testing.assert_array_equal(row["v"], state["v"][slot])
        np.testing.assert_array_equal(row["h"], state["h"][slot])
    assert build_vocab(sents).keys.tolist() == m.vocab.keys.tolist()
