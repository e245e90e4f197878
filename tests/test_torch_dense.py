"""The dense-logits rendering in the port (``[word2vec] dense_logits:
1``) against the JAX package's ``_build_grads_dense`` + ``_build_apply``
and against the port's own gather step, on the CPU, from JAX's initial
table with JAX's draws replayed.

Tolerances: tables within ``|a - b| <= 1e-5 + 1e-3 |b|``; ``err_cnt``
exact; ``err_sum`` rtol 1e-5 against JAX, 1e-4 against the gather step
(three large products against per-row dot products, as
test_word2vec.py::test_w2v_dense_logits_matches_parity_step holds them).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import ConfigParser

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2,
                 "dense_logits": 1},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
CAP = 600
B = 64


def _envelope(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                               err_msg=err_msg)


def corpus(n_sent=60, vocab=300, length=16, seed=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _conf(cls, dense=1, **w2v):
    c = cls().update(CONF)
    c.set("word2vec", "dense_logits", dense)
    for k, v in w2v.items():
        c.set("word2vec", k, v)
    return c


def _models(sents, **conf):
    jm = JaxWord2Vec(config=_conf(JaxConfig, **conf),
                     capacity_per_shard=CAP).build(sents)
    pm = Word2Vec(config=_conf(ConfigParser, **conf), device="cpu",
                  capacity_per_shard=CAP)
    pm.build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    return jm, pm


def test_dense_step_matches_jax_and_the_gather_step():
    """One dense step with JAX's draws against JAX's dense step, and
    against the port's gather step from the same table and draws (mirrors
    test_word2vec.py::test_w2v_dense_logits_matches_parity_step)."""
    sents = corpus()
    jm, pm = _models(sents)
    assert jm.dense_logits == 1 and pm.resolved_rendering == "dense"
    batch = next(iter(CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                  seed=5).epoch(B)))
    key = jax.random.key(3)
    state0 = {f: np.array(a) for f, a in jm.table.state.items()}
    out, es, ec = jm._build_step()(
        jm.table.state, jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
        jnp.asarray(batch.centers), jnp.asarray(batch.contexts),
        jnp.asarray(batch.ctx_mask), key)
    assert jm.resolved_rendering == "dense"
    draws = _jax_draws(key, len(pm.vocab), pm.draw_shape(B))
    got_es, got_ec = pm.step_batch(batch, draws=draws)
    assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, float(es), rtol=1e-5)
    assert dict(pm.transfer.push_paths) == {"h:table": 1, "v:sparse": 1}
    dense = state_to_numpy(pm.table.state)
    for f in state0:
        _envelope(dense[f], np.asarray(out[f]), f)
        assert not np.array_equal(dense[f], state0[f])
    # the gather rendering from the same table and draws
    gm = Word2Vec(config=_conf(ConfigParser, dense=0), device="cpu",
                  capacity_per_shard=CAP)
    gm.build(sents)
    assert gm.resolved_rendering == "gather"
    gm.table.state = state_from_jax(state0, "cpu")
    g_es, g_ec = gm.step_batch(batch, draws=draws)
    assert g_ec == got_ec
    np.testing.assert_allclose(g_es, got_es, rtol=1e-4)
    gathered = state_to_numpy(gm.table.state)
    for f in state0:
        _envelope(dense[f], gathered[f], f)


def test_dense_three_step_train_tracks_jax():
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents)
    want = jm.train(sents, niters=3, batch_size=B)
    key = jax.random.key(0 ^ 0x5EED)
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), pm.draw_shape(B)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    assert pm.train_metrics["push_paths"] == {"h:table": 3, "v:sparse": 3}
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


def test_dense_duplicate_targets_accumulate():
    """A negative drawn twice in a row (and equal to a later row's
    center) sums both of its logits' grads into G: the step matches the
    gather step, whose scatter-add sums them too."""
    sents = corpus()
    _, pm = _models(sents)
    gm = Word2Vec(config=_conf(ConfigParser, dense=0), device="cpu",
                  capacity_per_shard=CAP)
    gm.build(sents)
    gm.table.state = {f: t.clone() for f, t in pm.table.state.items()}
    batch = next(iter(CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                  seed=6).epoch(B)))
    rng = np.random.default_rng(0)
    j = rng.integers(0, 3, size=(B, pm.negative))     # few distinct words
    u = np.zeros((B, pm.negative), np.float32)        # accept every bucket
    assert any(len(set(r)) < len(r) for r in j)
    out = [m.step_batch(batch, draws=(j, u)) for m in (pm, gm)]
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4)
    got, want = state_to_numpy(pm.table.state), state_to_numpy(gm.table.state)
    for f in got:
        _envelope(got[f], want[f], f)


@pytest.mark.parametrize("w2v,cluster,match", [
    ({"sg": 1}, {}, "CBOW-only"),
    ({"sg": 1, "stencil": 1, "dense_logits": 0}, {}, "drop sg or stencil"),
    ({"shared_negatives": 1}, {}, "pick one"),
    ({}, {"transfer": "tpu", "server_num": 8}, "transfer: xla")])
def test_refused_combinations_raise(w2v, cluster, match):
    """The JAX package's ValueErrors for combinations that are not
    configurations at all: sg with dense, sg with stencil, dense with
    shared negatives, dense with the sharded transfer."""
    c = _conf(ConfigParser, **w2v)
    for k, v in cluster.items():
        c.set("cluster", k, v)
    with pytest.raises(ValueError, match=match):
        Word2Vec(config=c, device="cpu")


def test_auto_resolves_to_gather():
    """``dense_logits: auto`` (the default) is the gather rendering, as
    the JAX package resolves it off a TPU."""
    sents = corpus(n_sent=10)
    base = {**CONF, "word2vec": {k: v for k, v in CONF["word2vec"].items()
                                 if k != "dense_logits"}}
    for raw in ("auto", None):
        c, jc = ConfigParser().update(base), JaxConfig().update(base)
        if raw is not None:
            c.set("word2vec", "dense_logits", raw)
            jc.set("word2vec", "dense_logits", raw)
        pm = Word2Vec(config=c, device="cpu")
        assert pm.resolved_rendering == "gather" and not pm.dense_logits
        jm = JaxWord2Vec(config=jc).build(sents)
        jm._build_grads()
        assert jm.resolved_rendering == pm.resolved_rendering
