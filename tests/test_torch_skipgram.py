"""Skip-gram in the port (``[word2vec] sg: 1``: the ``sg`` and
``sg_shared`` renderings) against the JAX package's
``_build_grads_sg`` / ``_build_grads_sg_shared`` + ``_build_apply``, on
the CPU, from JAX's initial table with JAX's draws replayed: ``sg``
draws K negatives per pair, ``(B, 2W, K)``; ``sg_shared`` one pool.

Tolerances: tables within ``|a - b| <= 1e-5 + 1e-3 |b|``; ``err_cnt``
exact for ``sg`` (it counts live target pairs) and within 1e-6 relative
for ``sg_shared`` (pool pairs weighted ``negative / pool``); ``err_sum``
rtol 1e-5; bf16 fields within one bfloat16 ulp (a 1-ulp float32
difference can cross a bf16 rounding boundary).

The one-shard capacity is 600 slots, so the sg h push (B*2W*(K+1) = 1,536
rows) goes dense through the scatter-add and the v push (B*2W = 256 rows
< 300) sparse, as at the reference shape, where the h push is 840,000
rows.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes

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
                 "shared_pool": 64, "sg": 1},
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


def _models(sents, cap=CAP, **conf):
    """The JAX model and the port's on the CPU from one conf (``conf``:
    section -> keys on top of CONF); the port starts from JAX's initial
    table, shard for shard on ``transfer: tpu``."""
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for sec, kv in conf.items():
        for k, v in kv.items():
            jc.set(sec, k, v)
            pc.set(sec, k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    assert pm.resolved_rendering == ("sg_shared" if pm.shared_negatives
                                     else "sg")
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh if pm.transfer.name == "tpu" else None)
    return jm, pm


def _batch(pm, sents, seed=13):
    return next(iter(CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                 seed=seed).epoch(B)))


def _jax_step(jm, batch, key):
    out, es, ec = jm._build_step()(
        jm.table.state, jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
        jnp.asarray(batch.centers), jnp.asarray(batch.contexts),
        jnp.asarray(batch.ctx_mask), key)
    return out, float(es), ec


@pytest.mark.parametrize("shared", [0, 1])
def test_one_step_matches_jax_step(shared):
    """One step of ``sg`` (err_cnt exact) or ``sg_shared`` (err_cnt
    within 1e-6 relative) with JAX's draws replayed (mirrors
    test_word2vec.py::test_w2v_skipgram_grads_match_numpy and
    ::test_w2v_sg_shared_grads_match_numpy, through the apply)."""
    sents = corpus()
    jm, pm = _models(sents, word2vec={"shared_negatives": shared})
    batch = _batch(pm, sents)
    assert not batch.ctx_mask.all()          # padded pairs are dead
    key = jax.random.key(7)
    state0 = {f: np.array(a) for f, a in jm.table.state.items()}
    out, es, ec = _jax_step(jm, batch, key)
    shape = pm.draw_shape(B)
    assert shape == ((64,) if shared else (B, 2 * pm.window, pm.negative))
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), shape))
    if shared:
        assert got_ec == pytest.approx(float(ec), rel=1e-6)
        assert got_ec != int(got_ec)               # fractional
        assert dict(pm.transfer.push_paths) == {"h:sparse": 2,
                                                "v:sparse": 1}
    else:
        assert got_ec == int(ec) and isinstance(got_ec, int)
        assert dict(pm.transfer.push_paths) == {"h:dense": 1, "v:sparse": 1}
    np.testing.assert_allclose(got_es, es, rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in state0:
        _envelope(got[f], np.asarray(out[f]), f)
        assert not np.array_equal(got[f], state0[f])     # the step moved


def test_sg_pool_push_is_a_sum_family(monkeypatch):
    """``sg_shared`` pushes three families: the positive pairs' h and the
    contexts' v mean-normalized, the pool's ``(pool, d)`` h grads as a sum
    (a mean would divide each pool row's summed pair contributions)."""
    sents = corpus()
    _, pm = _models(sents, word2vec={"shared_negatives": 1})
    seen = []
    push = pm.transfer.push

    def spy(state, slots, grads, access, mean=False):
        seen.append((tuple(grads), slots.shape[0], mean))
        return push(state, slots, grads, access, mean=mean)

    monkeypatch.setattr(pm.transfer, "push", spy)
    pm.step_batch(_batch(pm, sents))
    W2 = 2 * pm.window
    assert seen == [(("h",), B * W2, True), (("h",), pm.shared_pool, False),
                    (("v",), B * W2, True)]


@pytest.mark.parametrize("shared", [0, 1])
def test_three_step_train_tracks_jax(shared):
    """``train`` with per-step replayed draws: one batch per epoch, three
    epochs, so the per-iteration losses are the per-step losses."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents, word2vec={"shared_negatives": shared})
    want = jm.train(sents, niters=3, batch_size=B)
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), pm.draw_shape(B)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    m = pm.train_metrics
    assert m["steps"] == 3 and m["rendering"] == pm.resolved_rendering
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


@pytest.mark.parametrize("shared", [0, 1])
def test_sharded_sg_step_matches_tpu_transfer(devices8, shared):
    """``sg`` and ``sg_shared`` on ``transfer: tpu`` with 8 ranks against
    the JAX step on ``TpuTransfer`` over the 8-device mesh: the pulls
    and pushes go through the sharded transfer as the gather rendering's
    do, every family routed."""
    sents = corpus()
    jm, pm = _models(sents, cap=80,
                     cluster={"transfer": "tpu", "server_num": 8},
                     word2vec={"shared_negatives": shared})
    assert jm.transfer.name == pm.transfer.name == "tpu"
    assert pm.cluster.n_servers == 8 and len(pm.table.state["h"]) == 8
    batch = _batch(pm, sents)
    key = jax.random.key(5)
    out, es, ec = _jax_step(jm, batch, key)
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), pm.draw_shape(B)))
    if shared:
        assert got_ec == pytest.approx(float(ec), rel=1e-6)
    else:
        assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, es, rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in out:
        _envelope(got[f], np.asarray(out[f]), f)
    assert dict(pm.transfer.push_paths) == (
        {"h:routed": 2, "v:routed": 1} if shared
        else {"h:routed": 1, "v:routed": 1})
    assert pm.transfer.overflow_count() == 0


def test_sharded_sg_train_tracks_jax(devices8):
    """A 3-step sharded ``sg`` train with JAX's draws replayed."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)
    jm, pm = _models(sents, cap=80,
                     cluster={"transfer": "tpu", "server_num": 8})
    want = jm.train(sents, niters=3, batch_size=B)
    key = jax.random.key(0 ^ 0x5EED)
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), pm.draw_shape(B)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    assert pm.train_metrics["push_paths"] == {"h:routed": 3, "v:routed": 3}
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


def _ordinal(a):
    """bfloat16 values as integers in the order of the reals."""
    bits = np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int64)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


@pytest.mark.parametrize("shared", [0, 1])
def test_bf16_sg_step_within_one_ulp(shared):
    """``[server] dtype: bfloat16`` with ``sg``: h and v within one bf16
    ulp of the JAX step, the float32 accumulators in the envelope."""
    sents = corpus()
    jm, pm = _models(sents, server={"dtype": "bfloat16"},
                     word2vec={"shared_negatives": shared})
    assert jm.table.state["h"].dtype == jnp.bfloat16
    batch = _batch(pm, sents)
    key = jax.random.key(3)
    out, es, ec = _jax_step(jm, batch, key)
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), pm.draw_shape(B)))
    if shared:
        assert got_ec == pytest.approx(float(ec), rel=1e-6)
    else:
        assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, es, rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in ("h", "v"):
        assert got[f].dtype == ml_dtypes.bfloat16
        gap = np.abs(_ordinal(got[f]) - _ordinal(np.asarray(out[f])))
        assert gap.max() <= 1, (f, int(gap.max()))
    for f in ("h2sum", "v2sum"):
        _envelope(got[f], np.asarray(out[f]), f)
