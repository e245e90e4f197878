"""``Word2Vec.grow``, ``embedding`` and ``embedding_index`` against the
JAX package's, on the CPU, with JAX's negatives replayed (its ``(j, u)``
a step from its own key stream).

Each backend (``gather`` on ``xla``, ``hybrid`` and ``tpu`` with 8 ranks)
builds from one corpus and one initial table on both sides, trains 2
epochs, grows to twice its capacity a shard, and trains 2 more.  Held:
the key -> slot maps and the vocab's slots, equal; every occupied row,
bit for bit across the growth within each package; ``embedding`` of the
probe keys unchanged by the growth; the losses and the occupied rows
after it within the repo envelope ``|a - b| <= 1e-5 + 1e-3 |b|`` of
JAX's (sums of duplicate rows in another order; rtol 5e-3 on the epoch
losses, as the 3-epoch train tests).  The growth's new rows are fresh
draws on each side (``jax.random`` cannot be replayed) and no step
touches them.
"""

import jax
import numpy as np
import pytest
import torch

from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.convert import state_from_jax
from swiftmpi_tpu_torch.data.text import synthetic_corpus
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.serve import EmbeddingReader
from swiftmpi_tpu_torch.utils import ConfigParser

CONF = {
    "word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
#: backend -> [cluster] keys; the capacity a shard before the growth
BACKENDS = {"gather": ({"server_num": 1, "transfer": "xla"}, 160),
            "hybrid": ({"server_num": 8, "transfer": "hybrid"}, 24),
            "tpu": ({"server_num": 8, "transfer": "tpu"}, 24)}
B = 64
ENVELOPE = dict(rtol=1e-3, atol=1e-5)


def _corpus():
    rng = np.random.default_rng(4)
    p = 1.0 / np.arange(1, 121)
    p /= p.sum()
    # 5 sentences of 12: 60 centers, one batch an epoch
    return [list(map(int, rng.choice(np.arange(1, 121), size=12, p=p)))
            for _ in range(5)]


def _models(backend, sents):
    cluster, cap = BACKENDS[backend]
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for c in (jc, pc):
        for k, v in cluster.items():
            c.set("cluster", k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    return jm, pm


def _jax_draws(key, V, shape):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _rows_by_key(table, keys):
    """Every field's rows of ``keys`` (unified slots: the hot head, then
    the tail), as host arrays."""
    slots = np.asarray(table.key_index.lookup(keys, create=False))
    return {f: np.asarray(table.unified_rows_host(f))[slots]
            for f in table.access.fields}


@pytest.fixture(scope="module")
def grown():
    """Per backend: JAX's and the port's losses before and after the
    growth, the rows by key before and after, and the models."""
    if len(jax.devices()) < 8:          # JAX's hybrid and tpu: 8 devices
        pytest.skip("needs 8 virtual devices")
    sents = _corpus()
    out = {}
    for backend in BACKENDS:
        jm, pm = _models(backend, sents)
        key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
        draws = []
        for _ in range(4):
            key, sub = jax.random.split(key)
            draws.append(_jax_draws(sub, len(pm.vocab), (B, pm.negative)))
        keys = pm.vocab.keys
        want1 = jm.train(sents, niters=2, batch_size=B)
        got1 = pm.train(sents, niters=2, batch_size=B, draws=iter(draws[:2]))
        before = (_rows_by_key(pm.table, keys), _rows_by_key(jm.table, keys))
        emb = [pm.embedding(int(k)) for k in keys[:6]]
        cap = pm.table.key_index.capacity_per_shard
        jm.grow(2 * cap)
        pm.grow(2 * cap)
        after = (_rows_by_key(pm.table, keys), _rows_by_key(jm.table, keys))
        want2 = jm.train(sents, niters=2, batch_size=B)
        got2 = pm.train(sents, niters=2, batch_size=B, draws=iter(draws[2:]))
        out[backend] = dict(jm=jm, pm=pm, cap=cap, losses=(got1, got2),
                            jax_losses=(want1, want2), before=before,
                            after=after, emb=emb, keys=keys)
    return out


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_grow_relays_the_table_as_jax(grown, backend):
    g = grown[backend]
    pm, jm = g["pm"], g["jm"]
    assert pm.table.key_index.capacity_per_shard == 2 * g["cap"] == \
        jm.table.key_index.capacity_per_shard
    assert list(pm.table.key_index.items()) == \
        list(jm.table.key_index.items())
    np.testing.assert_array_equal(pm._slot_of_vocab.numpy(),
                                  np.asarray(jm._slot_of_vocab))
    assert pm.table.generation == 1
    # every occupied row moved unchanged, in each package
    for side in (0, 1):
        b, a = g["before"][side], g["after"][side]
        for f in b:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_training_after_the_growth_tracks_jax(grown, backend):
    g = grown[backend]
    for got, want in zip(g["losses"], g["jax_losses"]):
        np.testing.assert_allclose(got, want, rtol=5e-3)
    assert g["losses"][1][-1] < g["losses"][0][0]
    pt, jt = g["pm"].table, g["jm"].table
    got, want = _rows_by_key(pt, g["keys"]), _rows_by_key(jt, g["keys"])
    for f in want:
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **ENVELOPE)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_embedding_reads_a_key_across_the_growth(grown, backend):
    """``embedding`` of a probe key: the same bits after the growth as
    before it (read before the later epochs), and JAX's row now within
    the envelope; hot keys come from the head on ``hybrid``; an unknown
    key gives None."""
    g = grown[backend]
    pm, jm = g["pm"], g["jm"]
    before = g["before"][0]["v"]
    for i, (k, row) in enumerate(zip(g["keys"][:6], g["emb"])):
        assert row.dtype == np.float32 and row.shape == (8,)
        np.testing.assert_array_equal(row, before[i])
        np.testing.assert_allclose(pm.embedding(int(k)),
                                   np.asarray(jm.embedding(int(k))),
                                   **ENVELOPE)
    if backend == "hybrid":
        hot = [int(k) for k, s in pm.table.key_index.items()
               if s < pm.table.n_hot]
        assert hot
        np.testing.assert_array_equal(
            pm.embedding(hot[0]),
            pm.table.state["v@hot"][pm.table.key_index.slot(hot[0])].numpy())
    assert pm.embedding(10 ** 12) is None is jm.embedding(10 ** 12)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_embedding_index_over_the_grown_table_matches_jax(grown, backend):
    g = grown[backend]
    idx, jidx = g["pm"].embedding_index(), g["jm"].embedding_index()
    np.testing.assert_array_equal(idx.keys, jidx.keys)
    np.testing.assert_allclose(idx.vecs, jidx.vecs, **ENVELOPE)
    k = int(g["keys"][0])
    keys, scores = idx.neighbors(k, 5)
    jkeys, jscores = jidx.neighbors(k, 5)
    np.testing.assert_allclose(scores, jscores, rtol=1e-3, atol=1e-4)
    assert len(keys) == len(jkeys) == 5


def test_embedding_index_needs_a_vocab(tmp_path):
    pc = ConfigParser().update(CONF)
    pc.set("cluster", "server_num", 1)
    m = Word2Vec(config=pc, device="cpu", capacity_per_shard=64)
    m.build(_corpus())
    path = str(tmp_path / "v.txt")
    m.save(path)
    bare = Word2Vec(config=pc, device="cpu", capacity_per_shard=64)
    bare.load(path)
    with pytest.raises(RuntimeError, match="no vocab"):
        bare.embedding_index()
    jc = JaxConfig().update(CONF)
    jbare = JaxWord2Vec(config=jc, capacity_per_shard=64)
    jbare.load(path)
    with pytest.raises(RuntimeError, match="no vocab"):
        jbare.embedding_index()


def test_a_pull_after_the_growth_is_a_cold_pull():
    """With ``pull_cache`` armed and warm, a growth flushes the shadow:
    the next pull of every vocab slot equals a pull on a fresh transfer,
    and books no cache hit."""
    pc = ConfigParser().update(CONF)
    for k, v in {"server_num": 1, "transfer": "xla", "pull_cache": 4096}\
            .items():
        pc.set("cluster", k, v)
    m = Word2Vec(config=pc, device="cpu", capacity_per_shard=160)
    sents = _corpus()
    m.build(sents)
    m.transfer.count_traffic = True
    m.train(sents, niters=2, batch_size=B)
    slots = m._slot_of_vocab.clone()
    m.transfer.pull(m.table.state, slots, m.access)
    hits = m.transfer.traffic()["pull_cache_hits"]
    assert m.transfer.pull(m.table.state, slots, m.access) and \
        m.transfer.traffic()["pull_cache_hits"] > hits
    m.grow(320)
    hits = m.transfer.traffic()["pull_cache_hits"]
    got = m.transfer.pull(m.table.state, m._slot_of_vocab, m.access)
    assert m.transfer.traffic()["pull_cache_hits"] == hits
    from swiftmpi_tpu_torch.transfer import SingleTransfer
    cold = SingleTransfer().pull(m.table.state, m._slot_of_vocab, m.access)
    for f in cold:
        assert torch.equal(got[f], cold[f]), f


def test_grow_while_serving_keeps_the_held_snapshot():
    """JAX's ``test_grow_during_serving_old_snapshot_stays_valid`` through
    ``Word2Vec.grow``: the held snapshot keeps its old arrays, and the
    next publish carries the grown map with the same rows."""
    sents = synthetic_corpus(30, vocab_size=50, length=12, seed=6)
    pc = ConfigParser().update(CONF)
    pc.set("cluster", "server_num", 1)
    pc.set("serve", "every", 1)
    model = Word2Vec(config=pc, device="cpu")
    model.build(sents)
    pub = model.serving_publisher()
    model.train(sents, niters=1, batch_size=B)
    old_snap = pub.latest()
    probe = model.vocab.keys[:8]
    before = EmbeddingReader(pub, field="v").read(probe)
    old_cap = model.table.capacity
    model.grow(2 * model.table.key_index.capacity_per_shard)
    assert old_snap.tail_array("v").shape[0] == old_cap
    model._serve_publish()
    new_snap = pub.latest()
    assert new_snap.version == old_snap.version + 1
    assert new_snap.tail_array("v").shape[0] == 2 * old_cap
    np.testing.assert_array_equal(
        EmbeddingReader(pub, field="v").read(probe), before)
    np.testing.assert_array_equal(
        np.stack([model.embedding(int(k)) for k in probe]), before)
