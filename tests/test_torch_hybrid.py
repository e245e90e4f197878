"""The port's ``hybrid`` transfer (hot planes + the sharded tail) against
the JAX package's ``HybridTransfer`` and the oracles, mirroring
``tests/test_hybrid.py`` at small sizes: 8 ranks on the CPU against the
``devices8`` mesh.

Tolerances: a pull moves bits (held exactly); a push sums duplicates in
another order than the oracle (rtol 1e-5 / atol 1e-6, as the JAX test);
a model step within the envelope ``|a - b| <= 1e-5 + 1e-3 * |b|`` with
``err_cnt`` exact; a 3-step loss trajectory within rtol 5e-3 of JAX's
hybrid; checkpoints and dumps cross bit for bit and byte for byte;
counters exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.io import checkpoint as jck
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.transfer.hybrid import HybridTransfer as JaxHybrid
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          synthetic_corpus_bulk)
from swiftmpi_tpu_torch.io import checkpoint as pck
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
from swiftmpi_tpu_torch.parameter.sparse_table import hot_name
from swiftmpi_tpu_torch.transfer import SingleTransfer, get_transfer
from swiftmpi_tpu_torch.transfer.hybrid import HybridTransfer
from swiftmpi_tpu_torch.transfer.local import LocalTransfer
from swiftmpi_tpu_torch.transfer.sharded import ShardedTransfer
from swiftmpi_tpu_torch.utils import ConfigParser

N, D, LR = 8, 8, 0.3


def zipf_counts(v, s=1.0, total=1_000_000):
    p = np.arange(1, v + 1, dtype=np.float64) ** -s
    return np.maximum((total * p / p.sum()).astype(np.int64), 1)


def _tables(n_keys=400, cap=64, seed=0):
    """``make_hybrid_table`` of tests/test_hybrid.py on both sides: the
    same keys and Zipf counts, the same partition and slots, the port's
    state a copy of JAX's (hot planes whole, the tail dealt to 8 ranks)."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(100_000, size=n_keys, replace=False).astype(np.uint64)
    counts = zipf_counts(n_keys)[rng.permutation(n_keys)]
    jt = JaxSparseTable(
        jax_w2v_access(learning_rate=LR, len_vec=D),
        JaxKeyIndex(N, cap, partition=JaxPart.from_counts(
            keys, counts, batch_rows=64)),
        mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    layout = ps_mesh(N, ["cpu"])
    pt = SparseTable(w2v_access(LR, D), KeyIndex(N, cap, partition=(
        HotColdPartition.from_counts(keys, counts, batch_rows=64))),
        "cpu", mesh=layout)
    np.testing.assert_array_equal(pt.key_index.lookup(keys),
                                  jt.key_index.lookup(keys))
    pt.state = state_from_jax({f: np.asarray(a)
                               for f, a in jt.state.items()}, "cpu",
                              mesh=layout)
    return jt, pt, keys


def _unified_np(table):
    return {f: table.unified_rows_host(f) for f in table.access.fields}


def _unified_after(state, access):
    """Unified rows of a port hybrid state (hot plane first)."""
    np_state = state_to_numpy(state)
    return {f: np.concatenate([np_state[hot_name(f)], np_state[f]])
            for f in access.fields}


def _mixed_slots(table, keys, n=64):
    slots = np.asarray(table.key_index.lookup(keys[:n]), np.int64)
    slots[::7] = -1                     # padding
    slots[1] = slots[0]                 # duplicate
    n_hot = table.n_hot
    assert ((slots >= 0) & (slots < n_hot)).any(), "want hot rows"
    assert (slots >= n_hot).any(), "want tail rows"
    return slots.astype(np.int32)


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    return {f: rng.normal(size=(n, D)).astype(np.float32)
            for f in ("h", "v")}


def _t(arrays):
    return {f: torch.from_numpy(a) for f, a in arrays.items()}


# -- selection ----------------------------------------------------------------

def test_hybrid_selection_matches_jax():
    """The same head, slots and unified rows as JAX's table; the port's
    own init draws the hot planes after the tail, so a partitioned table's
    tail is the unpartitioned table's, bit for bit."""
    jt, pt, keys = _tables()
    assert pt.n_hot == jt.n_hot > 0
    assert pt.state[hot_name("h")].shape == (pt.n_hot, D)
    for f in pt.access.fields:
        np.testing.assert_array_equal(pt.unified_rows_host(f),
                                      jt.unified_rows_host(f))
    slots = _mixed_slots(pt, keys)
    got = pt.gather(torch.from_numpy(slots))
    for f, rows in jt.gather(jnp.asarray(slots)).items():
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(rows))
    layout = ps_mesh(N, ["cpu"])
    part = pt.key_index.partition
    a = SparseTable(w2v_access(LR, D), KeyIndex(N, 64, partition=part),
                    "cpu", seed=3, mesh=layout)
    b = SparseTable(w2v_access(LR, D), KeyIndex(N, 64), "cpu", seed=3,
                    mesh=layout)
    na, nb = a.to_numpy(), b.to_numpy()
    assert set(na) == set(nb) | {hot_name(f) for f in nb}
    for f in nb:
        np.testing.assert_array_equal(na[f], nb[f])
    t = get_transfer("hybrid", mesh=layout)
    assert isinstance(t, HybridTransfer) and t.name == "hybrid"
    assert isinstance(t.tail, ShardedTransfer) and t.n == N
    with pytest.raises(ValueError, match="hybrid"):
        get_transfer("bogus")


# -- parity against the oracles --------------------------------------------

@pytest.mark.parametrize("mean", [False, True])
def test_hybrid_pull_push_parity_vs_local(devices8, mean):
    """Pull bit for bit against the numpy oracle; the push against the
    oracle and against JAX's ``HybridTransfer`` on the same state."""
    jt, pt, keys = _tables()
    slots = _mixed_slots(pt, keys)
    grads = _grads(64, 2)
    oracle = _unified_np(pt)
    t = HybridTransfer(ps_mesh(N, ["cpu"]))
    got = t.pull(pt.state, torch.from_numpy(slots), pt.access)
    want = LocalTransfer().pull(oracle, slots, pt.access)
    for f in want:
        np.testing.assert_array_equal(got[f].numpy(), want[f])
    t.push(pt.state, torch.from_numpy(slots), _t(grads), pt.access,
           mean=mean)
    new = _unified_after(pt.state, pt.access)
    want_new = LocalTransfer().push(oracle, slots, grads, pt.access,
                                    mean=mean)
    jnew = JaxHybrid(jax_ps_mesh()).push(jt.state, slots, grads, jt.access,
                                         mean=mean)
    for f in want_new:
        np.testing.assert_allclose(new[f], want_new[f], rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        jf = np.concatenate([np.asarray(jnew[hot_name(f)]),
                             np.asarray(jnew[f])])
        np.testing.assert_allclose(new[f], jf, rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_hybrid_push_span_parity_vs_xla():
    jt, pt, keys = _tables(seed=5)
    slots = _mixed_slots(pt, keys)
    rng = np.random.default_rng(6)
    grads = _grads(64, 7)
    counts = rng.integers(1, 4, size=64).astype(np.float32)
    counts[slots < 0] = 0
    ref = state_from_jax(_unified_np(pt), "cpu")
    HybridTransfer(ps_mesh(N, ["cpu"])).push_span(
        pt.state, torch.from_numpy(slots), _t(grads),
        torch.from_numpy(counts), pt.access, mean=True)
    SingleTransfer().push_span(ref, torch.from_numpy(slots), _t(grads),
                               torch.from_numpy(counts), pt.access,
                               mean=True)
    new = _unified_after(pt.state, pt.access)
    for f, a in state_to_numpy(ref).items():
        np.testing.assert_allclose(new[f], a, rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_hybrid_pads_non_mesh_aligned_batches():
    """A stencil span is B + 2W rows, e.g. 70 on 8 ranks: the backend pads
    with -1 slots and zero grads and slices back."""
    jt, pt, keys = _tables(seed=9)
    n = 70
    slots = _mixed_slots(pt, keys, n=n)
    grads = _grads(n, 4)
    counts = np.random.default_rng(4).integers(1, 4, size=n).astype(
        np.float32)
    counts[slots < 0] = 0
    oracle = _unified_np(pt)
    ref = state_from_jax(oracle, "cpu")
    t = HybridTransfer(ps_mesh(N, ["cpu"]))
    got = t.pull(pt.state, torch.from_numpy(slots), pt.access)
    want = LocalTransfer().pull(oracle, slots, pt.access)
    for f in want:
        assert got[f].shape[0] == n
        np.testing.assert_array_equal(got[f].numpy(), want[f])
    t.push_span(pt.state, torch.from_numpy(slots), _t(grads),
                torch.from_numpy(counts), pt.access, mean=True)
    SingleTransfer().push_span(ref, torch.from_numpy(slots), _t(grads),
                               torch.from_numpy(counts), pt.access,
                               mean=True)
    new = _unified_after(pt.state, pt.access)
    for f, a in state_to_numpy(ref).items():
        np.testing.assert_allclose(new[f], a, rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_hybrid_without_partition_matches_tpu():
    """No hot planes (n_hot = 0): hybrid is the tpu backend, bit for
    bit, pull and push."""
    layout = ps_mesh(N, ["cpu"])
    tables = [SparseTable(w2v_access(LR, D), KeyIndex(N, 32), "cpu",
                          mesh=layout) for _ in range(2)]
    rng = np.random.default_rng(10)
    keys = rng.choice(5_000, size=48, replace=False).astype(np.uint64)
    slots = np.asarray(tables[0].key_index.lookup(keys), np.int32)
    tables[1].key_index.lookup(keys)
    slots[::5] = -1
    grads = _grads(48, 11)
    outs = []
    for t, table in zip((HybridTransfer(layout), ShardedTransfer(layout)),
                        tables):
        rows = t.pull(table.state, torch.from_numpy(slots), table.access)
        for mean in (False, True):
            t.push(table.state, torch.from_numpy(slots), _t(grads),
                   table.access, mean=mean)
        outs.append((rows, table.to_numpy()))
    for f in outs[0][0]:
        np.testing.assert_array_equal(outs[0][0][f], outs[1][0][f])
    for f in outs[0][1]:
        np.testing.assert_array_equal(outs[0][1][f], outs[1][1][f])


def test_hybrid_overflow_threads_through_tail():
    jt, pt, keys = _tables(seed=11)
    t = HybridTransfer(ps_mesh(N, ["cpu"]), bucket_capacity=1)
    t.count_traffic = True
    t.pull(pt.state, torch.from_numpy(_mixed_slots(pt, keys)), pt.access)
    tr = t.traffic()
    assert tr["overflow_dropped"] > 0
    assert t.overflow_count() == tr["overflow_dropped"]


# -- traffic accounting ------------------------------------------------------

def test_hybrid_traffic_counters_golden():
    """JAX's golden: 4 hot (one duplicated), 6 tail and 6 padding rows,
    two pulls and one push: routed 18, hot 12, psum_bytes 10 x (2 x 8 x 4
    + 4); and the whole dict equal to JAX's ``traffic()`` on the same
    calls."""
    keys = np.arange(1, 41, dtype=np.uint64)
    layout = ps_mesh(N, ["cpu"])
    pt = SparseTable(w2v_access(LR, D), KeyIndex(
        N, 16, partition=HotColdPartition(keys[:10])), "cpu", mesh=layout)
    jt = JaxSparseTable(jax_w2v_access(learning_rate=LR, len_vec=D),
                        JaxKeyIndex(N, 16, partition=JaxPart(keys[:10])),
                        mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    all_slots = np.asarray(pt.key_index.lookup(keys), np.int64)
    jt.key_index.lookup(keys)
    slots = np.concatenate([all_slots[:3], all_slots[:1],
                            all_slots[10:16], [-1] * 6]).astype(np.int32)
    grads = {f: np.ones((16, D), np.float32) for f in ("h", "v")}
    t, jtr = HybridTransfer(layout), JaxHybrid(jax_ps_mesh())
    t.count_traffic = jtr.count_traffic = True
    for _ in range(2):
        t.pull(pt.state, torch.from_numpy(slots), pt.access)
        jtr.pull(jt.state, slots, jt.access)
    t.push(pt.state, torch.from_numpy(slots), _t(grads), pt.access,
           mean=True)
    jtr.push(jt.state, slots, grads, jt.access, mean=True)
    tr = t.traffic()
    assert tr["routed_rows"] == 3 * 6
    assert tr["hot_rows"] == 3 * 4
    assert tr["psum_bytes"] == 10 * (2 * 8 * 4 + 4)
    assert tr["overflow_dropped"] == 0
    assert tr == jtr.traffic()


# -- the model -----------------------------------------------------------------

CONF = {
    "cluster": {"server_num": N, "transfer": "hybrid"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2,
                 "shared_pool": 64},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
B = 64


def corpus(n_sent=60, vocab=300, length=16, seed=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _models(sents, cap=80, transfer="hybrid", **w2v):
    """A JAX and a port model on the same corpus, the port's table a copy
    of JAX's (``convert.state_from_jax``)."""
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for c in (jc, pc):
        c.set("cluster", "transfer", transfer)
        for k, v in w2v.items():
            c.set("word2vec", k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    assert jm.transfer.name == pm.transfer.name == transfer
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


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("rendering", ["gather", "stencil"])
def test_one_hybrid_step_matches_jax_step(devices8, rendering):
    """One step with JAX's draws replayed; the stencil rendering pulls its
    span through the hybrid transfer, as JAX's non-fused path does."""
    sents = corpus()
    jm, pm = _models(sents, stencil=int(rendering == "stencil"))
    assert pm.resolved_rendering == rendering and pm.table.n_hot > 0
    bat = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=13)
    batch = next(iter(bat.epoch_stencil(B) if pm.stencil else bat.epoch(B)))
    key = jax.random.key(7)
    step = jm._build_step()
    fields = ((batch.tokens, batch.sent_id, batch.center_pos, batch.half)
              if pm.stencil else
              (batch.centers, batch.contexts, batch.ctx_mask))
    out, es, ec = step({f: jnp.array(v) for f, v in jm.table.state.items()},
                       jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
                       *(jnp.asarray(f) for f in fields), key)
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), (B, pm.negative)))
    assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, float(es), rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in out:
        _envelope(got[f], np.asarray(out[f]))
    paths = dict(pm.transfer.push_paths)
    assert paths["h:hot"] == 1
    assert paths["v:hot_span" if pm.stencil else "v:hot"] == 1


def test_hybrid_train_loss_tracks_jax(devices8):
    """Three epochs of one batch through ``train`` with JAX's draws
    replayed: the losses track JAX's hybrid within rtol 5e-3 and fall."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents)
    want = jm.train(sents, niters=3, batch_size=B)
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), (B, pm.negative)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    np.testing.assert_allclose(got, want, rtol=5e-3)
    assert got[-1] < got[0]
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))


def test_train_metrics_carries_transfer_traffic():
    sents = corpus(n_sent=30, vocab=60, length=15, seed=8)
    pm = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    pm.transfer.count_traffic = True
    pm.train(sents, niters=1, batch_size=64)
    tr = pm.train_metrics["transfer_traffic"]
    assert tr["hot_rows"] > 0 and tr["routed_rows"] > 0
    assert tr["psum_bytes"] > 0 and tr["pull_hot_rows"] > 0
    assert tr == pm.transfer.traffic()
    off = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    off.train(sents, niters=1, batch_size=64)
    assert "transfer_traffic" not in off.train_metrics


# -- checkpoints -----------------------------------------------------------------

def test_hybrid_checkpoint_roundtrip_and_n_hot_guard(tmp_path):
    """npz with ``n_hot`` and the ``@hot`` planes: a fresh model on the
    same corpus (same partition) restores every row bit for bit; a table
    without the partition refuses it, naming ``n_hot``."""
    sents = corpus(n_sent=30, vocab=60, length=15, seed=4)
    m = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    m.train(sents, niters=1, batch_size=64)
    assert m.table.n_hot > 0
    path = str(tmp_path / "hyb")
    pck.save_checkpoint(m.table, path)
    with np.load(path + ".npz") as z:
        assert int(z["n_hot"]) == m.table.n_hot
        assert z["field__h@hot"].shape == (m.table.n_hot, 16)
    m2 = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    m2.build(sents)
    hot_t = m2.table.state[hot_name("h")]
    pck.load_checkpoint(m2.table, path)
    assert m2.table.state[hot_name("h")] is hot_t     # copied in place
    a, b = m.table.to_numpy(), m2.table.to_numpy()
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])
    assert list(m2.table.key_index.items()) == list(m.table.key_index.items())
    assert np.isfinite(m2.train(sents, niters=1, batch_size=64)[0])
    c = ConfigParser().update(CONF)
    c.set("cluster", "transfer", "tpu")
    m3 = Word2Vec(config=c, device="cpu")
    m3.build(sents)
    with pytest.raises(ValueError, match="n_hot"):
        pck.load_checkpoint(m3.table, path)


def test_hybrid_checkpoints_and_dumps_cross_with_jax(tmp_path, devices8):
    """A JAX hybrid checkpoint loads into the port and the port's into
    JAX, bit for bit; the text dumps are byte for byte the same file."""
    sents = corpus(n_sent=30, vocab=60, length=15, seed=5)
    jm, pm = _models(sents)
    jm.train(sents, niters=1, batch_size=B)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jm.table, jpath)
    pck.load_checkpoint(pm.table, jpath)
    got = pm.table.to_numpy()
    for f, a in jm.table.state.items():
        np.testing.assert_array_equal(got[f], np.asarray(a), err_msg=f)
    pm.train(sents, niters=1, batch_size=B)
    pck.save_checkpoint(pm.table, ppath)
    jm2 = JaxWord2Vec(config=JaxConfig().update(CONF),
                      capacity_per_shard=80).build(sents)
    jck.load_checkpoint(jm2.table, ppath)
    got = pm.table.to_numpy()
    for f, a in jm2.table.state.items():
        np.testing.assert_array_equal(np.asarray(a), got[f], err_msg=f)
    assert list(jm2.table.key_index.items()) == \
        list(pm.table.key_index.items())
    jm2.save(str(tmp_path / "j.txt"))
    pm.save(str(tmp_path / "p.txt"))
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "p.txt").read_bytes()


# -- the Zipf reduction ----------------------------------------------------------

def test_hybrid_zipf_traffic_reduction():
    """On a Zipf(1.0) corpus the hybrid routes at least 3x fewer rows than
    tpu through the same batches, and the split conserves rows exactly:
    every row tpu routed is routed or hot here.  Both start from the same
    rows by key (``state_from_jax``'s copy of the tpu table through the
    unified view)."""
    V = 4000
    bulk = synthetic_corpus_bulk(40, V, length=500, seed=7, zipf=1.0)
    sents = [list(map(int, r)) for r in bulk]
    vocab = build_vocab(sents)
    models = {}
    for name in ("tpu", "hybrid"):
        c = ConfigParser().update(CONF)
        c.set("cluster", "transfer", name)
        c.set("worker", "minibatch", 4096)
        models[name] = Word2Vec(config=c, device="cpu").build_from_vocab(
            vocab)
    tpu, hyb = models["tpu"], models["hybrid"]
    assert hyb.table.n_hot > 0
    src = np.asarray(tpu.table.key_index.lookup(vocab.keys))
    dst = np.asarray(hyb.table.key_index.lookup(vocab.keys))
    n_hot = hyb.table.n_hot
    uni = {}
    for f in hyb.table.access.fields:
        rows = hyb.table.unified_rows_host(f).copy()
        rows[dst] = tpu.table.unified_rows_host(f)[src]
        uni[f], uni[hot_name(f)] = rows[n_hot:], rows[:n_hot]
    hyb.table.state = state_from_jax(uni, "cpu", mesh=hyb.cluster.mesh)
    out = {}
    for name, m in models.items():
        m.transfer.count_traffic = True
        out[name] = (m.train(sents[:8], niters=1, batch_size=512),
                     m.transfer.traffic())
    (tl, tt), (hl, ht) = out["tpu"], out["hybrid"]
    np.testing.assert_allclose(hl, tl, rtol=5e-3)
    assert ht["routed_rows"] + ht["hot_rows"] == tt["routed_rows"]
    assert ht["routed_rows"] * 3 <= tt["routed_rows"], (ht, tt)
    assert ht["psum_bytes"] > 0 and tt["hot_rows"] == 0


# -- LR and GloVe: no partition, the tpu path ----------------------------------

@pytest.mark.parametrize("app", ["lr", "glove"])
def test_lr_and_glove_on_hybrid_are_tpu_bit_for_bit(app):
    """The JAX package builds LR's and GloVe's tables with no partition,
    so ``transfer: hybrid`` is the ``tpu`` path (n_hot = 0): the same
    losses and tables, bit for bit, from the same seed."""
    from swiftmpi_tpu_torch.data.libsvm import synthetic_dataset
    from swiftmpi_tpu_torch.models.glove import GloVe
    from swiftmpi_tpu_torch.models.logistic import LogisticRegression
    runs = []
    for transfer in ("tpu", "hybrid"):
        c = ConfigParser().update({
            "cluster": {"transfer": transfer, "server_num": N},
            "worker": {"minibatch": 32, "inner_steps": 2},
            "server": {"initial_learning_rate": 0.1},
            "glove": {"len_vec": 16, "window": 4, "minibatch": 64}})
        if app == "lr":
            m = LogisticRegression(config=c, capacity_per_shard=64,
                                   device="cpu")
            losses = m.train(synthetic_dataset(256, 40, 5, seed=6), niters=2)
        else:
            m = GloVe(config=c, capacity_per_shard=32, device="cpu").build(
                corpus(n_sent=40, vocab=60, length=20, seed=2))
            losses = m.train(niters=2)
        assert m.transfer.name == transfer and m.table.n_hot == 0
        runs.append((losses, m.table.to_numpy()))
    (lt, tt), (lh, th) = runs
    assert lh == lt
    assert set(th) == set(tt)
    for f in tt:
        np.testing.assert_array_equal(th[f], tt[f], err_msg=f)


def test_hybrid_snapshot_mode_tracks_jax(devices8):
    """``local_steps: 3`` on hybrid: the snapshot holds the hot planes
    with the tail (grads against both, pushes onto the live table), six
    steps against JAX's hybrid with its draws replayed."""
    sents = corpus(n_sent=16, vocab=300, length=8, seed=4)   # 2 batches
    jm, pm = _models(sents, local_steps=3)
    want = jm.train(sents, niters=3, batch_size=B)
    key, draws = jax.random.key(0 ^ 0x5EED), []
    for _ in range(6):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), (B, pm.negative)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    assert pm.train_metrics["steps"] == 6
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))
