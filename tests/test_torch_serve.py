"""The port's serving plane (``swiftmpi_tpu_torch/serve/``, ``[serve]`` on
word2vec, sent2vec's ``snapshot=`` and ``serve_publisher``) and the
host-side pieces it stands on (``utils/buffer.py``, ``HashFrag.
serialize``, ``parameter/cache.py``) against the JAX package, mirroring
``tests/test_serve.py`` and ``tests/test_serve_fleet.py`` at small sizes;
sharded tables use 8 ranks on the CPU against the ``devices8`` mesh.

Tolerances: snapshot planes of a table copied from JAX's are held bit for
bit against JAX's publish of it; shipper manifests (but their clocks) and
replayed planes exactly; ``LruTailFront``'s eviction order and
``HashFrag.serialize``'s bytes exactly; top-k keys exactly and scores
within 1e-5 (the torch path against the host path: scores within 1e-5,
the same neighbours wherever the gap between scores exceeds 1e-5);
sent2vec over a snapshot within the sent2vec tests' ``1e-6 + 1e-4|b|``
of JAX's, and bit for bit the port's over the live table it copies.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.cluster.hashfrag import HashFrag as JaxHashFrag
from swiftmpi_tpu.data.text import synthetic_corpus as jax_synthetic
from swiftmpi_tpu.models.sent2vec import Sent2Vec as JaxSent2Vec
from swiftmpi_tpu.models.sent2vec import \
    build_word_model_from_dump as jax_build
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.parameter.cache import LocalParamCache as JaxCache
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.serve import LruTailFront as JaxFront
from swiftmpi_tpu.serve import SnapshotPublisher as JaxPublisher
from swiftmpi_tpu.serve.query import snapshot_topk as jax_topk
from swiftmpi_tpu.serve.shipper import SnapshotReplica as JaxReplica
from swiftmpi_tpu.serve.shipper import SnapshotShipper as JaxShipper
from swiftmpi_tpu.serve.snapshot import TableSnapshot as JaxSnapshot
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu.utils.buffer import BinaryBuffer as JaxBuffer
from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.cluster.hashfrag import HashFrag
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import synthetic_corpus
from swiftmpi_tpu_torch.io.resilience import train_with_resume
from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.parameter.cache import LocalParamCache
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
from swiftmpi_tpu_torch.parameter.sparse_table import ROWVER_KEY, ef_name
from swiftmpi_tpu_torch.serve import (EmbeddingReader, LruTailFront,
                                      SnapshotPublisher, SnapshotReplica,
                                      SnapshotShipper, SnapshotUnavailable,
                                      TableSnapshot)
from swiftmpi_tpu_torch.serve.query import snapshot_topk
from swiftmpi_tpu_torch.serve.shipper import read_manifest
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.testing.faults import FaultPlan
from swiftmpi_tpu_torch.utils import ConfigParser
from swiftmpi_tpu_torch.utils.buffer import BinaryBuffer, TextBuffer

N = 8


@pytest.fixture(autouse=True)
def _clean():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()
    faults.clear()


def _plain_table(num_shards=2, cap=16, d=8, n_keys=12, seed=1):
    """(table, keys, slots): a table of ``num_shards`` ranks on the CPU,
    keys from 1 so the vacant-slot key (0) never collides."""
    ki = KeyIndex(num_shards=num_shards, capacity_per_shard=cap)
    mesh = ps_mesh(num_shards, ["cpu"]) if num_shards > 1 else None
    table = SparseTable(w2v_access(0.3, d), ki, "cpu", seed=seed, mesh=mesh)
    keys = np.arange(1, 1 + n_keys, dtype=np.uint64)
    slots = np.asarray(ki.lookup(keys), np.int64)
    return table, keys, slots


def _publish(pub, table, keys):
    slots = np.asarray(table.key_index.lookup(keys, create=False), np.int64)
    return pub.publish(table, keys=keys, slots=slots)


# -- the host pieces ------------------------------------------------------------

def test_binary_buffer_bytes_match_jax():
    ops = [("put_int32", -7), ("put_uint32", 9), ("put_int64", -(1 << 40)),
           ("put_uint64", (1 << 63) + 5), ("put_float", 1.5),
           ("put_double", -2.25), ("put_bool", True)]
    a, b = BinaryBuffer(), JaxBuffer()
    for name, v in ops:
        getattr(a, name)(v)
        getattr(b, name)(v)
    arr = np.arange(6, dtype=np.int32)
    a.put_array(arr)
    b.put_array(arr)
    assert a.to_bytes() == b.to_bytes() and a.size == b.size
    r = BinaryBuffer(b.to_bytes())
    got = [getattr(r, "get" + name[3:])() for name, _ in ops]
    assert got == [v for _, v in ops]
    np.testing.assert_array_equal(r.get_array(6, np.int32), arr)
    assert r.read_finished
    t = TextBuffer("a").put(1, 2.5).put_line(" x")
    assert t.to_string() == "a12.5 x\n" and t.tokens() == ["a12.5", "x"]


@pytest.mark.parametrize("shards,frags", [(1, None), (8, None), (3, 17)])
def test_hashfrag_serialize_bytes_match_jax(shards, frags):
    p, j = HashFrag(shards, frags), JaxHashFrag(shards, frags)
    pb, jb = p.serialize(BinaryBuffer()), j.serialize(JaxBuffer())
    assert pb.to_bytes() == jb.to_bytes()
    back = HashFrag.deserialize(BinaryBuffer(jb.to_bytes()))
    assert back == p
    keys = np.arange(1000, dtype=np.uint64)
    np.testing.assert_array_equal(back.to_shard_id(keys),
                                  j.to_shard_id(keys))


def test_local_param_cache_matches_jax():
    sides = [LocalParamCache({"h": 3, "v": 3}), JaxCache({"h": 3, "v": 3})]
    rng = np.random.default_rng(2)
    pos = np.array([0, 2, 2, 1, 0, 2])
    rows = rng.normal(size=(6, 3)).astype(np.float32)
    params = rng.normal(size=(3, 3)).astype(np.float32)
    for c in sides:
        c.init_keys([5, 9, 5, 11])
        c.set_params({"h": params})
        c.accumulate("h", pos, rows)
    assert sides[0].keys.tolist() == sides[1].keys.tolist() == [5, 9, 11]
    assert sides[0].positions([11, 5]).tolist() == [2, 0]
    a, b = sides[0].normalized_grads(), sides[1].normalized_grads()
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(sides[0].params["h"], params)


# -- the publisher ---------------------------------------------------------------

def test_publisher_every_cadence_and_versions():
    table, keys, slots = _plain_table()
    pub = SnapshotPublisher(every=3, depth=2)
    assert pub.latest() is None
    with pytest.raises(SnapshotUnavailable):
        pub.require()
    for i in range(1, 8):
        snap = pub.on_steps(table, n=1, keys=keys, slots=slots)
        if i % 3:
            assert snap is None
        else:
            assert snap is pub.latest()
            assert snap.version == i // 3 and snap.step == i
    assert pub.version == 2 and pub.staleness_steps() == 1
    final = pub.publish(table, keys=keys, slots=slots)
    assert final.version == 3 and pub.staleness_steps() == 0
    assert len(pub._history) == 2
    assert pub.wait_for_version(3, timeout=0.1) is final
    assert pub.wait_for_version(99, timeout=0.01) is None
    for bad in (dict(every=0), dict(depth=0)):
        with pytest.raises(ValueError):
            SnapshotPublisher(**bad)


def test_snapshot_lookup_and_lazy_callables():
    table, keys, slots = _plain_table()
    pub = SnapshotPublisher(every=1)
    resolved = []

    def lazy_keys():
        resolved.append("k")
        return keys

    snap = pub.publish(table, keys=lazy_keys, slots=lambda: slots)
    assert resolved == ["k"]            # resolved exactly at publish
    got = snap.lookup(np.concatenate([keys[:4], [999]]).astype(np.uint64))
    np.testing.assert_array_equal(got[:4], slots[:4])
    assert got[4] == -1                 # unknown key
    np.testing.assert_array_equal(snap.key_of_slot()[slots], keys)
    bare = SnapshotPublisher(every=1).publish({"w": np.zeros((4, 2))})
    with pytest.raises(SnapshotUnavailable):
        bare.lookup([1])


def _jax_hybrid(n_keys=200, d=8, planes=True):
    """A hybrid table on JAX's ``devices8`` mesh, with ``v@ef`` and
    ``@rowver`` planes of random values, and the port's copy of it."""
    rng = np.random.default_rng(4)
    keys = rng.choice(50_000, size=n_keys, replace=False).astype(np.uint64)
    counts = np.arange(n_keys, 0, -1).astype(np.int64) ** 2
    jt = JaxSparseTable(jax_w2v_access(0.3, d), JaxKeyIndex(
        N, 64, partition=JaxPart.from_counts(keys, counts, batch_rows=64)),
        mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    slots = np.asarray(jt.key_index.lookup(keys), np.int64)
    if planes:
        jt.ensure_ef(("v",))
        jt.ensure_row_versions()
        cap = jt.key_index.capacity
        jt.state[ef_name("v")] = jax.device_put(
            rng.normal(size=(cap, d)).astype(np.float32),
            jt.field_sharding("v"))
        jt.state[ROWVER_KEY] = jax.device_put(
            rng.integers(0, 9, size=(cap, 1)).astype(np.int32),
            jt.field_sharding("v"))
    layout = ps_mesh(N, ["cpu"])
    pt = SparseTable(w2v_access(0.3, d), KeyIndex(
        N, 64, partition=HotColdPartition.from_counts(keys, counts,
                                                      batch_rows=64)),
        "cpu", mesh=layout)
    np.testing.assert_array_equal(pt.key_index.lookup(keys), slots)
    pt.state = state_from_jax({f: np.asarray(a)
                               for f, a in jt.state.items()}, "cpu",
                              mesh=layout)
    return jt, pt, keys, slots


def test_snapshot_planes_match_jax_publish(devices8):
    """A sharded hybrid table's snapshot: every plane (``@hot``, ``@ef``,
    ``@rowver``) a host numpy copy in global row order, bit for bit JAX's
    publish of the same table, with the same key map and ``n_hot``; the
    next in-place update does not reach it."""
    jt, pt, keys, slots = _jax_hybrid()
    sj = JaxPublisher(every=1).publish(jt, keys=keys, slots=slots)
    sp = SnapshotPublisher(every=1).publish(pt, keys=keys, slots=slots)
    assert sp.n_hot == sj.n_hot > 0
    assert set(sp.state) == set(sj.state) >= {"v@hot", "v@ef", ROWVER_KEY}
    for f, a in sj.state.items():
        assert isinstance(sp.state[f], np.ndarray)
        assert sp.state[f].dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(sp.state[f], np.asarray(a), f)
    before = sp.state["v"].copy()
    for t in pt.state["v"]:
        t.add_(1.0)                         # the next step, in place
    np.testing.assert_array_equal(sp.state["v"], before)


def test_bf16_snapshot_is_jax_bits():
    """A bfloat16 field comes out as ``ml_dtypes.bfloat16`` bits; readers
    upcast exactly."""
    ki = KeyIndex(1, 16)
    t = SparseTable(w2v_access(0.3, 4, param_dtype=torch.bfloat16), ki,
                    "cpu")
    keys = np.arange(1, 9, dtype=np.uint64)
    slots = np.asarray(ki.lookup(keys), np.int64)
    snap = SnapshotPublisher().publish(t, keys=keys, slots=slots)
    assert snap.state["v"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        snap.state["v"].view(np.int16),
        t.state["v"].view(torch.int16).numpy())
    pub = SnapshotPublisher()
    pub.publish(t, keys=keys, slots=slots)
    got = EmbeddingReader(pub).read(keys)
    np.testing.assert_array_equal(got, t.state["v"].float().numpy()[slots])


# -- the read path ----------------------------------------------------------------

def test_reader_routes_tail_and_caches():
    table, keys, slots = _plain_table()
    pub = SnapshotPublisher(every=1)
    _publish(pub, table, keys)
    reader = EmbeddingReader(pub, field="v", cache_rows=64)
    want = table.unified_rows_host("v")[slots]
    np.testing.assert_array_equal(reader.read(keys), want)
    assert reader.stats["tail_misses"] == len(keys)
    assert reader.stats["front_hits"] == 0
    np.testing.assert_array_equal(reader.read(keys), want)
    assert reader.stats["front_hits"] == len(keys)
    assert 0.0 < reader.hit_ratio() <= 0.5
    z = reader.read(np.array([9999], np.uint64))
    np.testing.assert_array_equal(z, np.zeros_like(z))
    q = reader.latency_quantiles()
    assert set(q) == {"p50_ms", "p99_ms"} and q["p99_ms"] >= q["p50_ms"]


def test_reader_hot_head_is_local_hit(devices8):
    """Hot slots answer from the snapshot's hot plane, tail slots through
    the front; both agree with the unified host view and with JAX's
    reader over JAX's publish of the same table."""
    from swiftmpi_tpu.serve import EmbeddingReader as JaxReader
    jt, pt, keys, slots = _jax_hybrid(planes=False)
    pub, jpub = SnapshotPublisher(every=1), JaxPublisher(every=1)
    pub.publish(pt, keys=keys, slots=slots)
    jpub.publish(jt, keys=keys, slots=slots)
    reader, jreader = EmbeddingReader(pub), JaxReader(jpub)
    probe = np.concatenate([keys[:8], keys[-32:]])
    pslots = np.asarray(pt.key_index.lookup(probe, create=False))
    got = reader.read(probe)
    np.testing.assert_array_equal(got, pt.unified_rows_host("v")[pslots])
    np.testing.assert_array_equal(got, jreader.read(probe))
    n_hot = int((pslots < pt.n_hot).sum())
    assert reader.stats == jreader.stats
    assert reader.stats["hot_hits"] == n_hot > 0
    assert reader.stats["tail_misses"] == len(probe) - n_hot > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_front_eviction_order_matches_jax(seed):
    """A random run of gets, puts and version syncs through both fronts:
    the same hits, rows and resident slots after every operation."""
    rng = np.random.default_rng(seed)
    p, j = LruTailFront("v", dim=3, capacity=4), JaxFront("v", dim=3,
                                                          capacity=4)
    for _ in range(60):
        op = rng.integers(0, 5)
        slots = rng.integers(0, 9, size=rng.integers(1, 4))
        if op == 0:
            p.sync_version(int(rng.integers(0, 2)))
            j.sync_version(p.version)
        elif op < 3:
            rows = rng.normal(size=(len(slots), 3)).astype(np.float32)
            p.put(slots, rows)
            j.put(slots, rows)
        else:
            (rp, hp), (rj, hj) = p.get(slots), j.get(slots)
            np.testing.assert_array_equal(hp, hj)
            np.testing.assert_array_equal(rp, rj)
        assert list(p._pos.items()) == list(j._pos.items())
    with pytest.raises(ValueError):
        LruTailFront("v", dim=4, capacity=0)


def test_lru_front_eviction_and_version_sync():
    front = LruTailFront("v", dim=4, capacity=2)
    r = np.arange(8, dtype=np.float32).reshape(2, 4)
    front.put(np.array([1, 2]), r)
    rows, hit = front.get(np.array([1, 2]))
    assert hit.all()
    np.testing.assert_array_equal(rows, r)
    front.get(np.array([1]))                 # 2 becomes the LRU
    front.put(np.array([3]), r[:1] + 10)
    _, hit = front.get(np.array([1, 2, 3]))
    np.testing.assert_array_equal(hit, [True, False, True])
    front.sync_version(7)
    _, hit = front.get(np.array([1, 3]))
    assert not hit.any() and len(front) == 0


# -- top-k ------------------------------------------------------------------------

def test_topk_matches_host_oracle_and_jax():
    table, keys, slots = _plain_table(d=8, n_keys=12)
    pub = SnapshotPublisher(every=1)
    pub.publish(table, keys=keys, slots=slots, meta={"query_field": "v"})
    reader = EmbeddingReader(pub, field="v")
    q = keys[:3]
    nkeys, scores = reader.topk(q, k=4)
    assert nkeys.shape == (3, 4) and scores.shape == (3, 4)
    vecs = table.unified_rows_host("v").astype(np.float32)
    vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True),
                             1e-12)
    inv = pub.latest().key_of_slot()
    for qi in range(len(q)):
        s = int(slots[qi])
        cos = vecs @ vecs[s]
        cos[s] = -np.inf                 # self-exclusion
        order = np.argsort(-cos)[:4]
        np.testing.assert_array_equal(nkeys[qi], inv[order])
        np.testing.assert_allclose(scores[qi], cos[order], rtol=1e-5,
                                   atol=1e-6)
    snap = pub.latest()
    jsnap = JaxSnapshot(snap.version, snap.step, dict(snap.state),
                        keys=snap.keys, slots=snap.slots,
                        meta={"query_field": "v"})
    qv = reader.read(q)
    got, want = (snapshot_topk(snap, qv, k=4, exclude_slots=slots[:3]),
                 jax_topk(jsnap, qv, k=4, exclude_slots=slots[:3]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    _, s_unknown = reader.topk(np.array([44444], np.uint64), k=4)
    assert np.isneginf(s_unknown).all()
    assert reader.stats["topk_queries"] == 4


def _hold_topk(host, dev, k, tol=1e-5):
    """The first ``k`` of ``k + 1`` neighbours: scores within ``tol``, the
    same neighbour set wherever the gap to the next score exceeds
    ``tol``."""
    (_, hs_, hsc), (_, ds_, dsc) = host, dev
    np.testing.assert_allclose(dsc[:, :k], hsc[:, :k], rtol=0, atol=tol)
    for qi in range(hsc.shape[0]):
        sc = hsc[qi]
        for n in range(1, k + 1):
            if sc[n - 1] - sc[n] > tol:
                assert set(hs_[qi, :n]) == set(ds_[qi, :n]), (qi, n)


@pytest.mark.parametrize("hot", [False, True])
def test_device_topk_agrees_with_host(devices8, hot):
    """``snapshot_topk(device=...)``, the torch path (here on the CPU),
    against the host path on a plain and a hybrid snapshot."""
    if hot:
        _, pt, keys, slots = _jax_hybrid(planes=False)
    else:
        pt, keys, slots = _plain_table(num_shards=8, cap=32, n_keys=200)
    snap = SnapshotPublisher().publish(pt, keys=keys, slots=slots)
    assert (snap.n_hot > 0) == hot
    qv = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    host = snapshot_topk(snap, qv, k=11, exclude_slots=slots[:16])
    dev = snapshot_topk(snap, qv, k=11, exclude_slots=slots[:16],
                        device="cpu")
    _hold_topk(host, dev, 10)
    if not torch.cuda.is_available():
        # device=True is the card: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            snapshot_topk(snap, qv, k=3, device=True)


# -- metrics ----------------------------------------------------------------------

def test_serve_metrics_mirrored_into_registry():
    obs.set_enabled(True)
    reg = obs.get_registry()
    table, keys, slots = _plain_table()
    pub = SnapshotPublisher(every=1)
    _publish(pub, table, keys)
    reader = EmbeddingReader(pub)
    reader.read(keys)
    reader.read(keys)
    reader.topk(keys[:2], k=3)
    snap = reg.snapshot()
    c, g = snap["counters"], snap["gauges"]
    assert c["serve/snapshots"] == 1 and g["serve/snapshot_version"] == 1
    assert c["serve/queries"] == 4
    assert c["serve/rows_read"] == 2 * len(keys) + 2
    assert c["serve/misses"] == len(keys)
    assert c["serve/hits"] >= len(keys)
    assert c["serve/topk_queries"] == 2
    assert snap["hists"]["serve/latency_ms"]["count"] == 4
    assert g["serve/staleness_steps"] == 0


def test_serve_metrics_replica_labeled_when_launched(monkeypatch):
    monkeypatch.setenv("SMTPU_PROCESS_ID", "2")
    obs.set_enabled(True)
    reg = obs.get_registry()
    table, keys, slots = _plain_table()
    pub = SnapshotPublisher(every=1)
    _publish(pub, table, keys)
    EmbeddingReader(pub).read(keys)
    snap = reg.snapshot()
    c = snap["counters"]
    assert c["serve/queries{replica=r2}"] == 1
    assert c["serve/rows_read{replica=r2}"] == len(keys)
    assert "serve/latency_ms{replica=r2}" in snap["hists"]
    assert "serve/staleness_steps{replica=r2}" in snap["gauges"]
    assert "serve/queries" not in c


# -- word2vec with [serve] -----------------------------------------------------------

SERVE_CONF = {
    "cluster": {"transfer": "xla", "server_num": 1},
    "word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                 "learning_rate": 0.05},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 128},
}


def _serving_model(every=2, **sections):
    c = ConfigParser().update(SERVE_CONF)
    c.set("serve", "every", every)
    for sec, kv in sections.items():
        for k, v in kv.items():
            c.set(sec, k, v)
    return Word2Vec(config=c, device="cpu")


def test_train_while_serving_concurrent_readers():
    """Concurrent query streams over a training model see complete
    snapshots of numpy planes, versions only move forward, and the final
    snapshot is the trained table."""
    corpus = synthetic_corpus(30, vocab_size=50, length=12, seed=6)
    model = _serving_model(every=2)
    model.build(corpus)
    pub = model.serving_publisher()
    stop = threading.Event()
    failures, versions = [], [[] for _ in range(3)]

    def query_stream(seed):
        rng = np.random.default_rng(seed)
        reader = EmbeddingReader(pub, field="v", cache_rows=128)
        if pub.wait_for_version(1, timeout=60.0) is None:
            failures.append("no snapshot within 60s")
            return
        while not stop.is_set():
            snap = reader.publisher.require()
            if not all(isinstance(v, np.ndarray)
                       for v in snap.state.values()):
                failures.append("a plane that is not numpy")
            rows = reader.read(rng.choice(model.vocab.keys, size=16))
            if not np.isfinite(rows).all():
                failures.append("non-finite rows")
            versions[seed].append(snap.version)
            time.sleep(0.001)

    threads = [threading.Thread(target=query_stream, args=(s,),
                                daemon=True) for s in range(3)]
    for t in threads:
        t.start()
    losses = model.train(corpus, niters=3, batch_size=64)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert pub.version >= 2 and any(versions)
    for vs in versions:
        assert all(b >= a for a, b in zip(vs, vs[1:]))
    probe = model.vocab.keys[:8]
    want = model.table.unified_rows_host("v")[
        np.asarray(model.table.key_index.lookup(probe, create=False))]
    np.testing.assert_array_equal(EmbeddingReader(pub).read(probe), want)
    assert pub.staleness_steps() == 0


def test_serve_every_publishes_at_the_jax_safe_points(devices8):
    """``[serve] every: 3`` over single steps and over groups of
    ``inner_steps``: the same versions at the same steps as the JAX
    package's publisher (the final publish included); hogwild publishes
    once an epoch, as JAX's does."""
    corpus = synthetic_corpus(30, vocab_size=50, length=12, seed=6)
    for sections in ({}, {"worker": {"inner_steps": 4}}):
        m = _serving_model(every=3, serve={"depth": 64}, **sections)
        jc = JaxConfig().update(SERVE_CONF)
        jc.set("serve", "every", 3)
        jc.set("serve", "depth", 64)
        for sec, kv in sections.items():
            for k, v in kv.items():
                jc.set(sec, k, v)
        jm = JaxWord2Vec(config=jc)
        for x in (m, jm):
            x.train(corpus, niters=2, batch_size=64)
        steps = [(s.version, s.step) for s in m.serve_publisher._history]
        assert steps == [(s.version, s.step)
                         for s in jm.serve_publisher._history], sections
        assert len(steps) >= 2
    m = _serving_model(every=1, serve={"depth": 64}, word2vec={
        "async_mode": "hogwild", "local_steps": 2})
    m.train(corpus, niters=2, batch_size=16)
    assert [(s.version, s.step) for s in m.serve_publisher._history] \
        == [(1, 1), (2, 2), (3, 2)]


def test_grow_during_serving_old_snapshot_stays_valid():
    """A held pre-grow snapshot keeps answering from its own arrays; the
    next publish carries the grown map and the same rows."""
    corpus = synthetic_corpus(30, vocab_size=50, length=12, seed=6)
    model = _serving_model(every=1)
    model.build(corpus)
    pub = model.serving_publisher()
    model.train(corpus, niters=1, batch_size=64)
    old_snap = pub.latest()
    probe = model.vocab.keys[:8]
    before = EmbeddingReader(pub, field="v").read(probe)
    old_cap = model.table.capacity
    model.table.grow(2 * model.table.key_index.capacity_per_shard)
    model._remap_vocab()
    assert old_snap.tail_array("v").shape[0] == old_cap
    model._serve_publish()
    new_snap = pub.latest()
    assert new_snap.version == old_snap.version + 1
    assert new_snap.tail_array("v").shape[0] == 2 * old_cap
    np.testing.assert_array_equal(
        EmbeddingReader(pub, field="v").read(probe), before)


def test_chaos_serving_reads_survive_crash_and_restore(tmp_path):
    """Reads keep succeeding while training crashes at an injected step
    and resumes from its checkpoint: no read fails, versions never go
    back, publishes go on after the restore."""
    corpus = synthetic_corpus(30, vocab_size=50, length=12, seed=6)
    model = _serving_model(every=1)
    model.build(corpus)
    pub = model.serving_publisher()
    stop = threading.Event()
    failures, versions = [], []

    def query_stream():
        reader = EmbeddingReader(pub, field="v", cache_rows=128)
        rng = np.random.default_rng(0)
        if pub.wait_for_version(1, timeout=60.0) is None:
            failures.append("no snapshot within 60s")
            return
        while not stop.is_set():
            try:
                rows = reader.read(rng.choice(model.vocab.keys, size=8))
                if not np.isfinite(rows).all():
                    failures.append("non-finite rows")
                versions.append(pub.require().version)
            except Exception as e:               # noqa: BLE001
                failures.append(repr(e))
                return
            time.sleep(0.001)

    t = threading.Thread(target=query_stream, daemon=True)
    t.start()
    losses = train_with_resume(
        model, corpus, niters=4, checkpoint_path=str(tmp_path / "ck"),
        checkpoint_every=1, max_restarts=2,
        fault_plan=FaultPlan().crash_at_step(2), batch_size=64)
    crash_version = pub.version
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert not failures, failures
    assert versions and np.isfinite(losses).all()
    assert all(b >= a for a, b in zip(versions, versions[1:]))
    assert crash_version > 2


# -- shipping ----------------------------------------------------------------------

class _Src:
    """tests/test_serve_fleet.py's publisher stand-in: a mutable hot/tail
    table minting successive host snapshots of either package."""

    def __init__(self, snap_cls, n_hot=4, tail_cap=12, n_keys=14, d=4,
                 seed=0):
        rng = np.random.default_rng(seed)
        self.snap_cls = snap_cls
        self.state = {
            "v@hot": rng.normal(size=(n_hot, d)).astype(np.float32),
            "v": rng.normal(size=(tail_cap, d)).astype(np.float32)}
        self.n_hot, self.d = n_hot, d
        self.keys = np.arange(1, n_keys + 1, dtype=np.uint64)
        self.slots = np.arange(n_keys, dtype=np.int64)
        self.version = self.step = 0

    def touch(self, rows, scale=0.5):
        rows = np.asarray(rows, np.int64)
        self.state["v@hot"][rows[rows < self.n_hot]] += scale
        self.state["v"][rows[rows >= self.n_hot] - self.n_hot] += scale

    def snap(self):
        self.version += 1
        self.step += 5
        return self.snap_cls(
            self.version, self.step,
            {f: v.copy() for f, v in self.state.items()},
            keys=self.keys.copy(), slots=self.slots.copy(),
            n_hot=self.n_hot)


def _script_first_then_touched(src, ship):
    ship(src.snap())
    src.touch([1, 6, 9])
    ship(src.snap())


def _script_int8_chain(src, ship):
    ship(src.snap())
    for _ in range(5):
        src.touch([2, 7], scale=0.01)
        ship(src.snap())


def _script_reshape_remap(src, ship):
    ship(src.snap())
    src.state["v@hot"] = np.vstack([src.state["v@hot"],
                                    np.zeros((2, src.d), np.float32)])
    src.n_hot += 2
    ship(src.snap())
    src.slots[0], src.slots[1] = src.slots[1], src.slots[0]
    ship(src.snap())


def _script_append(src, ship):
    ship(src.snap())
    src.keys = np.append(src.keys, np.uint64(15))
    src.slots = np.append(src.slots, np.int64(14))
    src.touch([3])
    ship(src.snap())


def _script_wide_touch(src, ship):
    ship(src.snap())
    src.touch(np.arange(16))                    # every row: a dense delta
    ship(src.snap())


@pytest.mark.parametrize("script,quant,full_every", [
    (_script_first_then_touched, "off", 0), (_script_int8_chain, "int8", 0),
    (_script_int8_chain, "off", 2), (_script_reshape_remap, "off", 0),
    (_script_append, "off", 0), (_script_wide_touch, "int8", 0)])
def test_shipper_manifest_and_replay_match_jax(tmp_path, script, quant,
                                               full_every):
    """The same publishes through both packages' shippers: the manifest
    records (but their clocks) and the payload arrays are equal, and both
    replicas replay the same planes and key maps."""
    dirs = {}
    for pkg, (snap_cls, shipper_cls) in {
            "port": (TableSnapshot, SnapshotShipper),
            "jax": (JaxSnapshot, JaxShipper)}.items():
        d = tmp_path / pkg
        shipper = shipper_cls(str(d), quant=quant, full_every=full_every)
        script(_Src(snap_cls, seed=3), shipper.ship)
        dirs[pkg] = d

    def records(d):
        out = read_manifest(str(d))
        for r in out:
            r.pop("ts"), r.pop("ship_ms")
        return out

    rp, rj = records(dirs["port"]), records(dirs["jax"])
    assert rp == rj and len(rp) >= 2
    for r in rp:
        name = f"ship_v{r['version']}.npz"
        with np.load(dirs["port"] / name) as a, \
                np.load(dirs["jax"] / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], k)
    rep, jrep = SnapshotReplica(str(dirs["port"])), JaxReplica(
        str(dirs["jax"]))
    assert rep.poll() == jrep.poll() == len(rp)
    a, b = rep.require(), jrep.require()
    assert (a.version, a.step, a.n_hot) == (b.version, b.step, b.n_hot)
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.slots, b.slots)
    for f in b.state:
        np.testing.assert_array_equal(a.state[f], b.state[f])


def test_replica_surface_serves_and_refuses_a_rewind(tmp_path):
    src = _Src(TableSnapshot)
    shipper = SnapshotShipper(str(tmp_path), quant="off")
    shipper.ship(src.snap())
    rep = SnapshotReplica(str(tmp_path))
    assert rep.wait_for_version(1, timeout=5.0) is not None
    got = EmbeddingReader(rep, field="v", cache_rows=8).read(
        np.array([1, 5, 14], np.uint64))
    np.testing.assert_array_equal(got, np.stack(
        [src.state["v@hot"][0], src.state["v"][0], src.state["v"][9]]))
    assert rep.staleness_steps() == 0 and 0.0 <= rep.staleness_s() < 60
    with open(tmp_path / "ship_manifest.jsonl", "a") as f:
        f.write(json.dumps({"version": 1, "kind": "full", "step": 0})
                + "\n")
    with pytest.raises(RuntimeError, match="forked chain"):
        rep.poll()


def test_restart_late_joiner_and_torn_tail(tmp_path):
    src = _Src(TableSnapshot, seed=5)
    s1 = SnapshotShipper(str(tmp_path), quant="int8")
    for i in range(3):
        src.touch([i, 4 + i])
        s1.ship(src.snap())
    s2 = SnapshotShipper(str(tmp_path), quant="int8")   # a restart
    assert s2.version == 3
    rec = s2.ship(src.snap())
    assert (rec["version"], rec["kind"]) == (4, "full")
    live, late = SnapshotReplica(str(tmp_path)), None
    live.poll()
    late = SnapshotReplica(str(tmp_path))
    late.poll()
    for f in live.require().state:
        np.testing.assert_array_equal(live.require().state[f],
                                      late.require().state[f])
    path = tmp_path / "ship_manifest.jsonl"
    whole = path.read_bytes()
    lines = whole.splitlines(keepends=True)
    path.write_bytes(b"".join(lines[:-1]) + lines[-1][:20])   # torn
    assert [r["version"] for r in read_manifest(str(tmp_path))] \
        == [1, 2, 3]
    path.write_bytes(whole)
    assert len(read_manifest(str(tmp_path))) == 4


def test_word2vec_snapshots_ship_to_a_replica(tmp_path):
    """A trained model's published snapshots through the shipper: the
    replica's last version reads the trained rows."""
    corpus = synthetic_corpus(30, vocab_size=50, length=12, seed=6)
    model = _serving_model(every=2)
    model.build(corpus)
    shipper = SnapshotShipper(str(tmp_path), quant="off")
    model.train(corpus, niters=1, batch_size=64)
    shipper.ship(model.serve_publisher.latest())
    model.train(corpus, niters=1, batch_size=64)
    rec = shipper.ship(model.serve_publisher.latest())
    assert rec["kind"] in ("delta", "full")
    rep = SnapshotReplica(str(tmp_path))
    rep.poll()
    probe = model.vocab.keys[:5]
    np.testing.assert_array_equal(
        EmbeddingReader(rep).read(probe),
        EmbeddingReader(model.serve_publisher).read(probe))


# -- sent2vec over a snapshot ------------------------------------------------------

S2V_CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 12, "window": 2, "negative": 4, "sample": -1,
                 "learning_rate": 0.1, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 8},
}
S2V_NITERS = 3
LENGTHS = [12, 3, 7, 12, 5, 12, 9, 2, 12]


@pytest.fixture(scope="module")
def s2v_dump(tmp_path_factory):
    corpus = jax_synthetic(30, vocab_size=50, length=12, seed=3)
    jm = JaxWord2Vec(config=JaxConfig().update(S2V_CONF))
    jm.train(corpus, niters=2, batch_size=64)
    path = str(tmp_path_factory.mktemp("s2v") / "words.txt")
    jm.save(path)
    lines = [" ".join(map(str, s[:n])) for s, n in zip(corpus, LENGTHS)]
    return path, lines


def _s2v_jax_draws(seed, lines, V, S=8, W=2, K=4, d=12):
    """JAX ``infer_sentences``'s draws, per batch (test_torch_sent2vec)."""
    key = jax.random.key(seed ^ 0xD0C)
    out = []
    for start in range(0, len(lines), S):
        chunk = lines[start:start + S]
        L = 1 << (max(len(ln.split()) for ln in chunk) - 1).bit_length()
        key, sub = jax.random.split(key)
        k_init, k = jax.random.split(sub)
        sent0 = np.asarray((jax.random.uniform(k_init, (S, d)) - 0.5) / d)
        passes = []
        for _ in range(S2V_NITERS):
            k, kb, kn = jax.random.split(k, 3)
            k1, k2 = jax.random.split(kn)
            passes.append((
                np.asarray(jax.random.randint(kb, (S, L), 0, W)),
                np.asarray(jax.random.randint(k1, (S, L, K), 0, V)),
                np.asarray(jax.random.uniform(k2, (S, L, K)))))
        out.append((sent0, passes))
    return out


def test_sent2vec_over_a_snapshot_matches_jax_and_the_live_table(
        s2v_dump):
    """Inference over a published snapshot: within 1e-6 + 1e-4|b| of
    JAX's ``infer_sentences(snapshot=)`` over JAX's publish, and bit for
    bit the port's inference over the live table it copies; the table
    moving after the publish does not reach the snapshot's result."""
    path, lines = s2v_dump
    jm = jax_build(path, JaxConfig().update(S2V_CONF))
    jsnap = JaxPublisher().publish(jm.table, keys=jm.vocab.keys,
                                   slots=np.asarray(jm._slot_of_vocab))
    want = JaxSent2Vec(jm, seed=1).infer_sentences(
        lines, niters=S2V_NITERS, snapshot=jsnap)
    pm = build_word_model_from_dump(path, ConfigParser().update(S2V_CONF),
                                    device="cpu")
    psnap = SnapshotPublisher().publish(
        pm.table, keys=pm.vocab.keys, slots=pm._slot_of_vocab.numpy())
    draws = _s2v_jax_draws(1, lines, len(pm.vocab))
    live = Sent2Vec(pm, seed=1).infer_sentences(lines, niters=S2V_NITERS,
                                                draws=iter(draws))
    pm.table.state["h"].add_(1.0)          # training moves on
    got = Sent2Vec(pm, seed=1).infer_sentences(
        lines, niters=S2V_NITERS, snapshot=psnap, draws=iter(draws))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b), (_, c) in zip(got, want, live):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(a, c)


def test_sent2vec_publishes_sentence_vectors_as_jax(s2v_dump):
    """With ``serve_publisher`` set, the vectors go out as one
    ``{"sent": ...}`` snapshot keyed by sentence id, which the reader and
    the top-k path serve; the same keys, slots and meta as JAX's."""
    path, lines = s2v_dump
    jm = jax_build(path, JaxConfig().update(S2V_CONF))
    js = JaxSent2Vec(jm, seed=1)
    js.serve_publisher = JaxPublisher()
    js.infer_sentences(lines, niters=S2V_NITERS)
    pm = build_word_model_from_dump(path, ConfigParser().update(S2V_CONF),
                                    device="cpu")
    ps = Sent2Vec(pm, seed=1)
    ps.serve_publisher = SnapshotPublisher()
    out = ps.infer_sentences(lines, niters=S2V_NITERS, draws=iter(
        _s2v_jax_draws(1, lines, len(pm.vocab))))
    sp, sj = ps.serve_publisher.latest(), js.serve_publisher.latest()
    assert list(sp.state) == list(sj.state) == ["sent"]
    assert sp.meta == sj.meta == {"query_field": "sent"}
    np.testing.assert_array_equal(sp.keys, sj.keys)
    np.testing.assert_array_equal(sp.slots, sj.slots)
    np.testing.assert_allclose(sp.state["sent"], sj.state["sent"],
                               rtol=1e-4, atol=1e-6)
    ids = np.array([sid for sid, _ in out], np.uint64)
    np.testing.assert_array_equal(
        EmbeddingReader(ps.serve_publisher, field="sent").read(ids[:3]),
        np.stack([v for _, v in out[:3]]))
    nkeys, _ = EmbeddingReader(ps.serve_publisher, field="sent").topk(
        ids[:2], k=2)
    assert nkeys.shape == (2, 2) and set(nkeys.ravel()) <= set(ids)


def test_sent2vec_over_a_hybrid_snapshot_reads_tail_rows_as_jax(devices8):
    """The fault ROADMAP queue C records, fixed in the port: over a table
    with a hot head, JAX's sent2vec indexes the tail planes with unified
    slots, so a hot key reads a tail row.  The port reads ``concat(hot,
    tail)`` by unified slot, on the snapshot path and on the live path,
    and equals JAX's sent2vec over an ``xla`` table holding the same rows
    by key (a case JAX gets right); JAX's own hybrid result still differs
    from that by more than 1e-3, so the reference's fault stays on
    record."""
    corpus = jax_synthetic(30, vocab_size=50, length=12, seed=3)
    lines = [" ".join(map(str, s[:n])) for s, n in zip(corpus, LENGTHS)]
    conf = dict(S2V_CONF, cluster={"server_num": N, "transfer": "hybrid"})
    jm = JaxWord2Vec(config=JaxConfig().update(conf)).build(corpus)
    pm = Word2Vec(config=ConfigParser().update(conf), device="cpu")
    pm.build(corpus)
    assert pm.table.n_hot == jm.table.n_hot > 0
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    jsnap = JaxPublisher().publish(jm.table, keys=jm.vocab.keys,
                                   slots=np.asarray(jm._slot_of_vocab))
    psnap = SnapshotPublisher().publish(
        pm.table, keys=pm.vocab.keys, slots=pm._slot_of_vocab.numpy())
    draws = _s2v_jax_draws(1, lines, len(pm.vocab))
    # JAX over an xla table holding the hybrid table's rows by key
    xm = JaxWord2Vec(config=JaxConfig().update(S2V_CONF)).build(corpus)
    slots = pm._slot_of_vocab.long().numpy()
    xslots = np.asarray(xm._slot_of_vocab)
    xm.table.state = {
        f: jnp.asarray(np.asarray(a).copy()).at[xslots].set(
            pm.table.unified_rows_host(f)[slots])
        for f, a in xm.table.state.items()}
    xsnap = JaxPublisher().publish(xm.table, keys=xm.vocab.keys,
                                   slots=xslots)
    want = JaxSent2Vec(xm, seed=1).infer_sentences(
        lines, niters=S2V_NITERS, snapshot=xsnap)
    got = Sent2Vec(pm, seed=1).infer_sentences(
        lines, niters=S2V_NITERS, snapshot=psnap, draws=iter(draws))
    live = Sent2Vec(pm, seed=1).infer_sentences(
        lines, niters=S2V_NITERS, draws=iter(draws))
    assert [i for i, _ in got] == [i for i, _ in want] \
        == [i for i, _ in live]
    for (_, a), (_, b), (_, c) in zip(got, want, live):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(a, c)
    # the reference's fault: JAX's hybrid result is not the rows by key
    faulty = JaxSent2Vec(jm, seed=1).infer_sentences(
        lines, niters=S2V_NITERS, snapshot=jsnap)
    gap = max(float(np.abs(a - c).max())
              for (_, a), (_, c) in zip(faulty, want))
    assert gap > 1e-3
