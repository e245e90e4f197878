"""The port's sharded parameter server (``[cluster] transfer: tpu``,
``server_num: n``) against the JAX package's ``TpuTransfer`` path.

The same seeded numpy inputs go through the JAX package on the 8-device
CPU mesh (``devices8``) and through the port with 8 ranks on the CPU, at
the sizes of ``tests/test_ring_push.py::_setup``.  Shard ids, slots and
request buckets are identical and a pull moves bits, so those are held
exactly; pushes sum duplicates in another order on each side, so tables
are held at rtol 1e-6 / atol 1e-7; a whole ``Word2Vec`` step, with JAX's
draws replayed, inside the envelope ``|a - b| <= 1e-5 + 1e-3 * |b|`` with
``err_cnt`` exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.cluster.hashfrag import HashFrag as JaxHashFrag
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.parameter.key_index import CapacityError as JaxCapacityError
from swiftmpi_tpu.transfer.tpu import TpuTransfer
from swiftmpi_tpu.transfer.tpu import _bucketize as jax_bucketize
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu.utils.hashing import get_hash_code_np as jax_hash_np
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.cluster import Cluster, HashFrag, ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          load_corpus, synthetic_corpus,
                                          write_tokens_file)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, w2v_parser
from swiftmpi_tpu_torch.parameter import (CapacityError, KeyIndex,
                                          SparseTable, w2v_access)
from swiftmpi_tpu_torch.transfer import ShardedTransfer, get_transfer
from swiftmpi_tpu_torch.transfer.sharded import _bucketize
from swiftmpi_tpu_torch.utils import ConfigParser
from swiftmpi_tpu_torch.utils.hashing import get_hash_code_np

N, CAP, D, LR = 8, 32, 8, 0.3

CONF = {
    "cluster": {"server_num": N, "transfer": "tpu"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2,
                 "shared_pool": 64},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
B = 64


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def _setup(devices8):
    """test_ring_push.py::_setup on both sides: 8 shards of 32 rows of
    d = 8, 64 requests (every seventh padding), grads for both families.
    Returns the JAX mesh, access and table, the port's layout, access and
    state, and the numpy slots and grads."""
    mesh = jax_ps_mesh()
    jacc = jax_w2v_access(learning_rate=LR, len_vec=D)
    jki = JaxKeyIndex(num_shards=N, capacity_per_shard=CAP)
    jtable = JaxSparseTable(jacc, jki, mesh=mesh, axis=SHARD_AXIS)
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 10_000, size=64).astype(np.uint64)
    slots = jki.lookup(keys)
    np.testing.assert_array_equal(KeyIndex(N, CAP).lookup(keys), slots)
    slots[::7] = -1
    grads = {f: rng.normal(size=(64, D)).astype(np.float32)
             for f in jacc.grad_fields}
    layout = ps_mesh(N, ["cpu"])
    return mesh, jacc, jtable, layout, w2v_access(LR, D), slots, grads


def _port_state(jtable, layout):
    return state_from_jax({f: np.asarray(a)
                           for f, a in jtable.state.items()}, "cpu",
                          mesh=layout)


def _t(arrays):
    return {f: torch.from_numpy(a) for f, a in arrays.items()}


# -- routing: hash, hashfrag, key index ----------------------------------------

def test_hash_code_matches_jax():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(0, 2 ** 63, 200, dtype=np.uint64),
                           np.arange(50, dtype=np.uint64),
                           np.array([2 ** 64 - 1], np.uint64)])
    np.testing.assert_array_equal(get_hash_code_np(keys), jax_hash_np(keys))
    assert get_hash_code_np(keys).dtype == np.uint64


@pytest.mark.parametrize("shards,frags", [(8, None), (3, 64), (1, None),
                                          (7, 7)])
def test_hashfrag_matches_jax(shards, frags):
    rng = np.random.default_rng(shards)
    keys = rng.integers(0, 2 ** 63, 500, dtype=np.uint64)
    jh, ph = JaxHashFrag(shards, frags), HashFrag(shards, frags)
    np.testing.assert_array_equal(ph.to_shard_id(keys), jh.to_shard_id(keys))
    np.testing.assert_array_equal(ph.to_node_id(keys), jh.to_node_id(keys))
    np.testing.assert_array_equal(ph.map_table, jh.map_table)
    assert ph.num_frags == jh.num_frags
    assert ph == HashFrag(shards, frags) and ph != HashFrag(shards + 1)
    with pytest.raises(ValueError):
        HashFrag(0)
    with pytest.raises(ValueError):
        HashFrag(8, 4)


def test_sharded_key_index_assigns_jax_slots():
    """Same keys in the same lookup batches -> the same shard and the
    same slot = shard * cap + local, first touch within each shard."""
    rng = np.random.default_rng(0)
    jk, pk = JaxKeyIndex(N, 40), KeyIndex(N, 40)
    for _ in range(4):
        keys = rng.integers(0, 2 ** 63, 40, dtype=np.uint64)
        keys = np.concatenate([keys, keys[:7], rng.integers(1, 60, 30)
                               .astype(np.uint64)])
        got = pk.lookup(keys)
        np.testing.assert_array_equal(got, jk.lookup(keys))
        np.testing.assert_array_equal(pk.shard_of(keys), jk.shard_of(keys))
        np.testing.assert_array_equal(got // 40, pk.shard_of(keys))
    assert list(pk.items()) == list(jk.items())
    np.testing.assert_array_equal(pk.shard_fill(), jk.shard_fill())
    assert pk.capacity == jk.capacity == N * 40 and len(pk) == len(jk)
    miss = np.array([2 ** 62 + 5], np.uint64)
    assert pk.lookup(miss, create=False)[0] == -1
    with pytest.raises(ValueError, match="shard count mismatch"):
        KeyIndex(4, 8, hashfrag=HashFrag(8))


def test_capacity_error_names_the_full_shard():
    keys = np.arange(1, 200, dtype=np.uint64)
    jk, pk = JaxKeyIndex(N, 8), KeyIndex(N, 8)
    with pytest.raises(JaxCapacityError) as je:
        jk.lookup(keys)
    with pytest.raises(CapacityError) as pe:
        pk.lookup(keys)
    assert str(pe.value) == str(je.value)
    assert len(pk) == 0          # nothing was assigned by the failed call


# -- layout, cluster, table ------------------------------------------------------

def test_ps_mesh_deals_ranks_over_devices():
    a, b = torch.device("cpu"), torch.device("meta")
    layout = ps_mesh(5, [a, b])
    assert layout.n == 5
    assert layout.devices == (a, b, a, b, a)
    assert layout.distinct_devices == (a, b)
    assert ps_mesh(devices=[a]).n == 1
    with pytest.raises(ValueError):
        ps_mesh(0, [a])


def test_cluster_brings_up_the_sharded_transfer(tmp_path):
    conf = ConfigParser().update({"cluster": {"transfer": "tpu",
                                              "server_num": N},
                                  "server": {"frag_num": 64}})
    cluster = Cluster(conf, devices=["cpu"])
    with pytest.raises(RuntimeError, match="initialize"):
        cluster.create_table("t", w2v_access(LR, D), CAP)
    cluster.initialize()
    assert cluster.transfer.name == "tpu" and cluster.n_servers == N
    assert cluster.mesh.n == N and cluster.hashfrag == HashFrag(N, 64)
    table = cluster.create_table("t", w2v_access(LR, D), CAP)
    assert table.key_index.hashfrag is cluster.hashfrag
    assert all(len(v) == N and v[0].shape == (CAP, D)
               for v in table.state.values())
    table.key_index.lookup(np.arange(20, dtype=np.uint64))

    def fmt(row):
        return " ".join(repr(float(x)) for x in row["v"])

    path = str(tmp_path / "dump.txt")
    cluster.finalize(path, formatter=fmt)
    lines = open(path).read().splitlines()
    assert len(lines) == 20 and not cluster.tables
    rows = table.to_numpy()
    for line in lines:
        key, _, rest = line.partition("\t")
        np.testing.assert_array_equal(
            np.array(rest.split(), np.float32),
            rows["v"][table.key_index.slot(int(key))])


def test_cluster_defaults_and_refusals(monkeypatch):
    # server_num absent: one shard per visible device
    c = Cluster(ConfigParser().update({"cluster": {"transfer": "tpu"}}),
                devices=["cpu"]).initialize()
    assert c.n_servers == 1 and c.transfer.name == "tpu"
    assert Cluster(ConfigParser(), devices=["cpu"]).initialize() \
        .transfer.name == "xla"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster(ConfigParser()).initialize()
    # hybrid builds the tpu rank layout for its tail
    h = Cluster(ConfigParser().update({"cluster": {
        "transfer": "hybrid", "server_num": 4}}), devices=["cpu"]).initialize()
    assert h.transfer.name == "hybrid" and h.mesh.n == 4
    # xla with server_num 2 (refused until ROADMAP A11a was ported): the
    # model-axis shards as one tensor on the one device
    x = Cluster(ConfigParser().update({"cluster": {
        "transfer": "xla", "server_num": 2}}), devices=["cpu"]).initialize()
    assert x.transfer.name == "xla" and x.mesh is None and x.n_servers == 2
    t = x.create_table("w", w2v_access(LR, D), CAP)
    assert t.key_index.num_shards == 2
    assert t.state["h"].shape == (2 * CAP, D)
    # data_plane: xla (refused until ROADMAP A16b was ported) builds the
    # sharded transfer on the library exchange
    lib = Cluster(ConfigParser().update({"cluster": {
        "transfer": "tpu", "server_num": 2, "data_plane": "xla"}}),
        devices=["cpu"]).initialize()
    assert lib.transfer.exchange_route == "library"
    for conf, err, match in [
            ({"transfer": "bogus"}, ValueError, "bogus"),
            ({"transfer": "tpu", "data_plane": "bogus"}, ValueError,
             "data_plane")]:
        with pytest.raises(err, match=match):
            Cluster(ConfigParser().update({"cluster": conf}),
                    devices=["cpu"]).initialize()
    with pytest.raises(NotImplementedError, match="A11"):
        Cluster(ConfigParser().update({"cluster": {
            "transfer": "tpu", "server_num": 2}}),
            devices=["cpu", "meta"]).initialize()


def test_sharded_table_is_the_jax_global_array(devices8):
    """Shards concatenated in shard order are the global array; the
    round trip through ``state_from_jax`` / ``state_to_numpy`` is exact;
    the initial rows do not depend on the layout."""
    _, _, jtable, layout, pacc, _, _ = _setup(devices8)
    want = {f: np.asarray(a) for f, a in jtable.state.items()}
    st = _port_state(jtable, layout)
    for f, shards in st.items():
        assert len(shards) == N
        for s, t in enumerate(shards):
            assert t.is_contiguous() and t.shape == (CAP, D)
            np.testing.assert_array_equal(t.numpy(),
                                          want[f][s * CAP:(s + 1) * CAP])
    got = state_to_numpy(st)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
    sharded = SparseTable(pacc, KeyIndex(N, CAP), "cpu", mesh=layout)
    fused = SparseTable(pacc, KeyIndex(1, N * CAP), "cpu")
    for f, a in fused.to_numpy().items():
        np.testing.assert_array_equal(sharded.to_numpy()[f], a)
    # no layout: the xla model-axis table (refused until ROADMAP A11a was
    # ported), the same global array as one tensor
    model_axis = SparseTable(pacc, KeyIndex(N, CAP), "cpu")
    for f, a in model_axis.to_numpy().items():
        assert model_axis.state[f].shape == (N * CAP, D)
        np.testing.assert_array_equal(sharded.to_numpy()[f], a)
    with pytest.raises(ValueError, match="ranks"):
        SparseTable(pacc, KeyIndex(4, CAP), "cpu", mesh=layout)


# -- the transfer ------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 2, 1])
def test_bucketize_matches_jax(C):
    rng = np.random.default_rng(C)
    for _ in range(3):
        slots = rng.integers(0, N * CAP, 16).astype(np.int32)
        slots[rng.random(16) < 0.2] = -1
        slots[:5] = 3 * CAP + np.arange(5)       # one crowded owner
        want = jax_bucketize(jnp.asarray(slots), N, CAP, C)
        got = _bucketize(torch.from_numpy(slots), N, CAP, C)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].dtype == torch.int32 and got[0].is_contiguous()


def test_pull_is_bit_equal(devices8):
    mesh, jacc, jtable, layout, pacc, slots, _ = _setup(devices8)
    want = TpuTransfer(mesh).pull(jtable.state, slots, jacc)
    got = ShardedTransfer(layout).pull(_port_state(jtable, layout),
                                       torch.from_numpy(slots), pacc)
    assert set(got) == set(want) == {"h", "v"}
    for f in want:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
        assert not got[f].numpy()[slots < 0].any()
    one = ShardedTransfer(layout).pull(_port_state(jtable, layout),
                                       torch.from_numpy(slots), pacc,
                                       fields=("v",))
    assert set(one) == {"v"}


@pytest.mark.parametrize("mean", [False, True])
def test_push_matches_tpu_transfer(devices8, mean):
    """Duplicates and -1 padding included; both families in one push."""
    mesh, jacc, jtable, layout, pacc, slots, grads = _setup(devices8)
    before = {f: np.asarray(a).copy() for f, a in jtable.state.items()}
    st = _port_state(jtable, layout)
    want = TpuTransfer(mesh).push(jtable.state, slots, grads, jacc,
                                  mean=mean)
    t = ShardedTransfer(layout)
    out = t.push(st, torch.from_numpy(slots), _t(grads), pacc, mean=mean)
    assert out is st                              # updated in place
    got = state_to_numpy(st)
    for f in jacc.fields:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
        assert not np.array_equal(got[f], before[f])
    assert dict(t.push_paths) == {"h,v:routed": 1}
    assert t.overflow_count() == 0


def test_push_span_matches_tpu_transfer(devices8):
    mesh, jacc, jtable, layout, pacc, slots, grads = _setup(devices8)
    counts = np.random.default_rng(2).integers(0, 4, size=64).astype(
        np.float32)
    st = _port_state(jtable, layout)
    want = TpuTransfer(mesh).push_span(jtable.state, slots, grads, counts,
                                       jacc, mean=True)
    t = ShardedTransfer(layout)
    t.push_span(st, torch.from_numpy(slots), _t(grads),
                torch.from_numpy(counts), pacc, mean=True)
    got = state_to_numpy(st)
    for f in jacc.fields:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    assert dict(t.push_paths) == {"h,v:routed_span": 1}


def test_ranks_dealt_over_two_devices_route_alike(devices8):
    """A layout over two devices (here two names of the CPU) routes each
    device's ranks in its own batched pass: the same pull, bit for bit,
    and the same push as the one-device layout."""
    _, _, jtable, layout, pacc, slots, grads = _setup(devices8)
    two = ps_mesh(N, ["cpu", torch.device("cpu", 0)])
    assert len(two.distinct_devices) == 2
    t1, t2 = ShardedTransfer(layout), ShardedTransfer(two)
    assert [r for _, r in t2._groups] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    s1, s2 = _port_state(jtable, layout), _port_state(jtable, two)
    ts = torch.from_numpy(slots)
    for f, rows in t1.pull(s1, ts, pacc).items():
        np.testing.assert_array_equal(t2.pull(s2, ts, pacc)[f].numpy(),
                                      rows.numpy())
    t1.push(s1, ts, _t(grads), pacc, mean=True)
    t2.push(s2, ts, _t(grads), pacc, mean=True)
    got, want = state_to_numpy(s2), state_to_numpy(s1)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("mean", [False, True])
def test_push_scatters_once_per_device_group_and_family(devices8,
                                                        monkeypatch, mean):
    """The owners of one device sum each pushed family in one scatter-add
    call over all their ranks' ``(R, n * C)`` received rows, and a mean
    push takes its counts from the first family's call: one call per
    device group and family, none for counts alone.  On one device every
    exchange is one call of the stacked ring form."""
    from swiftmpi_tpu_torch.transfer import sharded
    _, _, jtable, layout, pacc, slots, grads = _setup(devices8)
    calls, exchanges = [], []
    scatter_add, stacked = sharded.masked_scatter_add, \
        sharded.ring_exchange_stacked

    def counting_scatter(*args, **kw):
        calls.append((tuple(args[0].shape), kw.get("counts", False)))
        return scatter_add(*args, **kw)

    def counting_exchange(x):
        exchanges.append(tuple(x.shape))
        return stacked(x)

    monkeypatch.setattr(sharded, "masked_scatter_add", counting_scatter)
    monkeypatch.setattr(sharded, "ring_exchange_stacked", counting_exchange)
    two = ps_mesh(N, ["cpu", torch.device("cpu", 0)])
    C = slots.shape[0] // N
    for lay, n_groups in ((layout, 1), (two, 2)):
        calls.clear()
        ShardedTransfer(lay).push(_port_state(jtable, lay),
                                  torch.from_numpy(slots), _t(grads), pacc,
                                  mean=mean)
        assert len(calls) == n_groups * len(grads)
        assert {shape for shape, _ in calls} == {(N // n_groups, N * C)}
        assert sum(c for _, c in calls) == (n_groups if mean else 0)
    # the one-device push: the requests, then one exchange per family
    assert exchanges == [(N, N, C)] + [(N, N, C, D)] * len(grads)


@pytest.mark.parametrize("devices,groups", [
    (["cpu"], [[0, 1, 2, 3, 4, 5, 6, 7]]),
    (["cpu", torch.device("cpu", 0)], [[0, 2, 4, 6], [1, 3, 5, 7]])])
def test_shards_of_a_group_are_one_block(devices8, devices, groups):
    """The shards of the ranks that share a device are the rank slices of
    one ``(R, cap, d)`` block in the group's rank order, each contiguous;
    ``shard_block`` returns that block as a view (writes through it land
    in the shards) and refuses shard lists that are not."""
    from swiftmpi_tpu_torch.parameter.sparse_table import shard_block
    _, _, jtable, _, _, _, _ = _setup(devices8)
    lay = ps_mesh(N, devices)
    assert [list(r) for _, r in lay.device_groups] == groups
    st = _port_state(jtable, lay)
    want = {f: np.asarray(a) for f, a in jtable.state.items()}
    for f, shards in st.items():
        for ranks in groups:
            block = shard_block([shards[r] for r in ranks])
            assert block.shape == (len(ranks), CAP, D)
            assert block.data_ptr() == shards[ranks[0]].data_ptr()
            for i, r in enumerate(ranks):
                assert shards[r].is_contiguous()
                np.testing.assert_array_equal(
                    block[i].numpy(), want[f][r * CAP:(r + 1) * CAP])
            block[-1, 0, 0] = 123.0                  # a view, not a copy
            assert shards[ranks[-1]][0, 0] == 123.0
    one = st["h"][0]
    assert shard_block([one]).data_ptr() == one.data_ptr()
    blk = torch.zeros(4, CAP, D)
    for bad in ([blk[0], blk[1], blk[3]],                 # uneven stride
                [blk[1], blk[0]],                         # wrong order
                [blk[0], blk[0]],                         # one shard twice
                [torch.zeros(CAP, D), torch.zeros(CAP, D)],   # apart
                [blk[0], blk[1, :CAP - 1]]):              # other shape
        with pytest.raises(ValueError, match="shard_block"):
            shard_block(bad)
    with pytest.raises(ValueError, match="contiguous"):
        shard_block([t.t() for t in torch.zeros(2, D, CAP).unbind(0)])
    # one stride that is not cap * d is still one block
    assert shard_block([blk[0], blk[2]]).stride(0) == 2 * CAP * D


@pytest.mark.parametrize("mean", [False, True])
def test_gather_and_apply_once_per_device_group(devices8, monkeypatch,
                                                mean):
    """A pull gathers each field in one call per device group over the
    group's ``(R, cap, d)`` block; a push applies each family in one
    ``apply_push`` per device group over the group's blocks, with the
    mean's reciprocal as ``mul``; the results equal the one-device
    layout's, bit for bit."""
    from swiftmpi_tpu_torch.transfer import sharded
    _, _, jtable, layout, pacc, slots, grads = _setup(devices8)
    gathers, applies = [], []
    masked_gather = sharded.masked_gather
    apply_push = type(pacc).apply_push

    def counting_gather(table, s, v, out=None):
        gathers.append((tuple(table.shape), tuple(s.shape)))
        return masked_gather(table, s, v, out=out)

    def counting_apply(self, params, grads, mul=None, div=None):
        applies.append(({f: tuple(t.shape) for f, t in params.items()},
                        sorted(grads), None if mul is None
                        else tuple(mul.shape), div))
        return apply_push(self, params, grads, mul=mul, div=div)

    monkeypatch.setattr(sharded, "masked_gather", counting_gather)
    monkeypatch.setattr(type(pacc), "apply_push", counting_apply)
    two = ps_mesh(N, ["cpu", torch.device("cpu", 0)])
    C = slots.shape[0] // N
    ts = torch.from_numpy(slots)
    results = []
    for lay, R in ((layout, N), (two, N // 2)):
        gathers.clear()
        applies.clear()
        t = ShardedTransfer(lay)
        st = _port_state(jtable, lay)
        pulled = t.pull(st, ts, pacc)
        assert gathers == [((R, CAP, D), (R, N * C))] * (N // R) * 2
        t.push(st, ts, _t(grads), pacc, mean=mean)
        assert len(applies) == N // R
        for params, fams, mul, div in applies:
            assert fams == sorted(grads) and div is None
            assert params == {f: (R, CAP, D) for f in _pushed_fields(pacc)}
            assert mul == ((R, CAP) if mean else None)
        results.append((pulled, state_to_numpy(st)))
    (p1, s1), (p2, s2) = results
    for f in p1:
        np.testing.assert_array_equal(p1[f].numpy(), p2[f].numpy())
    for f in s1:
        np.testing.assert_array_equal(s1[f], s2[f])


def _pushed_fields(access):
    """The fields a push of every family touches."""
    return set(access.touched_fields(access.grad_fields))


def test_bucket_capacity_drops_the_same_rows(devices8):
    """``bucket_capacity=2``: the same overflow count and, since both
    sides keep the first two requests of a bucket in request order, the
    same dropped rows in the pull and the same table after the push."""
    mesh, jacc, jtable, layout, pacc, slots, grads = _setup(devices8)
    slots = slots.copy()
    slots[8:16] = slots[9]                        # crowd one bucket
    jt = TpuTransfer(mesh, bucket_capacity=2)
    pt = ShardedTransfer(layout, bucket_capacity=2)
    st = _port_state(jtable, layout)
    want = jt.pull(jtable.state, slots, jacc)
    got = pt.pull(st, torch.from_numpy(slots), pacc)
    for f in want:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    dropped = (~got["h"].numpy().any(axis=1)) & (slots >= 0)
    assert dropped.sum() == jt.overflow_count() == pt.overflow_count() > 0
    out = jt.push(jtable.state, slots, grads, jacc, mean=True)
    pt.push(st, torch.from_numpy(slots), _t(grads), pacc, mean=True)
    assert jt.overflow_count() == pt.overflow_count() == 2 * dropped.sum()
    final = state_to_numpy(st)
    for f in jacc.fields:
        np.testing.assert_allclose(final[f], np.asarray(out[f]), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    loud = ShardedTransfer(layout, bucket_capacity=2, debug_overflow=True)
    with pytest.raises(RuntimeError, match="overflowed"):
        loud.pull(st, torch.from_numpy(slots), pacc)


def test_sharded_transfer_refusals(devices8):
    _, _, jtable, layout, pacc, slots, grads = _setup(devices8)
    t = get_transfer("tpu", mesh=layout)
    assert isinstance(t, ShardedTransfer) and t.n == N
    st = _port_state(jtable, layout)
    with pytest.raises(ValueError, match="equal rank slices"):
        t.pull(st, torch.from_numpy(slots[:60]), pacc)
    with pytest.raises(ValueError, match="equal rank slices"):
        t.push(st, torch.from_numpy(slots[:60]),
               _t({f: g[:60] for f, g in grads.items()}), pacc)
    # data_plane: xla (refused until ROADMAP A16b was ported): the library
    # exchange pulls the kernel route's rows
    lib = ShardedTransfer(layout, data_plane="xla")
    assert (lib.exchange_route, t.exchange_route) == ("library", "kernel")
    for f, rows in lib.pull(st, torch.from_numpy(slots), pacc).items():
        assert torch.equal(rows, t.pull(st, torch.from_numpy(slots),
                                        pacc)[f])
    with pytest.raises(ValueError, match="data_plane"):
        ShardedTransfer(layout, data_plane="bogus")
    # a quantized window runs (tests/test_torch_wire.py holds it against
    # JAX): without @ef planes it ships the quantized sums
    t.wire_quant = "int8"
    before = st["h"][0].clone()
    t.push_window(st, torch.from_numpy(slots).view(2, 32),
                  _t({f: g.reshape(2, 32, D) for f, g in grads.items()}),
                  pacc, mean=True)
    assert not torch.equal(before, st["h"][0])
    t.wire_quant = "off"
    # the ledger is ported now (held against TpuTransfer in
    # test_torch_traffic.py): off by default, every count 0
    assert t.traffic()["routed_rows"] == 0 and t.traffic()["dispatches"] == 0


# -- the model -------------------------------------------------------------------------

def corpus(n_sent=60, vocab=300, length=16, seed=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _models(sents, cap=80, **w2v):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for k, v in w2v.items():
        jc.set("word2vec", k, v)
        pc.set("word2vec", k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    assert jm.cluster.n_servers == pm.cluster.n_servers == N
    assert jm.transfer.name == pm.transfer.name == "tpu"
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    return jm, pm


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def test_model_shards_like_jax(devices8):
    """Default capacity max(64, int(V * 1.3 / n) + 1) per shard, and the
    same slot for every vocab word."""
    sents = corpus(vocab=1500, n_sent=200, seed=5)
    jm = JaxWord2Vec(config=JaxConfig().update(CONF)).build(sents)
    pm = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    pm.build(sents)
    V = len(pm.vocab)
    assert int(V * 1.3 / N) + 1 > 64
    assert pm.table.capacity == jm.table.capacity \
        == N * (int(V * 1.3 / N) + 1)
    np.testing.assert_array_equal(pm._slot_of_vocab.numpy(),
                                  np.asarray(jm._slot_of_vocab))
    assert len(pm.table.state["h"]) == N


@pytest.mark.parametrize("rendering", ["gather", "shared"])
def test_one_step_matches_jax_step(devices8, rendering):
    sents = corpus()
    jm, pm = _models(sents, shared_negatives=int(rendering == "shared"))
    assert pm.resolved_rendering == rendering
    batch = next(iter(CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                  seed=13).epoch(B)))
    key = jax.random.key(7)
    state0 = {f: np.array(a) for f, a in jm.table.state.items()}
    out, es, ec = jm._build_step()(
        jm.table.state, jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
        jnp.asarray(batch.centers), jnp.asarray(batch.contexts),
        jnp.asarray(batch.ctx_mask), key)
    shape = (pm.shared_pool,) if pm.shared_negatives else (B, pm.negative)
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), shape))
    if pm.shared_negatives:
        assert got_ec == pytest.approx(float(ec), rel=1e-6)
    else:
        assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, float(es), rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in state0:
        _envelope(got[f], np.asarray(out[f]))
        assert not np.array_equal(got[f], state0[f])        # the step moved
    want_paths = {"h:routed": 2, "v:routed": 1} if pm.shared_negatives \
        else {"h:routed": 1, "v:routed": 1}
    assert dict(pm.transfer.push_paths) == want_paths


def test_three_step_train_tracks_jax(devices8):
    """``train`` with per-step replayed draws: one batch per epoch, three
    epochs, so the per-iteration losses are the per-step losses."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents)
    want = jm.train(sents, niters=3, batch_size=B)
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), (B, pm.negative)))
    got = pm.train(sents, niters=3, batch_size=B, draws=iter(draws))
    assert pm.train_metrics["steps"] == 3
    assert pm.train_metrics["shards"] == N
    assert pm.train_metrics["push_paths"] == {"h:routed": 3, "v:routed": 3}
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))
    assert pm.transfer.overflow_count() == 0


def test_stencil_with_tpu_transfer_raises():
    """The JAX package refuses stencil + tpu too (the span family pushes
    through push_span of the xla or hybrid transfer)."""
    c = ConfigParser().update(CONF)
    c.set("word2vec", "stencil", 1)
    with pytest.raises(ValueError, match="push_span"):
        Word2Vec(config=c, device="cpu")


def test_step_refuses_a_batch_that_does_not_split():
    sents = corpus(n_sent=10)
    pm = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    pm.build(sents)
    batch = next(iter(CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                  seed=1).epoch(B + 1)))
    with pytest.raises(ValueError, match="equal rank slices"):
        pm.step_batch(batch)
    # train()'s default batch is rounded up to whole centers per rank:
    # minibatch 1300 gives 325 centers, which 8 ranks cannot split
    c = ConfigParser().update(CONF)
    c.set("worker", "minibatch", 1300)
    pm = Word2Vec(config=c, device="cpu")
    seen = []
    orig = pm._step_fields
    pm._step_fields = lambda f, d=None, s=None: (seen.append(len(f[0])),
                                                 orig(f, d, s))[1]
    pm.train(sents, niters=1)
    assert seen and set(seen) == {328}


@pytest.mark.parametrize("how", ["conf", "flag"])
def test_cli_trains_and_dumps_sharded(tmp_path, how):
    """``w2v_main`` with ``transfer: tpu`` and 8 shards, from the conf's
    ``server_num`` or from ``-shards``: one dump line per vocab word, each
    the word's row of its shard."""
    from swiftmpi_tpu_torch.utils import reset_global_config
    reset_global_config()
    data, conf, out = (str(tmp_path / n) for n in
                       ("corpus.txt", "w2v.conf", "vec.txt"))
    write_tokens_file(synthetic_corpus(60, 200, 12, seed=1), data)
    with open(conf, "w") as f:
        f.write("[cluster]\ntransfer: tpu\n"
                + ("server_num: 8\n" if how == "conf" else "")
                + "[worker]\nminibatch: 256\n[word2vec]\nlen_vec: 8\n"
                "window: 2\nnegative: 3\nsample: -1\n")
    argv = ["w2v", "-config", conf, "-data", data, "-niters", "1",
            "-output", out, "-device", "cpu"]
    seen = []
    orig = Word2Vec.train

    def spy(self, *a, **k):
        res = orig(self, *a, **k)
        seen.append(self)
        return res

    Word2Vec.train = spy
    try:
        assert w2v_main.main(argv + (["-shards", "8"] if how == "flag"
                                     else [])) == 0
    finally:
        Word2Vec.train = orig
        reset_global_config()
    model = seen[0]
    assert model.cluster.n_servers == N and model.transfer.name == "tpu"
    assert set(model.train_metrics["push_paths"]) == {"h:routed",
                                                      "v:routed"}
    vocab = build_vocab(load_corpus(data))
    lines = open(out).read().splitlines()
    assert len(lines) == len(vocab)
    rows = model.table.to_numpy()
    for line in lines:
        key, _, rest = line.partition("\t")
        slot = model.table.key_index.slot(int(key))
        np.testing.assert_array_equal(w2v_parser(rest)["v"],
                                      rows["v"][slot])
    assert {int(line.partition("\t")[0]) for line in lines} \
        == set(vocab.keys.tolist())
