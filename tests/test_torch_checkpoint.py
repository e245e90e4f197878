"""The port's table I/O (``swiftmpi_tpu_torch/io/checkpoint.py``), the
key index's ``grow``/``restore`` and ``SparseTable.grow`` against the JAX
package's, on the CPU.

npz checkpoints cross between the packages in both directions and load
bit for bit (float32, bfloat16 tables and 8 shards: JAX on the
``devices8`` mesh, the port with 8 ranks on the CPU); ``Word2Vec.save``
writes the JAX package's dump byte for byte; CRCs, files written before
the CRCs, the generation window, the stale-tmp sweep, and growth on text
and npz load as the JAX package does them (its new rows' draws aside:
``jax.random`` cannot be replayed, so a growth is held on the key -> slot
map and the occupied rows only).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from swiftmpi_tpu.io import checkpoint as jck
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.io import checkpoint as pck
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, w2v_formatter
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.parameter.sparse_table import shard_block
from swiftmpi_tpu_torch.testing.faults import corrupt_file_bytes
from swiftmpi_tpu_torch.utils import ConfigParser

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 8, "window": 2, "negative": 3, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
#: table kind -> extra conf: float32, bfloat16 h and v, 8 shards
KINDS = {"f32": {}, "bf16": {"server": {"dtype": "bfloat16"}},
         "shards8": {"cluster": {"server_num": 8, "transfer": "tpu"}}}


def corpus(n_sent=30, vocab=60, length=10, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _confs(kind):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for sec, kv in KINDS[kind].items():
        for k, v in kv.items():
            jc.set(sec, k, v)
            pc.set(sec, k, v)
    return jc, pc


def _bits(a: np.ndarray) -> np.ndarray:
    """The array's bits, for a bit-for-bit comparison of any dtype."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _same_state(port_state, jax_state):
    got = state_to_numpy(port_state)
    assert set(got) == set(jax_state)
    for f, a in jax_state.items():
        a = np.asarray(a)
        assert got[f].dtype == a.dtype, f
        np.testing.assert_array_equal(_bits(got[f]), _bits(a), err_msg=f)


def _trained_pair(kind, request):
    """A JAX model trained one iteration, and a port model built from the
    same corpus (the same key -> slot map) with its own initial table."""
    if kind == "shards8":
        request.getfixturevalue("devices8")
    sents = corpus()
    jc, pc = _confs(kind)
    jm = JaxWord2Vec(config=jc)
    jm.train(sents, niters=1, batch_size=64)
    pm = Word2Vec(config=pc, device="cpu").build(sents)
    return jm, pm, sents


@pytest.mark.parametrize("kind", list(KINDS))
def test_npz_crosses_both_ways_bit_for_bit(tmp_path, request, kind):
    """JAX ``save_checkpoint`` -> port ``load_checkpoint`` and the port's
    ``save_checkpoint`` -> JAX ``load_checkpoint``: every field (AdaGrad
    sums included), the key index and ``extra`` equal, bit for bit; the
    port's load copies into its tensors (addresses kept, a sharded
    table's shards still one block)."""
    jm, pm, sents = _trained_pair(kind, request)
    ck = str(tmp_path / "jax")
    jck.save_checkpoint(jm.table, ck, extra={"iter": np.int64(1)})
    before = {f: [t.data_ptr() for t in (v if isinstance(v, list) else [v])]
              for f, v in pm.table.state.items()}
    assert pm.resume(ck) == 1
    _same_state(pm.table.state, jm.table.state)
    assert list(pm.table.key_index.items()) == \
        list(jm.table.key_index.items())
    for f, v in pm.table.state.items():
        assert [t.data_ptr() for t in (v if isinstance(v, list)
                                       else [v])] == before[f]
        if isinstance(v, list):
            shard_block(v)
    # the port trains on and saves; a fresh JAX model restores it
    pm.train(sents, niters=1, batch_size=64)
    ck2 = str(tmp_path / "port")
    pck.save_checkpoint(pm.table, ck2, extra={"iter": np.int64(2)})
    jc, _ = _confs(kind)
    jm2 = JaxWord2Vec(config=jc, seed=9).build(sents)
    assert jm2.resume(ck2 + ".npz") == 2
    _same_state(pm.table.state, jm2.table.state)
    assert list(jm2.table.key_index.items()) == \
        list(pm.table.key_index.items())
    if kind == "bf16":
        assert pm.table.state["h"].dtype == torch.bfloat16
        with np.load(ck2 + ".npz") as z:           # saved upcast, exactly
            assert z["field__h"].dtype == np.float32
            assert set(z.files) >= {"keys", "slots", "num_shards",
                                    "capacity_per_shard", "n_hot",
                                    "extra__iter", "__crc__field__h"}


@pytest.mark.parametrize("writer", ["native", "python"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_save_is_the_jax_dump_byte_for_byte(tmp_path, request, monkeypatch,
                                            kind, writer):
    """For the same state the port's ``Word2Vec.save`` writes the JAX
    package's file byte for byte: through the native C++ writer when it
    builds (``%.9g``), and through the Python formatter (``repr``) when
    neither package has it; so does ``dump_table_text`` with
    ``w2v_formatter`` against the JAX call with its own."""
    from swiftmpi_tpu.data import native as jax_native
    from swiftmpi_tpu.models.word2vec import w2v_formatter as jax_fmt
    if writer == "native" and not native.available():
        pytest.skip("the native library does not build here")
    if writer == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    jm, pm, _ = _trained_pair(kind, request)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    assert jm.save(a) == pm.save(b) == len(pm.vocab)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert jck.dump_table_text(jm.table, a, jax_fmt) == \
        pck.dump_table_text(pm.table, b, w2v_formatter)
    assert open(a, "rb").read() == open(b, "rb").read()


def _table(num_shards=1, cap=16, d=4, seed=0):
    mesh = ps_mesh(num_shards, ["cpu"]) if num_shards > 1 else None
    return SparseTable(w2v_access(0.1, d), KeyIndex(num_shards, cap), "cpu",
                       seed=seed, mesh=mesh)


def _jax_table(num_shards=1, cap=16, d=4, seed=0):
    return JaxSparseTable(jax_w2v_access(0.1, d),
                          JaxKeyIndex(num_shards, cap), seed=seed)


def _occupied_equal(pt, jt):
    """The key -> slot maps are equal, in order, and so are the occupied
    rows of every field."""
    assert list(pt.key_index.items()) == list(jt.key_index.items())
    occ = np.array([s for _, s in pt.key_index.items()], np.int64)
    got = pt.to_numpy()
    for f, a in jt.state.items():
        np.testing.assert_array_equal(got[f][occ], np.asarray(a)[occ],
                                      err_msg=f)


@pytest.mark.parametrize("shards", [1, 2])
def test_text_dump_load_and_growth_match_jax(tmp_path, shards):
    """A dump of 40 keys loads into a table of 2 rows a shard: both
    packages double the capacity until the keys fit (2 -> 32 a shard for
    two shards, 64 for one), with the same key -> slot map and the same
    rows; a grown sharded table is still one block."""
    big = _jax_table(shards, 64)
    big.key_index.lookup(np.arange(40, dtype=np.uint64))
    path = str(tmp_path / "dump.txt")
    jck.dump_table_text(big, path)
    small, jsmall = _table(shards, 2), _jax_table(shards, 2)
    assert pck.load_table_text(small, path) == \
        jck.load_table_text(jsmall, path) == 40
    assert small.key_index.capacity_per_shard == \
        jsmall.key_index.capacity_per_shard == 64 // shards
    _occupied_equal(small, jsmall)
    if shards > 1:
        shard_block(small.state["h"])


def test_text_load_shard_filter_matches_jax(tmp_path):
    src = _jax_table(2, 32)
    keys = np.arange(1, 40, dtype=np.uint64)
    src.key_index.lookup(keys)
    path = str(tmp_path / "dump.txt")
    jck.dump_table_text(src, path)
    pt, jt = _table(2, 32), _jax_table(2, 32)
    n = pck.load_table_text(pt, path, shard_filter=0)
    assert n == jck.load_table_text(jt, path, shard_filter=0) \
        == int((src.key_index.shard_of(keys) == 0).sum()) > 0
    _occupied_equal(pt, jt)


def test_grow_matches_jax_on_occupied_rows():
    """``SparseTable.grow`` against the JAX package's from the same state:
    the same re-strided key -> slot map, every occupied row (parameters
    and AdaGrad sums) moved unchanged; new rows are fresh draws of each
    field's init (zeros for the sums)."""
    jt, pt = _jax_table(2, 12, seed=3), _table(2, 12, seed=3)
    keys = np.arange(100, 113, dtype=np.uint64)
    jt.key_index.lookup(keys)
    pt.key_index.lookup(keys)
    rng = np.random.default_rng(0)
    state = {f: rng.normal(size=np.asarray(a).shape).astype(np.float32)
             for f, a in jt.state.items()}
    import jax.numpy as jnp
    jt.state = {f: jnp.asarray(a) for f, a in state.items()}
    pt.state = state_from_jax(state, "cpu", mesh=pt.mesh)
    jt.grow()
    pt.grow()
    assert pt.key_index.capacity_per_shard == 24 and pt.seed == 4
    _occupied_equal(pt, jt)
    new = pt.to_numpy()
    occ = np.zeros(48, bool)
    occ[[s for _, s in pt.key_index.items()]] = True
    assert (new["h2sum"][~occ] == 0).all()
    assert (np.abs(new["h"][~occ]) <= 0.5 / 4).all()
    # new slots continue each shard's local numbering
    more = np.arange(200, 205, dtype=np.uint64)
    np.testing.assert_array_equal(pt.key_index.lookup(more),
                                  jt.key_index.lookup(more))


def test_npz_load_grows_refuses_shrink_and_other_shard_counts(tmp_path):
    """An npz written after a growth loads into a table of the original
    capacity (which grows), as in the JAX package; a smaller saved
    capacity and another shard count raise."""
    jt = _jax_table(2, 4)
    jt.key_index.lookup(np.arange(6, dtype=np.uint64))
    jt.grow(16)
    jt.key_index.lookup(np.arange(6, 20, dtype=np.uint64))
    path = str(tmp_path / "ck")
    jck.save_checkpoint(jt, path)
    small = _table(2, 4)
    pck.load_checkpoint(small, path)
    assert small.key_index.capacity_per_shard == 16
    _same_state(small.state, jt.state)
    assert list(small.key_index.items()) == list(jt.key_index.items())
    more = np.arange(50, 60, dtype=np.uint64)
    np.testing.assert_array_equal(small.key_index.lookup(more),
                                  jt.key_index.lookup(more))
    with pytest.raises(ValueError, match="shrink"):
        pck.load_checkpoint(_table(2, 64), path)
    with pytest.raises(ValueError, match="shards"):
        pck.load_checkpoint(_table(4, 16), path)


@pytest.mark.parametrize("plane", ["n_hot", "field__h@hot", "field__h@ef",
                                   "field__@rowver"])
def test_unported_planes_raise(tmp_path, plane):
    """Planes of a checkpoint the table was not built for: an ``n_hot`` or
    an ``@hot`` plane is refused as the JAX package refuses it, with a
    ``ValueError`` naming ``n_hot`` or the fields; an ``@ef`` plane the
    table does not arm is refused naming ``wire_quant`` (its pending
    residuals would vanish).  The ``@rowver`` plane, which earlier slices
    refused (ROADMAP A12d), loads: it arms the table's plane with its
    stamps, as JAX's load does."""
    t = _table()
    path = str(tmp_path / "ck")
    pck.save_checkpoint(t, path)
    with np.load(path + ".npz") as z:
        payload = {k: z[k] for k in z.files if not k.startswith("__crc__")}
    stamps = np.arange(16, dtype=np.int32).reshape(16, 1)
    if plane == "n_hot":
        payload["n_hot"] = np.int64(3)
    elif plane == "field__@rowver":
        payload[plane] = stamps
    else:
        payload[plane] = np.zeros((16, 4), np.float32)
    pck.atomic_savez(path + ".npz", payload)
    if plane == "field__@rowver":
        pck.load_checkpoint(t, path)
        np.testing.assert_array_equal(t.to_numpy()["@rowver"], stamps)
        assert t.state["@rowver"].dtype == torch.int32
        return
    err, match = {"n_hot": (ValueError, "n_hot"),
                  "field__h@hot": (ValueError, "fields")}.get(
                      plane, (ValueError, "wire_quant"))
    with pytest.raises(err, match=match):
        pck.load_checkpoint(t, path)


def test_crc_detects_corruption_on_both_sides(tmp_path):
    """The CRC entries catch flipped bytes: the port's verify and loads
    refuse the port's file and the JAX package's, and JAX's verify
    refuses the port's; ``corrupt_file_bytes`` is the port's copy."""
    from swiftmpi_tpu.io.resilience import load_checkpoint_elastic
    from swiftmpi_tpu_torch.io.resilience import \
        load_checkpoint_elastic as port_elastic
    t = _table(2, 32)
    t.key_index.lookup(np.arange(9, dtype=np.uint64))
    p_path, j_path = str(tmp_path / "p"), str(tmp_path / "j")
    pck.save_checkpoint(t, p_path, extra={"iter": np.int64(1)})
    jck.save_checkpoint(_jax_table(2, 32), j_path)
    for path in (p_path, j_path):
        pck.verify_checkpoint(path)
        jck.verify_checkpoint(path)
        corrupt_file_bytes(pck.npz_path(path))
        for verify in (pck.verify_checkpoint, jck.verify_checkpoint):
            with pytest.raises(Exception, match="CRC|unreadable"):
                verify(path)
        with pytest.raises(pck.CheckpointCorruptError):
            pck.load_checkpoint(_table(2, 32), path)
        with pytest.raises(pck.CheckpointCorruptError):
            port_elastic(_table(4, 32), path)
    with pytest.raises(jck.CheckpointCorruptError):
        load_checkpoint_elastic(_jax_table(4, 32), p_path)


def test_files_without_crcs_and_missing_files(tmp_path):
    p = str(tmp_path / "old.npz")
    np.savez(p, a=np.arange(4), b=np.ones((2, 2)))
    pck.verify_checkpoint(p)
    with pytest.raises(FileNotFoundError):
        pck.verify_checkpoint(str(tmp_path / "never_written"))


def test_generation_window_and_valid_fallback(tmp_path):
    """``retain=3`` keeps the live file and two generations, named as the
    JAX package names them (its scan finds the same file); a corrupted
    newest falls back to the previous generation; with every file
    damaged nothing is valid."""
    t = _table(2, 32)
    path = str(tmp_path / "ck")
    for i in range(4):
        pck.save_checkpoint(t, path, extra={"iter": np.int64(i + 1)},
                            retain=3)
    files = sorted(os.listdir(tmp_path))
    assert files == ["ck.g2.npz", "ck.g3.npz", "ck.npz"]
    live = pck.npz_path(path)
    assert pck.find_latest_valid_checkpoint(path) == live \
        == jck.find_latest_valid_checkpoint(path)
    corrupt_file_bytes(live)
    best = pck.find_latest_valid_checkpoint(path)
    assert best == str(tmp_path / "ck.g3.npz") \
        == jck.find_latest_valid_checkpoint(path)
    with np.load(best) as z:
        assert int(z["extra__iter"]) == 3
    for f in files:
        p = str(tmp_path / f)
        corrupt_file_bytes(p, offset=os.path.getsize(p) // 4)
    assert pck.find_latest_valid_checkpoint(path) is None


def test_atomic_save_sweeps_only_stale_tmps(tmp_path):
    """A writer killed between savez and the rename leaves its pid's tmp;
    the next save sweeps an aged one of a dead pid, never a live writer's
    (however old) nor a young one, and leaves no tmp of its own."""
    t = _table()
    path = str(tmp_path / "ck")
    dst = pck.npz_path(path)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    live = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        orphan = f"{dst}.{dead.pid}.tmp.npz"
        slow_writer = f"{dst}.{live.pid}.tmp.npz"
        fresh_orphan = f"{dst}.{dead.pid + 100000}.tmp.npz"
        for p in (orphan, slow_writer, fresh_orphan):
            with open(p, "w") as f:
                f.write("partial write")
        old = time.time() - 3600
        os.utime(orphan, (old, old))
        os.utime(slow_writer, (old, old))
        pck.save_checkpoint(t, path, retain=2)
        pck.save_checkpoint(t, path, retain=2)
        assert not os.path.exists(orphan)
        assert os.path.exists(slow_writer)
        assert os.path.exists(fresh_orphan)
        assert os.path.exists(dst)
        mine = [f for f in os.listdir(tmp_path)
                if f".{os.getpid()}.tmp" in f]
        assert not mine
    finally:
        live.kill()
        live.wait()


def test_key_index_restore_matches_jax():
    """``restore`` of saved pairs: the same next free row per shard as
    the JAX index, so keys created after a restore get the same slots."""
    ki, jki = KeyIndex(4, 16), JaxKeyIndex(4, 16)
    keys = np.array([9, 3, 77, 12, 5, 41, 2], np.uint64)
    src = JaxKeyIndex(4, 16)
    slots = src.lookup(keys)
    ki.restore(keys, slots)
    jki.restore(keys, slots)
    assert list(ki.items()) == list(jki.items())
    np.testing.assert_array_equal(ki.shard_fill(), jki.shard_fill())
    more = np.arange(100, 130, dtype=np.uint64)
    np.testing.assert_array_equal(ki.lookup(more), jki.lookup(more))
    with pytest.raises(ValueError, match="outside"):
        ki.restore([1], [4 * 16 + 3])


def test_numerics_extra_is_returned_not_applied(tmp_path, monkeypatch):
    """A checkpoint carrying the JAX package's numerics detector baselines
    (``extra__numerics``) resumes: the entry comes back from the load, and
    ``resume`` keeps it for the detector the next armed ``train`` builds,
    which then holds the JAX detector's state."""
    from swiftmpi_tpu.obs.numerics import AnomalyDetector as JaxDetector
    sents = corpus()
    pm = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    pm.build(sents)
    path = str(tmp_path / "ck")
    jdet = JaxDetector(warmup=2)
    for v in (1.0, 1.1, 0.9, 1.05):
        jdet.observe("numerics/grad_norm", v)
    blob = jdet.state_bytes()
    pck.save_checkpoint(pm.table, path, extra={"iter": np.int64(4),
                                               "numerics": blob})
    extra = pck.load_checkpoint(pm.table, path)
    np.testing.assert_array_equal(extra["numerics"], blob)
    assert pm.resume(path) == 4
    np.testing.assert_array_equal(pm._numerics_restore, blob)
    from swiftmpi_tpu_torch import obs
    monkeypatch.chdir(tmp_path)
    pm.config.set("worker", "telemetry", 1)
    pm.config.set("obs", "numerics", 1)
    pm.numerics_on = True
    try:
        pm.train(sents, niters=1, batch_size=16)
    finally:
        obs.reset_for_tests()
    assert pm._numerics_restore is None
    base = pm._numerics.detector.state()["series"]["numerics/grad_norm"]
    assert base[2] >= jdet.state()["series"]["numerics/grad_norm"][2]
