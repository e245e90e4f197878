"""The port's sparse-allreduce collective (``[cluster] collective``)
against the JAX package's, on the CPU, mirroring
``tests/test_sparse_allreduce.py`` case for case (8 ranks on the CPU
against the ``devices8`` mesh):

* ``merge_rows`` / ``merge_counts`` against ``np.add.at`` and JAX's, the
  bucket permutation's round trip and layout;
* ``collective: psum`` pinned is the default bit for bit on every
  backend;
* the ``tpu`` dense rung's flip to the sparse allreduce is bit-identical,
  only the ledger moves (key for key JAX's);
* the ``hybrid`` hot plane under the sparse allreduce against the dense
  reconcile and against JAX's, its ledger JAX's;
* the ``auto`` crossover, the knob forwarding, the ``@ef`` planes across
  a flip, the pricer and the hot plan's cache, JAX's.

Tolerances: the sparse hot reconcile sums in another order than the dense
one and than JAX's reduce-scatter: ``allclose`` at JAX's own ``rtol=1e-5,
atol=1e-6``; integer ledger keys exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import key_index as jax_ki
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.transfer import plan as jax_plan
from swiftmpi_tpu.transfer import sparse_allreduce as jax_sar
from swiftmpi_tpu.transfer.hybrid import HybridTransfer as JaxHybrid
from swiftmpi_tpu.transfer.local import LocalTransfer as JaxLocal
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable
from swiftmpi_tpu_torch.parameter import key_index as port_ki
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
from swiftmpi_tpu_torch.parameter.sparse_table import ef_name
from swiftmpi_tpu_torch.transfer import plan as port_plan
from swiftmpi_tpu_torch.transfer import sparse_allreduce as port_sar
from swiftmpi_tpu_torch.transfer.api import get_transfer
from swiftmpi_tpu_torch.transfer.local import LocalTransfer
from tests.test_torch_window import (DIM, JACC, N, PACC, _jax_table,
                                     _port_push_window, _sides, window_batch)


@pytest.fixture(autouse=True)
def fresh_plan_caches():
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()
    yield
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()


def zipf_counts(v, s=1.0, total=1_000_000):
    p = np.arange(1, v + 1, dtype=np.float64) ** -s
    return np.maximum((total * p / p.sum()).astype(np.int64), 1)


def hybrid_tables(n_keys=400, cap=64, seed=0):
    """One Zipf key set under both packages' partitions, the port's state
    from JAX's; returns ``(jtable, ptable, keys, p)``."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(100_000, size=n_keys, replace=False).astype(np.uint64)
    counts = zipf_counts(n_keys)[rng.permutation(n_keys)]
    jki = JaxKeyIndex(N, cap, partition=JaxPart.from_counts(
        keys, counts, batch_rows=64))
    jtable = JaxSparseTable(JACC, jki, mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    jki.lookup(keys)
    layout = ps_mesh(N, ["cpu"])
    pki = KeyIndex(N, cap, partition=HotColdPartition.from_counts(
        keys, counts, batch_rows=64))
    np.testing.assert_array_equal(pki.lookup(keys), jki.lookup(keys))
    ptable = SparseTable(PACC, pki, "cpu", mesh=layout)
    ptable.state = state_from_jax(
        {f: np.asarray(a) for f, a in jtable.state.items()}, "cpu",
        mesh=layout)
    return jtable, ptable, keys, counts / counts.sum()


def hybrid_window(keys, ki, rng, W=4, B=64, p=None):
    kk = keys[rng.choice(len(keys), size=W * B, p=p)]
    slots = np.asarray(ki.lookup(kk), np.int32).reshape(W, B)
    slots[:, ::7] = -1
    grads = {f: rng.normal(size=(W, B, DIM)).astype(np.float32)
             for f in ("h", "v")}
    counts = rng.integers(1, 4, size=(W, B)).astype(np.float32)
    counts[slots < 0] = 0
    return slots, grads, counts


def _port_hybrid(mode, frac):
    t = get_transfer("hybrid", mesh=ps_mesh(N, ["cpu"]))
    t.count_traffic, t.collective_mode = True, mode
    t.hot_touched_fraction = frac
    return t


def _np(state):
    return {f: np.concatenate([x.numpy() for x in v]) if isinstance(v, list)
            else v.numpy() for f, v in state.items()}


# -- the merge and the bucketing ---------------------------------------------

def test_merge_rows_matches_numpy_scatter_add():
    """Duplicates summed, padding and out-of-range rows dropped: exactly
    ``np.add.at`` and JAX's ``merge_rows``; the counts twin too."""
    rng = np.random.default_rng(0)
    cap, n = 16, 200
    slots = rng.integers(-2, cap + 3, size=n).astype(np.int32)
    vals = rng.normal(size=(n, DIM)).astype(np.float32)
    valid = (slots >= 0) & (slots < cap)
    want = np.zeros((cap, DIM), np.float32)
    np.add.at(want, slots[valid], vals[valid])
    got = port_sar.merge_rows(torch.from_numpy(slots),
                              torch.from_numpy(vals), cap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jax_sar.merge_rows(slots, vals, cap)), rtol=1e-6,
        atol=1e-6)
    cts = rng.integers(0, 4, size=n).astype(np.float32)
    want_c = np.zeros((cap,), np.float32)
    np.add.at(want_c, slots[valid], cts[valid])
    got_c = port_sar.merge_counts(torch.from_numpy(slots),
                                  torch.from_numpy(cts), cap).numpy()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(
        got_c, np.asarray(jax_sar.merge_counts(slots, cts, cap)))


def test_bucket_permute_roundtrip_and_layout():
    """Row r to bucket r % n at index r // n, the exact inverse, JAX's
    layout and permutation."""
    for rows, n in ((64, 8), (65, 8), (0, 8), (10, 4), (222, 8)):
        assert port_sar.bucket_layout(rows, n) \
            == jax_sar.bucket_layout(rows, n)
    assert port_sar.bucket_layout(65, 8) == (9, 72)
    n = 4
    cap_bucket, n_pad = port_sar.bucket_layout(10, n)
    dense = np.random.default_rng(1).normal(size=(n_pad, DIM)).astype(
        np.float32)
    bucketed = port_sar.bucket_permute(torch.from_numpy(dense), n).numpy()
    for r in range(n_pad):
        np.testing.assert_array_equal(
            bucketed[(r % n) * cap_bucket + r // n], dense[r])
    np.testing.assert_array_equal(
        bucketed, np.asarray(jax_sar.bucket_permute(jnp.asarray(dense), n)))
    np.testing.assert_array_equal(
        port_sar.bucket_unpermute(torch.from_numpy(bucketed), n).numpy(),
        dense)


def test_byte_models_goldens():
    assert port_sar.dense_psum_bytes(1024, 36) == 1024 * 36
    assert port_sar.sparse_ar_bytes(50, 36) == 50 * (port_sar.ROW_ID_BYTES
                                                     + 36)


# -- psum pinned ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_psum_pinned_bit_identical_all_backends(name, devices8):
    """Pinning ``collective: psum`` leaves every window bit-identical to
    the default and books nothing on the sparse side."""
    jtable, ki = _jax_table()
    slots, grads, counts = window_batch(ki, np.random.default_rng(11))
    _, _, off, s_off, conv = _sides(name, jtable)
    _, _, pin, s_pin, _ = _sides(name, jtable)
    pin.collective_mode, pin.count_traffic = "psum", True
    got_off = _port_push_window(off, s_off, conv, slots, grads, True, counts)
    got_pin = _port_push_window(pin, s_pin, conv, slots, grads, True, counts)
    for f in PACC.fields:
        np.testing.assert_array_equal(got_off[f], got_pin[f], (name, f))
    tr = pin.traffic()
    assert tr["collective_sparse_ar"] == 0 and tr["hot_psum_bytes_saved"] \
        == 0, (name, tr)


def test_tpu_dense_rung_sparse_ar_flip_bit_identical(devices8):
    """The sharded dense rung's flip to the sparse allreduce is the same
    computation bit for bit; the ledger re-books the touched rows, key for
    key JAX's."""
    jtable, ki = _jax_table(cap=8)               # densifies at 64 slots
    slots, grads, counts = window_batch(ki, np.random.default_rng(2),
                                        key_hi=24)
    got, tr = {}, {}
    for mode in ("psum", "sparse_allreduce"):
        jt, jstate, pt, pstate, conv = _sides("tpu", jtable)
        for t in (jt, pt):
            t.count_traffic, t.collective_mode = True, mode
        jt.push_window(jstate, slots, grads, JACC, mean=True, counts=counts)
        got[mode] = _port_push_window(pt, pstate, conv, slots, grads, True,
                                      counts)
        tr[mode] = pt.traffic()
        assert tr[mode] == jt.traffic(), mode
    for f in PACC.fields:
        np.testing.assert_array_equal(got["psum"][f],
                                      got["sparse_allreduce"][f], f)
    d, s = tr["psum"], tr["sparse_allreduce"]
    assert d["window_dense"] == s["window_dense"] == 1
    assert d["collective_psum"] == 1 and d["collective_sparse_ar"] == 0
    assert s["collective_sparse_ar"] == 1 and s["collective_psum"] == 0
    assert s["wire_bytes"] != d["wire_bytes"]
    assert s["hot_psum_bytes_saved"] != 0


# -- the hybrid hot plane ---------------------------------------------------------

def test_hybrid_hot_plane_parity_and_ledger(devices8):
    """Three windows: the sparse hot reconcile reaches the dense one's
    state and JAX's sparse arm's (float order only), and the ledger,
    JAX's key for key, swaps the head's bytes for the touched rows'."""
    arms = {}
    for mode in ("psum", "sparse_allreduce"):
        jtable, ptable, keys, p = hybrid_tables()
        rng = np.random.default_rng(5)
        jt = JaxHybrid(jax_ps_mesh())
        pt = _port_hybrid(mode, 0.1)
        jt.count_traffic, jt.collective_mode = True, mode
        jt.hot_touched_fraction = 0.1
        jstate = jtable.state
        for _ in range(3):
            slots, grads, counts = hybrid_window(keys, ptable.key_index, rng,
                                                 W=4, B=16, p=p)
            jstate = jt.push_window(jstate, slots, grads, JACC, mean=True,
                                    counts=counts)
            pt.push_window(ptable.state, torch.from_numpy(slots),
                           {f: torch.from_numpy(g) for f, g in grads.items()},
                           PACC, mean=True, counts=torch.from_numpy(counts))
        got = _np(ptable.state)
        for f, a in jstate.items():
            np.testing.assert_allclose(got[f], np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=(mode, f))
        assert pt.traffic() == jt.traffic(), mode
        arms[mode] = (got, pt.traffic())
    (st_p, tr_p), (st_s, tr_s) = arms["psum"], arms["sparse_allreduce"]
    for f in st_p:
        np.testing.assert_allclose(st_s[f], st_p[f], rtol=1e-5, atol=1e-6)
    assert tr_p["collective_psum"] > 0 and tr_p["collective_sparse_ar"] == 0
    assert tr_s["collective_sparse_ar"] > 0 and tr_s["collective_psum"] == 0
    assert 0 < tr_s["psum_bytes"] and tr_p["psum_bytes"] >= \
        2 * tr_s["psum_bytes"]
    assert tr_s["hot_psum_bytes_saved"] > 0 == tr_p["hot_psum_bytes_saved"]


def test_hybrid_auto_crossover_picks_by_density(devices8):
    """``auto``: a sparse touched fraction takes the sparse exchange, a
    dense one keeps the psum."""
    for frac, want_sparse in ((0.05, True), (0.95, False)):
        _, ptable, keys, p = hybrid_tables()
        slots, grads, counts = hybrid_window(
            keys, ptable.key_index, np.random.default_rng(7), p=p)
        t = _port_hybrid("auto", frac)
        t.push_window(ptable.state, torch.from_numpy(slots),
                      {f: torch.from_numpy(g) for f, g in grads.items()},
                      PACC, mean=True, counts=torch.from_numpy(counts))
        assert (t.traffic()["collective_sparse_ar"] > 0) == want_sparse


def test_hybrid_forwards_collective_knobs_to_tail(devices8):
    h = get_transfer("hybrid", mesh=ps_mesh(N, ["cpu"]))
    assert h.collective_mode == "psum"
    h.collective_mode, h.hot_touched_fraction = "auto", 0.25
    h.sparse_ar_ratio = 3.0
    assert (h.tail.collective_mode, h.tail.hot_touched_fraction,
            h.tail.sparse_ar_ratio) == ("auto", 0.25, 3.0)
    for knob, v in (("pull_quant", "int8"), ("pull_quant_guard", 2.0),
                    ("pull_cache", 64), ("pull_cache_oracle", True)):
        setattr(h, knob, v)
        assert getattr(h.tail, knob) == v


def test_ef_planes_survive_collective_flip(devices8):
    """The tail's ``@ef`` planes (the quantized wire) are bit-identical
    between the psum and sparse-allreduce arms of the hot reconcile, and
    equal JAX's sparse arm's within one int8 step; the value planes agree
    to float order."""
    arms = {}
    for mode in ("psum", "sparse_allreduce"):
        jtable, ptable, keys, p = hybrid_tables()
        jtable.ensure_ef(("h", "v"))
        ptable.ensure_ef(("h", "v"))
        rng = np.random.default_rng(13)
        jt, pt = JaxHybrid(jax_ps_mesh()), _port_hybrid(mode, 0.1)
        for t in (jt, pt):
            t.wire_quant, t.window_expected_unique = "int8", 16.0
            t.collective_mode, t.hot_touched_fraction = mode, 0.1
        jstate = jtable.state
        for _ in range(3):
            slots, grads, counts = hybrid_window(keys, ptable.key_index, rng,
                                                 p=p)
            jstate = jt.push_window(jstate, slots, grads, JACC, mean=True,
                                    counts=counts)
            pt.push_window(ptable.state, torch.from_numpy(slots),
                           {f: torch.from_numpy(g) for f, g in grads.items()},
                           PACC, mean=True, counts=torch.from_numpy(counts))
        arms[mode] = _np(ptable.state)
        if mode == "sparse_allreduce":
            for f in ("h@ef", "v@ef"):
                w = np.asarray(jstate[f])
                np.testing.assert_allclose(arms[mode][f], w,
                                           atol=np.abs(w).max() + 1e-6)
    st_p, st_s = arms["psum"], arms["sparse_allreduce"]
    assert any(st_p[ef_name(f)].any() for f in ("h", "v"))
    for f in ("h", "v"):
        np.testing.assert_array_equal(st_s[ef_name(f)], st_p[ef_name(f)])
        np.testing.assert_allclose(st_s[f], st_p[f], rtol=1e-5, atol=1e-6)


# -- the crossover and the hot plan ----------------------------------------------

def test_price_hot_collectives_goldens():
    dense = 1024 * 36.0
    d, p = port_ki.price_hot_collectives(1024, 36, 0.05)
    assert d == "sparse_allreduce"
    assert p == {"psum": dense, "sparse_allreduce": 0.05 * 1024 * 40.0}
    assert port_ki.price_hot_collectives(1024, 36, 0.9)[0] == "psum"
    assert port_ki.price_hot_collectives(1024, 36, 0.45)[0] == "psum"
    assert port_ki.price_hot_collectives(1024, 36, 0.449)[0] \
        == "sparse_allreduce"
    assert port_ki.price_hot_collectives(
        1024, 36, 0.45, sparse_ar_ratio=1.0)[0] == "sparse_allreduce"
    assert port_ki.price_hot_collectives(1024, 36, None) \
        == ("psum", {"psum": dense})
    for frac in (None, 0.05, 0.45, 0.449, 0.9):
        assert port_ki.price_hot_collectives(1024, 36, frac) \
            == jax_ki.price_hot_collectives(1024, 36, frac)


def test_hot_plan_cache_hit_and_reprice_on_density_move():
    """Same shape and knobs: a hit; a moved density: a new key, a new
    plan, JAX's field for field."""
    for mod, t in ((port_plan, LocalTransfer()), (jax_plan, JaxLocal())):
        t.collective_mode, t.hot_touched_fraction = "auto", 0.05
        plan, hit = mod.compile_hot_plan(t, 1024, 36)
        assert not hit and plan.collective == "sparse_allreduce"
        plan2, hit2 = mod.compile_hot_plan(t, 1024, 36)
        assert hit2 and plan2 is plan
        t.hot_touched_fraction = 0.9
        plan3, hit3 = mod.compile_hot_plan(t, 1024, 36)
        assert not hit3 and plan3.collective == "psum"
        t.hot_touched_fraction = 0.05
        assert mod.compile_hot_plan(t, 1024, 36)[1] is True
    assert vars(port_plan.compile_hot_plan(t, 1024, 36)[0]) \
        == vars(jax_plan.compile_hot_plan(t, 1024, 36)[0])


def test_hot_plan_pinned_modes_override_pricer():
    t = LocalTransfer()
    t.collective_mode, t.hot_touched_fraction = "sparse_allreduce", None
    assert port_plan.compile_hot_plan(t, 512, 36)[0].collective \
        == "sparse_allreduce"
    t2 = LocalTransfer()
    t2.collective_mode, t2.hot_touched_fraction = "psum", 0.01
    plan2, _ = port_plan.compile_hot_plan(t2, 512, 36)
    assert plan2.collective == "psum"
    assert plan2.family == "hot" and plan2.capacity == 512
