"""The port's window-coalesced push (``[cluster] push_window: W``)
against the JAX package's, on the CPU, mirroring ``tests/test_window_push
.py``, ``tests/test_traffic_plan.py`` and ``tests/test_sparse_allreduce
.py`` at small sizes (8 ranks on the CPU against the ``devices8`` mesh):

* ``W == 1`` is the per-step push, bit for bit, on every backend;
* the ``tpu`` sparse rung (per-rank dedup, one routed exchange) and the
  dense rung (one scatter onto the global plane, the owners' tiles) and
  the ``hybrid`` hot split against JAX's ``push_window`` and the
  flatten-once oracle, the ledger key for key, overflow exact;
* the pricers, the plan compiler and the byte models equal JAX's field
  for field;
* a windowed word2vec group with JAX's draws replayed, on ``xla``,
  ``tpu`` and ``hybrid``.

Tolerances: a sparse window within ``|a - b| <= 1e-5 + 1e-3 |b|`` (the
dedup and the owners sum in another order than JAX), the dense rung
within JAX's own ``rtol=1e-4, atol=1e-5``; integer ledger keys exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.cluster.hashfrag import \
    expected_unique_rows as jax_expected_unique
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.parameter.access import lr_access as jax_lr_access
from swiftmpi_tpu.parameter import key_index as jax_ki
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.transfer import plan as jax_plan
from swiftmpi_tpu.transfer import sketch as jax_sketch
from swiftmpi_tpu.transfer import sparse_allreduce as jax_sar
from swiftmpi_tpu.transfer.api import \
    quant_grad_row_bytes as jax_quant_row_bytes
from swiftmpi_tpu.transfer.hybrid import HybridTransfer as JaxHybrid
from swiftmpi_tpu.transfer.local import LocalTransfer as JaxLocal
from swiftmpi_tpu.transfer.tpu import TpuTransfer
from swiftmpi_tpu.transfer.xla import XlaTransfer
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.cluster.hashfrag import expected_unique_rows
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, _batch_fields
from swiftmpi_tpu_torch.data.text import CBOWBatcher
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.parameter import key_index as port_ki
from swiftmpi_tpu_torch.parameter.access import lr_access
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
from swiftmpi_tpu_torch.parameter.sparse_table import hot_name
from swiftmpi_tpu_torch.transfer import plan as port_plan
from swiftmpi_tpu_torch.transfer import sketch as port_sketch
from swiftmpi_tpu_torch.transfer import sparse_allreduce as port_sar
from swiftmpi_tpu_torch.transfer.api import (get_transfer,
                                             quant_grad_row_bytes,
                                             window_dedup)
from swiftmpi_tpu_torch.transfer.local import LocalTransfer
from swiftmpi_tpu_torch.utils import ConfigParser

N, DIM, LR = 8, 8, 0.3


@pytest.fixture(autouse=True)
def fresh_plan_caches():
    """Both packages' plan caches are module globals: start each test
    from empty ones, so plan compiles and hits compare."""
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()
    yield
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()


def _envelope(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                               err_msg=str(what))


def _jax_table(cap=128):
    jacc = jax_w2v_access(learning_rate=LR, len_vec=DIM)
    ki = JaxKeyIndex(N, cap)
    return JaxSparseTable(jacc, ki, mesh=jax_ps_mesh(), axis=SHARD_AXIS), ki


def window_batch(ki, rng, W=4, B=64, key_hi=700):
    """tests/test_window_push.py's window: padding (-1), repeats across
    and within steps, integer counts."""
    keys = rng.integers(0, key_hi, size=W * B).astype(np.uint64)
    slots = np.asarray(ki.lookup(keys), np.int32).reshape(W, B)
    slots[:, ::7] = -1
    grads = {f: rng.normal(size=(W, B, DIM)).astype(np.float32)
             for f in ("h", "v")}
    counts = rng.integers(1, 4, size=(W, B)).astype(np.float32)
    counts[slots < 0] = 0
    return slots, grads, counts


def _jax_backend(name):
    if name == "local":
        return JaxLocal()
    if name == "xla":
        return XlaTransfer()
    if name == "tpu":
        return TpuTransfer(jax_ps_mesh())
    return JaxHybrid(jax_ps_mesh())


def _sides(name, jtable):
    """(jax transfer, jax state, port transfer, port state, converter) for
    one backend from one JAX table; the port's state a copy."""
    np_state = {f: np.asarray(a) for f, a in jtable.state.items()}
    layout = ps_mesh(N, ["cpu"])
    if name in ("tpu", "hybrid"):
        return (_jax_backend(name), jtable.state,
                get_transfer(name, mesh=layout),
                state_from_jax(np_state, "cpu", mesh=layout),
                torch.from_numpy)
    jstate = ({f: jnp.asarray(v) for f, v in np_state.items()}
              if name == "xla" else np_state)
    pstate = (state_from_jax(np_state, "cpu") if name == "xla"
              else {f: v.copy() for f, v in np_state.items()})
    return (_jax_backend(name), jstate, get_transfer(name), pstate,
            torch.from_numpy if name == "xla" else (lambda a: a))


def _port_push_window(t, state, conv, slots, grads, mean, counts=None):
    """The port's push_window; the state it returns (the same tensors on
    the in-place backends, new arrays on the oracle) as numpy."""
    out = t.push_window(state, conv(slots),
                        {f: conv(g) for f, g in grads.items()}, PACC,
                        mean=mean, counts=None if counts is None
                        else conv(counts))
    return state_to_numpy(out) if not isinstance(
        next(iter(out.values())), np.ndarray) else out


PACC = w2v_access(LR, DIM)
JACC = jax_w2v_access(learning_rate=LR, len_vec=DIM)


def oracle_window(state_np, slots, grads, mean=False, counts=None):
    """Sum-then-apply-once: the flattened window through the port's numpy
    oracle."""
    flat = slots.reshape(-1)
    fgrads = {f: g.reshape(-1, DIM) for f, g in grads.items()}
    st = {f: v.copy() for f, v in state_np.items()}
    if counts is not None:
        return LocalTransfer().push_span(st, flat, fgrads,
                                         counts.reshape(-1), PACC, mean=mean)
    return LocalTransfer().push(st, flat, fgrads, PACC, mean=mean)


# -- W == 1: the per-step push, bit for bit ------------------------------------

@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_push_window_w1_bit_identical(name, devices8):
    """A (1, B) window is the per-step push bit for bit, on every
    backend; against JAX's W == 1 window it holds the per-step push's own
    tolerance (the two packages' pushes round the AdaGrad update apart in
    the last bit)."""
    jtable, ki = _jax_table()
    slots, grads, _ = window_batch(ki, np.random.default_rng(0), W=1)
    jt, jstate, pt, pstate, conv = _sides(name, jtable)
    want = jt.push_window(jstate, slots, grads, JACC, mean=True)
    _, _, pt2, pstate2, _ = _sides(name, jtable)
    got = _port_push_window(pt, pstate, conv, slots, grads, True)
    per = pt2.push(pstate2, conv(slots[0]),
                   {f: conv(g[0]) for f, g in grads.items()}, PACC,
                   mean=True)
    per = per if name == "local" else state_to_numpy(per)
    for f in PACC.fields:
        np.testing.assert_array_equal(got[f], per[f], err_msg=f)
        _envelope(got[f], np.asarray(want[f]), f)


# -- tpu: the sparse rung --------------------------------------------------------

@pytest.mark.parametrize("mean,use_counts", [(False, False), (True, False),
                                             (True, True), (False, True)])
def test_tpu_push_window_matches_jax(mean, use_counts, devices8):
    """A W = 4 window on 8 ranks: each rank's slice (spanning steps)
    deduplicated, one routed exchange; the table against JAX's
    ``TpuTransfer.push_window`` and the flatten-once oracle, the ledger
    (``window_sparse``, ``coalesced_rows_*``, ``routed_rows``,
    ``wire_bytes`` ...) key for key."""
    jtable, ki = _jax_table()
    state_np = {f: np.asarray(v) for f, v in jtable.state.items()}
    slots, grads, counts = window_batch(ki, np.random.default_rng(1))
    counts = counts if use_counts else None
    jt, jstate, pt, pstate, conv = _sides("tpu", jtable)
    jt.count_traffic = pt.count_traffic = True
    want = jt.push_window(jstate, slots, grads, JACC, mean=mean,
                          counts=counts)
    got = _port_push_window(pt, pstate, conv, slots, grads, mean, counts)
    oracle = oracle_window(state_np, slots, grads, mean, counts)
    for f in PACC.fields:
        _envelope(got[f], np.asarray(want[f]), f)
        _envelope(got[f], oracle[f], f)
    tr = pt.traffic()
    assert tr == jt.traffic()
    assert tr["window_sparse"] == tr["window_fmt_sparse"] == 1
    assert tr["coalesced_rows_in"] > tr["coalesced_rows_out"] > 0
    assert tr["routed_rows"] == tr["coalesced_rows_out"]
    assert pt.push_paths == {"h,v:routed_span" if mean or use_counts
                             else "h,v:routed": 1}


def test_tpu_dedup_slices_span_steps(devices8):
    """Rank r takes rows ``[r L, (r + 1) L)`` of the flat window, L = W B
    / n (JAX's layout, not each step's own rank slice): a slot repeated
    within a rank's slice keeps its first position there, one repeated
    across two ranks' slices keeps one in each."""
    pt = get_transfer("tpu", mesh=ps_mesh(N, ["cpu"]))
    W, B, cap = 2, 16, 64
    L = W * B // N                        # 4 rows a rank, steps interleave
    flat = torch.full((W * B,), -1, dtype=torch.int32)
    flat[[0, 2, 3]] = 5                   # rank 0 thrice
    flat[[4, 9]] = 7                      # ranks 1 and 2
    g = {"h": torch.arange(W * B, dtype=torch.float32)[:, None].repeat(
        1, 3).contiguous()}
    ded, dg, dc = pt._prim_window_dedup(flat, g, None, cap)
    assert ded.tolist()[:12] == [5, -1, -1, -1, 7, -1, -1, -1, -1, 7, -1,
                                 -1]
    assert dg["h"][0].tolist() == [5.0] * 3 and dg["h"][2].sum() == 0
    assert dc[[0, 4, 9]].tolist() == [3.0, 1.0, 1.0] and dc.sum() == 5
    assert L == 4


# -- the dense rung ----------------------------------------------------------------

@pytest.mark.parametrize("mean,use_counts", [(True, False), (False, False),
                                             (True, True)])
def test_tpu_push_window_dense_rung_matches_jax(mean, use_counts, devices8):
    """A window over most of a small table (8 rows a shard) densifies: one
    scatter onto the global plane, each shard's tile applied with the
    mean's reciprocal.  JAX's rtol 1e-4 / atol 1e-5, booked as JAX books
    it (``capacity`` rows without the index)."""
    jtable, ki = _jax_table(cap=8)
    state_np = {f: np.asarray(v) for f, v in jtable.state.items()}
    slots, grads, counts = window_batch(ki, np.random.default_rng(2),
                                        key_hi=24)
    counts = counts if use_counts else None
    jt, jstate, pt, pstate, conv = _sides("tpu", jtable)
    jt.count_traffic = pt.count_traffic = True
    want = jt.push_window(jstate, slots, grads, JACC, mean=mean,
                          counts=counts)
    got = _port_push_window(pt, pstate, conv, slots, grads, mean, counts)
    oracle = oracle_window(state_np, slots, grads, mean, counts)
    for f in PACC.fields:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
        np.testing.assert_allclose(got[f], oracle[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    tr = pt.traffic()
    assert tr == jt.traffic()
    assert tr["window_dense"] == tr["collective_psum"] == 1
    assert tr["wire_bytes"] == ki.capacity * (2 * DIM * 4 + 4 * mean)
    assert pt.push_paths == {"h,v:window_dense": 1}


def test_window_expected_unique_steers_decision(devices8):
    """The raw request count densifies the window; an expected-unique
    hint below the crossover keeps it sparse; both agree with JAX and
    with the oracle."""
    jtable, ki = _jax_table(cap=8)                    # capacity 64
    state_np = {f: np.asarray(v) for f, v in jtable.state.items()}
    slots, grads, _ = window_batch(ki, np.random.default_rng(3), key_hi=16)
    want = oracle_window(state_np, slots, grads, mean=True)
    for hint, key in ((None, "window_dense"), (16.0, "window_sparse")):
        jt, jstate, pt, pstate, conv = _sides("tpu", jtable)
        jt.count_traffic = pt.count_traffic = True
        jt.window_expected_unique = pt.window_expected_unique = hint
        jout = jt.push_window(jstate, slots, grads, JACC, mean=True)
        got = _port_push_window(pt, pstate, conv, slots, grads, True)
        assert pt.traffic() == jt.traffic()
        assert pt.traffic()[key] == 1
        for f in PACC.fields:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4,
                                       atol=1e-5, err_msg=f)
            np.testing.assert_allclose(got[f], np.asarray(jout[f]),
                                       rtol=1e-4, atol=1e-5, err_msg=f)


# -- hybrid: the hot split -----------------------------------------------------

def _hybrid_tables(seed=4, partitioned=True):
    rng = np.random.default_rng(seed)
    keys = rng.choice(100_000, size=400, replace=False).astype(np.uint64)
    ranks = np.arange(1, 401, dtype=np.float64)
    counts = np.maximum((1e6 * ranks ** -1.0 / np.sum(ranks ** -1.0))
                        .astype(np.int64), 1)[rng.permutation(400)]
    jpart = (JaxPart.from_counts(keys, counts, batch_rows=64)
             if partitioned else None)
    jki = JaxKeyIndex(N, 64, partition=jpart)
    jtable = JaxSparseTable(JACC, jki, mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    jki.lookup(keys)
    layout = ps_mesh(N, ["cpu"])
    ppart = (HotColdPartition.from_counts(keys, counts, batch_rows=64)
             if partitioned else None)
    pki = KeyIndex(N, 64, partition=ppart)
    np.testing.assert_array_equal(pki.lookup(keys), jki.lookup(keys))
    ptable = SparseTable(PACC, pki, "cpu", mesh=layout)
    ptable.state = state_from_jax({f: np.asarray(a)
                                   for f, a in jtable.state.items()}, "cpu",
                                  mesh=layout)
    return jtable, ptable, keys, rng


@pytest.mark.parametrize("partitioned", [True, False])
def test_hybrid_push_window_matches_jax(partitioned, devices8):
    """n_hot > 0: one dedup in the unified slot space, the hot slice
    through the hot push with the deduplicated counts, the tail's own
    plan on the ``tpu`` tail; n_hot == 0: the whole window to the tail.
    Against JAX's ``HybridTransfer.push_window`` and the unified oracle,
    hot planes included, the ledger key for key."""
    jtable, ptable, keys, rng = _hybrid_tables(partitioned=partitioned)
    assert (ptable.n_hot > 0) is partitioned
    W, B = 3, 64
    slots = np.asarray(jtable.key_index.lookup(
        keys[rng.integers(0, 400, W * B)]), np.int32).reshape(W, B)
    slots[:, ::9] = -1
    if partitioned:
        assert ((slots >= 0) & (slots < ptable.n_hot)).any()
    grads = {f: rng.normal(size=(W, B, DIM)).astype(np.float32)
             for f in ("h", "v")}
    uni = {f: jtable.unified_rows_host(f) for f in PACC.fields}
    want_uni = oracle_window(uni, slots, grads, mean=True)
    jt = JaxHybrid(jax_ps_mesh())
    pt = get_transfer("hybrid", mesh=ps_mesh(N, ["cpu"]))
    jt.count_traffic = pt.count_traffic = True
    jout = jt.push_window(jtable.state, slots, grads, JACC, mean=True)
    got = _port_push_window(pt, ptable.state, torch.from_numpy, slots,
                            grads, True)
    for f in jout:
        _envelope(got[f], np.asarray(jout[f]), f)
    for f in PACC.fields:
        hot = got[hot_name(f)] if partitioned else got[f][:0]
        _envelope(np.concatenate([hot, got[f]]), want_uni[f], f)
    tr = pt.traffic()
    assert tr == jt.traffic()
    assert tr["window_sparse"] + tr["window_dense"] == 1
    assert tr["coalesced_rows_in"] >= tr["coalesced_rows_out"] > 0
    if partitioned:
        assert tr["hot_rows"] > 0 and tr["psum_bytes"] > 0
        assert tr["collective_psum"] == 1


# -- overflow --------------------------------------------------------------------

def test_push_window_overflow_matches_jax(devices8):
    """tests/test_window_push.py::test_push_window_overflow_preserved on
    both packages: 24 distinct keys of one shard through buckets of 2
    drop as many requests as the per-step push does, and as JAX's
    window; buckets of 24 drop none."""
    jki = JaxKeyIndex(num_shards=N, capacity_per_shard=64)
    jtable = JaxSparseTable(jax_lr_access(0.1), jki, mesh=jax_ps_mesh(),
                            axis=SHARD_AXIS)
    keys, k = [], 0
    while len(keys) < 24:
        if jki.shard_of(np.array([k], np.uint64))[0] == 3:
            keys.append(k)
        k += 1
    flat = np.asarray(jki.lookup(np.array(keys, np.uint64)), np.int32)
    g = np.ones((24, 1), np.float32)
    layout = ps_mesh(N, ["cpu"])
    pacc = lr_access(0.1)
    np_state = {f: np.asarray(a) for f, a in jtable.state.items()}
    results = {}
    for bc in (2, 24):
        jt = TpuTransfer(jax_ps_mesh(), bucket_capacity=bc)
        jt.count_traffic = True
        jt.push_window(jtable.state, flat.reshape(2, 12),
                       {"val": g.reshape(2, 12, 1)}, jax_lr_access(0.1))
        pt = get_transfer("tpu", mesh=layout, bucket_capacity=bc)
        pt.count_traffic = True
        pt.push_window(state_from_jax(np_state, "cpu", mesh=layout),
                       torch.from_numpy(flat).view(2, 12),
                       {"val": torch.from_numpy(g).view(2, 12, 1)}, pacc)
        ref = get_transfer("tpu", mesh=layout, bucket_capacity=bc)
        ref.push(state_from_jax(np_state, "cpu", mesh=layout),
                 torch.from_numpy(flat), {"val": torch.from_numpy(g)}, pacc)
        results[bc] = (pt.overflow_count(), jt.overflow_count(),
                       ref.overflow_count())
        assert pt.traffic() == jt.traffic()
        assert pt.traffic()["window_sparse"] == 1
    assert results[2][0] == results[2][1] == results[2][2] > 0
    assert results[24] == (0, 0, 0)


# -- the ledger on every backend -------------------------------------------------

@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_window_traffic_matches_jax_all_backends(name, devices8):
    """A W = 2 window on each backend books JAX's ledger key for key (on
    ``local`` and ``xla`` with every knob off: the per-step push's)."""
    jtable, ki = _jax_table()
    slots, grads, _ = window_batch(ki, np.random.default_rng(5), W=2)
    jt, jstate, pt, pstate, conv = _sides(name, jtable)
    jt.count_traffic = pt.count_traffic = True
    jt.push_window(jstate, slots, grads, JACC, mean=True)
    _port_push_window(pt, pstate, conv, slots, grads, True)
    tr = pt.traffic()
    assert tr == jt.traffic()
    assert tr["wire_bytes"] > 0 and tr["dispatches"] >= 1
    assert (tr["window_sparse"] + tr["window_dense"] == 1) \
        is (name in ("tpu", "hybrid"))


# -- what stays refused ---------------------------------------------------------

@pytest.mark.parametrize("name,knob,value", [
    ("tpu", "wire_quant", "int8"), ("hybrid", "wire_quant", "bf16"),
    ("xla", "wire_sketch", True), ("local", "wire_sketch", True),
    ("tpu", "collective_mode", "sparse_allreduce"),
    ("hybrid", "collective_mode", "sparse_allreduce")])
def test_encoded_rungs_and_sparse_collective_raise_a12d(name, knob, value,
                                                        devices8):
    """The quantized and encoded rungs and the sparse allreduce, which
    earlier slices refused (ROADMAP A12d), run: the same knob on the same
    window gives JAX's ``push_window`` its table within the envelope (the
    ``@ef`` planes within one int8 or bf16 step of the largest grad sum)
    and its ledger key for key."""
    jtable, ki = _jax_table(cap=8 if knob == "collective_mode" else 128)
    if knob == "wire_quant":
        jtable.ensure_ef(("h", "v"))
    slots, grads, _ = window_batch(
        ki, np.random.default_rng(6), W=2,
        key_hi=24 if knob == "collective_mode" else 700)
    jt, jstate, pt, pstate, conv = _sides(name, jtable)
    for t in (jt, pt):
        setattr(t, knob, value)
        t.count_traffic = True
    want = jt.push_window(jstate, slots, grads, JACC, mean=True)
    got = _port_push_window(pt, pstate, conv, slots, grads, True)
    for f in PACC.fields:
        _envelope(got[f], np.asarray(want[f]), f)
    for f in set(got) - set(PACC.fields):
        w = np.asarray(want[f])
        np.testing.assert_allclose(got[f], w, atol=np.abs(w).max() + 1e-6)
    assert pt.traffic() == jt.traffic()


# -- pricers, plans and byte models --------------------------------------------

GRID = [(rows, cap, rb, ratio, eu)
        for rows in (0, 8, 64, 1024, 65_536)
        for cap in (64, 1024, 100_000)
        for rb in (12, 72, 136, 408)
        for ratio in (1.0, 2.0, 4.0)
        for eu in (None, 16.0, 4_000.0)]


@pytest.mark.parametrize("quant,sketch", [("off", False), ("off", True),
                                          ("int8", False), ("int8", True),
                                          ("bf16", False), ("bf16", True)])
def test_window_pricers_match_jax(quant, sketch):
    """``price_window_formats`` and ``window_wire_format`` over a grid of
    rows, capacity, row bytes, dense ratio and expected unique rows:
    decisions and every price equal JAX's."""
    for rows, cap, rb, ratio, eu in GRID:
        qrb = (None if quant == "off"
               else (rb - 4) // 4 + 8 if quant == "int8" else rb // 2 + 2)
        kw = dict(dense_ratio=ratio, expected_unique=eu, quant=quant,
                  quant_row_bytes=qrb, sketch=sketch)
        got = port_ki.price_window_formats(rows, cap, rb, **kw)
        assert got == jax_ki.price_window_formats(rows, cap, rb, **kw), kw
        assert port_ki.window_wire_format(rows, cap, rb, **kw) \
            == jax_ki.window_wire_format(rows, cap, rb, **kw) == got[0]


def test_pricer_goldens_d1_d32():
    """tests/test_traffic_plan.py's canonical mid-density shapes."""
    d1, p1 = port_ki.price_window_formats(
        64, 1024, 12, expected_unique=64.0, quant="int8",
        quant_row_bytes=13, sketch=True)
    assert (d1, p1) == ("sparse_sketch", {
        "dense": 12288.0, "sparse": 1024.0, "bitmap": 640.0,
        "sparse_sketch": 584.0, "sparse_q": 1088.0})
    d32, p32 = port_ki.price_window_formats(
        64, 1024, 136, expected_unique=64.0, quant="int8",
        quant_row_bytes=44, sketch=True)
    assert d32 == "sparse_q" and p32["sparse_q"] == 3072.0


def test_price_hot_collectives_matches_jax():
    for cap in (1, 222, 62_261):
        for wb in (8, 404, 804):
            for frac in (None, 0.0, 0.01, 0.2, 0.26, 0.5, 1.0, 1.7):
                for ratio in (1.0, 2.0, 3.0):
                    assert port_ki.price_hot_collectives(
                        cap, wb, frac, sparse_ar_ratio=ratio) == \
                        jax_ki.price_hot_collectives(
                            cap, wb, frac, sparse_ar_ratio=ratio)


def test_byte_models_and_tables_match_jax():
    """The sketch and sparse-allreduce byte models, ``quant_grad_row_
    bytes``, the format table and the route tables: JAX's, value for
    value."""
    for name in ("BUCKET_WIDTH", "OFFSET_BYTES", "COUNT_BYTES"):
        assert getattr(port_sketch, name) == getattr(jax_sketch, name)
    for cap in (0, 1, 255, 256, 257, 100_000):
        assert port_sketch.n_buckets(cap) == jax_sketch.n_buckets(cap)
        assert port_sketch.sketch_base_bytes(cap) \
            == jax_sketch.sketch_base_bytes(cap)
        for rows in (0.0, 7.5, 64.0):
            assert port_sketch.sketch_wire_bytes(cap, rows, 68) \
                == jax_sketch.sketch_wire_bytes(cap, rows, 68)
    assert port_sar.ROW_ID_BYTES == jax_sar.ROW_ID_BYTES
    assert port_sar.HOT_COLLECTIVES == jax_sar.HOT_COLLECTIVES
    for rows, wb in ((0, 8), (12.5, 404), (62_261, 804)):
        assert port_sar.sparse_ar_bytes(rows, wb) \
            == jax_sar.sparse_ar_bytes(rows, wb)
        assert port_sar.dense_psum_bytes(int(rows), wb) \
            == jax_sar.dense_psum_bytes(int(rows), wb)
    g = {"h": np.zeros((3, 100), np.float32), "n": np.zeros((3, 1),
                                                            np.float32)}
    for quant in ("int8", "bf16"):
        for wc in (False, True):
            assert quant_grad_row_bytes(
                {f: torch.from_numpy(a) for f, a in g.items()}, quant,
                with_counts=wc) == jax_quant_row_bytes(g, quant,
                                                       with_counts=wc)
    for name in ("WIRE_FORMATS", "COLLECTIVES", "COLLECTIVE_MODES"):
        assert getattr(port_plan, name) == getattr(jax_plan, name)
    for table in ("FORMAT_TABLE", "WINDOW_ROUTES", "PULL_ROUTES"):
        got, want = getattr(port_plan, table), getattr(jax_plan, table)
        assert set(got) == set(want)
        for k in want:
            assert vars(got[k]) == vars(want[k]), (table, k)
    with pytest.raises(KeyError, match="window route"):
        port_plan.window_route("rdma")
    assert port_plan.FORMAT_TABLE["sparse"].wire({}, "off", 8, True) is None
    assert port_plan.FORMAT_TABLE["bitmap"].wire({}, "off", 8, True) \
        == jax_plan.FORMAT_TABLE["bitmap"].wire({}, "off", 8, True) == (4, 1)


def _knobs(name, **kw):
    """A transfer as the plan compiler sees it: its name and its knobs."""
    ratios = kw.pop("ratios", {})
    base = dict(name=name, wire_quant="off", wire_sketch=False,
                window_expected_unique=None, wire_quant_guard=1.25,
                collective_mode="psum", hot_touched_fraction=None,
                sparse_ar_ratio=2.0,
                wire_dense_ratio=lambda fam: ratios.get(fam, 2.0))
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
@pytest.mark.parametrize("mode", ["psum", "auto", "sparse_allreduce"])
def test_compile_window_plan_matches_jax(name, mode):
    """Every field of the compiled plan (decision, dedup, collective,
    taps, prices ...) and the cache behaviour equal JAX's, over a grid of
    shapes and knobs."""
    for quant, sketch, eu, frac in (("off", False, None, None),
                                    ("off", False, 300.0, 0.1),
                                    ("int8", False, None, 0.5),
                                    ("bf16", True, 40.0, None),
                                    ("off", True, None, 0.01)):
        t = _knobs(name, wire_quant=quant, wire_sketch=sketch,
                   window_expected_unique=eu, collective_mode=mode,
                   hot_touched_fraction=frac)
        for rows, cap, rb in ((64, 1024, 72), (4096, 1024, 72),
                              (512, 100_000, 408), (96, 640, 36)):
            qrb = None if quant == "off" else rb // 2
            for wc in (False, True):
                got = port_plan.compile_window_plan(t, rows, cap, rb, qrb,
                                                    wc)
                want = jax_plan.compile_window_plan(t, rows, cap, rb, qrb,
                                                    wc)
                assert vars(got[0]) == vars(want[0]), (rows, cap, rb)
                assert got[1] == want[1]


@pytest.mark.parametrize("mode", ["psum", "auto", "sparse_allreduce"])
def test_compile_hot_plan_matches_jax(mode):
    for frac in (None, 0.02, 0.3, 0.9):
        t = _knobs("hybrid", collective_mode=mode, hot_touched_fraction=frac)
        for n_hot, wb in ((222, 804), (62_261, 404), (1, 8)):
            got = port_plan.compile_hot_plan(t, n_hot, wb)
            want = jax_plan.compile_hot_plan(t, n_hot, wb)
            assert vars(got[0]) == vars(want[0]) and got[1] == want[1]


def test_plan_cache_key_holds_every_knob():
    """Each knob moved, one at a time, misses the cache (the next window
    re-prices); the knobs as they were hit it."""
    t = _knobs("tpu")
    args = (4096, 100_000, 72, None, True)
    assert not port_plan.compile_window_plan(t, *args)[1]
    assert port_plan.compile_window_plan(t, *args)[1]
    for knob, value in (("wire_sketch", True),
                        ("window_expected_unique", 64.0),
                        ("wire_quant_guard", 1.5),
                        ("collective_mode", "auto"),
                        ("hot_touched_fraction", 0.2),
                        ("sparse_ar_ratio", 3.0)):
        old = getattr(t, knob)
        setattr(t, knob, value)
        assert not port_plan.compile_window_plan(t, *args)[1], knob
        setattr(t, knob, old)
        assert port_plan.compile_window_plan(t, *args)[1], knob
    t.wire_dense_ratio = lambda fam: 3.0
    assert not port_plan.compile_window_plan(t, *args)[1]
    with pytest.raises(ValueError, match="collective mode"):
        port_plan.compile_window_plan(_knobs("tpu", collective_mode="x"),
                                      *args)


def test_transfer_knobs_and_ratios():
    """The knobs' defaults are JAX's; the per-family dense ratio falls
    back to the default family's; the hybrid keeps its knobs on the
    tail, which prices the window."""
    pt, jt = get_transfer("xla"), XlaTransfer()
    for knob in ("window_expected_unique", "wire_quant", "wire_quant_guard",
                 "wire_sketch", "collective_mode", "hot_touched_fraction",
                 "sparse_ar_ratio"):
        assert getattr(pt, knob) == getattr(jt, knob), knob
    assert pt.wire_dense_ratio("window") == jt.wire_dense_ratio("window")
    pt.set_wire_dense_ratio(3.0)
    pt.set_wire_dense_ratio(5.0, "h")
    assert (pt.wire_dense_ratio("v"), pt.wire_dense_ratio("h")) == (3.0, 5.0)
    assert pt.decide_wire_format(8, 1024, 72) == "sparse"
    h = get_transfer("hybrid", mesh=ps_mesh(N, ["cpu"]))
    h.window_expected_unique = 12.0
    h.set_wire_dense_ratio(4.0, "window")
    assert h.tail.window_expected_unique == 12.0
    assert h.tail.wire_dense_ratio("window") == 4.0


def test_window_dedup_is_the_representative_trick():
    """``window_dedup`` on two ranks against a numpy reference: each
    slot's first position keeps the sum of its rows and their count (or
    the given counts), every other position -1 and zero."""
    rng = np.random.default_rng(8)
    R, L, cap = 2, 40, 12
    slots = rng.integers(-1, cap, size=(R, L)).astype(np.int32)
    g = rng.normal(size=(R, L, 3)).astype(np.float32)
    c = rng.integers(1, 4, size=(R, L)).astype(np.float32)
    for counts in (None, c):
        ded, dg, dc = window_dedup(
            torch.from_numpy(slots), {"x": torch.from_numpy(g)},
            None if counts is None else torch.from_numpy(counts), cap)
        for r in range(R):
            want_s = np.full(L, -1)
            want_g = np.zeros((L, 3), np.float32)
            want_c = np.zeros(L, np.float32)
            for s in np.unique(slots[r][slots[r] >= 0]):
                at = np.flatnonzero(slots[r] == s)
                want_s[at[0]] = s
                want_g[at[0]] = g[r, at].sum(0)
                want_c[at[0]] = (len(at) if counts is None
                                 else counts[r, at].sum())
            np.testing.assert_array_equal(ded[r].numpy(), want_s)
            np.testing.assert_allclose(dg["x"][r].numpy(), want_g,
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(dc[r].numpy(), want_c)


# -- the windowed AdaGrad envelope ---------------------------------------------

def test_windowed_adagrad_accumulator_envelope():
    """tests/test_window_push.py's envelope on the port's oracle: a window
    advances the accumulator by (sum g)^2, within [0, W x the per-step
    mass], W x when the window's grads align, 0 when they cancel."""
    W = 4
    for case, scale in [("aligned", np.ones(W)),
                        ("cancel", np.array([1.0, -1.0, 1.0, -1.0])),
                        ("mixed", np.array([0.5, -0.2, 1.0, 0.3]))]:
        g = np.stack([s * np.ones((1, DIM), np.float32) for s in scale])
        slots = np.zeros((W, 1), np.int32)
        zero = {f: np.zeros((4, DIM), np.float32)
                for f in ("h", "v", "h2sum", "v2sum")}
        win = LocalTransfer().push_window(
            {f: v.copy() for f, v in zero.items()}, slots, {"h": g}, PACC)
        win_mass = float(win["h2sum"][0].sum())
        st = {f: v.copy() for f, v in zero.items()}
        for i in range(W):
            st = LocalTransfer().push(st, slots[i], {"h": g[i]}, PACC)
        step_mass = float(st["h2sum"][0].sum())
        np.testing.assert_allclose(win_mass, float((g.sum(0) ** 2).sum()),
                                   rtol=1e-6)
        assert 0.0 <= win_mass <= W * step_mass + 1e-6, case
        if case == "aligned":
            np.testing.assert_allclose(win_mass, W * step_mass, rtol=1e-6)
        if case == "cancel":
            assert win_mass < 1e-6


# -- word2vec ------------------------------------------------------------------

CONF = {
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
B = 16


def corpus(n_sent, vocab=300, length=8, seed=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _confs(transfer, **sections):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    cluster = {"transfer": transfer,
               "server_num": 1 if transfer == "xla" else N}
    for c in (jc, pc):
        for k, v in cluster.items():
            c.set("cluster", k, v)
        for sec, kv in sections.items():
            for k, v in kv.items():
                c.set(sec, k, v)
    return jc, pc


def _models(sents, transfer, cap=80, **sections):
    jc, pc = _confs(transfer, **sections)
    if transfer == "xla":
        cap *= N                            # one shard holds the table
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    assert pm.table.n_hot == jm.table.n_hot
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh)
    return jm, pm


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


@pytest.mark.parametrize("transfer", ["xla", "tpu", "hybrid"])
def test_windowed_group_matches_jax(transfer, devices8):
    """One group of ``inner_steps: 4`` at ``push_window: 2`` (two windows
    of two steps, each step's grads against the window-start table)
    against JAX's ``_build_multi_step_windowed`` with its draws replayed:
    tables within the envelope, ``err_cnt`` exact, and the per-execution
    ledger keys (``window_*``, ``coalesced_rows_*``, ``wire_bytes``, the
    routed and hot rows) equal to JAX's."""
    sents = corpus(n_sent=60, vocab=120, length=10, seed=11)
    jm, pm = _models(sents, transfer, worker={"inner_steps": 4},
                     cluster={"push_window": 2})
    assert pm.transfer.window_expected_unique \
        == jm.transfer.window_expected_unique > 0
    if transfer == "hybrid":
        assert pm.table.n_hot > 0
    batches = []
    for b in CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                         seed=9).epoch(B):
        if len(b.centers) == B:
            batches.append(b)
        if len(batches) == 4:
            break
    stack = [np.stack([np.asarray(f) for f in fs])
             for fs in zip(*map(_batch_fields, batches))]
    jm.transfer.count_traffic = pm.transfer.count_traffic = True
    key = jax.random.key(42)
    out, es, ec = jm._build_multi_step(4)(
        {f: jnp.asarray(np.asarray(v)) for f, v in jm.table.state.items()},
        jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
        *(jnp.asarray(s) for s in stack), key)
    draws = [_jax_draws(k, len(pm.vocab), pm.draw_shape(B))
             for k in jax.random.split(key, 4)]
    got_es, got_ec = pm._window_group(
        tuple(torch.from_numpy(s) for s in stack), draws)
    assert int(got_ec) == int(ec)
    np.testing.assert_allclose(float(got_es), float(es), rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in out:
        _envelope(got[f], np.asarray(out[f]), f)
    want, have = jm.transfer.traffic(), pm.transfer.traffic()
    for k in ("window_sparse", "window_dense", "window_fmt_sparse",
              "window_fmt_dense", "coalesced_rows_in", "coalesced_rows_out",
              "wire_bytes", "dispatches", "routed_rows", "hot_rows",
              "psum_bytes", "pull_rows", "pull_bytes"):
        assert have.get(k, 0) == want.get(k, 0), (k, have, want)
    assert (have["window_sparse"] + have["window_dense"]
            == (4 if transfer != "xla" else 0))


def test_windowed_train_replays_jax_groups(devices8):
    """``train`` at ``inner_steps: 4``, ``push_window: 2`` on ``tpu`` over
    one epoch with JAX's group keys replayed: the same losses (rtol 1e-4)
    and a table within the envelope."""
    sents = corpus(n_sent=16, vocab=120, length=8, seed=5)   # 128 centers
    jm, pm = _models(sents, "tpu", worker={"inner_steps": 4},
                     cluster={"push_window": 2})
    want = jm.train(sents, niters=2, batch_size=B)
    key, draws = jax.random.key(0 ^ 0x5EED), []
    for _ in range(2 * 2):                  # 8 batches: 2 groups an epoch
        key, sub = jax.random.split(key)
        draws += [_jax_draws(k, len(pm.vocab), pm.draw_shape(B))
                  for k in jax.random.split(sub, 4)]
    got = pm.train(sents, niters=2, batch_size=B, draws=iter(draws))
    assert pm.train_metrics["push_window"] == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


def test_windowed_train_tracks_per_step_train():
    """tests/test_window_push.py::test_w2v_push_window_training_parity on
    the port: three epochs at ``push_window: 2`` stay within 25% of the
    per-step run's losses (the bounded-staleness band), and fall."""
    sents = corpus(n_sent=90, vocab=60, length=12, seed=8)
    runs = []
    for cluster in ({}, {"push_window": 2}):
        _, pc = _confs("xla", worker={"inner_steps": 4}, cluster=cluster)
        m = Word2Vec(config=pc, device="cpu")
        runs.append(m.train(sents, niters=3, batch_size=64))
    base, win = runs
    assert win[-1] < win[0]
    for a, b in zip(win, base):
        assert abs(a - b) / b < 0.25, (win, base)


def test_expected_unique_rows_matches_jax():
    counts = np.maximum((1e6 * np.arange(1, 5001) ** -1.1).astype(np.int64),
                        1)
    for rows in (0, 1, 1000, 40_000, 420_000):
        assert expected_unique_rows(counts, rows) \
            == jax_expected_unique(counts, rows)


def test_push_window_dense_logits_raises():
    """As JAX: a dense (capacity-shaped) family cannot be coalesced."""
    sents = corpus(n_sent=20, vocab=30, length=10, seed=9)
    _, pc = _confs("xla", worker={"inner_steps": 2},
                   cluster={"push_window": 2},
                   word2vec={"dense_logits": "1"})
    m = Word2Vec(config=pc, device="cpu")
    with pytest.raises(ValueError, match="cannot coalesce dense"):
        m.train(sents, niters=1, batch_size=64)


@pytest.mark.parametrize("key,value", [
    ("wire_quant", "int8"), ("pull_quant", "bf16"), ("pull_cache", 64),
    ("wire_sketch", 1), ("collective", "auto")])
def test_a12d_knobs_still_refused(key, value):
    """The wire stack's knobs, refused by earlier slices (ROADMAP A12d),
    arm the transfer (and the table's planes) as JAX's ``Word2Vec`` does
    and train."""
    sents = corpus(n_sent=20, vocab=60, length=10, seed=4)
    _, pc = _confs("tpu", worker={"inner_steps": 2},
                   cluster={"push_window": 2, key: value})
    m = Word2Vec(config=pc, device="cpu")
    losses = m.train(sents, niters=1, batch_size=64)
    assert np.isfinite(losses).all()
    t = m.transfer
    armed = {"wire_quant": t.wire_quant, "pull_quant": t.pull_quant,
             "pull_cache": t.pull_cache, "wire_sketch": int(t.wire_sketch),
             "collective": t.collective_mode}
    assert armed[key] == value
    assert bool(m.table.ef_fields) == (key == "wire_quant")
    assert ("@rowver" in m.table.state) == (key == "pull_cache")


def test_push_window_must_be_positive():
    _, pc = _confs("xla", cluster={"push_window": 0})
    with pytest.raises(ValueError, match="push_window must be >= 1"):
        Word2Vec(config=pc, device="cpu")
