"""The port's pull wire (``[cluster] pull_quant``, ``pull_cache`` and the
``@rowver`` plane) and its delta codec against the JAX package's, on the
CPU, mirroring ``tests/test_delta_pull.py`` and
``tests/test_transfer_delta.py`` (8 ranks on the CPU against the
``devices8`` mesh):

* ``PullCache`` hits, duplicates, conflicts, capacity flushes, the
  oracle's contract;
* the pull pricer's guard, JAX's prices;
* knobs off: pulls bit-identical with or without the ``@rowver`` plane,
  the legacy ledger, on every backend;
* armed: the same pull ledger on ``local``, ``xla`` and ``tpu``, equal to
  JAX's key for key, and the quantized rows bit-equal to JAX's;
* the hybrid's hot rows at 0 bytes, never cached or quantized;
* every push stamps its rows (the oracle catches a forgotten stamp),
  ``grow`` carries the stamps, the sharded stamps are per rank and equal
  JAX's;
* the model arms the knobs; a resume restarts with a cold cache;
* every golden of the delta codec, its payloads equal to JAX's.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.transfer import delta as jax_delta
from swiftmpi_tpu.transfer import plan as jax_plan
from swiftmpi_tpu.transfer.pull_cache import PullCache as JaxPullCache
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher
from swiftmpi_tpu_torch.io.checkpoint import npz_path
from swiftmpi_tpu_torch.io.resilience import train_with_resume
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable
from swiftmpi_tpu_torch.parameter.sparse_table import (ROWVER_KEY,
                                                       has_row_versions)
from swiftmpi_tpu_torch.transfer import plan as port_plan
from swiftmpi_tpu_torch.transfer.api import get_transfer
from swiftmpi_tpu_torch.transfer.delta import (atomic_savez, decode_delta,
                                               delta_wire_bytes,
                                               encode_delta)
from swiftmpi_tpu_torch.transfer.pull_cache import PullCache
from tests.test_torch_collective import hybrid_tables
from tests.test_torch_window import (DIM, JACC, N, PACC, _confs,
                                     _jax_backend, corpus)

#: full_f32 row: the 4-byte key and two DIM-wide float32 fields
FULL_RB = 4 + 2 * DIM * 4
#: int8 row: the key and 2 * (DIM bytes + a 4-byte scale)
Q_RB = 4 + 2 * (DIM + 4)

PULL_KEYS = ("pull_bytes", "pull_rows", "pull_hot_rows", "pull_cache_hits",
             "pull_delta_rows", "pull_bytes_saved", "pull_fmt_full",
             "pull_fmt_bf16", "pull_fmt_q", "plan_compiles",
             "plan_cache_hits")


@pytest.fixture(autouse=True)
def fresh_plan_caches():
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()
    yield
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()


def arm(t, lines=1024, quant="int8"):
    """Count traffic, cache and quantize (``lines`` >= the capacity here,
    so warm hits are exact: no direct-mapped conflicts)."""
    t.count_traffic, t.pull_cache, t.pull_quant = True, lines, quant
    return t


def booked_bytes(n_valid, n_miss, val_bytes):
    """The cached pull's wire model: 8 bytes a valid row, the hit bitmap,
    the encoded values of the missed rows."""
    return 8 * n_valid + (n_valid + 7) // 8 + n_miss * val_bytes


def jax_tables(cap=32, seed=0, rowver=False):
    """A JAX table over ``devices8`` (``tpu``'s layout, whose global
    arrays every backend's state is made from)."""
    ki = JaxKeyIndex(N, cap)
    t = JaxSparseTable(JACC, ki, mesh=jax_ps_mesh(), axis=SHARD_AXIS,
                       seed=seed)
    if rowver:
        t.ensure_row_versions()
    return t, ki


def port_state(name, np_state):
    """The port's state of backend ``name`` from global numpy arrays."""
    if name == "local":
        return {f: v.copy() for f, v in np_state.items()}
    if name == "xla":
        return state_from_jax(np_state, "cpu")
    return state_from_jax(np_state, "cpu", mesh=ps_mesh(N, ["cpu"]))


def jax_state(name, jtable):
    if name == "local":
        return {f: np.asarray(v).copy() for f, v in jtable.state.items()}
    if name == "xla":
        return {f: jnp.asarray(np.asarray(v)) for f, v in jtable.state.items()}
    return jtable.state


def port_backend(name):
    if name in ("tpu", "hybrid"):
        return get_transfer(name, mesh=ps_mesh(N, ["cpu"]))
    return get_transfer(name)


def _np(x):
    return x if isinstance(x, np.ndarray) else (
        state_to_numpy(x) if isinstance(x, dict) else x.numpy())


# -- PullCache ----------------------------------------------------------------

@pytest.mark.parametrize("cls", [PullCache, JaxPullCache])
def test_pull_cache_hits_invalidation_and_duplicates(cls):
    """Direct-mapped hits, a bumped version missing exactly its row and
    refilling, duplicates of an uncached slot missing (then hitting)
    together; the port's cache and JAX's take the same decisions."""
    sh = cls(lines=4)
    slots = np.array([0, 1, 2, -1], np.int64)
    vers = np.zeros(4, np.int64)
    assert not sh.lookup(slots, vers, capacity=16).any() and sh.misses == 3
    np.testing.assert_array_equal(sh.lookup(slots, vers, capacity=16),
                                  [True, True, True, False])
    vers2 = np.array([0, 5, 0, 0], np.int64)
    np.testing.assert_array_equal(sh.lookup(slots, vers2, capacity=16),
                                  [True, False, True, False])
    assert sh.lookup(slots, vers2, capacity=16).sum() == 3
    sh2 = cls(lines=8)
    dup = np.array([5, 5], np.int64)
    assert sh2.lookup(dup, np.zeros(2, np.int64), capacity=16).sum() == 0
    assert sh2.lookup(dup, np.zeros(2, np.int64), capacity=16).sum() == 2


def test_pull_cache_capacity_flush_conflicts_and_oracle():
    sh = PullCache(lines=8)
    v1 = np.zeros(1, np.int64)
    sh.lookup(np.array([3], np.int64), v1, capacity=16)
    assert sh.flushes == 0
    assert not sh.lookup(np.array([3], np.int64), v1, capacity=32).any()
    assert sh.flushes == 1
    sh = PullCache(lines=4)
    sh.lookup(np.array([0], np.int64), v1, capacity=16)
    sh.lookup(np.array([4], np.int64), v1, capacity=16)
    assert not sh.lookup(np.array([0], np.int64), v1, capacity=16).any()
    with pytest.raises(ValueError, match="fresh rows"):
        PullCache(lines=4, store_rows=True).lookup(
            np.array([0], np.int64), v1, capacity=16)
    with pytest.raises(ValueError, match="lines must be > 0"):
        PullCache(lines=0)


def test_pull_pricing_guard_units():
    cases = [(10, 8, "int8", 9, 1.25), (10, FULL_RB, "int8", Q_RB, 1.25),
             (10, FULL_RB, "int8", Q_RB, 3.0),
             (10, FULL_RB, "bf16", 4 + 4 * DIM, 1.25),
             (10, FULL_RB, "off", None, 1.25)]
    for rows, rb, quant, qrb, guard in cases:
        kw = dict(quant=quant, quant_row_bytes=qrb, quant_guard=guard)
        assert port_plan.price_pull_formats(rows, rb, **kw) \
            == jax_plan.price_pull_formats(rows, rb, **kw)
    assert port_plan.price_pull_formats(10, 8, quant="int8",
                                        quant_row_bytes=9) \
        == ("full_f32", {"full_f32": 80.0, "sparse_q": 90.0})
    assert port_plan.price_pull_formats(
        10, FULL_RB, quant="bf16", quant_row_bytes=36)[0] == "bf16"
    assert port_plan.PULL_FORMATS == jax_plan.PULL_FORMATS
    assert port_plan.PULL_QUANT_MODES == jax_plan.PULL_QUANT_MODES
    with pytest.raises(KeyError, match="PULL_ROUTES"):
        port_plan.pull_route("not-a-backend")


def test_compile_pull_plan_matches_jax():
    """Every field of the pull plan and its cache key, JAX's."""
    for quant in ("off", "int8", "bf16"):
        for lines in (0, 64):
            got = []
            for mod, t in ((port_plan, port_backend("local")),
                           (jax_plan, _jax_backend("local"))):
                t.pull_quant, t.pull_cache = quant, lines
                qrb = None if quant == "off" else (
                    Q_RB if quant == "int8" else 4 + 4 * DIM)
                p, hit = mod.compile_pull_plan(t, 64, 256, FULL_RB, qrb)
                assert not hit and mod.compile_pull_plan(
                    t, 64, 256, FULL_RB, qrb)[1]
                got.append(vars(p))
            assert got[0] == got[1], (quant, lines)
    t = port_backend("local")
    t.pull_quant = "fp4"
    with pytest.raises(ValueError, match="pull_quant"):
        port_plan.compile_pull_plan(t, 8, 256, FULL_RB, 20)


# -- knobs off --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_pull_cache_off_bit_identity(name, devices8):
    """Knobs off, a pull from a ``@rowver``-armed state equals one from an
    unarmed state bit for bit, never returns the plane, books the legacy
    ledger (JAX's) and compiles no pull plan."""
    rng = np.random.default_rng(5)
    if name == "hybrid":
        jt0, pt0, keys, _ = hybrid_tables(seed=3)
        plain = state_to_numpy(pt0.state)
        pt0.ensure_row_versions()
        armed, ki = state_to_numpy(pt0.state), pt0.key_index
        slots = np.asarray(ki.lookup(keys[rng.integers(0, 400, 64)]),
                           np.int32)
    else:
        jt0, ki = jax_tables(seed=3)
        plain = {f: np.asarray(v) for f, v in jt0.state.items()}
        jt0.ensure_row_versions()
        armed = {f: np.asarray(v) for f, v in jt0.state.items()}
        slots = np.asarray(ki.lookup(
            rng.integers(0, 10_000, size=64).astype(np.uint64)), np.int32)
    slots[::7] = -1
    t = port_backend(name)
    t.count_traffic = True
    conv = (lambda a: a) if name == "local" else torch.from_numpy
    got = t.pull(port_state(name, armed), conv(slots), PACC)
    want = t.pull(port_state(name, plain), conv(slots), PACC)
    assert ROWVER_KEY not in got
    for f in PACC.pull_fields:
        np.testing.assert_array_equal(_np(got[f]), _np(want[f]), f)
    tr = t.traffic()
    n_valid = int((slots >= 0).sum())
    assert tr["pull_rows"] == 2 * n_valid
    assert tr["pull_bytes"] == (2 * n_valid - tr["pull_hot_rows"]) * FULL_RB
    for k in PULL_KEYS[3:]:
        assert tr[k] == 0, (k, tr)
    jt = _jax_backend(name)
    jt.count_traffic = True
    js = jax_state(name, jt0)
    jt.pull(js, slots, JACC)
    jt.pull(js, slots, JACC)
    assert {k: tr[k] for k in PULL_KEYS} \
        == {k: jt.traffic()[k] for k in PULL_KEYS}


# -- armed: the pull ledger -----------------------------------------------------

def test_cross_backend_pull_ledger_parity(devices8):
    """Armed (cache + int8): cold pull, warm pull (all hits), push,
    re-pull (the pushed rows miss) book the same pull ledger on
    ``local``, ``xla`` and ``tpu``, JAX's key for key; the first pulls'
    quantized rows equal JAX's bit for bit."""
    rng = np.random.default_rng(11)
    kk = rng.integers(0, 10_000, size=48).astype(np.uint64)
    draw = kk[rng.integers(0, 48, size=64)]
    jtable, ki = jax_tables(rowver=True)
    slots = np.asarray(ki.lookup(draw), np.int32)
    slots[::7] = -1
    np_state = {f: np.asarray(v) for f, v in jtable.state.items()}
    n_valid = int((slots >= 0).sum())
    push_slots = slots[:16]
    grads = {f: rng.normal(size=(16, DIM)).astype(np.float32)
             for f in PACC.grad_fields}
    pushed = set(push_slots[push_slots >= 0].tolist())
    n_repull_miss = sum(1 for s in slots if s in pushed)
    assert 0 < n_repull_miss < n_valid
    deltas = {}
    for name in ("local", "xla", "tpu"):
        runs = []
        for side in ("port", "jax"):
            if side == "port":
                t, st = arm(port_backend(name)), port_state(name, np_state)
                conv = (lambda a: a) if name == "local" else torch.from_numpy
            else:
                t = arm(_jax_backend(name))
                st = (jax_state(name, jtable) if name != "tpu" else
                      jax_tables(rowver=True)[0].state)
                conv = (lambda a: a)
            first = t.pull(st, conv(slots), PACC if side == "port" else JACC)
            tr1 = t.traffic()
            t.pull(st, conv(slots), PACC if side == "port" else JACC)
            tr2 = t.traffic()
            st = t.push(st, conv(push_slots),
                        {f: conv(g) for f, g in grads.items()},
                        PACC if side == "port" else JACC)
            t.pull(st, conv(slots), PACC if side == "port" else JACC)
            tr3 = t.traffic()
            assert tr1["pull_bytes"] == booked_bytes(n_valid, n_valid,
                                                     Q_RB - 4), (name, side)
            assert tr1["pull_cache_hits"] == 0 and tr1["pull_fmt_q"] == 1
            assert tr2["pull_cache_hits"] == n_valid
            assert tr2["pull_bytes"] - tr1["pull_bytes"] \
                == booked_bytes(n_valid, 0, Q_RB - 4)
            assert tr3["pull_delta_rows"] - tr2["pull_delta_rows"] \
                == n_repull_miss
            runs.append(({k: tr3[k] for k in PULL_KEYS},
                         {f: _np(first[f]) if side == "port"
                          else np.asarray(first[f]) for f in PACC.pull_fields}))
        assert runs[0][0] == runs[1][0], name
        for f in PACC.pull_fields:
            np.testing.assert_array_equal(runs[0][1][f], runs[1][1][f],
                                          (name, f))
        deltas[name] = runs[0][0]
    assert deltas["local"] == deltas["xla"] == deltas["tpu"]


def test_hybrid_hot_rows_zero_bytes_never_quantized(devices8):
    """The hybrid's hot hits book 0 bytes under ``pull_hot_rows``, never
    enter the cache and come back as the exact replica rows; the tail
    takes the cache and the int8 wire; the ledger equals JAX's."""
    jtable, ptable, keys, _ = hybrid_tables()
    jtable.ensure_row_versions()
    ptable.ensure_row_versions()
    n_hot = ptable.n_hot
    rng = np.random.default_rng(7)
    slots = np.asarray(ptable.key_index.lookup(
        keys[rng.integers(0, 400, 96)]), np.int32)
    slots[::9] = -1
    hot_occ = int(((slots >= 0) & (slots < n_hot)).sum())
    tail_occ = int((slots >= n_hot).sum())
    assert hot_occ > 0 and tail_occ > 0
    t, jt = arm(port_backend("hybrid")), arm(_jax_backend("hybrid"))
    out = t.pull(ptable.state, torch.from_numpy(slots), PACC)
    tr1 = t.traffic()
    t.pull(ptable.state, torch.from_numpy(slots), PACC)
    tr2 = t.traffic()
    jt.pull(jtable.state, slots, JACC)
    jt.pull(jtable.state, slots, JACC)
    assert {k: tr2[k] for k in PULL_KEYS} \
        == {k: jt.traffic()[k] for k in PULL_KEYS}
    assert tr1["pull_rows"] == hot_occ + tail_occ
    assert tr1["pull_hot_rows"] == hot_occ
    assert tr1["pull_bytes"] == booked_bytes(tail_occ, tail_occ, Q_RB - 4)
    assert tr2["pull_cache_hits"] == tail_occ
    hot = (slots >= 0) & (slots < n_hot)
    for f in PACC.pull_fields:
        uni = ptable.unified_rows_host(f)
        got = out[f].numpy()
        np.testing.assert_array_equal(got[hot], uni[slots[hot]], f)
        assert not np.array_equal(got[slots >= n_hot],
                                  uni[slots[slots >= n_hot]])


# -- versions ---------------------------------------------------------------------

def test_version_invalidation_oracle(devices8):
    """The oracle cache checks every hit against the fresh row: honest
    re-pulls after pushes pass, a row changed without a stamp raises."""
    jtable, ki = jax_tables(rowver=True)
    slots = np.asarray(ki.lookup(np.arange(1, 49, dtype=np.uint64)),
                       np.int32)
    slots[::7] = -1
    st = port_state("xla", {f: np.asarray(v) for f, v in
                            jtable.state.items()})
    t = arm(port_backend("xla"), lines=256, quant="off")
    t.pull_cache_oracle = True
    ts = torch.from_numpy(slots)
    t.pull(st, ts, PACC)
    t.pull(st, ts, PACC)
    assert t.traffic()["pull_cache_hits"] == int((slots >= 0).sum())
    rng = np.random.default_rng(2)
    for push_slots in (ts[:12], ts[12:40]):
        grads = {f: torch.from_numpy(rng.normal(
            size=(len(push_slots), DIM)).astype(np.float32))
            for f in PACC.grad_fields}
        t.push(st, push_slots, grads, PACC)
        t.pull(st, ts, PACC)
        t.pull(st, ts, PACC)
    st["h"][int(slots[slots >= 0][-1])] += 1.0
    with pytest.raises(AssertionError, match="did not bump"):
        t.pull(st, ts, PACC)


@pytest.mark.parametrize("path", ["sparse", "dense", "span"])
def test_xla_push_stamps_match_jax(path, devices8):
    """Every ``xla`` push path (sparse, dense, span) stamps the rows it
    applies to with the plane's max + 1, JAX's stamps bit for bit over
    three pushes."""
    jtable, ki = jax_tables(cap=16 if path == "dense" else 32, rowver=True)
    np_state = {f: np.asarray(v) for f, v in jtable.state.items()}
    st, jst = port_state("xla", np_state), jax_state("xla", jtable)
    t, jt = port_backend("xla"), _jax_backend("xla")
    rng = np.random.default_rng(4)
    for _ in range(3):
        n = 80 if path == "dense" else 24
        slots = np.asarray(ki.lookup(rng.integers(0, 60, size=n).astype(
            np.uint64)), np.int32)
        slots[::5] = -1
        grads = {f: rng.normal(size=(n, DIM)).astype(np.float32)
                 for f in PACC.grad_fields}
        if path == "span":
            counts = np.ones(n, np.float32)
            t.push_span(st, torch.from_numpy(slots),
                        {f: torch.from_numpy(g) for f, g in grads.items()},
                        torch.from_numpy(counts), PACC)
            jst = jt.push_span(jst, slots, grads, counts, JACC)
        else:
            t.push(st, torch.from_numpy(slots),
                   {f: torch.from_numpy(g) for f, g in grads.items()}, PACC)
            jst = jt.push(jst, slots, grads, JACC)
    assert t.push_paths[f"h,v:{path}"] == 3
    np.testing.assert_array_equal(st[ROWVER_KEY].numpy(),
                                  np.asarray(jst[ROWVER_KEY]))
    assert st[ROWVER_KEY].max() == 3


def test_rowver_per_rank_stamps_match_jax(devices8):
    """``tpu``: every routed push and the window's dense rung stamp each
    shard's touched rows with that shard's max + 1, JAX's stamps bit for
    bit; a routed ``@rowver`` pull returns them."""
    jtable, ki = jax_tables(cap=16, rowver=True)
    st = port_state("tpu", {f: np.asarray(v) for f, v in
                            jtable.state.items()})
    t, jt = port_backend("tpu"), _jax_backend("tpu")
    for x in (t, jt):
        x.set_wire_dense_ratio(8.0, "window")   # the window densifies
    jst = jtable.state
    rng = np.random.default_rng(6)
    for step in range(4):
        slots = np.asarray(ki.lookup(rng.integers(0, 60, size=64).astype(
            np.uint64)), np.int32)
        slots[::7] = -1
        if step == 1:
            slots[3:] = -1                  # a push that few shards see
        grads = {f: rng.normal(size=(64, DIM)).astype(np.float32)
                 for f in PACC.grad_fields}
        if step < 3:
            t.push(st, torch.from_numpy(slots),
                   {f: torch.from_numpy(g) for f, g in grads.items()}, PACC)
            jst = jt.push(jst, slots, grads, JACC)
        else:
            w = {f: g.reshape(2, 32, DIM) for f, g in grads.items()}
            t.push_window(st, torch.from_numpy(slots.reshape(2, 32)),
                          {f: torch.from_numpy(g) for f, g in w.items()},
                          PACC)
            jst = jt.push_window(jst, slots.reshape(2, 32), w, JACC)
    assert t.push_paths["h,v:window_dense"] == 1
    got = state_to_numpy(st)[ROWVER_KEY]
    want = np.asarray(jst[ROWVER_KEY])
    np.testing.assert_array_equal(got, want)
    per_shard = got.reshape(N, -1).max(axis=1)
    assert len(set(per_shard.tolist())) > 1
    q = np.arange(-1, ki.capacity, 7, dtype=np.int32)
    q = np.concatenate([q, -np.ones((-len(q)) % N, np.int32)])
    pulled = t._prim_pull(st, torch.from_numpy(q), (ROWVER_KEY,))
    np.testing.assert_array_equal(
        pulled[ROWVER_KEY].numpy()[:, 0], np.where(q >= 0, want[q, 0], 0))


def test_rowver_survives_grow_and_cache_flushes(devices8):
    """``grow`` re-strides the stamps with their rows (new rows at 0) and
    carries the ``@ef`` planes too; the cache flushes on the new
    capacity."""
    layout = ps_mesh(N, ["cpu"])
    ki = KeyIndex(N, 32)
    table = SparseTable(PACC, ki, "cpu", mesh=layout)
    table.ensure_row_versions()
    table.ensure_ef(("h",))
    kk = np.arange(1, 41, dtype=np.uint64)
    slots = np.asarray(ki.lookup(kk), np.int32)
    rng = np.random.default_rng(4)
    t = arm(port_backend("tpu"), quant="off")
    ts = torch.from_numpy(slots)
    t.push(table.state, ts, {f: torch.from_numpy(rng.normal(
        size=(40, DIM)).astype(np.float32)) for f in PACC.grad_fields}, PACC)
    for s in table.state["h@ef"]:
        s.fill_(0.5)
    vers0 = table.to_numpy()[ROWVER_KEY].ravel()
    assert (vers0[slots] == 1).all()
    t.pull(table.state, ts, PACC)
    t.pull(table.state, ts, PACC)
    assert t.traffic()["pull_cache_hits"] == 40
    table.grow()
    new_slots = np.asarray(ki.lookup(kk, create=False), np.int32)
    after = table.to_numpy()
    vers1 = after[ROWVER_KEY].ravel()
    assert ki.capacity == 2 * len(vers0)
    assert (vers1[new_slots] == 1).all() and int((vers1 > 0).sum()) == 40
    assert (after["h@ef"][new_slots] == 0.5).all()
    assert int((after["h@ef"] != 0).any(axis=1).sum()) == 40
    tr = t.traffic()
    t.pull(table.state, torch.from_numpy(new_slots), PACC)
    assert t._pull_shadow.flushes == 1
    assert t.traffic()["pull_cache_hits"] == tr["pull_cache_hits"]


def test_pull_quant_envelope_and_encoded_booking(devices8):
    """int8 pulls move each element by at most half a step of its row,
    book the encoded wire, leave the table alone and equal JAX's rows
    bit for bit."""
    jtable, ki = jax_tables()
    slots = np.asarray(ki.lookup(np.arange(1, 49, dtype=np.uint64)),
                       np.int32)
    slots[::7] = -1
    before = {f: np.asarray(v).copy() for f, v in jtable.state.items()}
    st = port_state("xla", before)
    t, jt = port_backend("xla"), _jax_backend("xla")
    for x in (t, jt):
        x.count_traffic, x.pull_quant = True, "int8"
    out = t.pull(st, torch.from_numpy(slots), PACC)
    jout = jt.pull(jax_state("xla", jtable), slots, JACC)
    tr = t.traffic()
    n_valid = int((slots >= 0).sum())
    assert tr["pull_bytes"] == n_valid * Q_RB
    assert tr["pull_rows"] == n_valid and tr["pull_fmt_q"] == 1
    assert tr["pull_cache_hits"] == 0 and tr["pull_bytes_saved"] == 0
    assert {k: tr[k] for k in PULL_KEYS} \
        == {k: jt.traffic()[k] for k in PULL_KEYS}
    safe = np.clip(slots, 0, ki.capacity - 1)
    for f in PACC.pull_fields:
        fresh = before[f][safe] * (slots >= 0)[:, None]
        step = np.abs(fresh).max(axis=-1, keepdims=True) / 127.0
        got = out[f].numpy()
        assert np.all(np.abs(got - fresh) <= 0.5 * step + 1e-6), f
        assert not np.array_equal(got, fresh)
        np.testing.assert_array_equal(got, np.asarray(jout[f]))
        np.testing.assert_array_equal(st[f].numpy(), before[f])


# -- the model ---------------------------------------------------------------------

def test_model_knob_arming_and_default_pytree():
    """Knobs off: no ``@rowver`` plane; armed: the plane exists before any
    step, and the transfer carries the knobs."""
    sents = corpus(n_sent=20, vocab=40, length=10, seed=13)
    _, off_c = _confs("xla")
    off = Word2Vec(config=off_c, device="cpu").build(sents)
    assert not has_row_versions(off.table.state)
    assert off.transfer.pull_quant == "off" and not off.transfer.pull_cache
    _, on_c = _confs("tpu", cluster={"pull_cache": 64, "pull_quant": "int8"})
    on = Word2Vec(config=on_c, device="cpu").build(sents)
    assert has_row_versions(on.table.state)
    assert on.transfer.pull_cache == 64 and on.transfer.pull_quant == "int8"
    for key, bad in (("pull_quant", "fp8"), ("pull_cache", -1)):
        _, c = _confs("xla", cluster={key: bad})
        with pytest.raises(ValueError, match=key):
            Word2Vec(config=c, device="cpu")


def test_resume_restarts_with_cold_cache(tmp_path):
    """A crash with the pull knobs armed resumes from the checkpoint with
    its ``@rowver`` plane and a cold cache, and trains on to finite
    losses."""
    sents = corpus(n_sent=60, vocab=150, length=12, seed=22)
    _, pc = _confs("xla", worker={"inner_steps": 4, "minibatch": 64},
                   cluster={"push_window": 2, "pull_cache": 256,
                            "pull_quant": "int8"})
    m = Word2Vec(config=pc, device="cpu")
    m.build(sents)
    m.transfer.count_traffic = True

    class Flaky:
        def __init__(self, inner):
            self.inner, self.epoch_i = inner, 0

        def epoch(self, batch_size):
            self.epoch_i += 1
            for i, b in enumerate(self.inner.epoch(batch_size)):
                if self.epoch_i == 2 and i == 1:
                    raise RuntimeError("injected crash mid-stream")
                yield b

    ckpt = str(tmp_path / "dpull_ck")
    losses = train_with_resume(m, niters=3, checkpoint_path=ckpt,
                               checkpoint_every=1, max_restarts=2,
                               batcher=Flaky(CBOWBatcher(sents, m.vocab,
                                                         m.window)),
                               batch_size=64)
    assert len(losses) == 2 and np.isfinite(losses).all()
    sh = m.transfer.__dict__.get("_pull_shadow")
    assert sh is not None and sh.flushes >= 1
    with np.load(npz_path(ckpt)) as z:
        assert z["field__" + ROWVER_KEY].dtype == np.int32
        assert z["field__" + ROWVER_KEY].max() > 0
    assert has_row_versions(m.table.state)
    tr = m.transfer.traffic()
    assert tr["pull_cache_hits"] > 0 and tr["pull_fmt_q"] > 0


# -- the delta codec (tests/test_transfer_delta.py) --------------------------------

def _same_payload(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_sparse_golden_bytes_and_lossless_roundtrip():
    keys = np.arange(10, dtype=np.int64)
    vals = np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32)
    enc = encode_delta(keys, vals, capacity=4096, quant="off")
    assert str(np.asarray(enc["format"])) == "sparse"
    assert delta_wire_bytes(enc) == 400
    k, v = decode_delta(enc)
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(v, vals)


def test_sparse_q_golden_bytes_and_bounded_error():
    rng = np.random.default_rng(1)
    keys = np.arange(64, dtype=np.int64)
    vals = rng.normal(size=(64, 16)).astype(np.float32)
    enc = encode_delta(keys, vals, capacity=1 << 20, quant="int8")
    assert str(np.asarray(enc["format"])) == "sparse_q"
    assert delta_wire_bytes(enc) == 64 * 28
    _, v = decode_delta(enc)
    step = np.abs(vals).max(axis=1, keepdims=True) / 127.0
    assert np.all(np.abs(v - vals) <= step * 0.5 + 1e-7)


def test_sparse_q_zero_row_is_safe():
    enc = encode_delta([5], np.zeros((1, 4), np.float32), capacity=1 << 20,
                       quant="int8")
    if str(np.asarray(enc["format"])) == "sparse_q":
        np.testing.assert_array_equal(decode_delta(enc)[1],
                                      np.zeros((1, 4), np.float32))


def test_bitmap_golden_bytes_and_roundtrip():
    cap, d = 1024, 2
    pos = np.arange(256, dtype=np.int64)
    vals = np.random.default_rng(2).normal(size=(256, d)).astype(np.float32)
    enc = encode_delta(pos, vals, capacity=cap, quant="bf16", positions=pos)
    assert str(np.asarray(enc["format"])) == "bitmap"
    assert delta_wire_bytes(enc) == cap // 8 + 256 * d * 4
    k, v = decode_delta(enc)
    np.testing.assert_array_equal(k, pos)
    np.testing.assert_array_equal(v, vals)


def test_bitmap_and_dense_demote_to_sparse():
    keys = np.arange(0, 256, 2, dtype=np.int64)
    enc = encode_delta(keys, np.zeros((len(keys), 8), np.float32),
                       capacity=256, quant="off")
    assert str(np.asarray(enc["format"])) != "bitmap"
    enc = encode_delta(np.arange(64, dtype=np.int64),
                       np.ones((64, 4), np.float32), capacity=64, quant="off")
    assert str(np.asarray(enc["format"])) in ("sparse", "bitmap")


def test_empty_delta_roundtrip():
    enc = encode_delta([], np.zeros((0, 8), np.float32), capacity=256)
    k, v = decode_delta(enc)
    assert len(k) == 0 and v.shape == (0, 8) and delta_wire_bytes(enc) == 0


def test_atomic_savez_replaces_whole_and_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "payload.npz")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    atomic_savez(path, rows=a)
    atomic_savez(path, rows=a * 2)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["rows"], a * 2)
    assert os.listdir(tmp_path) == ["payload.npz"]


@pytest.mark.parametrize("quant", ["off", "int8", "bf16"])
def test_golden_parity_with_jax_codec(quant):
    """The same inputs through both packages' codecs give byte-identical
    payloads and decodes, with and without a position space."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(4096, size=32, replace=False)).astype(np.int64)
    vals = rng.normal(size=(32, 8)).astype(np.float32)
    for kw in ({}, {"positions": keys}):
        a = encode_delta(keys, vals, capacity=4096, quant=quant, **kw)
        b = jax_delta.encode_delta(keys, vals, capacity=4096, quant=quant,
                                   **kw)
        _same_payload(a, b)
        for x, y in zip(decode_delta(a), jax_delta.decode_delta(b)):
            np.testing.assert_array_equal(x, y)
        assert delta_wire_bytes(a) == jax_delta.delta_wire_bytes(b)
