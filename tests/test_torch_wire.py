"""The port's quantized and encoded window wire against the JAX
package's, on the CPU, mirroring ``tests/test_window_push.py`` (the
``sparse_q`` rung, its ``@ef`` error feedback and the ``bitmap`` rung)
and ``tests/test_traffic_plan.py`` (the ``sparse_sketch`` rung and its
codec), 8 ranks on the CPU against the ``devices8`` mesh.

Two kinds of inputs.  **Exact-sum** grads (multiples of 2^-10, small, so
every float32 sum is exact whatever its order) make the port's residual
planes and ledger equal JAX's bit for bit, duplicates included.
**Random** grads on a window of distinct slots: each ``@ef`` element
within one quantum (``max|row| / 127``) of JAX's.  Table fields are held
to the repo's envelope ``|a - b| <= 1e-5 + 1e-3 |b|`` (the two packages'
AdaGrad updates round apart in the last bit); integer ledger keys
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.io.checkpoint import load_checkpoint as jax_load
from swiftmpi_tpu.io.checkpoint import save_checkpoint as jax_save
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import key_index as jax_ki
from swiftmpi_tpu.parameter.access import lr_access as jax_lr_access
from swiftmpi_tpu.transfer import plan as jax_plan
from swiftmpi_tpu.transfer import sketch as jax_sketch
from swiftmpi_tpu.transfer.api import \
    ef_quantize_window as jax_ef_quantize_window
from swiftmpi_tpu.transfer.api import \
    quantize_dequantize as jax_quantize_dequantize
from swiftmpi_tpu.transfer.local import LocalTransfer as JaxLocal
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from swiftmpi_tpu_torch.io.resilience import train_with_resume
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, _batch_fields
from swiftmpi_tpu_torch.data.text import CBOWBatcher
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable
from swiftmpi_tpu_torch.parameter import key_index as port_ki
from swiftmpi_tpu_torch.parameter.access import lr_access
from swiftmpi_tpu_torch.parameter.sparse_table import ef_name
from swiftmpi_tpu_torch.transfer import plan as port_plan
from swiftmpi_tpu_torch.transfer import sketch as port_sketch
from swiftmpi_tpu_torch.transfer.api import (ef_quantize_window,
                                             get_transfer, grad_row_bytes,
                                             quant_grad_row_bytes,
                                             quantize_dequantize)
from swiftmpi_tpu_torch.transfer.local import LocalTransfer
from tests.test_torch_window import (B, DIM, JACC, N, PACC, _confs,
                                     _envelope, _jax_backend, _jax_draws,
                                     _jax_table, _models, _port_push_window,
                                     _sides, corpus, window_batch)

CAP = 1024


@pytest.fixture(autouse=True)
def fresh_plan_caches():
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()
    yield
    jax_plan.clear_plan_cache()
    port_plan.clear_plan_cache()


def exact(rng, shape):
    """Grads whose float32 sums are exact in any order: multiples of
    2^-10 below 1/16."""
    return (rng.integers(-64, 65, size=shape) * 2.0 ** -10).astype(
        np.float32)


def exact_window(ki, rng, W=4, B=64, key_hi=700):
    """``window_batch`` with exact-sum grads and residuals to drain."""
    slots, _, counts = window_batch(ki, rng, W=W, B=B, key_hi=key_hi)
    return slots, {f: exact(rng, (W, B, DIM)) for f in ("h", "v")}, counts


def distinct_window(ki, rng, W=2, B=64):
    """A window whose valid slots are all distinct, random grads."""
    keys = rng.choice(10_000, size=W * B, replace=False).astype(np.uint64)
    slots = np.asarray(ki.lookup(keys), np.int32).reshape(W, B)
    slots[:, ::7] = -1
    grads = {f: rng.normal(size=(W, B, DIM)).astype(np.float32)
             for f in ("h", "v")}
    counts = rng.integers(1, 4, size=(W, B)).astype(np.float32)
    counts[slots < 0] = 0
    return slots, grads, counts


def sketch_window(ki, rng):
    """tests/test_traffic_plan.py's mid-density window (~55 unique rows of
    64 requests over 8,192 slots), where the sketch undercuts both the
    index words and the bitmap."""
    return window_batch(ki, rng, W=4, B=16, key_hi=80)


def _armed_jax_table(residual, rng, exact_sum=True, cap=128):
    """A JAX table with ``@ef`` planes, seeded with residuals to drain."""
    jtable, ki = _jax_table(cap)
    jtable.ensure_ef(("h", "v"))
    if residual:
        st = dict(jtable.state)
        for f in ("h", "v"):
            r = (exact(rng, (ki.capacity, DIM)) if exact_sum
                 else (rng.normal(size=(ki.capacity, DIM)) * 1e-2
                       ).astype(np.float32))
            st[ef_name(f)] = jax.device_put(
                jnp.asarray(r), jtable.state[ef_name(f)].sharding)
        jtable.state = st
    return jtable, ki


def _quantum(state_np, slots, grads):
    """Per slot of a distinct-slot window: one int8 step of the row the
    drain quantizes (``max|g + residual| / 127``), broadcast to ``(cap,
    d)``; 0 on rows the window does not touch."""
    q = {}
    flat = slots.reshape(-1)
    ok = flat >= 0
    for f, g in grads.items():
        tot = g.reshape(-1, DIM)[ok] + state_np[ef_name(f)][flat[ok]]
        plane = np.zeros_like(state_np[ef_name(f)])
        plane[flat[ok]] = np.abs(tot).max(axis=1, keepdims=True) / 127.0
        q[f] = plane
    return q


# -- the 4-way decision and the error feedback --------------------------------

def test_window_wire_format_4way_goldens():
    """tests/test_window_push.py's goldens of the calibrated crossover on
    the port's pricer, each equal to JAX's."""
    cases = [(256, 72, "int8", 32, 1.25, "sparse_q"),
             (256, 72, "int8", None, 1.25, "bitmap"),
             (256, 72, "int8", 32, 2.5, "bitmap"),
             (256, 12, "int8", 13, 1.25, "bitmap"),
             (8, 12, "bf16", 10, 1.25, "sparse"),
             (4 * 16_384, 68, "int8", 1, 1.25, "dense")]
    for rows, rb, quant, qrb, guard, want in cases:
        kw = dict(quant=quant, quant_row_bytes=qrb, quant_guard=guard)
        assert port_ki.window_wire_format(rows, CAP, rb, **kw) == want
        assert jax_ki.window_wire_format(rows, CAP, rb, **kw) == want
    for rows in (8, 100, 4 * 16_384):
        for eu in (None, 16.0, 400.0):
            assert port_ki.window_wire_format(
                rows, CAP, 68, expected_unique=eu, quant="off",
                quant_row_bytes=40) == port_ki.window_wire_format(
                rows, CAP, 68, expected_unique=eu)


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_quantize_dequantize_matches_jax(quant):
    """The value codec on exact rows, random rows, zero rows and halfway
    points, bit for bit."""
    rng = np.random.default_rng(1)
    g = np.concatenate([rng.normal(size=(64, DIM)),
                        exact(rng, (16, DIM)), np.zeros((2, DIM)),
                        np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5,
                                   -127.0]])]).astype(np.float32)
    want = np.asarray(jax_quantize_dequantize(jnp.asarray(g), quant))
    np.testing.assert_array_equal(
        quantize_dequantize(torch.from_numpy(g), quant).numpy(), want)
    np.testing.assert_array_equal(quantize_dequantize(g, quant), want)


@pytest.mark.parametrize("exact_sum", [True, False])
def test_ef_quantize_window_duplicate_owner_identity(exact_sum):
    """Duplicate representatives (the sharded per-rank dedup): the
    residual drains into the first occurrence only, the errors of every
    occurrence bank into the cleared slot; against JAX's
    ``ef_quantize_window`` bit for bit on exact sums, and the per-slot
    identity ``sum(shipped) + residual' == sum(grads) + residual``."""
    cap, d = 16, 4
    rng = np.random.default_rng(6)
    ef0 = (exact(rng, (cap, d)) if exact_sum
           else (rng.normal(size=(cap, d)) * 0.01).astype(np.float32))
    ef0[9] = -0.0                       # an untouched -0.0 keeps its sign
    g = (exact(rng, (4, d)) if exact_sum
         else rng.normal(size=(4, d)).astype(np.float32))
    g[2] = 0.0
    ded = np.array([3, 3, -1, 5], np.int32)
    jst, jg = jax_ef_quantize_window(
        {"h": jnp.zeros((cap, d)), "h@ef": jnp.asarray(ef0)},
        jnp.asarray(ded), {"h": jnp.asarray(g)}, cap, "int8")
    plane = torch.from_numpy(ef0.copy())
    got = ef_quantize_window({"h": plane}, torch.from_numpy(ded),
                             {"h": torch.from_numpy(g)}, cap, "int8")
    deq, ef1 = got["h"].numpy(), plane.numpy()
    assert np.all(deq[2] == 0)
    assert np.signbit(ef1[9]).all()
    np.testing.assert_array_equal(ef1[np.setdiff1d(np.arange(cap), [3, 5])],
                                  ef0[np.setdiff1d(np.arange(cap), [3, 5])])
    for s, rows in ((3, [0, 1]), (5, [3])):
        np.testing.assert_allclose(deq[rows].sum(0) + ef1[s],
                                   g[rows].sum(0) + ef0[s], rtol=1e-5,
                                   atol=1e-6, err_msg=s)
    if exact_sum:
        np.testing.assert_array_equal(ef1, np.asarray(jst["h@ef"]))
        np.testing.assert_array_equal(deq[[0, 1, 3]],
                                      np.asarray(jg["h"])[[0, 1, 3]])
    else:
        np.testing.assert_allclose(ef1, np.asarray(jst["h@ef"]),
                                   atol=np.abs(g).max() / 127 + 1e-7)


def test_ef_drain_exactness_numpy_oracle(devices8):
    """The oracle's ``sparse_q`` pipeline over three windows against a
    numpy simulation and JAX's oracle: banked residuals bit-equal, the
    table the span push of the dequantized sums, the ledger at the
    encoded size and equal to JAX's, and the telescope ``sum(applied) +
    residual == sum(grads)`` closed."""
    jtable, ki = _jax_table()
    jtable.ensure_ef(("h", "v"))
    state = {f: np.asarray(v).copy() for f, v in jtable.state.items()}
    jstate = {f: v.copy() for f, v in state.items()}
    t, jt = LocalTransfer(), JaxLocal()
    for x in (t, jt):
        x.wire_quant, x.count_traffic = "int8", True
    rng = np.random.default_rng(7)
    cap = ki.capacity
    ef_sim = {f: np.zeros((cap, DIM), np.float32) for f in ("h", "v")}
    true_tot = {f: np.zeros((cap, DIM), np.float32) for f in ("h", "v")}
    applied = {f: np.zeros((cap, DIM), np.float32) for f in ("h", "v")}
    want_bytes = 0
    for _ in range(3):
        slots, grads, _ = window_batch(ki, rng, W=2, B=32)
        prev = {f: v.copy() for f, v in state.items()}
        state = t.push_window(state, slots, grads, PACC, mean=False)
        jstate = {f: np.asarray(v) for f, v in jt.push_window(
            jstate, slots, grads, JACC, mean=False).items()}
        flat = slots.reshape(-1)
        valid = flat >= 0
        uniq = np.unique(flat[valid])
        pos = np.searchsorted(uniq, flat[valid])
        deq_sums = {}
        for f in ("h", "v"):
            sums = np.zeros((len(uniq), DIM), np.float32)
            np.add.at(sums, pos, grads[f].reshape(-1, DIM)[valid])
            true_tot[f][uniq] += sums
            tot = sums + ef_sim[f][uniq]
            deq = quantize_dequantize(tot, "int8")
            ef_sim[f][uniq] = tot - deq
            applied[f][uniq] += deq
            deq_sums[f] = deq
            np.testing.assert_array_equal(state[ef_name(f)], ef_sim[f])
            np.testing.assert_array_equal(state[ef_name(f)],
                                          jstate[ef_name(f)])
        csum = np.zeros((len(uniq),), np.float32)
        np.add.at(csum, pos, np.ones(int(valid.sum()), np.float32))
        want = LocalTransfer().push_span(prev, uniq, deq_sums, csum, PACC)
        for f in PACC.fields:
            np.testing.assert_array_equal(state[f], want[f])
            _envelope(state[f], jstate[f], f)
        want_bytes += len(uniq) * quant_grad_row_bytes(
            deq_sums, "int8", with_counts=True)
    assert any(ef_sim[f].any() for f in ("h", "v"))
    for f in ("h", "v"):
        np.testing.assert_allclose(applied[f] + ef_sim[f], true_tot[f],
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    tr = t.traffic()
    assert tr == jt.traffic()
    assert tr["window_fmt_q"] == 3 and tr["window_sparse"] == 3, tr
    assert tr["wire_bytes"] == want_bytes, (tr, want_bytes)


@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_sparse_q_window_matches_jax(name, devices8):
    """One ``sparse_q`` window with mean and span counts on each backend
    against JAX's: on exact-sum grads with duplicates and residuals the
    ``@ef`` planes and the ledger bit for bit; on random grads over
    distinct slots each residual within one quantum; the table within the
    envelope."""
    rng = np.random.default_rng(13)
    for exact_sum in (True, False):
        jtable, ki = _armed_jax_table(True, rng, exact_sum)
        slots, grads, counts = (exact_window(ki, rng, W=2) if exact_sum
                                else distinct_window(ki, rng))
        before = {f: np.asarray(v) for f, v in jtable.state.items()}
        jt, jstate, pt, pstate, conv = _sides(name, jtable)
        for t in (jt, pt):
            t.wire_quant, t.count_traffic = "int8", True
        want = jt.push_window(jstate, slots, grads, JACC, mean=True,
                              counts=counts)
        got = _port_push_window(pt, pstate, conv, slots, grads, True,
                                counts)
        want = {f: np.asarray(v) for f, v in want.items()}
        for f in ("h", "v"):
            if exact_sum:
                np.testing.assert_array_equal(got[ef_name(f)],
                                              want[ef_name(f)], f)
            else:
                q = _quantum(before, slots, grads)[f]
                assert np.all(np.abs(got[ef_name(f)] - want[ef_name(f)])
                              <= q + 1e-7), f
        for f in PACC.fields:
            _envelope(got[f], want[f], (name, f))
        tr = pt.traffic()
        assert tr == jt.traffic(), (name, exact_sum)
        assert tr["window_fmt_q"] == 1 and tr["window_fmt_bitmap"] == 0
        if not exact_sum and name != "local":
            # encoded size: the unique rows at the int8 row
            qrb = quant_grad_row_bytes(
                {f: g.reshape(-1, DIM) for f, g in grads.items()}, "int8",
                with_counts=True)
            assert tr["wire_bytes"] == int((slots >= 0).sum()) * qrb


def test_sparse_q_xla_duplicate_window_matches_oracle(devices8):
    """Repeats across and within steps on ``xla``: the representative
    dedup, one drain and one quantization a slot, as the oracle's
    compacting dedup does; exact sums, so the planes are bit-equal."""
    rng = np.random.default_rng(14)
    jtable, ki = _armed_jax_table(True, rng)
    slots, grads, counts = exact_window(ki, rng, W=2)
    state_np = {f: np.asarray(v).copy() for f, v in jtable.state.items()}
    lo = LocalTransfer()
    lo.wire_quant = "int8"
    want = lo.push_window({f: v.copy() for f, v in state_np.items()},
                          slots, grads, PACC, mean=True, counts=counts)
    x = get_transfer("xla")
    x.wire_quant = "int8"
    pstate = state_from_jax(state_np, "cpu")
    got = _port_push_window(x, pstate, torch.from_numpy, slots, grads, True,
                            counts)
    for f in ("h@ef", "v@ef"):
        np.testing.assert_array_equal(got[f], want[f], f)
    for f in PACC.fields:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["local", "xla", "tpu"])
def test_bitmap_window_parity_and_byte_booking(name, devices8):
    """A width-1 family: an int8 row would be bigger than a bitmap row,
    so the window goes ``bitmap`` (lossless, the mask booked instead of
    the index words): the table equals JAX's within the envelope, the
    ledger key for key, ``256 * 8 + 1024 / 8`` wire bytes."""
    jki = JaxKeyIndex(N, 128)
    jtable = JaxSparseTable(jax_lr_access(0.1), jki, mesh=jax_ps_mesh(),
                            axis=SHARD_AXIS)
    rng = np.random.default_rng(15)
    keys = rng.choice(4000, size=256, replace=False).astype(np.uint64)
    slots = np.asarray(jki.lookup(keys), np.int32).reshape(2, 128)
    grads = {"val": rng.normal(size=(2, 128, 1)).astype(np.float32)}
    jt, jstate, pt, pstate, conv = _sides(name, jtable)
    for t in (jt, pt):
        t.wire_quant, t.count_traffic = "int8", True
    pacc, jacc = lr_access(0.1), jax_lr_access(0.1)
    want = jt.push_window(jstate, slots, grads, jacc, mean=True)
    out = pt.push_window(pstate, conv(slots),
                         {f: conv(g) for f, g in grads.items()}, pacc,
                         mean=True)
    got = out if name == "local" else state_to_numpy(out)
    for f in pacc.fields:
        _envelope(got[f], np.asarray(want[f]), f)
    tr = pt.traffic()
    assert tr == jt.traffic()
    assert tr["window_fmt_bitmap"] == 1 and tr["window_fmt_q"] == 0, tr
    assert tr["wire_bytes"] == 256 * 8 + 1024 // 8, tr
    assert port_plan.FORMAT_TABLE["bitmap"].wire(
        {"val": torch.zeros(3, 1)}, "int8", 1024, False) \
        == jax_plan.FORMAT_TABLE["bitmap"].wire(
            {"val": np.zeros((3, 1), np.float32)}, "int8", 1024, False)


@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_wire_quant_off_bit_identity_all_backends(name, devices8):
    """``wire_quant: off`` with ``@ef`` planes in the state is the
    unquantized path bit for bit: the same table as without the planes,
    the planes untouched, no quantized or bitmap decision booked."""
    jtable, ki = _jax_table()
    slots, grads, _ = window_batch(ki, np.random.default_rng(16), W=2)
    _, _, t0, plain, conv = _sides(name, jtable)
    want = _port_push_window(t0, plain, conv, slots, grads, True)
    jtable.ensure_ef(("h", "v"))
    _, _, t1, armed, conv = _sides(name, jtable)
    t1.wire_quant, t1.count_traffic = "off", True
    got = _port_push_window(t1, armed, conv, slots, grads, True)
    for f in PACC.fields:
        np.testing.assert_array_equal(got[f], want[f], (name, f))
    for f in ("h@ef", "v@ef"):
        assert not got[f].any()
    tr = t1.traffic()
    assert tr["window_fmt_q"] == 0 and tr["window_fmt_bitmap"] == 0, tr
    assert tr["window_fmt_dense"] + tr["window_fmt_sparse"] \
        == (1 if name in ("tpu", "hybrid") else 0)


@pytest.mark.parametrize("transfer", ["xla", "tpu"])
def test_sparse_q_windowed_group_matches_jax(transfer, devices8):
    """A word2vec group (``inner_steps: 4``, ``push_window: 2``,
    ``wire_quant: int8``) with JAX's draws replayed: ``sparse_q`` engaged
    on both sides, the tables within the envelope, each residual within
    one int8 step of its grad sum, the decisions and encoded bytes equal
    to JAX's."""
    sents = corpus(n_sent=60, vocab=120, length=10, seed=11)
    jm, pm = _models(sents, transfer, worker={"inner_steps": 4},
                     cluster={"push_window": 2, "wire_quant": "int8"})
    assert sorted(pm.table.ef_fields) == sorted(jm.table.ef_fields) \
        == ["h@ef", "v@ef"]
    assert pm.transfer.wire_quant == "int8"
    batches = [b for b in CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                      seed=9).epoch(B)
               if len(b.centers) == B][:4]
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
    np.testing.assert_allclose(float(got_es), float(es), rtol=1e-4)
    got = state_to_numpy(pm.table.state)
    for f in PACC.fields:
        _envelope(got[f], np.asarray(out[f]), f)
    for f in ("h@ef", "v@ef"):
        w = np.asarray(out[f])
        assert w.any()
        np.testing.assert_allclose(got[f], w, atol=np.abs(w).max() * 2 + 1e-6)
    want, have = jm.transfer.traffic(), pm.transfer.traffic()
    for k in ("window_fmt_q", "window_sparse", "window_dense",
              "coalesced_rows_in", "coalesced_rows_out", "wire_bytes",
              "dispatches", "pull_rows", "pull_bytes"):
        assert have[k] == want[k], (k, have, want)
    assert have["window_fmt_q"] > 0


def test_w2v_sparse_q_train_tracks_lossless(devices8):
    """tests/test_window_push.py::test_w2v_sparse_q_trajectory_parity at
    a small size: three epochs with ``wire_quant: int8`` stay within the
    envelope of the lossless window's losses, every window ``sparse_q``
    at the encoded 28-byte row."""
    sents = corpus(n_sent=160, vocab=1500, length=12, seed=21)
    runs = {}
    for quant in ("off", "int8"):
        _, pc = _confs("xla", worker={"inner_steps": 4},
                       cluster={"push_window": 2, "wire_quant": quant})
        m = Word2Vec(config=pc, device="cpu", seed=3)
        m.build(sents)
        m.transfer.count_traffic = True
        runs[quant] = (m.train(sents, niters=3, batch_size=64),
                       m.transfer.traffic())
    (base, _), (q, tr) = runs["off"], runs["int8"]
    assert q[-1] < q[0]
    for a, b in zip(q, base):
        assert abs(a - b) <= 1e-5 + 1e-3 * abs(b), (q, base)
    assert tr["window_fmt_q"] > 0
    assert tr["window_fmt_q"] == tr["window_sparse"] + tr["window_dense"]
    assert runs["off"][1]["window_fmt_q"] == 0
    assert tr["wire_bytes"] < runs["off"][1]["wire_bytes"]


def test_checkpoint_carries_ef_planes_both_ways(tmp_path, devices8):
    """``@ef`` planes through the npz both ways bit for bit; an arming
    mismatch between checkpoint and table raises in either direction, as
    in JAX."""
    rng = np.random.default_rng(18)
    jtable, jki = _armed_jax_table(True, rng, exact_sum=False)
    layout = ps_mesh(N, ["cpu"])
    ki = KeyIndex(N, 128)
    table = SparseTable(PACC, ki, "cpu", mesh=layout)
    table.ensure_ef(("h", "v"))
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    jax_save(jtable, jpath)
    load_checkpoint(table, jpath)
    got = table.to_numpy()
    for f, a in jtable.state.items():
        np.testing.assert_array_equal(got[f], np.asarray(a), f)
    save_checkpoint(table, ppath)
    back, _ = _jax_table()
    back.ensure_ef(("h", "v"))
    jax_load(back, ppath)
    for f, a in back.state.items():
        np.testing.assert_array_equal(np.asarray(a), got[f], f)
    plain = SparseTable(PACC, KeyIndex(N, 128), "cpu", mesh=layout)
    with pytest.raises(ValueError, match="wire_quant"):
        load_checkpoint(plain, jpath)
    armed = SparseTable(PACC, KeyIndex(N, 128), "cpu", mesh=layout)
    armed.ensure_ef(("h",))
    with pytest.raises(ValueError, match="wire_quant"):
        load_checkpoint(armed, jpath)


def test_resume_mid_window_preserves_ef(tmp_path):
    """A crash mid-epoch with ``wire_quant`` armed resumes from the
    checkpoint with its ``@ef`` planes, bit for bit, and trains on to
    finite losses."""
    sents = corpus(n_sent=60, vocab=150, length=12, seed=22)
    _, pc = _confs("xla", worker={"inner_steps": 4, "minibatch": 64},
                   cluster={"push_window": 2, "wire_quant": "int8"})
    m = Word2Vec(config=pc, device="cpu")
    m.build(sents)
    assert sorted(m.table.ef_fields) == ["h@ef", "v@ef"]

    class Flaky:
        def __init__(self, inner):
            self.inner, self.epoch_i = inner, 0

        def epoch(self, batch_size):
            self.epoch_i += 1
            for i, b in enumerate(self.inner.epoch(batch_size)):
                if self.epoch_i == 2 and i == 1:
                    raise RuntimeError("injected crash mid-stream")
                yield b

    seen = {}
    real_resume = m.resume

    def resume(path):
        it = real_resume(path)
        seen["ef"] = {f: m.table.to_numpy()[f].copy() for f in
                      ("h@ef", "v@ef")}
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            seen["saved"] = {f: z["field__" + f] for f in ("h@ef", "v@ef")}
        return it
    m.resume = resume
    ckpt = str(tmp_path / "qck")
    losses = train_with_resume(m, niters=3, checkpoint_path=ckpt,
                               checkpoint_every=1, max_restarts=2,
                               batcher=Flaky(CBOWBatcher(sents, m.vocab,
                                                         m.window)),
                               batch_size=64)
    assert len(losses) == 2 and np.isfinite(losses).all()
    for f in ("h@ef", "v@ef"):
        assert seen["saved"][f].any()
        np.testing.assert_array_equal(seen["ef"][f], seen["saved"][f])
    assert sorted(m.table.ef_fields) == ["h@ef", "v@ef"]


# -- the sketch rung (tests/test_traffic_plan.py) -------------------------------

def test_spec_wire_model_matches_pricer_and_codec():
    """The pricer's volume, ``WireFormatSpec.wire`` and the codec's
    length agree, and equal JAX's."""
    rng = np.random.default_rng(3)
    rows = 64
    slots = rng.choice(CAP, size=rows, replace=False)
    grads = {f: rng.normal(size=(rows, DIM)).astype(np.float32)
             for f in ("h", "v")}
    tg = {f: torch.from_numpy(g) for f, g in grads.items()}
    rb = grad_row_bytes(tg, with_counts=True)
    _, prices = port_ki.price_window_formats(
        rows, CAP, rb, expected_unique=float(rows), sketch=True)
    for fmt in ("sparse_sketch", "bitmap"):
        row, base = port_plan.FORMAT_TABLE[fmt].wire(tg, "off", CAP, True)
        assert base + rows * row == prices[fmt]
        assert (row, base) == jax_plan.FORMAT_TABLE[fmt].wire(
            grads, "off", CAP, True)
    for quant in ("int8", "bf16"):
        assert port_plan.FORMAT_TABLE["sparse_q"].wire(tg, quant, CAP,
                                                       True) \
            == jax_plan.FORMAT_TABLE["sparse_q"].wire(grads, quant, CAP,
                                                      True)
    assert port_plan.FORMAT_TABLE["dense"].wire(tg, "off", CAP, True) is None
    vals = {**grads, "counts": np.ones((rows, 1), np.float32)}
    payload = port_sketch.encode(slots, vals, CAP)
    assert payload == jax_sketch.encode(slots, vals, CAP)
    assert len(payload) == prices["sparse_sketch"] \
        == port_sketch.sketch_wire_bytes(CAP, rows, rb - 4)


def test_sketch_index_roundtrip_exact():
    rng = np.random.default_rng(0)
    for cap in (256, 300, 1024, 100_000):
        for n in (0, 1, 7, min(cap, 500)):
            slots = rng.choice(cap, size=n, replace=False)
            counts, offsets = port_sketch.encode_index(slots, cap)
            assert counts.dtype == np.uint16 and offsets.dtype == np.uint8
            jc, jo = jax_sketch.encode_index(slots, cap)
            np.testing.assert_array_equal(counts, jc)
            np.testing.assert_array_equal(offsets, jo)
            np.testing.assert_array_equal(
                port_sketch.decode_index(counts, offsets), np.sort(slots))
    counts, offsets = port_sketch.encode_index(
        np.array([-1, 0, 255, 256, 511, 1023, -1]), 1024)
    np.testing.assert_array_equal(port_sketch.decode_index(counts, offsets),
                                  [0, 255, 256, 511, 1023])
    counts, _ = port_sketch.encode_index(np.arange(256), 1024)
    assert int(counts[0]) == 256


def test_sketch_codec_error_cases():
    with pytest.raises(ValueError, match="out of range"):
        port_sketch.encode_index([1024], 1024)
    with pytest.raises(ValueError, match="distinct"):
        port_sketch.encode_index([3, 3], 1024)
    counts, offsets = port_sketch.encode_index([1, 2], 1024)
    with pytest.raises(ValueError, match="mismatch"):
        port_sketch.decode_index(counts, offsets[:1])
    payload = port_sketch.encode([1, 2],
                                 {"g": np.zeros((2, DIM), np.float32)}, 1024)
    with pytest.raises(ValueError, match="trailing"):
        port_sketch.decode(payload + b"x", 1024,
                           {"g": (DIM, np.dtype(np.float32))})


def test_sketch_payload_roundtrip_values_follow_slots():
    rng = np.random.default_rng(7)
    slots = rng.choice(CAP, size=90, replace=False)
    vals = {"h": rng.normal(size=(90, DIM)).astype(np.float32),
            "n": rng.normal(size=(90, 1)).astype(np.float32)}
    meta = {f: (v.shape[1], v.dtype) for f, v in vals.items()}
    got_slots, got = port_sketch.decode(port_sketch.encode(slots, vals, CAP),
                                        CAP, meta)
    order = np.argsort(slots)
    np.testing.assert_array_equal(got_slots, slots[order])
    for f, v in vals.items():
        np.testing.assert_array_equal(got[f], v[order])
    jslots, jgot = jax_sketch.decode(jax_sketch.encode(slots, vals, CAP),
                                     CAP, meta)
    np.testing.assert_array_equal(jslots, got_slots)


def test_compile_plan_sketch_route_and_taps():
    """The sketch plan, its cache hit and its live re-pricing, field for
    field against JAX's."""
    plans = {}
    for mod, t in ((port_plan, LocalTransfer()), (jax_plan, JaxLocal())):
        t.wire_sketch = True
        p, hit = mod.compile_window_plan(t, 64, CAP, 72, None, True)
        assert not hit and p.wire_format == "sparse_sketch"
        assert p.dedup == "backend" and not p.ef
        assert p.taps == ("decision", "coalesce", "keys")
        assert mod.compile_window_plan(t, 64, CAP, 72, None, True)[1]
        t.window_expected_unique = 8.0
        p2, hit2 = mod.compile_window_plan(t, 256, 100_000, 72, None, True)
        assert not hit2 and p2.wire_format == "sparse"
        plans[mod] = (p, p2)
    for a, b in zip(plans[port_plan], plans[jax_plan]):
        assert {k: v for k, v in vars(a).items()} \
            == {k: v for k, v in vars(b).items()}


@pytest.mark.parametrize("name", ["local", "xla", "tpu", "hybrid"])
def test_sketch_armed_state_bit_identical_all_backends(name, devices8):
    """``wire_sketch`` changes what is booked, not what is applied: the
    armed window's table equals the unarmed one's bit for bit, and two
    windows compile once and hit the cache once."""
    jtable, ki = _jax_table(CAP)
    rng = np.random.default_rng(11)
    slots, grads, counts = sketch_window(ki, rng)
    _, _, off, s_off, conv = _sides(name, jtable)
    _, _, arm, s_arm, _ = _sides(name, jtable)
    arm.wire_sketch, arm.count_traffic = True, True
    got_off = _port_push_window(off, s_off, conv, slots, grads, True, counts)
    got_arm = _port_push_window(arm, s_arm, conv, slots, grads, True, counts)
    for f in PACC.fields:
        np.testing.assert_array_equal(got_off[f], got_arm[f], (name, f))
    slots2, grads2, counts2 = sketch_window(ki, rng)
    _port_push_window(arm, s_arm, conv, slots2, grads2, True, counts2)
    tr = arm.traffic()
    assert tr["window_fmt_sketch"] == 2, (name, tr)
    assert tr["plan_compiles"] == 1 and tr["plan_cache_hits"] == 1, tr
    assert tr["coalesced_rows_in"] >= tr["coalesced_rows_out"] > 0


def test_sketch_ledger_local_xla_match_jax(devices8):
    """The oracle and ``xla`` book the same ledger, JAX's, at the codec's
    byte model: the sketch base plus the unique rows at offset + values +
    counts."""
    jtable, ki = _jax_table(CAP)
    rng = np.random.default_rng(11)
    slots, grads, counts = sketch_window(ki, rng)
    uniq = np.unique(slots[slots >= 0]).size
    ledgers = {}
    for name in ("local", "xla"):
        jt, jstate, pt, pstate, conv = _sides(name, jtable)
        for t in (jt, pt):
            t.wire_sketch, t.count_traffic = True, True
        jt.push_window(jstate, slots, grads, JACC, mean=True, counts=counts)
        _port_push_window(pt, pstate, conv, slots, grads, True, counts)
        ledgers[name] = pt.traffic()
        assert ledgers[name] == jt.traffic(), name
    row = 2 * DIM * 4 + 4 + port_sketch.OFFSET_BYTES
    assert ledgers["local"]["wire_bytes"] \
        == port_sketch.sketch_base_bytes(ki.capacity) + uniq * row
    assert ledgers["local"] == ledgers["xla"]
    assert ledgers["local"]["coalesced_rows_out"] == uniq


def test_hybrid_wire_knobs_forward_to_tail(devices8):
    h = get_transfer("hybrid", mesh=ps_mesh(N, ["cpu"]))
    assert h.wire_sketch is False and h.wire_quant == "off"
    h.wire_sketch, h.wire_quant = True, "bf16"
    assert h.tail.wire_sketch is True and h.tail.wire_quant == "bf16"
    jh = _jax_backend("hybrid")
    jh.wire_sketch = True
    assert jh.tail.wire_sketch is True
