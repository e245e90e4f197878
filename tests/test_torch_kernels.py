"""The port's kernel modules (swiftmpi_tpu_torch/kernels) against the JAX
package's Pallas kernels and the jnp rules beside them.

On the CPU every wrapper runs its plain PyTorch version, so these tests
hold the plain versions against

* the Pallas kernels in interpret mode (``adagrad_update``,
  ``vmem_gather(method="loop")`` through ``masked_vmem_gather``,
  ``vmem_scatter_add`` through ``masked_vmem_scatter_add``), and
* the jnp rules the JAX default path runs (``AdaGradAccess.apply_push``,
  ``transfer/xla.py::_masked_gather``, the ``.at[].add`` scatter of
  ``_push_dense``),

on the same numpy inputs, and the ring exchange's plain version against
a numpy block transpose and ``pallas_ring.ring_exchange`` in interpret mode
on the 8-device CPU mesh.  The CUDA kernels themselves run only on the
card: ``test_torch_cuda.py`` compares each with its plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from swiftmpi_tpu.ops import pallas_gather
from swiftmpi_tpu.ops import pallas_ring
from swiftmpi_tpu.ops.pallas_kernels import adagrad_update as pallas_adagrad
from swiftmpi_tpu.ops.pallas_scatter import masked_vmem_scatter_add
from swiftmpi_tpu.parameter.access import w2v_access as jax_w2v_access
from swiftmpi_tpu.transfer.xla import _masked_gather
from swiftmpi_tpu.utils import jax_compat  # noqa: F401  (jax.shard_map)
from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.kernels import (adagrad, build, gather, ring,
                                        scatter, stencil)

CAP, D, N = 300, 16, 512


def _slots(rng, n=N, cap=CAP, invalid=0.05, oob=4):
    """int32 slots with ~5% invalid entries (-1) and ``oob`` valid entries
    out of range on either side."""
    slots = rng.integers(0, cap, n).astype(np.int32)
    valid = rng.random(n) >= invalid
    slots[~valid] = -1
    pos = rng.choice(np.flatnonzero(valid), oob, replace=False)
    slots[pos[: oob // 2]] = cap + 7
    slots[pos[oob // 2:]] = -3
    valid[pos[oob // 2:]] = True
    return slots, valid


# -- B1: AdaGrad -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(CAP, D), (7, 3), (513,)])
def test_adagrad_plain_matches_pallas_and_rule(shape):
    """rtol 1e-6: float32 rsqrt on each side (XLA's and PyTorch's CPU
    rsqrt differ in the last bit at most)."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=shape).astype(np.float32)
    a = np.abs(rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    lr = 0.7
    po, ao = pallas_adagrad(jnp.asarray(p), jnp.asarray(a), jnp.asarray(g),
                            lr=lr, interpret=True, block_rows=8)
    rule = jax_w2v_access(lr, shape[-1]).apply_push(
        {"h": jnp.asarray(p), "h2sum": jnp.asarray(a)}, {"h": jnp.asarray(g)})

    tp, ta = torch.from_numpy(p.copy()), torch.from_numpy(a.copy())
    out_p, out_a = adagrad.adagrad_update_(tp, ta, torch.from_numpy(g), lr)
    assert out_p is tp and out_a is ta           # updated in place
    for want_p, want_a in ((po, ao), (rule["h"], rule["h2sum"])):
        np.testing.assert_allclose(ta.numpy(), np.asarray(want_a),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(tp.numpy(), np.asarray(want_p),
                                   rtol=1e-6, atol=1e-7)


def test_adagrad_access_matches_jax_access():
    """The port's AdaGradAccess.apply_push (in place, through the kernel
    module) == the JAX AdaGradAccess rule, rtol 1e-6."""
    from swiftmpi_tpu_torch.parameter.access import w2v_access
    rng = np.random.default_rng(2)
    params = {f: rng.normal(size=(32, D)).astype(np.float32)
              for f in ("h", "v", "h2sum", "v2sum")}
    params["h2sum"] = np.abs(params["h2sum"])
    params["v2sum"] = np.abs(params["v2sum"])
    grads = {"v": rng.normal(size=(32, D)).astype(np.float32)}
    want = jax_w2v_access(0.3, D).apply_push(
        {f: jnp.asarray(x) for f, x in params.items()},
        {f: jnp.asarray(x) for f, x in grads.items()})
    tparams = {f: torch.from_numpy(x.copy()) for f, x in params.items()}
    got = w2v_access(0.3, D).apply_push(
        tparams, {f: torch.from_numpy(x) for f, x in grads.items()})
    assert set(got) == set(want) == {"v", "v2sum"}
    for f in want:
        assert got[f] is tparams[f]
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=1e-6, atol=1e-7)
    # the h family was not pushed: untouched
    np.testing.assert_array_equal(tparams["h"].numpy(), params["h"])


# -- B2: masked gather ---------------------------------------------------------

def test_gather_plain_matches_pallas_loop_and_xla(monkeypatch):
    """Exact: a gather moves bits.  Covers invalid (-1) slots, which give
    zero rows, and valid out-of-range slots, which clip."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(CAP, D)).astype(np.float32)
    slots, valid = _slots(rng)
    monkeypatch.setattr(pallas_gather, "gather_method", lambda: "loop")
    monkeypatch.setattr(pallas_gather, "gather_idx_block", lambda: 128)
    want_pallas = np.asarray(pallas_gather.masked_vmem_gather(
        jnp.asarray(table), jnp.asarray(slots), jnp.asarray(valid)))
    want_xla = np.asarray(_masked_gather(
        jnp.asarray(table), jnp.asarray(slots), jnp.asarray(valid)))
    got = gather.masked_gather(torch.from_numpy(table),
                               torch.from_numpy(slots),
                               torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    assert not got[~valid].any()
    assert got.shape == (N, D)


@pytest.mark.parametrize("R", [1, 3, 8])
def test_gather_ranks_match_pallas_loop_and_xla(monkeypatch, R):
    """The rank form, ``(R, cap, d)`` block and ``(R, N)`` slots: rank r
    equals ``masked_vmem_gather`` (interpret mode) and ``_masked_gather``
    on slice r of the table, bit for bit, with invalid and out-of-range
    slots; also through a block whose rank stride is not ``cap * d`` and
    into ``out``."""
    rng = np.random.default_rng(30 + R)
    cap = 40
    table = rng.normal(size=(R, cap, D)).astype(np.float32)
    pairs = [_slots(rng, n=96, cap=cap) for _ in range(R)]
    slots = np.stack([s for s, _ in pairs])
    valid = np.stack([v for _, v in pairs])
    monkeypatch.setattr(pallas_gather, "gather_method", lambda: "loop")
    monkeypatch.setattr(pallas_gather, "gather_idx_block", lambda: 128)
    got = gather.masked_gather(torch.from_numpy(table),
                               torch.from_numpy(slots),
                               torch.from_numpy(valid)).numpy()
    assert got.shape == (R, 96, D)
    for r in range(R):
        args = (jnp.asarray(table[r]), jnp.asarray(slots[r]),
                jnp.asarray(valid[r]))
        np.testing.assert_array_equal(
            got[r], np.asarray(pallas_gather.masked_vmem_gather(*args)))
        np.testing.assert_array_equal(got[r],
                                      np.asarray(_masked_gather(*args)))
        np.testing.assert_array_equal(
            got[r], gather.masked_gather_plain(
                *(torch.from_numpy(a) for a in (table[r], slots[r],
                                                valid[r]))).numpy())
    assert not got[~valid].any()
    wide = torch.zeros((R, cap + 3, D))
    wide[:, :cap] = torch.from_numpy(table)
    out = torch.full((R, 96, D), 7.0)
    gather.masked_gather(wide[:, :cap], torch.from_numpy(slots),
                         torch.from_numpy(valid), out=out)
    np.testing.assert_array_equal(out.numpy(), got)
    with pytest.raises(ValueError, match="block"):
        gather.masked_gather(torch.from_numpy(table),
                             torch.from_numpy(np.vstack([slots, slots])),
                             torch.from_numpy(np.vstack([valid, valid])))


@pytest.mark.parametrize("R,op", [(None, "mul"), (None, "div"), (3, "mul"),
                                  (3, "div"), (8, "mul")])
def test_adagrad_scaled_matches_scale_then_pallas(R, op):
    """The fused per-row operand: ``a * inv`` (or ``a / div``) and then
    the Pallas ``adagrad_update`` in interpret mode, on a table or a block
    of shards; rtol 1e-6 as the unscaled update."""
    rng = np.random.default_rng(40 + (R or 0))
    shape = (CAP, D) if R is None else (R, CAP // 4, D)
    p = rng.normal(size=shape).astype(np.float32)
    a = np.abs(rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    row = rng.integers(1, 6, shape[:-1]).astype(np.float32)
    s = (1.0 / row).astype(np.float32) if op == "mul" else row
    scaled = g * s[..., None] if op == "mul" else g / row[..., None]
    po, ao = pallas_adagrad(jnp.asarray(p), jnp.asarray(a),
                            jnp.asarray(scaled), lr=0.7, interpret=True,
                            block_rows=8)
    tp, ta = torch.from_numpy(p.copy()), torch.from_numpy(a.copy())
    out_p, out_a = adagrad.adagrad_update_(
        tp, ta, torch.from_numpy(g), 0.7, **{op: torch.from_numpy(s)})
    assert out_p is tp and out_a is ta
    np.testing.assert_allclose(ta.numpy(), np.asarray(ao), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(po), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="not both"):
        adagrad.adagrad_update_(tp, ta, torch.from_numpy(g), 0.7,
                                mul=torch.from_numpy(s),
                                div=torch.from_numpy(s))


@pytest.mark.parametrize("masked,scaled", [(False, False), (True, True)])
def test_adagrad_rows_match_pallas_on_the_rows(masked, scaled):
    """The row-indexed form: the kept rows equal the Pallas update
    (interpret mode) of those rows, rtol 1e-6; every other row, and the
    rows of masked-out or out-of-range slots, is bit-unchanged."""
    rng = np.random.default_rng(50 + masked)
    M = 60
    p = rng.normal(size=(CAP, D)).astype(np.float32)
    a = np.abs(rng.normal(size=(CAP, D))).astype(np.float32)
    slots = rng.permutation(CAP)[:M].astype(np.int32)
    slots[:3] = [CAP, CAP + 5, -2]                  # out of range: skipped
    mask = rng.random(M) < 0.7 if masked else np.ones(M, bool)
    g = rng.normal(size=(M, D)).astype(np.float32)
    inv = (1.0 / rng.integers(1, 6, M)).astype(np.float32)
    keep = mask & (slots >= 0) & (slots < CAP)
    gk = g[keep] * inv[keep][:, None] if scaled else g[keep]
    tgt = slots[keep]
    po, ao = pallas_adagrad(jnp.asarray(p[tgt]), jnp.asarray(a[tgt]),
                            jnp.asarray(gk), lr=0.7, interpret=True,
                            block_rows=8)
    tp, ta = torch.from_numpy(p.copy()), torch.from_numpy(a.copy())
    adagrad.adagrad_update_rows_(
        tp, ta, torch.from_numpy(slots),
        torch.from_numpy(mask) if masked else None, torch.from_numpy(g),
        0.7, mul=torch.from_numpy(inv) if scaled else None)
    np.testing.assert_allclose(ta.numpy()[tgt], np.asarray(ao), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tp.numpy()[tgt], np.asarray(po), rtol=1e-6,
                               atol=1e-7)
    other = np.setdiff1d(np.arange(CAP), tgt)
    np.testing.assert_array_equal(tp.numpy()[other], p[other])
    np.testing.assert_array_equal(ta.numpy()[other], a[other])


# -- B3: masked scatter-add ----------------------------------------------------

@pytest.mark.parametrize("width", [D + 1, 3])
def test_scatter_plain_matches_pallas_and_xla(width):
    """atol 1e-6: the three sum duplicates in different orders.  W = d+1
    is the dense push's fused count column; invalid and out-of-range
    rows land in the dump row and never reach the result."""
    rng = np.random.default_rng(4)
    slots, valid = _slots(rng)
    # Zipf-duplicated slots: the word2vec push's shape
    hot = rng.zipf(1.3, N) % CAP
    slots = np.where(valid & (slots >= 0) & (slots < CAP), hot,
                     slots).astype(np.int32)
    g = rng.normal(size=(N, width)).astype(np.float32)
    want_pallas = np.asarray(masked_vmem_scatter_add(
        jnp.asarray(slots), jnp.asarray(valid), jnp.asarray(g), CAP))
    got = scatter.masked_scatter_add(torch.from_numpy(slots),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(g), CAP).numpy()
    assert got.shape == (CAP, width)
    np.testing.assert_allclose(got, want_pallas, atol=1e-6, rtol=0)

    # _push_dense's jnp scatter routes padding (-1) out of bounds, where
    # it drops; a push never carries a valid out-of-range slot (jnp would
    # wrap a negative one), so that rule is held on the in-range rows
    ok = valid & (slots >= 0) & (slots < CAP)
    in_range = np.where(ok, slots, -1).astype(np.int32)
    safe = jnp.where(jnp.asarray(ok), jnp.asarray(in_range), CAP)
    want_xla = np.asarray(jnp.zeros((CAP, width), jnp.float32).at[safe].add(
        jnp.asarray(g), mode="drop"))
    got_in = scatter.masked_scatter_add(torch.from_numpy(in_range),
                                        torch.from_numpy(ok),
                                        torch.from_numpy(g), CAP).numpy()
    np.testing.assert_allclose(got_in, want_xla, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, got_in, atol=1e-6, rtol=0)
    counts = np.bincount(slots[ok], minlength=CAP)
    if width == D + 1:
        g1 = g.copy()
        g1[:, -1] = 1.0
        got1 = scatter.masked_scatter_add(torch.from_numpy(slots),
                                          torch.from_numpy(valid),
                                          torch.from_numpy(g1), CAP).numpy()
        np.testing.assert_array_equal(got1[:, -1], counts)


@pytest.mark.parametrize("R,width", [(1, D), (3, D), (3, D + 1), (4, 1),
                                     (2, 3)])
def test_scatter_ranks_and_counts_match_pallas_and_numpy(R, width):
    """The rank dimension and the count output: ``(R, N)`` slots and
    ``(R, N, W)`` grads give ``(R, cap, W)`` sums and ``(R, cap)`` counts,
    rank by rank equal to ``masked_vmem_scatter_add`` (interpret mode; rtol
    1e-6, atol 1e-6: duplicates summed in another order) and to
    ``np.add.at``; counts exactly ``np.bincount`` of the rows that land.
    W = 16 is the vector path's shape, W = 17 the scalar one's, W = 1 the
    one-thread-a-row one's."""
    rng = np.random.default_rng(40 + R * width)
    n = 200
    slots = np.empty((R, n), np.int32)
    valid = np.empty((R, n), bool)
    for r in range(R):
        s, v = _slots(rng, n=n)
        hot = rng.zipf(1.3, n) % CAP           # Zipf-duplicated slots
        slots[r] = np.where(v & (s >= 0) & (s < CAP), hot, s)
        valid[r] = v
    g = rng.normal(size=(R, n, width)).astype(np.float32)
    acc, cnt = scatter.masked_scatter_add(
        torch.from_numpy(slots), torch.from_numpy(valid),
        torch.from_numpy(g), CAP, counts=True)
    assert acc.shape == (R, CAP, width) and cnt.shape == (R, CAP)
    assert cnt.dtype == torch.float32
    only = scatter.masked_scatter_add(torch.from_numpy(slots),
                                      torch.from_numpy(valid),
                                      torch.from_numpy(g), CAP)
    torch.testing.assert_close(only, acc, rtol=0, atol=0)
    for r in range(R):
        ok = valid[r] & (slots[r] >= 0) & (slots[r] < CAP)
        want_pallas = np.asarray(masked_vmem_scatter_add(
            jnp.asarray(slots[r]), jnp.asarray(valid[r]), jnp.asarray(g[r]),
            CAP))
        want_np = np.zeros((CAP, width), np.float32)
        np.add.at(want_np, slots[r][ok], g[r][ok])
        for want in (want_pallas, want_np):
            np.testing.assert_allclose(acc[r].numpy(), want, rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(
            cnt[r].numpy(), np.bincount(slots[r][ok], minlength=CAP))
        # the 2-D form of the same rank: the same sums, bit for bit
        a1, c1 = scatter.masked_scatter_add(
            torch.from_numpy(slots[r]), torch.from_numpy(valid[r]),
            torch.from_numpy(g[r]), CAP, counts=True)
        torch.testing.assert_close(a1, acc[r], rtol=0, atol=0)
        torch.testing.assert_close(c1, cnt[r], rtol=0, atol=0)


@pytest.mark.parametrize("counts", [True, False])
def test_scatter_into_out_adds_slices_in_order_as_pallas(counts):
    """``out=``: slices of distinct slots banked one launch each into one
    plane (the error feedback's order over the data axis) give, bit for
    bit, the slices' ``masked_vmem_scatter_add`` planes (interpret mode)
    added in slice order, and the counts the slices' ``np.bincount``s; the
    returned tensors are ``out``'s."""
    rng = np.random.default_rng(44)
    S, n, width = 3, 120, D
    slots = np.stack([rng.permutation(CAP)[:n] for _ in range(S)]) \
        .astype(np.int32)
    valid = rng.random((S, n)) >= 0.1
    slots[:, :3] = -1
    g = rng.normal(size=(S, n, width)).astype(np.float32)
    acc, cnt = torch.zeros(CAP, width), torch.zeros(CAP)
    want, want_cnt = np.zeros((CAP, width), np.float32), np.zeros(CAP)
    for s in range(S):
        got = scatter.masked_scatter_add(
            torch.from_numpy(slots[s]), torch.from_numpy(valid[s]),
            torch.from_numpy(g[s]), CAP, counts=counts,
            out=(acc, cnt) if counts else acc)
        if counts:
            assert got[0] is acc and got[1] is cnt
        else:
            assert got is acc
        want += np.asarray(masked_vmem_scatter_add(
            jnp.asarray(slots[s]), jnp.asarray(valid[s]),
            jnp.asarray(g[s]), CAP))
        ok = valid[s] & (slots[s] >= 0)
        want_cnt += np.bincount(slots[s][ok], minlength=CAP)
    np.testing.assert_array_equal(acc.numpy(), want)
    np.testing.assert_array_equal(cnt.numpy(),
                                  want_cnt if counts else np.zeros(CAP))


def test_scatter_all_padding_gives_zeros():
    """Every row invalid or out of range: zero sums and zero counts."""
    slots = torch.tensor([[-1, CAP, -5, 3]], dtype=torch.int32)
    valid = torch.tensor([[False, True, True, False]])
    acc, cnt = scatter.masked_scatter_add(slots, valid, torch.ones(1, 4, D),
                                          CAP, counts=True)
    assert acc.shape == (1, CAP, D) and not acc.any() and not cnt.any()


# -- width-1 rows at logistic regression's duplication -------------------------

#: the LR push at the a9a shape lands ~930 contributions on each of its
#: ~123 slots; here as many a slot over LR_CAP slots
LR_CAP, LR_DUP = 16, 930


def _lr_slots(rng):
    """``LR_CAP * LR_DUP`` int32 slots, ~930 on each slot, ~5% padding
    (-1, invalid), as ``where(mask, slots, -1)`` gives them."""
    n = LR_CAP * LR_DUP
    slots = rng.integers(0, LR_CAP, n).astype(np.int32)
    valid = rng.random(n) >= 0.05
    slots[~valid] = -1
    return slots, valid


def test_gather_width1_matches_pallas_loop_and_xla(monkeypatch):
    """B2 on a ``(cap, 1)`` table (the LR weight column, the scalar form
    on the card): bit for bit against the Pallas gather in interpret mode
    and the xla rule, padding rows zero."""
    rng = np.random.default_rng(60)
    table = rng.random((LR_CAP, 1)).astype(np.float32)
    slots, valid = _lr_slots(rng)
    monkeypatch.setattr(pallas_gather, "gather_method", lambda: "loop")
    monkeypatch.setattr(pallas_gather, "gather_idx_block", lambda: 128)
    args = (jnp.asarray(table), jnp.asarray(slots), jnp.asarray(valid))
    got = gather.masked_gather(torch.from_numpy(table),
                               torch.from_numpy(slots),
                               torch.from_numpy(valid)).numpy()
    assert got.shape == (len(slots), 1)
    np.testing.assert_array_equal(
        got, np.asarray(pallas_gather.masked_vmem_gather(*args)))
    np.testing.assert_array_equal(got, np.asarray(_masked_gather(*args)))
    assert not got[~valid].any()


def test_scatter_width1_lr_duplication_matches_pallas_and_numpy():
    """B3 at width 1 with its counts, ~930 rows a slot: sums against
    ``masked_vmem_scatter_add`` (interpret mode) and ``np.add.at`` within
    rtol 1e-5, atol 1e-5 (930-term float32 sums in other orders); counts
    exactly ``np.bincount``."""
    rng = np.random.default_rng(61)
    slots, valid = _lr_slots(rng)
    g = rng.normal(size=(len(slots), 1)).astype(np.float32)
    acc, cnt = scatter.masked_scatter_add(
        torch.from_numpy(slots), torch.from_numpy(valid), torch.from_numpy(g),
        LR_CAP, counts=True)
    ok = valid & (slots >= 0)
    want_np = np.zeros((LR_CAP, 1), np.float32)
    np.add.at(want_np, slots[ok], g[ok])
    want_pallas = np.asarray(masked_vmem_scatter_add(
        jnp.asarray(slots), jnp.asarray(valid), jnp.asarray(g), LR_CAP))
    for want in (want_np, want_pallas):
        np.testing.assert_allclose(acc.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(),
                                  np.bincount(slots[ok], minlength=LR_CAP))
    assert cnt.numpy().min() > 800


@pytest.mark.parametrize("form", ["table_div", "rows_mul"])
def test_adagrad_width1_matches_pallas(form):
    """B1 on width-1 rows as LR runs it: the table form with the mean's
    divisor (the dense push) and the row form with its reciprocal (the
    sparse push), against the scaled grad through the Pallas
    ``adagrad_update`` in interpret mode; rtol 1e-6 as the wider forms."""
    rng = np.random.default_rng(62)
    p = rng.random((LR_CAP, 1)).astype(np.float32)
    a = np.abs(rng.normal(size=(LR_CAP, 1))).astype(np.float32)
    cnt = rng.integers(1, 1000, LR_CAP).astype(np.float32)
    tp, ta = torch.from_numpy(p.copy()), torch.from_numpy(a.copy())
    if form == "table_div":
        g = rng.normal(size=(LR_CAP, 1)).astype(np.float32)
        tgt = np.arange(LR_CAP)
        scaled = g / cnt[:, None]
        adagrad.adagrad_update_(tp, ta, torch.from_numpy(g), 0.05,
                                div=torch.from_numpy(cnt))
    else:
        tgt = rng.permutation(LR_CAP)[:10].astype(np.int32)
        g = rng.normal(size=(10, 1)).astype(np.float32)
        inv = (1.0 / cnt[:10]).astype(np.float32)
        scaled = g * inv[:, None]
        adagrad.adagrad_update_rows_(tp, ta, torch.from_numpy(tgt), None,
                                     torch.from_numpy(g), 0.05,
                                     mul=torch.from_numpy(inv))
    po, ao = pallas_adagrad(jnp.asarray(p[tgt]), jnp.asarray(a[tgt]),
                            jnp.asarray(scaled), lr=0.05, interpret=True,
                            block_rows=8)
    np.testing.assert_allclose(ta.numpy()[tgt], np.asarray(ao), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tp.numpy()[tgt], np.asarray(po), rtol=1e-6,
                               atol=1e-7)
    other = np.setdiff1d(np.arange(LR_CAP), tgt)
    np.testing.assert_array_equal(tp.numpy()[other], p[other])


# -- B5: ring exchange -----------------------------------------------------------

def _ring_operands(rng, n, tail, dtype):
    if dtype == np.int32:
        return [rng.integers(-1, 1000, (n, *tail)).astype(np.int32)
                for _ in range(n)]
    return [rng.standard_normal((n, *tail)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("n,tail,dtype", [
    (8, (6, 9), np.float32), (8, (16,), np.int32), (3, (5, 101), np.float32),
    (2, (7,), np.int32), (1, (4, 3), np.float32)])
def test_ring_plain_is_a_block_transpose(n, tail, dtype):
    """Exact: an exchange moves bits.  Block j of rank r's result is block
    r of rank j's operand, i.e. the transpose of the (rank, block) axes."""
    xs = _ring_operands(np.random.default_rng(n), n, tail, dtype)
    want = np.stack(xs).swapaxes(0, 1)
    for fn in (ring.ring_exchange_plain, ring.ring_exchange):
        got = fn([torch.from_numpy(x) for x in xs])
        assert len(got) == n
        for r in range(n):
            assert got[r].dtype == torch.from_numpy(xs[0]).dtype
            np.testing.assert_array_equal(got[r].numpy(), want[r])


@pytest.mark.parametrize("n,tail,dtype", [
    (8, (6, 9), np.float32), (8, (13,), np.int32), (3, (5, 101), np.float32),
    (3, (7,), np.int32), (1, (4, 3), np.float32)])
def test_ring_stacked_form_matches_list_form(n, tail, dtype):
    """The stacked form (the transfer's: one ``(n, n, C, ...)`` tensor in
    and out) against the list form and the numpy transpose, bit for bit,
    also for rank slices that are not adjacent (a bucket slice ``[:, :n]``
    of an ``(n, n + 1, ...)`` tensor)."""
    xs = _ring_operands(np.random.default_rng(20 + n), n, tail, dtype)
    want = np.stack(xs).swapaxes(0, 1)
    wide = torch.zeros((n, n + 1, *tail), dtype=torch.from_numpy(xs[0]).dtype)
    wide[:, :n] = torch.from_numpy(np.stack(xs))
    x = wide[:, :n]
    assert (n == 1 or not x.is_contiguous()) and x[0].is_contiguous()
    listed = ring.ring_exchange([torch.from_numpy(a) for a in xs])
    for fn in (ring.ring_exchange_stacked_plain, ring.ring_exchange_stacked):
        got = fn(x)
        assert got.shape == (n, n, *tail) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
        for r in range(n):
            np.testing.assert_array_equal(got[r].numpy(), listed[r].numpy())


def test_ring_stacked_form_refuses_bad_shapes():
    for fn in (ring.ring_exchange_stacked, ring.ring_exchange_stacked_plain):
        with pytest.raises(ValueError, match=r"\(n, n, \.\.\.\)"):
            fn(torch.zeros((4, 3, 2)))
        with pytest.raises(ValueError, match=r"\(n, n, \.\.\.\)"):
            fn(torch.zeros(3))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_ring_plain_matches_pallas_ring(devices8, dtype):
    """Against the Pallas kernel in interpret mode under ``shard_map`` on
    the 8-device CPU mesh (skips where this jax build cannot discharge
    remote DMAs; the numpy leg above never skips)."""
    mesh = Mesh(np.asarray(devices8), ("x",))
    if not pallas_ring.ring_supported(mesh, "x"):
        pytest.skip("pallas remote-DMA interpret discharge unsupported on "
                    "this jax build")
    n = 8
    xs = _ring_operands(np.random.default_rng(9), n, (6, 9), dtype)
    fn = jax.jit(jax.shard_map(
        lambda b: pallas_ring.ring_exchange(b[0], "x", n)[None], mesh=mesh,
        in_specs=P("x"), out_specs=P("x"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(np.stack(xs))))
    got = ring.ring_exchange([torch.from_numpy(x) for x in xs])
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def test_ring_rejects_wrong_leading_dim():
    bad = [torch.zeros((4, 16)) for _ in range(8)]    # block dim 4 != n = 8
    for fn in (ring.ring_exchange, ring.ring_exchange_plain):
        with pytest.raises(ValueError, match="leading dim"):
            fn(bad)
    with pytest.raises(ValueError, match="one shape and dtype"):
        ring.ring_exchange([torch.zeros((2, 3)), torch.zeros((2, 4))])
    with pytest.raises(ValueError, match="at least one"):
        ring.ring_exchange([])


# -- dispatch ------------------------------------------------------------------

def _forbid_build(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernels.build reached for a CPU tensor")
    for name in ("build_all", "library", "function"):
        monkeypatch.setattr(build, name, boom)


@pytest.mark.parametrize("kernel", ["gather", "scatter", "adagrad",
                                    "stencil", "ring", "gather_ranks",
                                    "adagrad_rows"])
def test_dispatch_takes_plain_path_on_cpu(monkeypatch, kernel):
    """A CPU tensor runs the plain version: no build, no launch count."""
    _forbid_build(monkeypatch)
    kernels.reset_launches()
    rng = np.random.default_rng(5)
    slots, valid = _slots(rng, n=64)
    ts, tv = torch.from_numpy(slots), torch.from_numpy(valid)
    if kernel == "gather":
        t = torch.from_numpy(rng.normal(size=(CAP, D)).astype(np.float32))
        torch.testing.assert_close(gather.masked_gather(t, ts, tv),
                                   gather.masked_gather_plain(t, ts, tv),
                                   rtol=0, atol=0)
    elif kernel == "scatter":
        g = torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))
        torch.testing.assert_close(
            scatter.masked_scatter_add(ts, tv, g, CAP),
            scatter.masked_scatter_add_plain(ts, tv, g, CAP),
            rtol=0, atol=0)
    elif kernel == "stencil":
        t = torch.from_numpy(rng.normal(size=(CAP, D)).astype(np.float32))
        sid = torch.from_numpy((np.arange(64) // 7).astype(np.int32))
        cp = torch.from_numpy(rng.integers(-1, 64, 20))
        half = torch.from_numpy(rng.integers(0, 3, 20).astype(np.int32))
        torch.testing.assert_close(
            stencil.stencil_context_sum(t, ts, sid, cp, half, 2),
            stencil.stencil_context_sum_plain(t, ts, sid, cp, half, 2),
            rtol=0, atol=0)
    elif kernel == "ring":
        xs = [torch.from_numpy(x) for x in _ring_operands(
            rng, 4, (5, 3), np.float32)]
        for got, want in zip(ring.ring_exchange(xs),
                             ring.ring_exchange_plain(xs)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    elif kernel == "gather_ranks":
        t = torch.from_numpy(rng.normal(size=(2, CAP, D)).astype(np.float32))
        s2, v2 = torch.stack([ts, ts.flip(0)]), torch.stack([tv, tv.flip(0)])
        torch.testing.assert_close(gather.masked_gather(t, s2, v2),
                                   gather.masked_gather_plain(t, s2, v2),
                                   rtol=0, atol=0)
    elif kernel == "adagrad_rows":
        p, a = (torch.from_numpy(rng.random((CAP, D)).astype(np.float32))
                for _ in range(2))
        g = torch.from_numpy(rng.random((64, D)).astype(np.float32))
        rows = torch.from_numpy(rng.permutation(CAP)[:64].astype(np.int32))
        p2, a2 = p.clone(), a.clone()
        adagrad.adagrad_update_rows_(p, a, rows, tv, g, 0.5)
        adagrad.adagrad_update_rows_plain_(p2, a2, rows, tv, g, 0.5)
        torch.testing.assert_close(p, p2, rtol=0, atol=0)
        torch.testing.assert_close(a, a2, rtol=0, atol=0)
    else:
        p, a, g = (torch.from_numpy(rng.random((8, D)).astype(np.float32))
                   for _ in range(3))
        p2, a2 = p.clone(), a.clone()
        adagrad.adagrad_update_(p, a, g, 0.5)
        adagrad.adagrad_update_plain_(p2, a2, g, 0.5)
        torch.testing.assert_close(p, p2, rtol=0, atol=0)
        torch.testing.assert_close(a, a2, rtol=0, atol=0)
    assert kernels.launch_counts() == {"gather": 0, "scatter": 0,
                                       "adagrad": 0, "stencil": 0,
                                       "ring": 0}


@pytest.mark.parametrize("kernel", ["gather", "scatter", "adagrad",
                                    "stencil", "ring", "adagrad_rows"])
def test_dispatch_raises_on_other_devices(monkeypatch, kernel):
    """Neither CPU nor CUDA: the wrapper raises; nothing falls back."""
    _forbid_build(monkeypatch)
    meta = torch.empty((4, D), device="meta")
    ms = torch.empty(4, dtype=torch.int32, device="meta")
    mv = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "gather":
            gather.masked_gather(meta, ms, mv)
        elif kernel == "scatter":
            scatter.masked_scatter_add(ms, mv, meta, CAP)
        elif kernel == "stencil":
            stencil.stencil_context_sum(
                meta, ms, ms, torch.empty(4, dtype=torch.int64,
                                          device="meta"), ms, 1)
        elif kernel == "ring":
            ring.ring_exchange([meta] * 4)
        elif kernel == "adagrad_rows":
            adagrad.adagrad_update_rows_(meta, meta, ms, mv, meta, 0.5)
        else:
            adagrad.adagrad_update_(meta, meta, meta, 0.5)


def test_build_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.build_all()


def test_build_digest_tracks_sources():
    """The build directory is keyed by the sources and flags, so a changed
    kernel rebuilds in a fresh directory."""
    d = build.digest()
    assert d == build.digest() and len(d) == 16
    assert build.library_dir().name == d
    assert set(build.SOURCES.values()) == {
        p.name for p in build.CSRC.glob("*.cu")}
