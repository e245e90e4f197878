"""The port's single-device transfer (swiftmpi_tpu_torch/transfer) against
the JAX package's ``XlaTransfer`` on the same table state and slots.

Envelope ``|a - b| <= 1e-5 + 1e-3 * |b|`` (sums of duplicate rows in
another order, then AdaGrad's rsqrt), the repo's parity envelope.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu.parameter.access import w2v_access as jax_w2v_access
from swiftmpi_tpu.transfer.xla import XlaTransfer
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.parameter.access import w2v_access
from swiftmpi_tpu_torch.transfer import SingleTransfer, get_transfer

CAP, D = 300, 16
LR = 0.3


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    st = {f: ((rng.random((CAP, D)) - 0.5) / D).astype(np.float32)
          for f in ("h", "v")}
    for f in ("h2sum", "v2sum"):
        st[f] = np.abs(rng.normal(size=(CAP, D))).astype(np.float32) * 0.1
    return st


def _slots(rng, n):
    """Zipf-duplicated slots with ~10% padding (-1)."""
    slots = (rng.zipf(1.2, n) - 1) % CAP
    slots[rng.random(n) < 0.1] = -1
    return slots.astype(np.int32)


def test_get_transfer_names_xla_only():
    """``xla`` and, with a rank layout, ``tpu`` (held against the JAX
    package in test_torch_sharded.py); the others are not ported."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.transfer import ShardedTransfer
    assert isinstance(get_transfer("xla"), SingleTransfer)
    assert isinstance(get_transfer("tpu", mesh=ps_mesh(2, ["cpu"])),
                      ShardedTransfer)
    for name in ("hybrid", "local"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_transfer(name)


def test_pull_matches_xla():
    """Exact: a pull moves rows; -1 gives zero rows."""
    st = _state(1)
    rng = np.random.default_rng(2)
    slots = _slots(rng, 257)
    want = XlaTransfer().pull({f: jnp.asarray(a) for f, a in st.items()},
                              jnp.asarray(slots), jax_w2v_access(LR, D),
                              fields=("h", "v"))
    got = SingleTransfer().pull(state_from_jax(st, "cpu"),
                                torch.from_numpy(slots), w2v_access(LR, D),
                                fields=("h", "v"))
    assert set(got) == {"h", "v"}
    for f in ("h", "v"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    assert not got["h"].numpy()[slots < 0].any()


# n >= int(CAP / 2.0) = 150 goes dense, below it sparse (xla.py:107)
@pytest.mark.parametrize("n,path", [(149, "sparse"), (150, "dense"),
                                    (40, "sparse"), (600, "dense")])
@pytest.mark.parametrize("families,mean", [(("h",), True), (("v",), True),
                                           (("h", "v"), True),
                                           (("h",), False)])
def test_push_matches_xla(n, path, families, mean):
    st = _state(3)
    rng = np.random.default_rng(n)
    slots = _slots(rng, n)
    grads = {f: rng.normal(size=(n, D)).astype(np.float32) * 0.05
             for f in families}
    want = XlaTransfer().push({f: jnp.asarray(a) for f, a in st.items()},
                              jnp.asarray(slots),
                              {f: jnp.asarray(g) for f, g in grads.items()},
                              jax_w2v_access(LR, D), mean=mean)
    tr = SingleTransfer()
    tstate = state_from_jax(st, "cpu")
    ptrs = {f: t.data_ptr() for f, t in tstate.items()}
    out = tr.push(tstate, torch.from_numpy(slots),
                  {f: torch.from_numpy(g) for f, g in grads.items()},
                  w2v_access(LR, D), mean=mean)
    assert dict(tr.push_paths) == {f"{','.join(families)}:{path}": 1}
    # in place: the push wrote into the state's own tensors
    assert out is tstate
    assert {f: t.data_ptr() for f, t in tstate.items()} == ptrs
    got = state_to_numpy(tstate)
    for f in st:
        _envelope(got[f], np.asarray(want[f]))
    # rows no slot touched are exact no-ops on both paths
    untouched = np.setdiff1d(np.arange(CAP), slots[slots >= 0])
    for f in st:
        np.testing.assert_array_equal(got[f][untouched], st[f][untouched])


@pytest.mark.parametrize("families,mean", [(("h",), True),
                                           (("h", "v"), True),
                                           (("h", "v"), False)])
def test_dense_push_scatters_once_per_family(monkeypatch, families, mean):
    """One scatter-add call per family; a mean push takes its counts from
    the first family's call, so no call sums counts alone."""
    from swiftmpi_tpu_torch.transfer import single
    calls = []
    scatter_add = single.masked_scatter_add

    def counting(*args, **kw):
        calls.append(kw.get("counts", False))
        return scatter_add(*args, **kw)

    monkeypatch.setattr(single, "masked_scatter_add", counting)
    rng = np.random.default_rng(7)
    slots = _slots(rng, 600)
    grads = {f: torch.from_numpy(rng.normal(size=(600, D))
                                 .astype(np.float32)) for f in families}
    tr = SingleTransfer()
    tr.push(state_from_jax(_state(6), "cpu"), torch.from_numpy(slots), grads,
            w2v_access(LR, D), mean=mean)
    assert dict(tr.push_paths) == {f"{','.join(families)}:dense": 1}
    assert calls == [mean] + [False] * (len(families) - 1)


@pytest.mark.parametrize("families,mean", [(("h",), True),
                                           (("h", "v"), True),
                                           (("v",), False)])
def test_span_push_matches_xla(families, mean):
    """``push_span`` against ``XlaTransfer.push_span`` on a span with
    repeated slots and padding: inside the envelope, and every row no
    owner touched bit-unchanged."""
    st = _state(8)
    rng = np.random.default_rng(9)
    S = 120
    slots = _slots(rng, S)
    counts = rng.integers(0, 4, S).astype(np.float32)
    grads = {f: rng.normal(size=(S, D)).astype(np.float32) * 0.05
             for f in families}
    want = XlaTransfer().push_span(
        {f: jnp.asarray(a) for f, a in st.items()}, jnp.asarray(slots),
        {f: jnp.asarray(g) for f, g in grads.items()}, jnp.asarray(counts),
        jax_w2v_access(LR, D), mean=mean)
    tstate = state_from_jax(st, "cpu")
    SingleTransfer().push_span(tstate, torch.from_numpy(slots),
                               {f: torch.from_numpy(g)
                                for f, g in grads.items()},
                               torch.from_numpy(counts), w2v_access(LR, D),
                               mean=mean)
    got = state_to_numpy(tstate)
    untouched = np.setdiff1d(np.arange(CAP), slots[slots >= 0])
    for f in st:
        _envelope(got[f], np.asarray(want[f]))
        np.testing.assert_array_equal(got[f][untouched], st[f][untouched])


@pytest.mark.parametrize("families", [("h",), ("h", "v")])
def test_sparse_and_span_pushes_update_rows_in_place(monkeypatch,
                                                     families):
    """The sparse and span pushes run the row-indexed AdaGrad once per
    family on the table's own tensors (distinct kept slots), with no
    row write-back of their own; the dense mean push hands its divisor
    (one family) or reciprocal (several) to the whole-table apply."""
    from swiftmpi_tpu_torch.kernels import adagrad
    from swiftmpi_tpu_torch.parameter import access
    rows_calls, dense_calls, copies = [], [], []
    inside = [False]
    rows_, dense_ = access.adagrad_update_rows_, access.adagrad_update_
    index_copy = torch.Tensor.index_copy_

    def counting_rows(param, accum, slots, mask, grad, lr, fudge, mul=None):
        kept = slots if mask is None else slots[mask]
        assert kept.unique().numel() == kept.numel()      # distinct slots
        rows_calls.append((param.shape, mask is not None, mul is not None))
        inside[0] = True
        try:
            return rows_(param, accum, slots, mask, grad, lr, fudge,
                         mul=mul)
        finally:
            inside[0] = False

    def counting_dense(param, accum, grad, lr, fudge, mul=None, div=None):
        dense_calls.append((mul is not None, div is not None))
        return dense_(param, accum, grad, lr, fudge, mul=mul, div=div)

    def watched_copy(self, *args):
        if not inside[0]:
            copies.append(self.shape)
        return index_copy(self, *args)

    monkeypatch.setattr(access, "adagrad_update_rows_", counting_rows)
    monkeypatch.setattr(access, "adagrad_update_", counting_dense)
    monkeypatch.setattr(torch.Tensor, "index_copy_", watched_copy)
    assert adagrad.adagrad_update_rows_ is rows_
    rng = np.random.default_rng(10)
    n = 60                                        # < CAP / 2: sparse
    slots = torch.from_numpy(_slots(rng, n))
    grads = {f: torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
             for f in families}
    tr, acc = SingleTransfer(), w2v_access(LR, D)
    tstate = state_from_jax(_state(11), "cpu")
    tr.push(tstate, slots, grads, acc, mean=True)
    tr.push_span(tstate, slots, grads, torch.ones(n), acc, mean=True)
    assert dict(tr.push_paths) == {f"{','.join(families)}:sparse": 1,
                                   f"{','.join(families)}:span": 1}
    assert rows_calls == [((CAP, D), False, True)] * len(families) \
        + [((CAP, D), True, True)] * len(families)
    assert copies == [] and dense_calls == []
    tr.push(tstate, torch.from_numpy(_slots(rng, 600)),
            {f: torch.zeros(600, D) for f in families}, acc, mean=True)
    one = len(families) == 1
    assert dense_calls == [(not one, one)] * len(families)


def test_push_all_padding_is_a_no_op():
    st = _state(4)
    tstate = state_from_jax(st, "cpu")
    slots = torch.full((20,), -1, dtype=torch.int32)
    SingleTransfer().push(tstate, slots, {"h": torch.ones(20, D)},
                          w2v_access(LR, D), mean=True)
    for f, a in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(a, st[f])


def test_convert_round_trip():
    st = _state(5)
    t = state_from_jax(st, "cpu")
    back = state_to_numpy(t)
    for f in st:
        np.testing.assert_array_equal(back[f], st[f])
        assert t[f].is_contiguous() and t[f].dtype == torch.float32
    t["h"] += 1.0                    # copies: the source is untouched
    assert not np.shares_memory(back["h"], st["h"])
    np.testing.assert_array_equal(state_to_numpy(t)["h"], st["h"] + 1.0)
