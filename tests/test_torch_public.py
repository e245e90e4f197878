"""The JAX package's public names that the port gained last, each against
its JAX counterpart on the same seeded numpy inputs, on the CPU.

Tolerances: bit for bit for the hashes, ``lr_formatter``/``lr_parser``,
the prefetch epochs, ``Vocab.index``, ``num_rows``/``rows_as_numpy``, the
transfers' metrics gauges, the exchanges (``reduce_scatter`` and
``pmean`` over 2 processes, ``rank_reduce_scatter``: sums of two parts,
or copies) and ``SGDAccess`` on one shard (``xla``, ``local``) with
exact-sum grads; the repo envelope ``|a - b| <= 1e-5 + 1e-3 |b|`` for
``SGDAccess`` through ``tpu`` and ``hybrid`` (n = 8) and for gradients.
``sample_alias`` cannot replay ``jax.random``: its draws are held bit for
bit to the ``*_from_draws`` forms on the same generator (those equal
JAX's on JAX's own ``(j, u)``), and their distribution by chi-squared
against the alias table's probabilities.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.cluster.mesh import MODEL_AXIS as JAX_MODEL_AXIS
from swiftmpi_tpu.data.text import CBOWBatcher as JaxBatcher
from swiftmpi_tpu.data.text import build_vocab as jax_build_vocab
from swiftmpi_tpu.models import logistic as jlogistic
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.ops import sampling as jsampling
from swiftmpi_tpu.parallel import collectives as jcoll
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import access as jaccess
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.transfer.hybrid import HybridTransfer as JaxHybrid
from swiftmpi_tpu.transfer.local import LocalTransfer as JaxLocal
from swiftmpi_tpu.transfer.tpu import TpuTransfer
from swiftmpi_tpu.transfer.xla import XlaTransfer
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu.utils import hashing as jhashing
from swiftmpi_tpu.utils.timers import Metrics as JaxMetrics
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.cluster.mesh import MODEL_AXIS
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher, build_vocab
from swiftmpi_tpu_torch.models import logistic
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.obs.numerics import NumericsCollector
from swiftmpi_tpu_torch.ops import sampling
from swiftmpi_tpu_torch.parallel import rank_reduce_scatter
from swiftmpi_tpu_torch.parameter import (FieldSpec, KeyIndex, SGDAccess,
                                          SparseTable, lr_access,
                                          w2v_access)
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
from swiftmpi_tpu_torch.parameter.sparse_table import hot_name
from swiftmpi_tpu_torch.transfer import (ShardedTransfer, SingleTransfer,
                                         get_transfer)
from swiftmpi_tpu_torch.transfer.hybrid import HybridTransfer
from swiftmpi_tpu_torch.transfer.local import LocalTransfer
from swiftmpi_tpu_torch.utils import ConfigParser
from swiftmpi_tpu_torch.utils import hashing
from swiftmpi_tpu_torch.utils.timers import Metrics

ROOT = Path(__file__).resolve().parents[1]
ENVELOPE = dict(rtol=1e-3, atol=1e-5)
N, D, LR = 8, 8, 0.3


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


# -- utils/hashing.py ----------------------------------------------------------

def test_get_hash_code_matches_jax():
    rng = np.random.default_rng(0)
    keys = [int(k) for k in rng.integers(0, 2 ** 63, 200, dtype=np.uint64)]
    keys += [0, 1, 2 ** 64 - 1, 2 ** 64, -1, 2 ** 70 + 5]
    for k in keys:
        assert hashing.get_hash_code(k) == jhashing.get_hash_code(k), k
    arr = np.array([k & (2 ** 64 - 1) for k in keys], np.uint64)
    np.testing.assert_array_equal(
        [hashing.get_hash_code(int(k)) for k in arr],
        hashing.get_hash_code_np(arr))


@pytest.mark.parametrize("seed,bits", [(13131, 32), (13131, 64), (131, 32)])
def test_bkdr_hash_batch_matches_jax(seed, bits):
    words = ["", "a", "the", "anarchism", "café", "中文",
             "x" * 300, "12345", "-7"]
    got = hashing.bkdr_hash_batch(words, seed, bits)
    want = jhashing.bkdr_hash_batch(words, seed, bits)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert [hashing.bkdr_hash(w, seed, bits) for w in words] == \
        [jhashing.bkdr_hash(w, seed, bits) for w in words]


# -- ops/sampling.py -----------------------------------------------------------

def _alias(V=40, seed=0):
    counts = np.random.default_rng(seed).zipf(1.3, V).astype(np.int64) + 1
    prob, alias = sampling.build_unigram_alias(counts)
    return counts, torch.from_numpy(prob), torch.from_numpy(alias)


def test_sample_alias_is_its_draws_resolved():
    """``sample_alias(g, ...)`` and ``sample_alias_slots`` equal, bit for
    bit, the ``*_from_draws`` forms on ``alias_draws`` from a generator
    seeded alike."""
    _, prob, alias = _alias()
    slot_of_vocab = torch.from_numpy(
        np.random.default_rng(1).permutation(60)[:40].astype(np.int32))
    shape = (64, 5)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = sampling.sample_alias(g1, prob, alias, shape)
    want = sampling.sample_alias_from_draws(
        *sampling.alias_draws(g2, 40, shape), prob, alias)
    assert torch.equal(got, want) and got.shape == shape
    negs, slots = sampling.sample_alias_slots(g1, prob, alias,
                                              slot_of_vocab, shape)
    wn, ws = sampling.sample_alias_slots_from_draws(
        *sampling.alias_draws(g2, 40, shape), prob, alias, slot_of_vocab)
    assert torch.equal(negs, wn) and torch.equal(slots, ws)
    assert torch.equal(slots, slot_of_vocab[negs])


def test_sample_alias_from_jax_draws_equals_jax():
    """Fed the ``(j, u)`` JAX derives from its key, the port resolves the
    same indices as JAX's ``sample_alias``."""
    _, prob, alias = _alias(seed=3)
    key, shape = jax.random.key(5), (128, 7)
    k1, k2 = jax.random.split(key)
    j = np.array(jax.random.randint(k1, shape, 0, 40))
    u = np.array(jax.random.uniform(k2, shape))
    want = jsampling.sample_alias(key, jnp.asarray(prob.numpy()),
                                  jnp.asarray(alias.numpy()), shape)
    got = sampling.sample_alias_from_draws(torch.from_numpy(j),
                                           torch.from_numpy(u), prob, alias)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_alias_follows_the_unigram_distribution():
    """Chi-squared of 400,000 draws against the alias table's
    probabilities (counts^0.75, normalized), 39 degrees of freedom: below
    its 0.999 quantile, 72.05."""
    counts, prob, alias = _alias()
    n = 400_000
    draws = sampling.sample_alias(torch.Generator().manual_seed(2), prob,
                                  alias, (n,))
    seen = np.bincount(draws.numpy(), minlength=40)
    p = counts.astype(np.float64) ** 0.75
    expect = n * p / p.sum()
    chi2 = float(((seen - expect) ** 2 / expect).sum())
    assert chi2 < 72.05, chi2


# -- parameter/access.py: SGDAccess through every transfer ---------------------

def _sgd(dtype=torch.float32):
    return SGDAccess(LR, {"h": FieldSpec(D, dtype=dtype),
                          "v": FieldSpec(D, dtype=dtype)},
                     ("h", "v"), ("h", "v"))


def _jsgd(dtype=jnp.float32):
    return jaccess.SGDAccess(LR, {"h": jaccess.FieldSpec(D, dtype=dtype),
                                  "v": jaccess.FieldSpec(D, dtype=dtype)},
                             ("h", "v"), ("h", "v"))


def _exact_grads(rng, n, families=("h", "v")):
    """Multiples of 2^-10 below 1/16: every sum of them is exact, so any
    summation order gives the same bits."""
    return {f: (rng.integers(-64, 64, size=(n, D)) / 1024.0)
            .astype(np.float32) for f in families}


def test_sgd_access_schema_and_touched_fields():
    acc, jacc = _sgd(), _jsgd()
    assert acc.learning_rate == jacc.learning_rate == LR
    assert acc.pull_fields == jacc.pull_fields
    assert acc.grad_fields == jacc.grad_fields
    for gf in (("h",), ("v", "h"), ("x",), ()):
        assert acc.touched_fields(gf) == jacc.touched_fields(gf)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("n,path", [(40, "sparse"), (200, "dense")])
@pytest.mark.parametrize("backend", ["xla", "local"])
def test_sgd_push_on_one_shard_is_jax_bit_for_bit(backend, n, path, mean):
    """``xla`` (its sparse and dense paths) and ``local``, with exact-sum
    grads: the port's tables equal JAX's bit for bit."""
    cap = 300
    rng = np.random.default_rng(n)
    st = {f: rng.normal(size=(cap, D)).astype(np.float32) for f in "hv"}
    slots = ((rng.zipf(1.3, n) - 1) % cap).astype(np.int32)
    slots[::9] = -1
    grads = _exact_grads(rng, n)
    if backend == "xla":
        want = XlaTransfer().push({f: jnp.asarray(a) for f, a in st.items()},
                                  jnp.asarray(slots),
                                  {f: jnp.asarray(g) for f, g in grads.items()},
                                  _jsgd(), mean=mean)
        tr = SingleTransfer()
        got = state_to_numpy(tr.push(
            state_from_jax(st, "cpu"), torch.from_numpy(slots),
            {f: torch.from_numpy(g) for f, g in grads.items()}, _sgd(),
            mean=mean))
        assert dict(tr.push_paths) == {f"h,v:{path}": 1}
    else:
        want = JaxLocal().push(st, slots, grads, _jsgd(), mean=mean)
        got = LocalTransfer().push(st, slots, grads, _sgd(), mean=mean)
    for f in "hv":
        np.testing.assert_array_equal(_bits(got[f]), _bits(want[f]),
                                      err_msg=f)
    untouched = np.setdiff1d(np.arange(cap), slots[slots >= 0])
    np.testing.assert_array_equal(got["h"][untouched], st["h"][untouched])


@pytest.mark.parametrize("mean", [False, True])
def test_sgd_push_through_tpu_at_8_matches_jax(devices8, mean):
    """8 ranks on the CPU against ``TpuTransfer`` on the 8-device mesh:
    a pull moves the same bits, a push within the envelope."""
    jt = JaxSparseTable(_jsgd(), JaxKeyIndex(N, 32), mesh=jax_ps_mesh(),
                        axis=SHARD_AXIS)
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 10_000, size=64).astype(np.uint64)
    slots = jt.key_index.lookup(keys)
    slots[::7] = -1
    layout = ps_mesh(N, ["cpu"])
    state = state_from_jax({f: np.asarray(a) for f, a in jt.state.items()},
                           "cpu", mesh=layout)
    grads = {f: rng.normal(size=(64, D)).astype(np.float32) for f in "hv"}
    tr = ShardedTransfer(layout)
    pulled = tr.pull(state, torch.from_numpy(slots), _sgd())
    jpulled = TpuTransfer(jax_ps_mesh()).pull(jt.state, slots, _jsgd())
    for f in "hv":
        np.testing.assert_array_equal(pulled[f].numpy(),
                                      np.asarray(jpulled[f]))
    want = TpuTransfer(jax_ps_mesh()).push(jt.state, slots, grads, _jsgd(),
                                           mean=mean)
    tr.push(state, torch.from_numpy(slots),
            {f: torch.from_numpy(g) for f, g in grads.items()}, _sgd(),
            mean=mean)
    got = state_to_numpy(state)
    for f in "hv":
        np.testing.assert_allclose(got[f], np.asarray(want[f]), **ENVELOPE)
        assert not np.array_equal(got[f], np.asarray(jt.state[f]))


@pytest.mark.parametrize("mean", [False, True])
def test_sgd_push_through_hybrid_matches_jax(devices8, mean):
    """A hot head and a tail of 8 ranks against JAX's ``HybridTransfer``:
    hot and tail rows within the envelope."""
    rng = np.random.default_rng(6)
    keys = rng.choice(50_000, size=300, replace=False).astype(np.uint64)
    counts = np.maximum((1e6 * np.arange(1, 301) ** -1.0).astype(np.int64),
                        1)
    jt = JaxSparseTable(_jsgd(), JaxKeyIndex(N, 64, partition=(
        JaxPart.from_counts(keys, counts, batch_rows=64))),
        mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    layout = ps_mesh(N, ["cpu"])
    pt = SparseTable(_sgd(), KeyIndex(N, 64, partition=(
        HotColdPartition.from_counts(keys, counts, batch_rows=64))), "cpu",
        mesh=layout)
    mixed = keys[::4][:64]                  # hot and tail keys
    slots = np.asarray(jt.key_index.lookup(mixed), np.int32)
    np.testing.assert_array_equal(pt.key_index.lookup(mixed), slots)
    assert pt.n_hot > 0 and (slots < pt.n_hot).any() \
        and (slots >= pt.n_hot).any()
    slots[::7] = -1
    pt.state = state_from_jax({f: np.asarray(a)
                               for f, a in jt.state.items()}, "cpu",
                              mesh=layout)
    grads = {f: rng.normal(size=(64, D)).astype(np.float32) for f in "hv"}
    want = JaxHybrid(jax_ps_mesh()).push(jt.state, slots, grads, _jsgd(),
                                         mean=mean)
    HybridTransfer(layout).push(
        pt.state, torch.from_numpy(slots),
        {f: torch.from_numpy(g) for f, g in grads.items()}, _sgd(),
        mean=mean)
    got = state_to_numpy(pt.state)
    for f in ("h", "v", hot_name("h"), hot_name("v")):
        np.testing.assert_allclose(got[f], np.asarray(want[f]),
                                   err_msg=f, **ENVELOPE)


def test_sgd_push_rows_and_bf16_round_once():
    """The row form updates only kept, in-range slots; a bfloat16 param
    adds in float32 and rounds once, keeping its dtype, where JAX's
    ``params + lr * grads`` promotes the field to float32 (ROADMAP C):
    the port's rows are JAX's float32 result rounded to bfloat16."""
    rng = np.random.default_rng(8)
    p32 = rng.normal(size=(20, D)).astype(np.float32)
    g = rng.normal(size=(20, D)).astype(np.float32)
    mul = rng.random(20).astype(np.float32) + 0.5
    acc = _sgd(torch.bfloat16)
    param = torch.from_numpy(p32).to(torch.bfloat16)
    jout = _jsgd(jnp.bfloat16).apply_push(
        {"h": jnp.asarray(param.float().numpy()).astype(jnp.bfloat16)},
        {"h": jnp.asarray(g * mul[:, None])})
    assert jout["h"].dtype == jnp.float32          # JAX promotes the field
    acc.apply_push({"h": param}, {"h": torch.from_numpy(g)},
                   mul=torch.from_numpy(mul))
    assert param.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        param.view(torch.int16).numpy(),
        torch.from_numpy(np.array(jout["h"])).to(torch.bfloat16)
        .view(torch.int16).numpy())
    # rows: slots 3, 5, 3 (masked out), -1 and 99 (out of range) skipped
    t = torch.from_numpy(p32.copy())
    slots = torch.tensor([3, 5, 3, -1, 99], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    rows = torch.from_numpy(g[:5])
    acc32 = _sgd()
    acc32.apply_push_rows({"h": t}, slots, mask, {"h": rows},
                          mul=torch.from_numpy(mul[:5]))
    want = p32.copy()
    for i in (0, 1):
        want[int(slots[i])] = want[int(slots[i])] + \
            np.float32(LR) * (g[i] * mul[i])
    np.testing.assert_array_equal(t.numpy(), want)


# -- parameter/sparse_table.py -------------------------------------------------

@pytest.mark.parametrize("shards", [1, 8])
def test_num_rows_and_rows_as_numpy_match_jax(devices8, shards):
    kw = dict(mesh=jax_ps_mesh(), axis=SHARD_AXIS) if shards > 1 else {}
    jt = JaxSparseTable(jaccess.w2v_access(0.1, D), JaxKeyIndex(shards, 64),
                        seed=3, **kw)
    pt = SparseTable(w2v_access(0.1, D), KeyIndex(shards, 64), "cpu",
                     seed=3, mesh=ps_mesh(shards, ["cpu"])
                     if shards > 1 else None)
    assert pt.num_rows == jt.num_rows == 0
    keys = np.arange(7, 7 + 40, dtype=np.uint64)
    jt.key_index.lookup(keys)
    pt.key_index.lookup(keys)
    assert pt.num_rows == jt.num_rows == 40
    pt.state = state_from_jax({f: np.asarray(a)
                               for f, a in jt.state.items()}, "cpu",
                              mesh=pt.mesh)
    got, want = pt.rows_as_numpy(), jt.rows_as_numpy()
    assert set(got) == set(want)
    for f in want:
        assert got[f].dtype == want[f].dtype
        np.testing.assert_array_equal(got[f], want[f])


# -- data/text.py ----------------------------------------------------------------

def _corpus(n=40, V=80, L=14, seed=2):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, V, size=L))) for _ in range(n)]


@pytest.mark.parametrize("stencil", [False, True])
def test_prefetch_epochs_equal_the_synchronous_and_jax(stencil):
    """Batches and their order equal the synchronous epoch's and JAX's
    prefetch epoch, element for element; the producer hands back numpy
    arrays, no tensor."""
    sents = _corpus()
    vocab = build_vocab(sents)

    def run(b, prefetch):
        name = ("epoch_stencil" if stencil else "epoch") + \
            ("_prefetch" if prefetch else "")
        return list(getattr(b, name)(24, **({"depth": 2} if prefetch
                                              else {})))

    sync = run(CBOWBatcher(sents, vocab, 2, 1e-3, seed=7), False)
    pre = run(CBOWBatcher(sents, vocab, 2, 1e-3, seed=7), True)
    jpre = run(JaxBatcher(sents, jax_build_vocab(sents), 2, 1e-3, seed=7),
               True)
    assert len(sync) == len(pre) == len(jpre) > 3
    for a, b, c in zip(sync, pre, jpre):
        for name in a.__dataclass_fields__:
            x, y, z = (getattr(o, name) for o in (a, b, c))
            if isinstance(x, np.ndarray):
                assert isinstance(y, np.ndarray), name
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z)
            else:
                assert x == y == z, name


def test_vocab_index_is_jax_and_read_only():
    sents = _corpus()
    vocab, jvocab = build_vocab(sents), jax_build_vocab(sents)
    assert vocab.index == jvocab.index
    assert vocab.index is vocab.index
    assert vocab.index_of(int(vocab.keys[3])) == 3
    assert vocab.index_of(10 ** 9) is None
    with pytest.raises(AttributeError):
        vocab.index = {}


# -- models/logistic.py ----------------------------------------------------------

def test_lr_formatter_and_parser_match_jax():
    vals = np.concatenate([np.random.default_rng(0).normal(size=50),
                           [0.0, -0.0, 1e-30, 3.4e38, 0.1, 1 / 3]]
                          ).astype(np.float32)
    for v in vals:
        row = {"val": np.array([v], np.float32)}
        text = logistic.lr_formatter(row)
        assert text == jlogistic.lr_formatter(row)
        for t in (text, text + " 7 extra"):
            got, want = logistic.lr_parser(t), jlogistic.lr_parser(t)
            assert got["val"].dtype == want["val"].dtype == np.float32
            np.testing.assert_array_equal(_bits(got["val"]),
                                          _bits(want["val"]))


# -- transfer/sharded.py and transfer/hybrid.py: the metrics hook ----------------

def _owned_by(ki, shard, n):
    keys, k = [], 0
    while len(keys) < n:
        if ki.shard_of(np.array([k], np.uint64))[0] == shard:
            keys.append(k)
        k += 1
    return np.array(keys, np.uint64)


def test_overflow_gauge_matches_jax(devices8):
    """JAX's ``test_tpu_backend_overflow_counted_and_loud``: 24 keys owned
    by shard 3, 3 requests a rank; ``bucket_capacity`` 2 drops 8 a call
    and the gauge reads 16 after a pull and a push, 3 drops none."""
    access, jaccess_ = lr_access(0.1), jaccess.lr_access(0.1)
    jki = JaxKeyIndex(num_shards=N, capacity_per_shard=64)
    jt = JaxSparseTable(jaccess_, jki, mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    keys = _owned_by(jki, 3, 24)
    slots = jki.lookup(keys)
    layout = ps_mesh(N, ["cpu"])
    state = state_from_jax({f: np.asarray(a) for f, a in jt.state.items()},
                           "cpu", mesh=layout)
    grads = {f: np.ones((24, 1), np.float32) for f in access.grad_fields}
    gauges = []
    for port in (True, False):
        t = (ShardedTransfer(layout, bucket_capacity=2) if port
             else TpuTransfer(jax_ps_mesh(), bucket_capacity=2))
        t.metrics = Metrics() if port else JaxMetrics()
        if port:
            t.pull(state, torch.from_numpy(slots), access)
            first = t.overflow_count()
            t.push(state, torch.from_numpy(slots),
                   {f: torch.from_numpy(g) for f, g in grads.items()},
                   access)
        else:
            t.pull(jt.state, slots, jaccess_)
            first = t.overflow_count()
            t.push(jt.state, slots, grads, jaccess_)
        gauges.append((first, t.overflow_count(),
                       t.metrics.get("transfer_overflow_dropped")))
    assert gauges[0] == gauges[1] == (8, 16, 16.0)
    t2 = ShardedTransfer(layout, bucket_capacity=3)
    t2.metrics = Metrics()
    t2.pull(state, torch.from_numpy(slots), access)
    assert t2.overflow_count() == 0
    assert t2.metrics.get("transfer_overflow_dropped", -1.0) == 0.0


def test_hybrid_metrics_forward_to_the_tail_and_mirror_traffic(devices8):
    """``metrics`` and ``bucket_capacity`` are the tail's; ``traffic()``
    sets ``transfer_hot_rows``, ``transfer_psum_bytes`` and (through the
    tail's ``overflow_count``) ``transfer_overflow_dropped`` to what JAX's
    hybrid sets on the same pulls and pushes, and the routed rows' gauge
    too."""
    rng = np.random.default_rng(3)
    keys = rng.choice(50_000, size=300, replace=False).astype(np.uint64)
    counts = np.maximum((1e6 * np.arange(1, 301) ** -1.0).astype(np.int64),
                        1)
    acc, jacc = w2v_access(LR, D), jaccess.w2v_access(LR, D)
    jt = JaxSparseTable(jacc, JaxKeyIndex(N, 64, partition=(
        JaxPart.from_counts(keys, counts, batch_rows=64))),
        mesh=jax_ps_mesh(), axis=SHARD_AXIS)
    layout = ps_mesh(N, ["cpu"])
    pt = SparseTable(acc, KeyIndex(N, 64, partition=(
        HotColdPartition.from_counts(keys, counts, batch_rows=64))), "cpu",
        mesh=layout)
    pt.state = state_from_jax({f: np.asarray(a)
                               for f, a in jt.state.items()}, "cpu",
                              mesh=layout)
    slots = np.asarray(jt.key_index.lookup(keys[:64]), np.int32)
    grads = {f: rng.normal(size=(64, D)).astype(np.float32) for f in "hv"}
    t, jtr = HybridTransfer(layout, bucket_capacity=16), \
        JaxHybrid(jax_ps_mesh(), bucket_capacity=16)
    assert t.bucket_capacity == t.tail.bucket_capacity == 16 \
        == jtr.bucket_capacity
    assert t.mesh is layout
    t.metrics, jtr.metrics = Metrics(), JaxMetrics()
    assert t.tail.metrics is t.metrics
    for x in (t, jtr):
        x.count_traffic = True
    t.pull(pt.state, torch.from_numpy(slots), acc)
    jtr.pull(jt.state, slots, jacc)
    t.push(pt.state, torch.from_numpy(slots),
           {f: torch.from_numpy(g) for f, g in grads.items()}, acc)
    jtr.push(jt.state, slots, grads, jacc)
    assert t.traffic()["hot_rows"] == jtr.traffic()["hot_rows"] > 0
    t.tail.routed_rows()
    jtr.tail.routed_rows()
    want = jtr.metrics.snapshot()
    assert set(want) == {"transfer_hot_rows", "transfer_psum_bytes",
                         "transfer_routed_rows", "transfer_overflow_dropped"}
    assert t.metrics.snapshot() == want


# -- the rest of the surface -----------------------------------------------------

def test_numerics_sync_is_a_safe_point_that_changes_nothing():
    c = NumericsCollector()
    before = c.read()
    assert c.sync() is None
    assert c.read() == before
    c.quant_tap(torch.tensor(4.0, dtype=torch.float32))
    c.sync()
    assert c.read()["quant_err"] == 2.0


@pytest.mark.parametrize("dense_apply", [None, True, False])
def test_single_transfer_dense_apply_matches_xla(dense_apply):
    """``dense_apply`` forces the dense or the sparse push, as JAX's
    ``XlaTransfer(dense_apply=...)``: the same path and the same table."""
    cap, n = 128, 40          # 40 < 128 / 2: sparse unless forced
    rng = np.random.default_rng(2)
    st = {f: rng.normal(size=(cap, D)).astype(np.float32) for f in "hv"}
    slots = rng.integers(-1, cap, size=n).astype(np.int32)
    grads = _exact_grads(rng, n)
    tr = get_transfer("xla", dense_apply=dense_apply)
    assert tr.dense_apply is dense_apply
    got = state_to_numpy(tr.push(
        state_from_jax(st, "cpu"), torch.from_numpy(slots),
        {f: torch.from_numpy(g) for f, g in grads.items()}, _sgd()))
    want = XlaTransfer(dense_apply=dense_apply).push(
        {f: jnp.asarray(a) for f, a in st.items()}, jnp.asarray(slots),
        {f: jnp.asarray(g) for f, g in grads.items()}, _jsgd())
    assert dict(tr.push_paths) == {
        f"h,v:{'dense' if dense_apply else 'sparse'}": 1}
    for f in "hv":
        np.testing.assert_array_equal(got[f], np.asarray(want[f]))


@pytest.mark.parametrize("plane", ["auto", "pallas", "xla"])
def test_word2vec_data_plane_and_model_axis_match_jax(plane):
    conf = {"cluster": {"server_num": 1, "transfer": "xla",
                        "data_plane": plane},
            "word2vec": {"len_vec": 4}}
    m = Word2Vec(config=ConfigParser().update(conf), device="cpu")
    jm = JaxWord2Vec(config=JaxConfig().update(conf))
    assert m.data_plane == jm.data_plane == plane
    assert MODEL_AXIS == JAX_MODEL_AXIS


# -- parallel/collectives.py -----------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1, 2])
def test_rank_reduce_scatter_matches_jax(devices8, dim):
    """JAX's tiled ``reduce_scatter`` inside ``shard_map`` over 4 devices
    against the port's over 4 stacked ranks (B5's plain version on the
    CPU); the gradient of ``sum(w * rs(x))`` against JAX's."""
    n = 4
    mesh = JaxMesh(np.array(devices8[:n]), ("seq",))
    local = [6, 5, 7]
    local[dim] = 8
    x = np.random.default_rng(dim).normal(size=(n, *local)).astype(
        np.float32)
    w_shape = list(local)
    w_shape[dim] //= n
    w = np.random.default_rng(9).normal(size=(n, *w_shape)).astype(
        np.float32)

    def body(xl, wl):
        return jcoll.reduce_scatter(xl[0], "seq",
                                    scatter_dimension=dim)[None]

    def loss(xg, wg):
        y = jax.shard_map(body, mesh=mesh, in_specs=(P("seq"), P("seq")),
                          out_specs=P("seq"))(xg, wg)
        return (y * wg).sum(), y

    (_, want), jgrad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got = rank_reduce_scatter(xt, scatter_dimension=dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               **ENVELOPE)
    with pytest.raises(ValueError, match="does not split"):
        rank_reduce_scatter(torch.zeros(n, 6, 2))


def test_data_axis_collectives_are_the_identity_on_one_process():
    """With one process the data axis has size 1: ``reduce_scatter`` and
    ``pmean`` return their input's values (a new tensor), as JAX's do on
    a size-1 axis; an axis other than ``data`` raises."""
    from swiftmpi_tpu_torch.parallel import pmean, reduce_scatter
    x = torch.randn(6, 4)
    for y in (reduce_scatter(x), reduce_scatter(x, scatter_dimension=1),
              pmean(x)):
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="axis"):
        reduce_scatter(x, "seq")


def test_data_axis_reduce_scatter_and_pmean_match_jax(devices8, tmp_path):
    """2 processes over gloo (``mp_child w2v`` with a ``collectives``
    job) against JAX's ``shard_map`` ``psum_scatter`` and ``pmean`` over
    2 devices, on every process's seeded part: bit for bit (a sum of two
    parts)."""
    from swiftmpi_tpu_torch.testing.mp_child import _part
    shapes = [["plane", [6, 5], 0], ["cols", [3, 8], 1],
              ["words", [10], 0]]
    spec = [{"job": "collectives", "device": "cpu",
             "out": str(tmp_path / "out"), "shapes": shapes}]
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    res = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np", "2",
         "--", sys.executable, "-m", "swiftmpi_tpu_torch.testing.mp_child",
         "w2v", "-spec", str(tmp_path / "spec.json")], cwd=ROOT,
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, SMTPU_DIST_TIMEOUT="120"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    mesh = JaxMesh(np.array(devices8[:2]), ("data",))
    for label, shape, dim in shapes:
        x = np.stack([_part(300 + r, tuple(shape), np.float32)
                      for r in range(2)])

        def body(xl):
            return (jcoll.reduce_scatter(xl[0], "data",
                                         scatter_dimension=dim)[None],
                    jcoll.pmean(xl[0], "data")[None])

        rs, pm = jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                               out_specs=(P("data"), P("data")))(
            jnp.asarray(x))
        for r in range(2):
            got = np.load(tmp_path / "out" / f"collectives_state_r{r}.npz")
            np.testing.assert_array_equal(_bits(got[f"rs__{label}"]),
                                          _bits(np.asarray(rs)[r]))
            np.testing.assert_array_equal(_bits(got[f"pm__{label}"]),
                                          _bits(np.asarray(pm)[r]))
        for r in range(2):
            j = json.loads((tmp_path / "out" /
                            f"collectives_r{r}.json").read_text())
            assert j["dp"] == 2 and j["rank"] == r
