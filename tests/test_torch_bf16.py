"""bf16 tables (``[server] dtype: bfloat16``) in the port against the JAX
package, on the CPU: h and v stored in bfloat16, every pull upcast to
float32, the AdaGrad accumulators float32 and the update rounded once on
store (``swiftmpi_tpu/parameter/access.py`` ``w2v_access`` /
``AdaGradAccess.apply_push``).

The same seeded numpy inputs go through the JAX package (Pallas kernels
in interpret mode where its tests run them so, else its jnp rules) and
the port's plain versions (its CPU path).  Tolerances:

* conversions, pulls (a gather moves bits) and the text dump: exact;
* bfloat16 fields after an update: within one bfloat16 ulp (adjacent
  representable values): a 1-ulp float32 difference in ``rsqrt`` or in a
  sum's order moves a value across a bfloat16 rounding boundary, a 2^-8
  relative step.  The share that is bit-equal is printed (``pytest -s``);
* float32 accumulators: the repo envelope ``|a - b| <= 1e-5 + 1e-3|b|``;
  ``err_cnt`` exact (within 1e-6 relative for the shared renderings,
  whose count is fractional); ``err_sum`` rtol 1e-5;
* the stencil context sum: ``rtol 1e-5, atol 1e-5`` against the Pallas
  kernel (a matmul reduction against the port's k-order sum);
* a 3-step train: per-step losses rtol 1e-4, as for float32 tables (the
  measured gap on this corpus is 0), final tables as one step's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from swiftmpi_tpu.io.checkpoint import \
    dump_table_text as jax_dump_table_text
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.models.word2vec import w2v_formatter as jax_w2v_formatter
from swiftmpi_tpu.ops import pallas_gather
from swiftmpi_tpu.ops.pallas_stencil import \
    fused_stencil_gather as pallas_stencil_gather
from swiftmpi_tpu.ops.pallas_stencil import \
    stencil_window_inputs as jax_window_inputs
from swiftmpi_tpu.parameter.access import w2v_access as jax_w2v_access
from swiftmpi_tpu.transfer.xla import _masked_gather
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import (state_from_jax, state_to_numpy,
                                        tensor_from_numpy, tensor_to_numpy)
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          load_corpus, synthetic_corpus,
                                          write_tokens_file)
from swiftmpi_tpu_torch.kernels import adagrad, gather, ring, stencil
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, w2v_parser
from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
from swiftmpi_tpu_torch.utils import ConfigParser

BF16 = ml_dtypes.bfloat16
LR = 0.3

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2,
                 "shared_pool": 64},
    "server": {"initial_learning_rate": LR, "dtype": "bfloat16"},
    "worker": {"minibatch": 512},
}
CAP = 600


def _ordinal(a: np.ndarray) -> np.ndarray:
    """bfloat16 values as integers in the order of the reals: adjacent
    representable values differ by 1, +0 and -0 are both 0."""
    bits = np.asarray(a, BF16).view(np.uint16).astype(np.int64)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def _within_one_ulp(name, got, want) -> float:
    """Hold a bfloat16 field to one ulp of the reference; print (shown
    with ``pytest -s``) and return the share of bit-equal elements."""
    assert got.dtype == BF16 and np.asarray(want).dtype == BF16, \
        (got.dtype, np.asarray(want).dtype)
    gap = np.abs(_ordinal(got) - _ordinal(want))
    assert gap.max() <= 1, (name, int(gap.max()), int((gap > 1).sum()))
    share = float((gap == 0).mean())
    print(f"bit-equal share {name}: {share:.4f} of {gap.size}")
    return share


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def _hold_state(got, want):
    """bf16 fields to one ulp, float32 accumulators to the envelope."""
    for f in ("h", "v"):
        _within_one_ulp(f, got[f], np.asarray(want[f]))
    for f in ("h2sum", "v2sum"):
        assert got[f].dtype == np.float32
        _envelope(got[f], np.asarray(want[f]))


def corpus(n_sent=40, vocab=30, length=12, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p)))
            for _ in range(n_sent)]


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _models(sents, cap=CAP, **conf):
    """The JAX model and the port's on the CPU, one conf (``conf``:
    section -> keys), the port starting from JAX's initial bf16 table."""
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for sec, kv in conf.items():
        for k, v in kv.items():
            jc.set(sec, k, v)
            pc.set(sec, k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap)
    pm.build(sents)
    assert jm.table.state["h"].dtype == jnp.bfloat16
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh if pm.transfer.name == "tpu" else None)
    return jm, pm


def _jax_step(jm, batch, key):
    step = jm._build_step()
    state = {f: jnp.array(v) for f, v in jm.table.state.items()}
    if hasattr(batch, "tokens"):
        fields = (batch.tokens, batch.sent_id, batch.center_pos, batch.half)
    else:
        fields = (batch.centers, batch.contexts, batch.ctx_mask)
    out, es, ec = step(state, jm._slot_of_vocab, jm._alias_prob,
                       jm._alias_idx, *(jnp.asarray(f) for f in fields), key)
    return out, float(es), float(ec)


# -- conversions and the table -------------------------------------------------

@pytest.mark.parametrize("sharded", [False, True])
def test_convert_round_trips_bf16_bits(sharded):
    """ml_dtypes bfloat16 arrays cross into bfloat16 tensors and back with
    their bits unchanged (every bit pattern but NaNs' payload-free ones,
    one device or dealt to 8 shards); ``upcast`` gives float32 exactly."""
    bits = np.arange(0, 2 ** 16, dtype=np.uint16)
    finite = np.isfinite(bits.view(BF16).astype(np.float32))
    vals = bits[finite][:64 * 1000].view(BF16).reshape(-1, 8)
    acc = np.random.default_rng(0).random(vals.shape).astype(np.float32)
    mesh = ps_mesh(8, ["cpu"]) if sharded else None
    st = state_from_jax({"h": vals, "h2sum": acc}, "cpu", mesh=mesh)
    first = st["h"][0] if sharded else st["h"]
    assert first.dtype == torch.bfloat16 and first.is_contiguous()
    assert (st["h2sum"][0] if sharded else st["h2sum"]).dtype == \
        torch.float32
    back = state_to_numpy(st)
    assert back["h"].dtype == BF16 and back["h2sum"].dtype == np.float32
    np.testing.assert_array_equal(back["h"].view(np.uint16),
                                  vals.view(np.uint16))
    np.testing.assert_array_equal(back["h2sum"], acc)
    up = state_to_numpy(st, upcast=True)
    assert up["h"].dtype == np.float32
    np.testing.assert_array_equal(up["h"], vals.astype(np.float32))
    t = tensor_from_numpy(vals)
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy().view(np.uint16), vals.view(np.uint16))
    np.testing.assert_array_equal(tensor_to_numpy(t).view(np.uint16),
                                  vals.view(np.uint16))


def test_table_inits_in_float32_then_casts():
    """A bf16 table draws its rows in float32 and rounds them (JAX
    ``sparse_table.py``: ``init(...).astype(dtype)``): the same seed gives
    the float32 table's draws, rounded to nearest even; accumulators stay
    float32 zeros."""
    ki = KeyIndex(1, 200)
    f32 = SparseTable(w2v_access(LR, 12), ki, "cpu", seed=5).state
    b16 = SparseTable(w2v_access(LR, 12, torch.bfloat16), ki, "cpu",
                      seed=5).state
    for f in ("h", "v"):
        assert b16[f].dtype == torch.bfloat16
        assert torch.equal(b16[f], f32[f].to(torch.bfloat16))
        np.testing.assert_array_equal(
            tensor_to_numpy(b16[f]),
            tensor_to_numpy(f32[f]).astype(BF16))
    for f in ("h2sum", "v2sum"):
        assert b16[f].dtype == torch.float32 and not b16[f].any()


def test_server_dtype_is_read_like_jax():
    """``[server] dtype``: float32 and bfloat16 are configurations, any
    other value raises ``ValueError`` as in the JAX package."""
    for name, want in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        c = ConfigParser().update(CONF)
        c.set("server", "dtype", name)
        m = Word2Vec(config=c, device="cpu")
        assert m.param_dtype == want
        assert m.access.fields["h"].dtype == want
        assert m.access.fields["h2sum"].dtype == torch.float32
    for bad in ("float16", "bf16"):
        c = ConfigParser().update(CONF)
        c.set("server", "dtype", bad)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            Word2Vec(config=c, device="cpu")
        jc = JaxConfig().update(CONF)
        jc.set("server", "dtype", bad)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            JaxWord2Vec(config=jc)


# -- B2: the gather moves bfloat16 bits ----------------------------------------

def _slots(rng, n, cap):
    slots = rng.integers(0, cap, n).astype(np.int32)
    valid = rng.random(n) >= 0.05
    slots[~valid] = -1
    pos = rng.choice(np.flatnonzero(valid), 4, replace=False)
    slots[pos[:2]] = cap + 7
    slots[pos[2:]] = -3
    return slots, valid


@pytest.mark.parametrize("d", [16, 7])
def test_gather_plain_bf16_matches_pallas_loop_and_xla(monkeypatch, d):
    """Exact: bfloat16 rows come back bfloat16, bit for bit, as the Pallas
    kernel (interpret mode) and the jnp gather give them."""
    rng = np.random.default_rng(d)
    cap, n = 300, 512
    table = rng.normal(size=(cap, d)).astype(BF16)
    slots, valid = _slots(rng, n, cap)
    monkeypatch.setattr(pallas_gather, "gather_method", lambda: "loop")
    monkeypatch.setattr(pallas_gather, "gather_idx_block", lambda: 128)
    args = (jnp.asarray(table), jnp.asarray(slots), jnp.asarray(valid))
    want_pallas = np.asarray(pallas_gather.masked_vmem_gather(*args))
    want_xla = np.asarray(_masked_gather(*args))
    got = gather.masked_gather(tensor_from_numpy(table),
                               torch.from_numpy(slots),
                               torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    got = tensor_to_numpy(got)
    np.testing.assert_array_equal(got.view(np.uint16),
                                  want_pallas.view(np.uint16))
    np.testing.assert_array_equal(got.view(np.uint16),
                                  want_xla.view(np.uint16))
    assert not got.astype(np.float32)[~valid].any()


def test_gather_plain_bf16_block_of_ranks():
    """The rank form on a bfloat16 ``(R, cap, d)`` block: rank r equals
    the jnp gather of slice r, bit for bit."""
    rng = np.random.default_rng(9)
    R, cap, d = 8, 40, 16
    table = rng.normal(size=(R, cap, d)).astype(BF16)
    pairs = [_slots(rng, 96, cap) for _ in range(R)]
    slots = np.stack([s for s, _ in pairs])
    valid = np.stack([v for _, v in pairs])
    got = tensor_to_numpy(gather.masked_gather(
        tensor_from_numpy(table), torch.from_numpy(slots),
        torch.from_numpy(valid)))
    for r in range(R):
        want = np.asarray(_masked_gather(jnp.asarray(table[r]),
                                         jnp.asarray(slots[r]),
                                         jnp.asarray(valid[r])))
        np.testing.assert_array_equal(got[r].view(np.uint16),
                                      want.view(np.uint16))


# -- B1: the mixed AdaGrad -----------------------------------------------------

def _adagrad_inputs(rng, shape):
    p = ((rng.random(shape) - 0.5) / 16).astype(BF16)
    a = (np.abs(rng.normal(size=shape)) * 1e-2).astype(np.float32)
    g = (rng.normal(size=shape) * 1e-2).astype(np.float32)
    return p, a, g


def _jax_rule(p, a, g):
    """``AdaGradAccess.apply_push`` on the h family, bf16 h."""
    acc = jax_w2v_access(LR, p.shape[-1], param_dtype=jnp.bfloat16)
    out = acc.apply_push({"h": jnp.asarray(p), "h2sum": jnp.asarray(a)},
                         {"h": jnp.asarray(g)})
    assert out["h"].dtype == jnp.bfloat16
    return np.asarray(out["h"]), np.asarray(out["h2sum"])


@pytest.mark.parametrize("shape", [(300, 16), (257, 7)])
def test_adagrad_mixed_plain_matches_jax_rule(shape):
    """Dense mixed form: bf16 param within one ulp of the JAX rule
    (float32 rsqrt may differ in its last bit), float32 accum in the
    envelope."""
    rng = np.random.default_rng(shape[1])
    p, a, g = _adagrad_inputs(rng, shape)
    want_p, want_a = _jax_rule(p, a, g)
    tp, ta = tensor_from_numpy(p), torch.from_numpy(a.copy())
    adagrad.adagrad_update_(tp, ta, torch.from_numpy(g), LR)
    assert tp.dtype == torch.bfloat16 and ta.dtype == torch.float32
    share = _within_one_ulp("h", tensor_to_numpy(tp),
                            want_p)
    assert share > 0.9, share
    _envelope(ta.numpy(), want_a)


@pytest.mark.parametrize("op", ["mul", "div"])
def test_adagrad_mixed_block_with_scale_matches_jax_rule(op):
    """The block form over an (8, cap, d) bf16 block with the mean's
    operand: rank by rank the JAX rule on the scaled grads (``mul``: JAX
    ``tpu.py`` multiplies by the reciprocal; ``div``: ``xla.py`` divides),
    within one ulp."""
    rng = np.random.default_rng(4)
    R, cap, d = 8, 50, 16
    p, a, g = _adagrad_inputs(rng, (R, cap, d))
    cnt = rng.integers(1, 9, (R, cap)).astype(np.float32)
    operand = 1.0 / cnt if op == "mul" else cnt
    scaled = g * operand[..., None] if op == "mul" else g / cnt[..., None]
    tp, ta = tensor_from_numpy(p), torch.from_numpy(a.copy())
    adagrad.adagrad_update_(tp, ta, torch.from_numpy(g), LR,
                            **{op: torch.from_numpy(operand)})
    got_p = tensor_to_numpy(tp)
    for r in range(R):
        want_p, want_a = _jax_rule(p[r], a[r], scaled[r])
        _within_one_ulp(f"h{r}", got_p[r], want_p)
        _envelope(ta[r].numpy(), want_a)


@pytest.mark.parametrize("masked", [False, True])
def test_adagrad_mixed_rows_match_jax_rule_on_the_rows(masked):
    """The row-indexed mixed form: the kept rows as the JAX rule updates
    them (one ulp), every other row untouched, bit for bit."""
    rng = np.random.default_rng(11 + masked)
    cap, d, M = 400, 16, 150
    p, a, _ = _adagrad_inputs(rng, (cap, d))
    slots = rng.permutation(cap)[:M].astype(np.int32)
    slots[:3] = [cap, -1, cap + 4]
    mask = rng.random(M) < 0.7 if masked else np.ones(M, bool)
    g = (rng.normal(size=(M, d)) * 1e-2).astype(np.float32)
    inv = (1.0 / rng.integers(1, 9, M)).astype(np.float32)
    tp, ta = tensor_from_numpy(p), torch.from_numpy(a.copy())
    adagrad.adagrad_update_rows_(
        tp, ta, torch.from_numpy(slots),
        torch.from_numpy(mask) if masked else None, torch.from_numpy(g), LR,
        mul=torch.from_numpy(inv))
    keep = (slots >= 0) & (slots < cap) & mask
    tgt = slots[keep]
    want_p, want_a = _jax_rule(p[tgt], a[tgt], g[keep] * inv[keep, None])
    got_p = tensor_to_numpy(tp)
    _within_one_ulp("h", got_p[tgt], want_p)
    _envelope(ta.numpy()[tgt], want_a)
    other = np.setdiff1d(np.arange(cap), tgt)
    np.testing.assert_array_equal(got_p[other].view(np.uint16),
                                  p[other].view(np.uint16))
    np.testing.assert_array_equal(ta.numpy()[other], a[other])


# -- B4: the stencil context sum ------------------------------------------------

def _span(rng, S, B, W, cap):
    """A stream span with 7-token sentences, a padded tail, 9 padded
    centers and centers in no span order."""
    n_valid = S - 5
    slots = np.full(S, -1, np.int32)
    slots[:n_valid] = rng.integers(0, cap, n_valid)
    sent_id = np.full(S, -1, np.int32)
    sent_id[:n_valid] = np.arange(n_valid, dtype=np.int32) // 7
    n_words = B - 9
    center_pos = np.full(B, -1, np.int32)
    center_pos[:n_words] = rng.integers(0, n_valid, n_words)
    half = np.zeros(B, np.int32)
    half[:n_words] = rng.integers(1, W + 1, n_words)
    return slots, sent_id, center_pos, half


@pytest.mark.parametrize("W,B,d,block_b", [(2, 50, 8, 16), (4, 96, 20, 96),
                                           (4, 90, 32, 40)])
def test_stencil_context_sum_matches_pallas(W, B, d, block_b):
    """The new entry point's plain version (the CPU path: the window
    inputs, then the k-order sum of upcast rows) against
    ``pallas_stencil.fused_stencil_gather`` in interpret mode on the same
    bf16 table (the Pallas kernel upcasts its staged span): rtol 1e-5,
    atol 1e-5; padded centers exactly 0; float32 out.  No launch on the
    CPU.  The float32 case is ``test_torch_stencil.py``'s
    ``test_context_sum_matches_pallas_and_oracle``."""
    rng = np.random.default_rng(3)
    S, cap = B + 2 * W, 211
    table = rng.standard_normal((cap, d)).astype(BF16)
    slots, sent_id, center_pos, half = _span(rng, S, B, W, cap)
    jlo, jw = jax_window_inputs(jnp.asarray(sent_id),
                                jnp.asarray(center_pos), jnp.asarray(half), W)
    want = np.asarray(pallas_stencil_gather(
        jnp.asarray(table), jnp.asarray(slots), jlo, jw, interpret=True,
        block_b=block_b))
    assert want.dtype == np.float32
    kernels.reset_launches()
    got = stencil.stencil_context_sum(
        tensor_from_numpy(table), torch.from_numpy(slots),
        torch.from_numpy(sent_id), torch.from_numpy(center_pos).long(),
        torch.from_numpy(half), W)
    assert stencil.launches == 0
    assert got.dtype == torch.float32 and got.shape == (B, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[center_pos < 0] == 0).all()


@pytest.mark.parametrize("sample,B", [(-1.0, 24), (1e-2, 64), (0.1, 200)])
def test_window_rule_selects_the_ctx_mask_pairs(sample, B):
    """The kernel's window rule (``stencil_window_inputs``, which the
    kernel computes in registers) and the step's ``ctx_mask`` select the
    same (center, span position) pairs on real stencil batches: the
    context sum and the span push see the same contexts."""
    sents = corpus(n_sent=30, vocab=50, length=12, seed=4)
    vocab = build_vocab(sents)
    W = 2
    for batch in CBOWBatcher(sents, vocab, W, sample,
                             seed=13).epoch_stencil(B):
        S = batch.span
        cp = np.clip(batch.center_pos, 0, S - 1)
        offsets = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
        ctx_idx = cp[:, None] + offsets[None, :]
        ci = np.clip(ctx_idx, 0, S - 1)
        ctx_mask = ((ctx_idx >= 0) & (ctx_idx < S)
                    & (batch.sent_id[ci] == batch.sent_id[cp][:, None])
                    & (np.abs(offsets)[None, :] <= batch.half[:, None])
                    & (batch.center_pos >= 0)[:, None])
        lo, wmask = stencil.stencil_window_inputs(
            torch.from_numpy(batch.sent_id),
            torch.from_numpy(batch.center_pos).long(),
            torch.from_numpy(batch.half), W)
        pos = lo.numpy()[:, None] + np.arange(2 * W + 1)[None, :]
        kernel_pairs = {(int(b), int(pos[b, k]))
                        for b, k in zip(*np.nonzero(wmask.numpy()))}
        step_pairs = {(int(b), int(ci[b, o]))
                      for b, o in zip(*np.nonzero(ctx_mask))}
        assert kernel_pairs == step_pairs
        assert len(step_pairs) > 0


def test_stencil_context_sum_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    slots = torch.arange(12, dtype=torch.int32)
    sid = torch.zeros(12, dtype=torch.int32)
    cp = torch.arange(6, dtype=torch.int64) + 2
    half = torch.full((6,), 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        stencil.stencil_context_sum(t.half(), slots, sid, cp, half, 2)
    with pytest.raises(TypeError, match="int64 center_pos"):
        stencil.stencil_context_sum(t, slots, sid, cp.int(), half, 2)
    with pytest.raises(TypeError, match="int32 sent_id"):
        stencil.stencil_context_sum(t, slots, sid[:5], cp, half, 2)
    with pytest.raises(ValueError, match="S = 4"):
        stencil.stencil_context_sum(t, slots[:4], sid[:4], cp, half, 2)
    got = stencil.stencil_context_sum(t.bfloat16(), slots, sid, cp, half, 2)
    want = stencil.stencil_context_sum(t.bfloat16().float(), slots, sid, cp,
                                       half, 2)
    assert torch.equal(got, want)


# -- B5: bfloat16 operands -------------------------------------------------------

def test_ring_plain_moves_bf16_blocks():
    """The ring exchange's plain version on bfloat16 operands is the block
    transpose, bit for bit (the kernel takes them as 4-byte words)."""
    rng = np.random.default_rng(2)
    x = tensor_from_numpy(rng.normal(size=(8, 8, 13, 100)).astype(BF16))
    got = ring.ring_exchange_stacked(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       x.transpose(0, 1).contiguous().view(torch.int16))
    lst = ring.ring_exchange(list(x.unbind(0)))
    for r in range(8):
        assert torch.equal(lst[r], got[r])


# -- one step, and a train -----------------------------------------------------

@pytest.mark.parametrize("B", [24, 512])
@pytest.mark.parametrize("rendering", ["gather", "shared", "stencil",
                                       "stencil_shared"])
def test_step_matches_jax_step_bf16(rendering, B):
    """One step of each rendering with bf16 tables == JAX's
    ``_build_step`` with its draws replayed: h and v bf16 within one ulp,
    accumulators in the envelope, ``err_cnt`` exact (1e-6 relative for
    the shared renderings), full batch (B = 24) and padded tail
    (B = 512)."""
    w2v = {"stencil": int(rendering.startswith("stencil")),
           "shared_negatives": int(rendering.endswith("shared"))}
    sents = corpus(seed=3)
    jm, pm = _models(sents, word2vec=w2v)
    assert pm.resolved_rendering == rendering
    bat = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=13)
    batch = next(iter(bat.epoch_stencil(B) if pm.stencil
                      else bat.epoch(B)))
    key = jax.random.key(7)
    state0 = state_to_numpy(pm.table.state)
    out, es, ec = _jax_step(jm, batch, key)
    shape = (pm.shared_pool,) if pm.shared_negatives else (B, pm.negative)
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), shape))
    if pm.shared_negatives:
        assert got_ec == pytest.approx(ec, rel=1e-6)
    else:
        assert got_ec == int(ec)
    np.testing.assert_allclose(got_es, es, rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    _hold_state(got, out)
    for f in got:
        assert not np.array_equal(got[f], state0[f])        # the step moved
    if pm.stencil:
        assert pm.transfer.push_paths["v:span"] == 1


@pytest.mark.parametrize("rendering", ["gather", "shared"])
def test_sharded_step_matches_jax_step_bf16(devices8, rendering):
    """One step of the sharded parameter server (8 ranks on the CPU) with
    bf16 tables against JAX's ``TpuTransfer`` step on the 8-device mesh:
    bf16 fields within one ulp, accumulators in the envelope,
    ``err_cnt`` exact (1e-6 relative shared)."""
    sents = corpus(n_sent=60, vocab=300, length=16, seed=3)
    jm, pm = _models(sents, cap=80,
                     cluster={"server_num": 8, "transfer": "tpu"},
                     word2vec={"shared_negatives":
                               int(rendering == "shared")})
    assert pm.transfer.name == jm.transfer.name == "tpu"
    assert pm.table.state["h"][0].dtype == torch.bfloat16
    B = 64
    batch = next(iter(CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                  seed=13).epoch(B)))
    key = jax.random.key(7)
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
    _hold_state(state_to_numpy(pm.table.state), out)


@pytest.mark.parametrize("rendering", ["gather", "stencil"])
def test_three_step_train_tracks_jax_bf16(rendering):
    """``train`` with bf16 tables and per-step replayed draws, one batch
    an epoch, three epochs: the per-step losses within rtol 1e-4 of JAX's
    and the final bf16 tables within one ulp (accumulators in the
    envelope)."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents, word2vec={"stencil": int(rendering ==
                                                     "stencil")})
    want = jm.train(sents, niters=3, batch_size=64)
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), (64, pm.negative)))
    got = pm.train(sents, niters=3, batch_size=64, draws=iter(draws))
    assert pm.train_metrics["steps"] == 3
    gap = float(np.max(np.abs(np.array(got) - want) / np.abs(want)))
    print(f"loss relative gap: {gap:.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _hold_state(state_to_numpy(pm.table.state),
                jm.table.state)


def test_grads_stay_float32_under_bf16_tables(monkeypatch):
    """Under bf16 tables the scatter-add (B3) and AdaGrad (B1) get float32
    grads, as JAX's rule casts them (``astype(f32)``); only the param is
    bf16, the accumulator float32.  One gather step (dense h push, sparse
    v push) and one stencil step (span push)."""
    from swiftmpi_tpu_torch.parameter import access as access_mod
    from swiftmpi_tpu_torch.transfer import single
    seen = []

    def spy_scatter(slots, valid, grads, cap, counts=False):
        seen.append(("scatter", grads.dtype))
        return real_scatter(slots, valid, grads, cap, counts=counts)

    def spy_dense(param, accum, grad, *a, **k):
        seen.append(("adagrad", param.dtype, accum.dtype, grad.dtype))
        return real_dense(param, accum, grad, *a, **k)

    def spy_rows(param, accum, slots, mask, grad, *a, **k):
        seen.append(("adagrad_rows", param.dtype, accum.dtype, grad.dtype))
        return real_rows(param, accum, slots, mask, grad, *a, **k)

    real_scatter = single.masked_scatter_add
    real_dense = access_mod.adagrad_update_
    real_rows = access_mod.adagrad_update_rows_
    monkeypatch.setattr(single, "masked_scatter_add", spy_scatter)
    monkeypatch.setattr(access_mod, "adagrad_update_", spy_dense)
    monkeypatch.setattr(access_mod, "adagrad_update_rows_", spy_rows)
    sents = corpus(seed=3)
    for st in (0, 1):
        c = ConfigParser().update(CONF)
        c.set("word2vec", "stencil", st)
        m = Word2Vec(config=c, device="cpu", capacity_per_shard=CAP)
        m.build(sents)
        m.train(sents, niters=1, batch_size=64)
    kinds = {s[0] for s in seen}
    assert kinds == {"scatter", "adagrad", "adagrad_rows"}, kinds
    for s in seen:
        if s[0] == "scatter":
            assert s[1] == torch.float32
        else:
            assert s[1:] == (torch.bfloat16, torch.float32, torch.float32)


# -- the dump and the CLI --------------------------------------------------------

def test_bf16_text_dump_matches_jax(tmp_path):
    """The port's dump of a bf16 table (an exact upcast) is, byte for
    byte, the JAX package's Python dump of the same state with the same
    formatter (``io/checkpoint.py::dump_table_text`` with
    ``w2v_formatter``), and value for value its ``Word2Vec.save`` (the
    native writer, which prints 9 significant digits: enough to give
    every bfloat16 back exactly)."""
    sents = corpus(n_sent=20, vocab=40, length=10, seed=2)
    jm, pm = _models(sents)
    jm.train(sents, niters=1, batch_size=64)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    assert pm.table.state["v"].dtype == torch.bfloat16
    a, b, c = (str(tmp_path / n) for n in ("jax.txt", "port.txt",
                                            "native.txt"))
    assert jax_dump_table_text(jm.table, a, jax_w2v_formatter) \
        == pm.save(b) == jm.save(c) == len(pm.vocab)
    assert open(a).read() == open(b).read()
    mine = [line.split("\t") for line in open(b).read().splitlines()]
    theirs = [line.split("\t") for line in open(c).read().splitlines()]
    assert [m[0] for m in mine] == [t[0] for t in theirs]
    for m, t in zip(mine, theirs):
        for x, y in zip(m[1:], t[1:]):
            got = np.array(x.split(), np.float32)
            assert np.array_equal(got, np.array(y.split(), np.float32))
            assert np.array_equal(got.astype(BF16).astype(np.float32), got)


def test_cli_trains_bf16_tables(tmp_path, monkeypatch):
    """``w2v_main`` with ``[server] dtype: bfloat16`` in the conf trains
    with bf16 h and v and float32 accumulators, and dumps every vocab
    key."""
    data, conf = tmp_path / "corpus.txt", tmp_path / "w2v.conf"
    write_tokens_file(synthetic_corpus(60, 200, 12, seed=1), str(data))
    conf.write_text("[cluster]\nserver_num: 1\ntransfer: xla\n"
                    "[server]\ninitial_learning_rate: 0.3\n"
                    "dtype: bfloat16\n"
                    "[word2vec]\nlen_vec: 8\nwindow: 2\nnegative: 5\n"
                    "sample: -1\nlearning_rate: 0.05\n")
    seen = []
    train = w2v_main.Word2Vec.train

    def spy(self, *a, **k):
        out = train(self, *a, **k)
        seen.append(({f: t.dtype for f, t in self.table.state.items()},
                     out))
        return out

    monkeypatch.setattr(w2v_main.Word2Vec, "train", spy)
    from swiftmpi_tpu_torch.utils import reset_global_config
    reset_global_config()
    out = tmp_path / "vectors.txt"
    assert w2v_main.main(["w2v", "-config", str(conf), "-data", str(data),
                          "-niters", "2", "-output", str(out),
                          "-device", "cpu"]) == 0
    dtypes, losses = seen[0]
    assert dtypes == {"h": torch.bfloat16, "v": torch.bfloat16,
                      "h2sum": torch.float32, "v2sum": torch.float32}
    assert np.isfinite(losses).all()
    rows = [w2v_parser(line.partition("\t")[2])
            for line in out.read_text().splitlines()]
    assert len(rows) == len(build_vocab(load_corpus(str(data))))
    assert all(r["v"].shape == r["h"].shape == (8,) for r in rows)
