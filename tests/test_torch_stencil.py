"""The port's stencil rendering and shared negatives against the JAX
package, on the CPU: ``stencil_window_inputs``, the fused stencil
gather's plain version (against the Pallas kernel in interpret mode and a
sequential numpy oracle), ``epoch_stencil`` / ``stencil_to_cbow``,
``push_span``, and one step of each of the ``stencil``,
``stencil_shared`` and ``shared`` renderings with JAX's draws replayed.

Tolerances: the window inputs and the batches are exact (integer and
mask arrays); the context sums ``rtol 1e-5, atol 1e-5`` (the Pallas kernel
reduces by a matmul, the port sums in k order, as
``tests/test_pallas_stencil.py`` states); table state after a push or a
step within the repo envelope ``|a - b| <= 1e-5 + 1e-3 * |b|``; ``err_cnt``
exact for the per-center renderings and within 1e-6 relative for the
shared ones (a float32 sum on both sides); loss trajectories rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.data.text import CBOWBatcher as JaxBatcher
from swiftmpi_tpu.data.text import build_vocab as jax_build_vocab
from swiftmpi_tpu.data.text import stencil_to_cbow as jax_stencil_to_cbow
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.ops.pallas_stencil import \
    fused_stencil_gather as pallas_stencil_gather
from swiftmpi_tpu.ops.pallas_stencil import \
    stencil_window_inputs as jax_window_inputs
from swiftmpi_tpu.parameter.access import w2v_access as jax_w2v_access
from swiftmpi_tpu.transfer.xla import XlaTransfer
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, build_vocab,
                                          stencil_to_cbow)
from swiftmpi_tpu_torch.kernels import stencil
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter.access import w2v_access
from swiftmpi_tpu_torch.transfer import SingleTransfer
from swiftmpi_tpu_torch.utils import ConfigParser

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2,
                 "shared_pool": 64},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
CAP = 600


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


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


def _models(sents, **word2vec):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for k, v in word2vec.items():
        jc.set("word2vec", k, v)
        pc.set("word2vec", k, v)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=CAP).build(sents)
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=CAP)
    pm.build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu")
    return jm, pm


# -- stencil_window_inputs and the context sum (B4) --------------------------

def _synthetic_span(rng, S, B, W, cap, n_pad_rows=5, n_pad_centers=9):
    """A stream span with short sentences, a padded tail (sent_id -1 /
    slot -1), padded centers (center_pos -1 / half 0) and centers in no
    particular span order."""
    n_valid = S - n_pad_rows
    slots = np.full(S, -1, np.int32)
    slots[:n_valid] = rng.integers(0, cap, n_valid)
    sent_id = np.full(S, -1, np.int32)
    sent_id[:n_valid] = np.arange(n_valid, dtype=np.int32) // 7
    n_words = B - n_pad_centers
    center_pos = np.full(B, -1, np.int32)
    center_pos[:n_words] = rng.integers(0, n_valid, n_words)
    half = np.zeros(B, np.int32)
    half[:n_words] = rng.integers(1, W + 1, n_words)
    return slots, sent_id, center_pos, half


def _np_context_sums(table, slots, sent_id, center_pos, half):
    """Sequential oracle: each valid center's sum of the span rows at its
    true context positions."""
    S = len(slots)
    out = np.zeros((len(center_pos), table.shape[1]), np.float32)
    for b, cp in enumerate(center_pos):
        cp = int(cp)
        if cp < 0:
            continue
        for j in range(max(cp - int(half[b]), 0),
                       min(cp + int(half[b]) + 1, S)):
            if j != cp and sent_id[j] == sent_id[cp]:
                out[b] += table[max(int(slots[j]), 0)]
    return out


@pytest.mark.parametrize("W", [2, 4])
def test_window_inputs_match_jax(W):
    """``lo`` and ``wmask`` exact, for shuffled centers, pad centers and a
    padded span."""
    rng = np.random.default_rng(W)
    B = 60
    S = B + 2 * W
    _, sent_id, center_pos, half = _synthetic_span(rng, S, B, W, 50)
    want_lo, want_w = jax_window_inputs(
        jnp.asarray(sent_id), jnp.asarray(center_pos), jnp.asarray(half), W)
    lo, wmask = stencil.stencil_window_inputs(
        torch.from_numpy(sent_id), torch.from_numpy(center_pos),
        torch.from_numpy(half), W)
    assert lo.dtype == torch.int32 and wmask.dtype == torch.float32
    assert wmask.shape == (B, 2 * W + 1)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(want_lo))
    np.testing.assert_array_equal(wmask.numpy(), np.asarray(want_w))
    assert not wmask[center_pos < 0].any()


@pytest.mark.parametrize("W,B,d,block_b", [(2, 50, 8, 16), (4, 96, 20, 96),
                                           (4, 90, 32, 40)])
def test_context_sum_matches_pallas_and_oracle(W, B, d, block_b):
    """The plain version (the CPU path of the wrapper, which takes the
    stencil batch itself) against the Pallas kernel in interpret mode —
    with a ``block_b`` that divides ``B`` and ones that do not — and the
    sequential oracle; pad centers exactly 0.  The plain version's second
    half, the sum from ``(lo, wmask)``, gives the same result."""
    rng = np.random.default_rng(3)
    S, cap = B + 2 * W, 211
    table = rng.standard_normal((cap, d)).astype(np.float32)
    slots, sent_id, center_pos, half = _synthetic_span(rng, S, B, W, cap)
    jlo, jw = jax_window_inputs(jnp.asarray(sent_id),
                                jnp.asarray(center_pos), jnp.asarray(half), W)
    want = np.asarray(pallas_stencil_gather(
        jnp.asarray(table), jnp.asarray(slots), jlo, jw, interpret=True,
        block_b=block_b))
    lo, wmask = stencil.stencil_window_inputs(
        torch.from_numpy(sent_id), torch.from_numpy(center_pos),
        torch.from_numpy(half), W)
    kernels.reset_launches()
    got = stencil.stencil_context_sum(
        torch.from_numpy(table), torch.from_numpy(slots),
        torch.from_numpy(sent_id), torch.from_numpy(center_pos).long(),
        torch.from_numpy(half), W)
    assert stencil.launches == 0                 # the CPU runs the plain one
    assert torch.equal(got, stencil.fused_stencil_gather_plain(
        torch.from_numpy(table), torch.from_numpy(slots), lo, wmask))
    assert got.shape == (B, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    oracle = _np_context_sums(table, slots, sent_id, center_pos, half)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[center_pos < 0] == 0).all()


def test_context_sum_refuses_what_the_kernel_does_not_take():
    """The contract the CUDA kernel takes, held on the CPU path too: a
    float32 or bfloat16 table (a float16 one raises), int32 span arrays,
    int64 center positions, a span of at least K rows."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    slots = torch.arange(12, dtype=torch.int32)
    sid = torch.zeros(12, dtype=torch.int32)
    cp = torch.arange(6, dtype=torch.int64) + 2
    half = torch.full((6,), 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        stencil.stencil_context_sum(t.half(), slots, sid, cp, half, 2)
    with pytest.raises(TypeError, match="int32 slots"):
        stencil.stencil_context_sum(t, slots.long(), sid, cp, half, 2)
    with pytest.raises(TypeError, match="contiguous"):
        stencil.stencil_context_sum(t, slots, sid, cp, torch.full(
            (6, 2), 2, dtype=torch.int32)[:, 0], 2)
    with pytest.raises(ValueError, match="S = 4"):
        stencil.stencil_context_sum(t, slots[:4], sid[:4], cp, half, 2)
    # one sentence, centers 2..7 with radius 2: each sums the 4 rows
    # around it
    got = stencil.stencil_context_sum(t, slots, sid, cp, half, 2)
    want = torch.stack([t[c - 2:c + 3].sum(0) - t[c]
                        for c in range(2, 8)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- the stencil batcher -----------------------------------------------------

@pytest.mark.parametrize("sample", [-1.0, 1e-3, 1e-2, 0.1])
@pytest.mark.parametrize("B", [1, 7, 24, 256])
def test_epoch_stencil_matches_jax(sample, B):
    """Same corpus and seed: every span array, ``n_words`` and the
    expanded per-pair batch equal the JAX batcher's, two epochs running,
    padded tail batch included."""
    rng = np.random.default_rng(11)
    sents = [list(map(int, rng.integers(1, 40, rng.integers(1, 30))))
             for _ in range(30)]
    jb = JaxBatcher(sents, jax_build_vocab(sents), 2, sample, seed=9)
    pb = CBOWBatcher(sents, build_vocab(sents), 2, sample, seed=9)
    for _ in range(2):
        want, got = list(jb.epoch_stencil(B)), list(pb.epoch_stencil(B))
        assert len(got) == len(want) > 0
        for a, b in zip(want, got):
            for f in ("tokens", "sent_id", "center_pos", "half"):
                x, y = getattr(a, f), getattr(b, f)
                assert y.dtype == x.dtype == np.int32
                np.testing.assert_array_equal(y, x, err_msg=f)
            assert b.n_words == a.n_words
            ea, eb = jax_stencil_to_cbow(a, 2), stencil_to_cbow(b, 2)
            for f in ("centers", "contexts", "ctx_mask"):
                np.testing.assert_array_equal(getattr(eb, f), getattr(ea, f))
            assert eb.n_words == ea.n_words
        assert got[-1].n_words <= B


# -- push_span ---------------------------------------------------------------

@pytest.mark.parametrize("mean", [True, False])
def test_push_span_matches_xla(mean):
    """Duplicated and -1 slots, data counts (0..3 per row): the port's
    sort-free push against ``XlaTransfer.push_span`` on the same state, in
    place, rows no slot names left exactly as they were."""
    rng = np.random.default_rng(5)
    D, S = 16, 53
    st = {f: ((rng.random((CAP, D)) - 0.5) / D).astype(np.float32)
          for f in ("h", "v")}
    for f in ("h2sum", "v2sum"):
        st[f] = np.abs(rng.normal(size=(CAP, D))).astype(np.float32) * 0.1
    slots = rng.integers(0, 25, S).astype(np.int32)
    slots[::9] = -1
    counts = rng.integers(0, 4, S).astype(np.float32)
    g = (rng.normal(size=(S, D)) * 0.05).astype(np.float32)
    g[counts == 0] = 0.0
    want = XlaTransfer().push_span(
        {f: jnp.asarray(a) for f, a in st.items()}, jnp.asarray(slots),
        {"v": jnp.asarray(g)}, jnp.asarray(counts), jax_w2v_access(0.3, D),
        mean=mean)
    tr = SingleTransfer()
    tstate = state_from_jax(st, "cpu")
    ptrs = {f: t.data_ptr() for f, t in tstate.items()}
    out = tr.push_span(tstate, torch.from_numpy(slots),
                       {"v": torch.from_numpy(g)}, torch.from_numpy(counts),
                       w2v_access(0.3, D), mean=mean)
    assert out is tstate and dict(tr.push_paths) == {"v:span": 1}
    assert {f: t.data_ptr() for f, t in tstate.items()} == ptrs
    got = state_to_numpy(tstate)
    for f in st:
        _envelope(got[f], np.asarray(want[f]))
    untouched = np.setdiff1d(np.arange(CAP), slots[slots >= 0])
    for f in st:
        np.testing.assert_array_equal(got[f][untouched], st[f][untouched])


def test_push_span_all_padding_is_a_no_op():
    rng = np.random.default_rng(6)
    st = {f: rng.random((CAP, 4)).astype(np.float32)
          for f in ("h", "v", "h2sum", "v2sum")}
    tstate = state_from_jax(st, "cpu")
    SingleTransfer().push_span(tstate, torch.full((9,), -1, dtype=torch.int32),
                               {"v": torch.ones(9, 4)}, torch.ones(9),
                               w2v_access(0.3, 4), mean=True)
    for f, a in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(a, st[f])


# -- one step of each new rendering ------------------------------------------

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


@pytest.mark.parametrize("B", [24, 512])
@pytest.mark.parametrize("rendering,fused", [
    ("stencil", "0"), ("stencil", "1"), ("stencil_shared", "0"),
    ("shared", "0")])
def test_step_matches_jax_step(monkeypatch, rendering, fused, B):
    """One step of the port == ``Word2Vec._build_step`` with JAX's draws
    replayed, full batch (B = 24) and padded tail (B = 512).  For
    ``stencil`` JAX computes neu1 once through its XLA chain
    (``SMTPU_STENCIL_FUSED=0``) and once through the Pallas kernel in
    interpret mode (``=1``)."""
    monkeypatch.setenv("SMTPU_STENCIL_FUSED", fused)
    conf = {"stencil": int(rendering != "shared"),
            "shared_negatives": int(rendering != "stencil")}
    sents = corpus(seed=3)
    jm, pm = _models(sents, **conf)
    assert pm.resolved_rendering == rendering
    bat = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=13)
    batch = next(iter(bat.epoch_stencil(B) if pm.stencil
                      else bat.epoch(B)))
    assert (batch.n_words == B) == (B == 24)
    key = jax.random.key(7)
    state0 = {f: np.array(a) for f, a in jm.table.state.items()}
    out, es, ec = _jax_step(jm, batch, key)
    assert jm.resolved_rendering == rendering
    shape = (pm.shared_pool,) if pm.shared_negatives else (B, pm.negative)
    got_es, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), shape))
    if pm.shared_negatives:
        assert isinstance(got_ec, float)
        assert got_ec == pytest.approx(ec, rel=1e-6)
    else:
        assert isinstance(got_ec, int) and got_ec == int(ec)
    np.testing.assert_allclose(got_es, es, rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in state0:
        _envelope(got[f], np.asarray(out[f]))
        assert not np.array_equal(got[f], state0[f])        # the step moved
    paths = dict(pm.transfer.push_paths)
    if pm.stencil:
        assert paths["v:span"] == 1
    assert sum(paths.values()) == (2 if rendering == "stencil" else 3)


def test_stencil_train_tracks_jax():
    """3 epochs of one stencil batch each through ``train`` with per-step
    replayed draws: the per-iteration losses track JAX's and the final
    tables agree."""
    sents = corpus(n_sent=5, vocab=300, length=12, seed=4)   # 60 centers
    jm, pm = _models(sents, stencil=1)
    want = jm.train(sents, niters=3, batch_size=64)
    key = jax.random.key(0 ^ 0x5EED)       # Word2Vec(seed=0)'s stream
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), (64, pm.negative)))
    got = pm.train(sents, niters=3, batch_size=64, draws=iter(draws))
    assert pm.train_metrics["steps"] == 3
    assert pm.train_metrics["push_paths"]["v:span"] == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a))


def test_shared_err_cnt_stays_fractional():
    """Shared negatives weight each pool pair ``negative / shared_pool``, so
    a step's ``err_cnt`` is fractional: the port returns it as a float
    (rounding it per step, as the port once did, moves it off JAX's), and
    ``train`` rounds the epoch's sum once, as JAX does — over several
    steps an epoch's loss then tracks JAX's."""
    sents = corpus(n_sent=12, vocab=300, length=12, seed=8)
    jm, pm = _models(sents, shared_negatives=1)
    bat = CBOWBatcher(sents, pm.vocab, pm.window, pm.sample, seed=13)
    batch = next(iter(bat.epoch(32)))
    key = jax.random.key(3)
    _, _, ec = _jax_step(jm, batch, key)
    _, got_ec = pm.step_batch(
        batch, draws=_jax_draws(key, len(pm.vocab), (pm.shared_pool,)))
    assert got_ec == pytest.approx(ec, rel=1e-6)
    gap = abs(round(got_ec) - ec)
    assert gap > 1e-6 * ec, "the draw gave an integral count; pick another"

    jm, pm = _models(sents, shared_negatives=1)
    want = jm.train(sents, niters=2, batch_size=32)
    key = jax.random.key(0 ^ 0x5EED)
    draws = []
    for _ in range(2 * 5):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, len(pm.vocab), (pm.shared_pool,)))
    got = pm.train(sents, niters=2, batch_size=32, draws=iter(draws))
    assert pm.train_metrics["steps"] == 10             # 5 batches an epoch
    np.testing.assert_allclose(got, want, rtol=1e-4)


# -- configuration -------------------------------------------------------------

@pytest.mark.parametrize("stencil_on,shared,name", [
    (0, 0, "gather"), (0, 1, "shared"), (1, 0, "stencil"),
    (1, 1, "stencil_shared")])
def test_resolved_rendering_names_like_jax(stencil_on, shared, name):
    c = ConfigParser().update(CONF)
    c.set("word2vec", "stencil", stencil_on)
    c.set("word2vec", "shared_negatives", shared)
    m = Word2Vec(config=c, device="cpu")
    assert m.resolved_rendering == name
    m.build(corpus(seed=1))
    wrong = m.step if stencil_on else m.step_stencil
    with pytest.raises(ValueError, match="call step"):
        wrong(*([np.zeros(4, np.int32)] * (3 if stencil_on else 4)))


@pytest.mark.parametrize("sec,key,val,err,match", [
    ("word2vec", "sg", 1, ValueError, "CBOW-only"),
    ("word2vec", "dense_logits", 1, ValueError, "dense_logits"),
    ("cluster", "transfer", "local", ValueError, "push_span"),
    ("cluster", "data_plane", "bogus", ValueError, "data_plane"),
    ("cluster", "data_plane", "xla", NotImplementedError, "A16"),
    ("cluster", "transfer", "hybrid", NotImplementedError, "A12")])
def test_stencil_config_errors(sec, key, val, err, match):
    """The JAX package's own ValueErrors for what is no configuration, and
    NotImplementedError naming the ROADMAP item for what is not ported."""
    c = ConfigParser().update(CONF)
    c.set("word2vec", "stencil", 1)
    c.set(sec, key, val)
    with pytest.raises(err, match=match):
        Word2Vec(config=c, device="cpu")


@pytest.mark.parametrize("data_plane", ["auto", "pallas"])
def test_data_plane_auto_and_pallas_take_the_kernel(data_plane):
    c = ConfigParser().update(CONF)
    c.set("word2vec", "stencil", 1)
    c.set("cluster", "data_plane", data_plane)
    m = Word2Vec(config=c, device="cpu")
    losses = m.train(corpus(seed=2), niters=2, batch_size=64)
    assert losses[-1] < losses[0]
    assert m.train_metrics["rendering"] == "stencil"
