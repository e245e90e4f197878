"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one; none imports
JAX, so the file runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.kernels import (adagrad, gather, ring, scatter,
                                        stencil)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parameter.sparse_table import (shard_block,
                                                       split_rows)
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher, synthetic_corpus
from swiftmpi_tpu_torch.utils import ConfigParser

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _slots(rng, n, cap):
    """int32 slots with ~5% invalid rows and a few valid ones out of
    range on either side."""
    slots = rng.integers(0, cap, n).astype(np.int32)
    valid = rng.random(n) >= 0.05
    slots[~valid] = -1
    pos = rng.choice(np.flatnonzero(valid), 4, replace=False)
    slots[pos[:2]] = cap + 7
    slots[pos[2:]] = -3
    return slots, valid


@pytest.mark.parametrize("d", [100, 7])
def test_kernels_match_plain_on_card(dev, d):
    """gather exact; scatter rtol/atol 1e-5 (atomic order); AdaGrad rtol
    2e-6 (rsqrtf).  One launch each."""
    rng = np.random.default_rng(6)
    cap, n = 1000, 5000
    slots, valid = _slots(rng, n, cap)
    table = torch.from_numpy(rng.normal(size=(cap, d)).astype(np.float32))
    table, ts, tv = table.to(dev), torch.from_numpy(slots).to(dev), \
        torch.from_numpy(valid).to(dev)
    kernels.reset_launches()
    torch.testing.assert_close(gather.masked_gather(table, ts, tv),
                               gather.masked_gather_plain(table, ts, tv),
                               rtol=0, atol=0)
    g = torch.from_numpy(rng.normal(size=(n, d + 1)).astype(np.float32))
    g = g.to(dev)
    torch.testing.assert_close(scatter.masked_scatter_add(ts, tv, g, cap),
                               scatter.masked_scatter_add_plain(ts, tv, g,
                                                                cap),
                               rtol=1e-5, atol=1e-5)
    p, a, gr = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.normal(size=(cap, d)), np.abs(rng.normal(size=(cap, d))),
        rng.normal(size=(cap, d))))
    p2, a2 = p.clone(), a.clone()
    adagrad.adagrad_update_(p, a, gr, 0.7)
    adagrad.adagrad_update_plain_(p2, a2, gr, 0.7)
    torch.testing.assert_close(a, a2, rtol=2e-6, atol=0)
    torch.testing.assert_close(p, p2, rtol=2e-6, atol=0)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"gather": 1, "scatter": 1,
                                       "adagrad": 1, "stencil": 0,
                                       "ring": 0}


def test_kernels_take_empty_inputs_and_refuse_bad_ones(dev):
    table = torch.randn(10, 4, device=dev)
    none = torch.empty(0, dtype=torch.int32, device=dev)
    nov = torch.empty(0, dtype=torch.bool, device=dev)
    assert gather.masked_gather(table, none, nov).shape == (0, 4)
    out = scatter.masked_scatter_add(none, nov,
                                     torch.empty(0, 5, device=dev), 10)
    assert out.shape == (10, 5) and not out.any()
    slots = torch.zeros(3, dtype=torch.int32, device=dev)
    valid = torch.ones(3, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather.masked_gather(table.half(), slots, valid)
    with pytest.raises(TypeError, match="int32"):
        gather.masked_gather(table, slots.long(), valid)
    with pytest.raises(TypeError, match="contiguous"):
        scatter.masked_scatter_add(slots, valid,
                                   torch.randn(4, 3, device=dev).t(), 10)
    wide = torch.randn(10, 8, device=dev)
    with pytest.raises(TypeError, match="contiguous"):
        adagrad.adagrad_update_(wide[:, :4], wide[:, 4:], table, 0.1)


def test_one_step_on_card_matches_cpu(dev):
    """One word2vec step on the card and on the CPU from the same table
    and draws: |a - b| <= 1e-5 + 1e-3 |b|, err_cnt exact."""
    conf = {"cluster": {"transfer": "xla", "server_num": 1},
            "word2vec": {"len_vec": 16, "window": 2, "negative": 5,
                         "sample": -1, "learning_rate": 0.05},
            "server": {"initial_learning_rate": 0.3}}
    sents = synthetic_corpus(40, 300, 16, seed=3)
    models = []
    for where in ("cuda", "cpu"):
        m = Word2Vec(config=ConfigParser().update(conf), device=where,
                     capacity_per_shard=600)
        m.build(sents)
        models.append(m)
    card, cpu = models
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu")
    rng = np.random.default_rng(1)
    V, B = len(card.vocab), 64
    centers = rng.integers(0, V, B).astype(np.int32)
    contexts = rng.integers(0, V, (B, 4)).astype(np.int32)
    mask = rng.random((B, 4)) < 0.8
    draws = (rng.integers(0, V, (B, 5)), rng.random((B, 5), np.float32))
    kernels.reset_launches()
    es_c, ec_c = card.step(centers, contexts, mask, draws=draws)
    es_p, ec_p = cpu.step(centers, contexts, mask, draws=draws)
    assert ec_c == ec_p
    np.testing.assert_allclose(es_c, es_p, rtol=1e-5)
    got, want = state_to_numpy(card.table.state), \
        state_to_numpy(cpu.table.state)
    for f in want:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-3, atol=1e-5)
    counts = kernels.launch_counts()
    assert counts.pop("stencil") == 0 and counts.pop("ring") == 0
    assert all(counts.values())


def _span(rng, B, W, S, order):
    """A stream span: sentences of 7 tokens, a padded tail, 9 pad centers,
    and the real centers in span ``order`` ("sorted", "shuffled", "spread"
    across the whole span, or "none": every center padded)."""
    n_valid = S - min(5, S - 2 * W - 1)
    sent_id = np.full(S, -1, np.int32)
    sent_id[:n_valid] = np.arange(n_valid, dtype=np.int32) // 7
    n_words = 0 if order == "none" else max(B - 9, 1)
    pos = np.sort(rng.integers(0, n_valid, n_words))
    if order == "sorted":
        pos = np.minimum(np.arange(n_words) + W, n_valid - 1)
    elif order == "shuffled":
        pos = rng.permutation(np.minimum(np.arange(n_words) + W,
                                         n_valid - 1))
    center_pos = np.full(B, -1, np.int32)
    center_pos[:n_words] = pos
    half = np.zeros(B, np.int32)
    half[:n_words] = rng.integers(1, W + 1, n_words)
    return sent_id, center_pos, half


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,S,d,order", [
    (200, 4, 208, 7, "sorted"),        # d = 7: one element a lane
    (200, 4, 208, 100, "sorted"),      # d = 100: four elements a lane
    (200, 4, 208, 100, "shuffled"),    # centers in no span order
    (64, 4, 72, 100, "none"),          # every center padded: all zero
    (5, 4, 9, 100, "spread"),          # S = 2W + 1
    (64, 4, 4000, 100, "spread"),      # neighbours far apart in the span
    (100, 10, 120, 100, "sorted"),     # K = 21: two chunks of window rows
    (300, 4, 2000, 36, "sorted")])     # d = 36: 9 lanes of 4
def test_stencil_kernel_matches_plain_on_card(dev, B, W, S, d, order,
                                              dtype):
    """B4 from the stencil batch itself, on a float32 or bfloat16 table,
    against its plain version (the window inputs, then the k-order sum of
    upcast rows), bit for bit.  One launch."""
    rng = np.random.default_rng(S + d)
    cap = 1000
    sent_id, center_pos, half = _span(rng, B, W, S, order)
    slots = rng.integers(0, cap, S).astype(np.int32)
    slots[sent_id < 0] = -1
    table = torch.from_numpy(rng.normal(size=(cap, d)).astype(np.float32))
    table, slots = table.to(dev, dtype), torch.from_numpy(slots).to(dev)
    sid, cp, hf = (torch.from_numpy(a).to(dev) for a in (sent_id,
                                                          center_pos, half))
    cp = cp.long()
    kernels.reset_launches()
    got = stencil.stencil_context_sum(table, slots, sid, cp, hf, W)
    want = stencil.stencil_context_sum_plain(table, slots, sid, cp, hf, W)
    torch.cuda.synchronize()
    assert stencil.launches == 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got[cp < 0].any()


def test_stencil_kernel_refuses_bad_inputs(dev):
    table = torch.randn(20, 8, device=dev)
    slots = torch.arange(12, dtype=torch.int32, device=dev)
    sid = torch.zeros(12, dtype=torch.int32, device=dev)
    cp = torch.arange(6, dtype=torch.int64, device=dev) + 2
    half = torch.full((6,), 2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        stencil.stencil_context_sum(table.half(), slots, sid, cp, half, 2)
    with pytest.raises(TypeError, match="int64 center_pos"):
        stencil.stencil_context_sum(table, slots, sid, cp.int(), half, 2)
    with pytest.raises(TypeError, match="contiguous"):
        stencil.stencil_context_sum(table, slots, sid, cp, torch.full(
            (6, 2), 2, dtype=torch.int32, device=dev)[:, 0], 2)
    with pytest.raises(ValueError, match="S = 4"):
        stencil.stencil_context_sum(table, slots[:4], sid[:4], cp, half, 2)
    with pytest.raises(ValueError, match="share one device"):
        stencil.stencil_context_sum(table, slots.cpu(), sid, cp, half, 2)


@pytest.mark.parametrize("shared", [0, 1])
def test_one_stencil_step_on_card_matches_cpu(dev, shared):
    """One stencil (shared = 0) or stencil_shared step on the card and on
    the CPU from the same table and draws: |a - b| <= 1e-5 + 1e-3 |b|,
    err_cnt exact (stencil) or within 1e-6 relative (shared); the card
    step launched B4 once and pushed its span family."""
    conf = {"cluster": {"transfer": "xla", "server_num": 1},
            "word2vec": {"len_vec": 16, "window": 2, "negative": 5,
                         "sample": 1e-3, "learning_rate": 0.05,
                         "stencil": 1, "shared_negatives": shared,
                         "shared_pool": 64},
            "server": {"initial_learning_rate": 0.3}}
    sents = synthetic_corpus(40, 300, 16, seed=3)
    models = []
    for where in ("cuda", "cpu"):
        m = Word2Vec(config=ConfigParser().update(conf), device=where,
                     capacity_per_shard=600)
        m.build(sents)
        models.append(m)
    card, cpu = models
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu")
    batch = next(iter(CBOWBatcher(sents, card.vocab, 2, 1e-3,
                                  seed=5).epoch_stencil(96)))
    rng = np.random.default_rng(1)
    shape = (64,) if shared else (96, 5)
    draws = (rng.integers(0, len(card.vocab), shape),
             rng.random(shape, np.float32))
    kernels.reset_launches()
    es_c, ec_c = card.step_batch(batch, draws=draws)
    es_p, ec_p = cpu.step_batch(batch, draws=draws)
    assert stencil.launches == 1
    np.testing.assert_allclose(ec_c, ec_p, rtol=1e-6 if shared else 0)
    np.testing.assert_allclose(es_c, es_p, rtol=1e-5)
    got, want = state_to_numpy(card.table.state), \
        state_to_numpy(cpu.table.state)
    for f in want:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-3, atol=1e-5)
    assert card.transfer.push_paths["v:span"] == 1


# -- B5: the ring exchange and the sharded parameter server ------------------

def _ring_x(rng, n, tail, dtype, dev):
    shape = (n, n, *tail)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-1, 1000, shape)
                                .astype(np.int32)).to(dev)
    return torch.from_numpy(rng.standard_normal(shape)
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("n,tail,dtype", [
    (8, (13, 100), torch.float32),     # 16-byte blocks
    (8, (13, 101), torch.float32),     # odd row width: blocks 4 mod 16
    (8, (1001,), torch.int32),         # odd C
    (8, (13125,), torch.int32),        # the sharded h requests
    (8, (13125, 100), torch.float32),  # the sharded h rows
    (8, (13125, 101), torch.float32),  # odd width at full size
    (3, (7, 5), torch.float32),
    (5, (4099, 3), torch.float32),     # odd n, several items a step
    (2, (4097, 100), torch.float32),
    (2, (3,), torch.int32),
    (1, (5, 4), torch.float32)])
def test_ring_kernel_matches_plain_on_card(dev, n, tail, dtype):
    """B5 against its plain version, bit for bit (it is a copy), three
    exchanges in a row so the epochs grow: one send launch and one wait
    launch per exchange, no wait timing out.  List form and stacked
    form."""
    rng = np.random.default_rng(n + len(tail))
    kernels.reset_launches()
    for _ in range(3):
        x = _ring_x(rng, n, tail, dtype, dev)
        got = ring.ring_exchange_stacked(x)
        want = ring.ring_exchange_stacked_plain(x)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)
    assert ring.launches == 3
    xs = list(x.unbind(0))
    for g, w in zip(ring.ring_exchange(xs), ring.ring_exchange_plain(xs)):
        assert torch.equal(g, w)
    assert ring.launches == 4
    assert ring.timeouts() == 0


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ring_kernel_takes_unaligned_blocks_and_refuses_bad_inputs(
        dev, offset):
    """Operands that start 4, 8 or 12 bytes into an allocation and rank
    slices that are not adjacent (a bucket slice of an (n, n + 1, ...)
    tensor): source and destination out of step mod 16, so the body is cut
    from two aligned loads, and blocks of 111 words (head and tail words);
    and what the kernel does not take."""
    n = 4
    base = torch.randn(n * (n + 1) * 37 * 3 + offset, device=dev)
    x = base[offset:].view(n, n + 1, 37, 3)[:, :n]
    assert x.data_ptr() % 16 == 4 * offset and not x.is_contiguous()
    got = ring.ring_exchange_stacked(x)
    assert torch.equal(got, ring.ring_exchange_stacked_plain(x))
    with pytest.raises(ValueError, match="leading dim"):
        ring.ring_exchange([torch.zeros(3, 4, device=dev)] * 4)
    with pytest.raises(TypeError, match="float32 or int32"):
        ring.ring_exchange([torch.zeros(2, 4, device=dev).half()] * 2)
    with pytest.raises(TypeError, match="contiguous"):
        ring.ring_exchange([torch.zeros(4, 2, device=dev).t()] * 2)
    with pytest.raises(TypeError, match="contiguous"):
        ring.ring_exchange_stacked(torch.zeros(2, 2, 4, 3,
                                               device=dev)[..., :2])
    with pytest.raises(NotImplementedError, match="A11"):
        ring.ring_exchange([torch.zeros(2, 4, device=dev),
                            torch.zeros(2, 4)])
    empty = ring.ring_exchange([torch.zeros(2, 0, device=dev)] * 2)
    assert empty[0].shape == (2, 0)
    assert ring.timeouts() == 0


def _zipf_slots(rng, shape, cap, pad):
    """Zipf-duplicated int32 slots with a share ``pad`` of -1 padding and
    a few valid ones out of range."""
    slots = ((rng.zipf(1.2, shape) - 1) % cap).astype(np.int32)
    slots[rng.random(shape) < pad] = -1
    flat = slots.reshape(-1)
    flat[rng.choice(flat.size, 4, replace=False)] = [cap, cap + 9, -3, -8]
    return slots


@pytest.mark.parametrize("R,n,w,cap,pad", [
    (None, 20_000, 100, 5_000, 0.1),   # one shard, the vector path
    (None, 20_000, 101, 5_000, 0.1),   # the scalar path
    (None, 20_000, 1, 5_000, 0.1),     # one thread a row
    (8, 6_000, 100, 1_500, 0.9),       # owners of a card, mostly padding
    (8, 6_000, 1, 1_500, 0.9),
    (3, 3_000, 7, 800, 1.0)])          # all padding
def test_scatter_kernel_matches_plain_on_card(dev, R, n, w, cap, pad):
    """B3 against its plain version on Zipf-duplicated slots: sums within
    1e-5 + 1e-3 |b| (float reductions in no fixed order), counts exact;
    one launch for all R ranks, sums and counts."""
    rng = np.random.default_rng(n + w)
    shape = (n,) if R is None else (R, n)
    slots = torch.from_numpy(_zipf_slots(rng, shape, cap, pad)).to(dev)
    valid = (slots >= 0) & torch.from_numpy(
        rng.random(shape) >= 0.02).to(dev)
    g = torch.from_numpy(rng.normal(size=(*shape, w))
                         .astype(np.float32)).to(dev)
    kernels.reset_launches()
    acc, cnt = scatter.masked_scatter_add(slots, valid, g, cap, counts=True)
    want, want_cnt = scatter.masked_scatter_add_plain(slots, valid, g, cap,
                                                      counts=True)
    torch.cuda.synchronize()
    assert scatter.launches == 1
    assert acc.shape == (*shape[:-1], cap, w) and cnt.shape == want_cnt.shape
    torch.testing.assert_close(acc, want, rtol=1e-3, atol=1e-5)
    assert torch.equal(cnt, want_cnt)
    only = scatter.masked_scatter_add(slots, valid, g, cap)
    torch.testing.assert_close(only, want, rtol=1e-3, atol=1e-5)
    if pad == 1.0:
        assert not acc.any() and not cnt.any()


@pytest.mark.parametrize("shared", [0, 1])
def test_one_sharded_step_on_card_matches_cpu(dev, shared):
    """One step of the sharded parameter server (8 ranks on the card) and
    the same step on the CPU from the same table and draws: |a - b| <=
    1e-5 + 1e-3 |b|, err_cnt exact (gather) or within 1e-6 relative
    (shared); the card step launched the ring kernel for every exchange."""
    conf = {"cluster": {"transfer": "tpu", "server_num": 8},
            "word2vec": {"len_vec": 16, "window": 2, "negative": 5,
                         "sample": -1, "learning_rate": 0.05,
                         "shared_negatives": shared, "shared_pool": 64},
            "server": {"initial_learning_rate": 0.3}}
    sents = synthetic_corpus(40, 300, 16, seed=3)
    models = []
    for where in ("cuda", "cpu"):
        m = Word2Vec(config=ConfigParser().update(conf), device=where,
                     capacity_per_shard=80)
        m.build(sents)
        models.append(m)
    card, cpu = models
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu",
                                     mesh=cpu.cluster.mesh)
    rng = np.random.default_rng(1)
    V, B = len(card.vocab), 64
    centers = rng.integers(0, V, B).astype(np.int32)
    contexts = rng.integers(0, V, (B, 4)).astype(np.int32)
    mask = rng.random((B, 4)) < 0.8
    shape = (64,) if shared else (B, 5)
    draws = (rng.integers(0, V, shape), rng.random(shape, np.float32))
    kernels.reset_launches()
    es_c, ec_c = card.step(centers, contexts, mask, draws=draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu.step(centers, contexts, mask, draws=draws)
    np.testing.assert_allclose(ec_c, ec_p, rtol=1e-6 if shared else 0)
    np.testing.assert_allclose(es_c, es_p, rtol=1e-5)
    got, want = state_to_numpy(card.table.state), \
        state_to_numpy(cpu.table.state)
    for f in want:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-3, atol=1e-5)
    # two exchanges per pull and per pushed family, one send launch per
    # card each; one gather per pull, one scatter-add and one AdaGrad per
    # pushed family, each for all 8 ranks
    assert counts["ring"] == (10 if shared else 8)
    assert counts["scatter"] == (3 if shared else 2)
    assert counts["gather"] == 2 and counts["adagrad"] == (3 if shared
                                                           else 2)
    assert ring.timeouts() == 0 and card.transfer.overflow_count() == 0


# -- B2 and B1: rank dimension, fused scale, row-indexed ---------------------

def _block(rng, R, cap, d, dev, pad=0):
    """An (R, cap, d) float32 block; ``pad`` extra rows per rank make the
    rank stride (cap + pad) * d."""
    full = torch.from_numpy(rng.normal(size=(R, cap + pad, d))
                            .astype(np.float32)).to(dev)
    return full[:, :cap]


@pytest.mark.parametrize("R", [None, 1, 3, 8])
@pytest.mark.parametrize("d", [100, 101, 7])
def test_gather_forms_match_plain_on_card(dev, R, d):
    """B2 on a table or a block of R shards (contiguous, and at a rank
    stride of (cap + 3) * d), bit for bit against its plain version, with
    invalid and out-of-range slots; all-invalid slots give zeros; one
    launch a call."""
    rng = np.random.default_rng(d + (R or 0))
    cap, n = 1000, 5000
    lead = () if R is None else (R,)
    for pad in (0, 3):
        if R is None and pad:
            continue
        table = _block(rng, R or 1, cap, d, dev, pad)
        table = table[0] if R is None else table
        pairs = [_slots(rng, n, cap) for _ in range(R or 1)]
        slots = torch.from_numpy(np.stack([s for s, _ in pairs])
                                 .reshape(*lead, n)).to(dev)
        valid = torch.from_numpy(np.stack([v for _, v in pairs])
                                 .reshape(*lead, n)).to(dev)
        kernels.reset_launches()
        got = gather.masked_gather(table, slots, valid)
        want = gather.masked_gather_plain(table, slots, valid)
        torch.cuda.synchronize()
        assert gather.launches == 1 and got.shape == (*lead, n, d)
        assert torch.equal(got, want)
        none = torch.zeros_like(valid)
        out = torch.full_like(got, 5.0)
        gather.masked_gather(table, slots, none, out=out)
        torch.cuda.synchronize()
        assert not out.any()


def test_gather_takes_empty_and_unaligned_inputs_and_refuses_bad_ones(dev):
    """Empty slots; a table that starts 4 bytes into its allocation (the
    scalar form); and the refusals of the rank form."""
    block = torch.randn(3, 50, 100, device=dev)
    none = torch.empty(3, 0, dtype=torch.int32, device=dev)
    assert gather.masked_gather(block, none, none.bool()).shape == (3, 0, 100)
    base = torch.randn(50 * 100 + 1, device=dev)
    table = base[1:].view(50, 100)
    assert table.data_ptr() % 16 == 4
    slots = torch.arange(60, dtype=torch.int32, device=dev) % 53
    valid = torch.ones(60, dtype=torch.bool, device=dev)
    assert torch.equal(gather.masked_gather(table, slots, valid),
                       gather.masked_gather_plain(table, slots, valid))
    s3 = slots.view(3, 20)
    with pytest.raises(ValueError, match="block"):
        gather.masked_gather(block, slots, valid)
    with pytest.raises(ValueError, match="rows are contiguous"):
        gather.masked_gather(block.transpose(1, 2), s3, valid.view(3, 20))
    with pytest.raises(TypeError, match="int32"):
        gather.masked_gather(block, s3.long(), valid.view(3, 20))


@pytest.mark.parametrize("R", [None, 1, 3, 8])
@pytest.mark.parametrize("d", [100, 101, 7])
@pytest.mark.parametrize("op", [None, "mul", "div"])
def test_adagrad_dense_forms_match_plain_on_card(dev, R, d, op):
    """B1 over a table or a block of R shards, with no per-row operand or
    with one that multiplies or divides the grad row: bit for bit against
    its plain version (each op rounded alone, in the plain order); one
    launch."""
    rng = np.random.default_rng(7 * d + (R or 0))
    cap = 700
    lead = () if R is None else (R,)
    shape = (*lead, cap, d)
    # a block's rank stride is (cap + 2) * d
    p, a = (_block(rng, R or 1, cap, d, dev, pad=0 if R is None else 2)
            for _ in range(2))
    if R is None:
        p, a = p[0], a[0]
    a.abs_()
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    row = torch.from_numpy(rng.integers(1, 9, shape[:-1])
                           .astype(np.float32)).to(dev)
    scale = {} if op is None else {op: 1.0 / row if op == "mul" else row}
    p2, a2 = p.clone(), a.clone()
    kernels.reset_launches()
    adagrad.adagrad_update_(p, a, g, 0.7, **scale)
    adagrad.adagrad_update_plain_(p2, a2, g, 0.7, **scale)
    torch.cuda.synchronize()
    assert adagrad.launches == 1
    assert torch.equal(p, p2) and torch.equal(a, a2)


@pytest.mark.parametrize("d", [100, 101, 7])
@pytest.mark.parametrize("masked,scaled", [(False, False), (True, True),
                                           (False, True)])
def test_adagrad_rows_match_plain_on_card(dev, d, masked, scaled):
    """Row-indexed B1: distinct slots (a few out of range, skipped), a
    mask or none, the reciprocal or none: bit for bit against its plain
    version, every other row untouched; one launch.  Empty rows launch
    nothing."""
    rng = np.random.default_rng(3 * d + masked)
    cap, M = 9000, 2806
    p = torch.from_numpy(rng.normal(size=(cap, d)).astype(np.float32)).to(dev)
    a = torch.from_numpy(np.abs(rng.normal(size=(cap, d)))
                         .astype(np.float32)).to(dev)
    slots = rng.permutation(cap)[:M].astype(np.int32)
    slots[:4] = [cap, cap + 1, -1, -5]
    slots = torch.from_numpy(slots).to(dev)
    mask = torch.from_numpy(rng.random(M) < 0.6).to(dev) if masked else None
    g = torch.from_numpy(rng.normal(size=(M, d)).astype(np.float32)).to(dev)
    mul = (1.0 / torch.from_numpy(rng.integers(1, 9, M).astype(np.float32))
           ).to(dev) if scaled else None
    p0, a0 = p.clone(), a.clone()
    p2, a2 = p.clone(), a.clone()
    kernels.reset_launches()
    adagrad.adagrad_update_rows_(p, a, slots, mask, g, 0.7, mul=mul)
    adagrad.adagrad_update_rows_plain_(p2, a2, slots, mask, g, 0.7, mul=mul)
    torch.cuda.synchronize()
    assert adagrad.launches == 1
    assert torch.equal(p, p2) and torch.equal(a, a2)
    keep = (slots >= 0) & (slots < cap)
    keep = keep if mask is None else keep & mask
    other = torch.ones(cap, dtype=torch.bool, device=dev)
    other[slots[keep].long()] = False
    assert torch.equal(p[other], p0[other]) and torch.equal(a[other],
                                                            a0[other])
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    adagrad.adagrad_update_rows_(p, a, empty, None,
                                 torch.empty(0, d, device=dev), 0.7)
    assert adagrad.launches == 1


def test_adagrad_and_blocks_refuse_bad_inputs(dev):
    """What B1's forms and ``shard_block`` refuse: shards that are not
    contiguous or not one block at one stride; mismatched accum strides;
    int64 slots; a mask of the wrong shape."""
    blk = torch.zeros(4, 30, 8, device=dev)
    for bad in ([blk[0], blk[1], blk[3]], [blk[1], blk[0]],
                [torch.zeros(30, 8, device=dev),
                 torch.zeros(30, 8, device=dev)]):
        with pytest.raises(ValueError, match="shard_block"):
            shard_block(bad)
    with pytest.raises(ValueError, match="contiguous"):
        shard_block([t.t() for t in torch.zeros(2, 8, 30, device=dev)])
    assert shard_block([blk[0], blk[1], blk[2]]).shape == (3, 30, 8)
    g = torch.zeros(4, 30, 8, device=dev)
    with pytest.raises(ValueError, match="does not match"):
        adagrad.adagrad_update_(blk, torch.zeros(4, 31, 8, device=dev)
                                [:, :30], g, 0.1)
    with pytest.raises(TypeError, match="disjoint"):
        adagrad.adagrad_update_(blk[0].expand(4, 30, 8),
                                blk[0].expand(4, 30, 8), g, 0.1)
    slots = torch.arange(5, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        adagrad.adagrad_update_rows_(blk[0], blk[1], slots.long(), None,
                                     torch.zeros(5, 8, device=dev), 0.1)
    with pytest.raises(TypeError, match="mask"):
        adagrad.adagrad_update_rows_(blk[0], blk[1], slots,
                                     torch.ones(4, dtype=torch.bool,
                                                device=dev),
                                     torch.zeros(5, 8, device=dev), 0.1)


# -- bf16 tables: B2's bf16 rows, B1's mixed form, B5 on bf16 buckets --------

@pytest.mark.parametrize("R", [None, 1, 3, 8])
@pytest.mark.parametrize("d", [100, 101, 7])
def test_gather_bf16_forms_match_plain_on_card(dev, R, d):
    """B2 on a bfloat16 table or block of R shards (contiguous, and at a
    rank stride of (cap + 3) * d): bfloat16 rows, bit for bit against the
    plain version; 8-byte groups of four at d = 100, one element a lane at
    d = 101 and 7; one launch."""
    rng = np.random.default_rng(5 * d + (R or 0))
    cap, n = 1000, 5000
    lead = () if R is None else (R,)
    for pad in (0, 3):
        if R is None and pad:
            continue
        full = torch.from_numpy(rng.normal(size=(R or 1, cap + pad, d))
                                .astype(np.float32)).to(dev, torch.bfloat16)
        table = full[:, :cap]
        table = table[0] if R is None else table
        pairs = [_slots(rng, n, cap) for _ in range(R or 1)]
        slots = torch.from_numpy(np.stack([s for s, _ in pairs])
                                 .reshape(*lead, n)).to(dev)
        valid = torch.from_numpy(np.stack([v for _, v in pairs])
                                 .reshape(*lead, n)).to(dev)
        kernels.reset_launches()
        got = gather.masked_gather(table, slots, valid)
        want = gather.masked_gather_plain(table, slots, valid)
        torch.cuda.synchronize()
        assert gather.launches == 1 and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_gather_bf16_takes_unaligned_rows(dev):
    """A bfloat16 table that starts 2 bytes into its allocation takes the
    one-element form; bit for bit."""
    base = torch.randn(50 * 100 + 1, device=dev).to(torch.bfloat16)
    table = base[1:].view(50, 100)
    assert table.data_ptr() % 8 == 2
    slots = torch.arange(60, dtype=torch.int32, device=dev) % 53
    valid = torch.ones(60, dtype=torch.bool, device=dev)
    got = gather.masked_gather(table, slots, valid)
    want = gather.masked_gather_plain(table, slots, valid)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("R", [None, 3, 8])
@pytest.mark.parametrize("d", [100, 101, 7])
@pytest.mark.parametrize("op", [None, "mul", "div"])
def test_adagrad_mixed_dense_forms_match_plain_on_card(dev, R, d, op):
    """B1's mixed form (bfloat16 param, float32 accum and grads) over a
    table or a block of R shards, with or without the per-row operand:
    bit for bit against the plain version (float32 math, one
    round-to-nearest-even on store); one launch."""
    rng = np.random.default_rng(11 * d + (R or 0))
    cap = 700
    lead = () if R is None else (R,)
    shape = (*lead, cap, d)
    # a block's rank stride is (cap + 2) * d, for param and accum alike
    pad = 0 if R is None else 2
    p = (_block(rng, R or 1, cap, d, dev, pad) * 0.05).to(torch.bfloat16)
    pb = torch.empty((R or 1, cap + pad, d), dtype=torch.bfloat16,
                     device=dev)[:, :cap]
    p = pb.copy_(p)
    a = _block(rng, R or 1, cap, d, dev, pad).abs_()
    if R is None:
        p, a = p[0], a[0]
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    row = torch.from_numpy(rng.integers(1, 9, shape[:-1])
                           .astype(np.float32)).to(dev)
    scale = {} if op is None else {op: 1.0 / row if op == "mul" else row}
    p2, a2 = p.clone(), a.clone()
    kernels.reset_launches()
    adagrad.adagrad_update_(p, a, g, 0.7, **scale)
    adagrad.adagrad_update_plain_(p2, a2, g, 0.7, **scale)
    torch.cuda.synchronize()
    assert adagrad.launches == 1 and p.dtype == torch.bfloat16
    assert torch.equal(p.view(torch.int16), p2.view(torch.int16))
    assert torch.equal(a, a2)


@pytest.mark.parametrize("d", [100, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_adagrad_mixed_rows_match_plain_on_card(dev, d, masked):
    """Row-indexed mixed form: distinct slots (a few out of range), a mask
    or none, the reciprocal: bit for bit, every other row untouched."""
    rng = np.random.default_rng(13 * d + masked)
    cap, M = 9000, 2806
    p = torch.from_numpy((rng.normal(size=(cap, d)) * 0.05)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    a = torch.from_numpy(np.abs(rng.normal(size=(cap, d)))
                         .astype(np.float32)).to(dev)
    slots = rng.permutation(cap)[:M].astype(np.int32)
    slots[:4] = [cap, cap + 1, -1, -5]
    slots = torch.from_numpy(slots).to(dev)
    mask = torch.from_numpy(rng.random(M) < 0.6).to(dev) if masked else None
    g = torch.from_numpy(rng.normal(size=(M, d)).astype(np.float32)).to(dev)
    mul = (1.0 / torch.from_numpy(rng.integers(1, 9, M).astype(np.float32))
           ).to(dev)
    p0 = p.clone()
    p2, a2 = p.clone(), a.clone()
    kernels.reset_launches()
    adagrad.adagrad_update_rows_(p, a, slots, mask, g, 0.7, mul=mul)
    adagrad.adagrad_update_rows_plain_(p2, a2, slots, mask, g, 0.7, mul=mul)
    torch.cuda.synchronize()
    assert adagrad.launches == 1
    assert torch.equal(p.view(torch.int16), p2.view(torch.int16))
    assert torch.equal(a, a2)
    keep = (slots >= 0) & (slots < cap)
    keep = keep if mask is None else keep & mask
    other = torch.ones(cap, dtype=torch.bool, device=dev)
    other[slots[keep].long()] = False
    assert torch.equal(p[other].view(torch.int16),
                       p0[other].view(torch.int16))


@pytest.mark.parametrize("n,tail", [
    (8, (13125, 100)),    # the sharded h rows of a bf16 table: 8 mod 16
    (8, (13, 100)),       # 2,600-byte blocks
    (8, (2, 3)),          # 12-byte blocks: head and tail words only
    (3, (7, 6))])
def test_ring_kernel_moves_bf16_blocks_on_card(dev, n, tail):
    """B5 on bfloat16 operands, taken as 4-byte words: bit for bit against
    the plain version, one exchange launch; a block that is no whole
    number of words raises."""
    rng = np.random.default_rng(n + tail[0])
    x = torch.from_numpy(rng.standard_normal((n, n, *tail))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    kernels.reset_launches()
    got = ring.ring_exchange_stacked(x)
    want = ring.ring_exchange_stacked_plain(x)
    torch.cuda.synchronize()
    assert ring.launches == 1 and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert ring.timeouts() == 0
    with pytest.raises(ValueError, match="4-byte words"):
        ring.ring_exchange_stacked(torch.zeros((2, 2, 3), device=dev,
                                               dtype=torch.bfloat16))


@pytest.mark.parametrize("path", ["gather", "stencil", "gather@8"])
def test_one_bf16_step_on_card_matches_cpu(dev, path):
    """One step with ``[server] dtype: bfloat16`` on the card and on the
    CPU from the same table and draws: h and v within 1e-5 + 1e-3 |b| or
    one bfloat16 ulp of b, whichever is wider (the card sums some grads in
    another order, a float32 difference that can cross a rounding
    boundary; near zero a bfloat16 step is finer than 1e-5), the float32
    accumulators within 1e-5 + 1e-3 |b|, err_cnt exact."""
    rendering, _, shards = path.partition("@")
    conf = {"cluster": {"transfer": "tpu" if shards else "xla",
                        "server_num": int(shards or 1)},
            "word2vec": {"len_vec": 16, "window": 2, "negative": 5,
                         "sample": 1e-3 if rendering == "stencil" else -1,
                         "learning_rate": 0.05,
                         "stencil": int(rendering == "stencil")},
            "server": {"initial_learning_rate": 0.3, "dtype": "bfloat16"}}
    sents = synthetic_corpus(40, 300, 16, seed=3)
    models = []
    for where in ("cuda", "cpu"):
        m = Word2Vec(config=ConfigParser().update(conf), device=where,
                     capacity_per_shard=80 if shards else 600)
        m.build(sents)
        models.append(m)
    card, cpu = models
    # the card's table, dealt to the CPU model's shards as it deals them
    cpu.table.state = {
        f: (split_rows(torch.cat(v).cpu(), cpu.cluster.mesh) if shards
            else v.cpu().clone())
        for f, v in card.table.state.items()}
    rng = np.random.default_rng(1)
    V, B = len(card.vocab), 64
    draws = (rng.integers(0, V, (B, 5)), rng.random((B, 5), np.float32))
    if rendering == "stencil":
        batch = next(iter(CBOWBatcher(sents, card.vocab, 2, 1e-3,
                                      seed=5).epoch_stencil(B)))
    else:
        batch = next(iter(CBOWBatcher(sents, card.vocab, 2, -1,
                                      seed=5).epoch(B)))
    kernels.reset_launches()
    es_c, ec_c = card.step_batch(batch, draws=draws)
    es_p, ec_p = cpu.step_batch(batch, draws=draws)
    assert ec_c == ec_p
    np.testing.assert_allclose(es_c, es_p, rtol=1e-5)
    for f in ("h", "v", "h2sum", "v2sum"):
        got, want = card.table.state[f], cpu.table.state[f]
        got = torch.cat(got) if shards else got
        want = torch.cat(want) if shards else want
        if f in ("h", "v"):
            assert got.dtype == torch.bfloat16
            gap = (got.cpu().float() - want.float()).abs()
            mag = want.abs()
            step = ((mag.view(torch.int16) + 1).view(torch.bfloat16).float()
                    - mag.float())
            limit = torch.maximum(1e-5 + 1e-3 * mag.float(), step)
            assert bool((gap <= limit).all()), (f, gap.max().item())
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                                       atol=1e-5)
    counts = kernels.launch_counts()
    assert counts["gather"] and counts["adagrad"]
    assert counts["stencil"] == (rendering == "stencil")
