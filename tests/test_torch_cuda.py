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
from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, _batch_fields
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


def test_scatter_into_out_on_card_sums_slices_in_launch_order(dev):
    """B3 with ``out=`` at the error feedback's data-axis bank: 8 slices
    of 20,000 rows, each of distinct slots, one launch each into one
    (117,672, 100) plane and its counts, bit for bit against the plain
    version's slices added in the same order; a wrong ``out`` raises."""
    rng = np.random.default_rng(18)
    S, n, w, cap = 8, 20_000, 100, 117_672
    slots = torch.from_numpy(np.stack([
        rng.permutation(cap)[:n] for _ in range(S)]).astype(np.int32)).to(dev)
    slots[:, :50] = -1
    valid = slots >= 0
    g = torch.from_numpy(rng.normal(size=(S, n, w))
                         .astype(np.float32)).to(dev)
    acc, cnt = torch.zeros(cap, w, device=dev), torch.zeros(cap, device=dev)
    want, want_cnt = torch.zeros_like(acc), torch.zeros_like(cnt)
    kernels.reset_launches()
    for s in range(S):
        scatter.masked_scatter_add(slots[s], valid[s], g[s], cap,
                                   counts=True, out=(acc, cnt))
        scatter.masked_scatter_add_plain(slots[s], valid[s], g[s], cap,
                                         counts=True, out=(want, want_cnt))
    torch.cuda.synchronize()
    assert scatter.launches == S
    assert torch.equal(acc, want) and torch.equal(cnt, want_cnt)
    with pytest.raises(TypeError):
        scatter.masked_scatter_add(slots[0], valid[0], g[0], cap,
                                   out=torch.zeros(cap, w + 1, device=dev))


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


# -- the input and dispatch path: no host sync, pinned copies, graphs -------

#: rendering -> its [word2vec] keys
RENDERINGS = {"gather": {}, "stencil": {"stencil": 1}, "sg": {"sg": 1},
              "sg_shared": {"sg": 1, "shared_negatives": 1,
                            "shared_pool": 256},
              "dense": {"dense_logits": 1}}


def _path_model(dev, rendering, seed=0, dtype="float32", w2v=None,
                cluster=None, **worker):
    """A model of a rendering of ``RENDERINGS`` at the reference widths;
    at a batch of 100 its h push goes dense (B3) and its v push sparse, as
    at the reference shape (the dense rendering's h push is the table's).
    ``w2v``: more [word2vec] keys; ``cluster``: the model's Cluster."""
    conf = {"cluster": {"transfer": "xla", "server_num": 1},
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": 1e-3, "learning_rate": 0.05,
                         **RENDERINGS[rendering], **(w2v or {})},
            "server": {"initial_learning_rate": 0.7, "dtype": dtype},
            "worker": worker}
    c = ConfigParser().update(conf)
    if cluster is not None:
        cluster = Cluster(c, devices=cluster).initialize()
    m = Word2Vec(config=c, device=dev, seed=seed, cluster=cluster)
    assert m.resolved_rendering == rendering
    sents = synthetic_corpus(400, 3000, 40, seed=8)
    m.build(sents)
    return m, sents


def _items(m, sents, B, n, group=1):
    """``n`` work items of ``group`` stacked batches (as ``_epoch_items``
    renders them), numpy."""
    from swiftmpi_tpu_torch.models.word2vec import _stack_group_host
    b = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
    it = iter(b.epoch_stencil(B) if m.stencil else b.epoch(B))
    return [_stack_group_host([next(it) for _ in range(group)])
            for _ in range(n)]


@pytest.mark.parametrize("rendering", ["gather", "stencil", "sg",
                                       "sg_shared", "dense"])
def test_step_runs_with_no_host_sync(dev, rendering):
    """One step, its batch staged through pinned memory and a side stream
    (``CudaTransfer``), under ``torch.cuda.set_sync_debug_mode("error")``:
    nothing in the step or the staging synchronizes with the host."""
    from swiftmpi_tpu_torch.io.pipeline import CudaTransfer
    m, sents = _path_model(dev, rendering)
    batches = [tuple(f[0] for f in g) for g in _items(m, sents, 100, 3)]
    stage = CudaTransfer(dev)
    for fields in batches[:2]:          # builds the kernels, warms up
        m._step_fields(stage.ready(stage(fields)))
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        es, ec = m._step_fields(stage.ready(stage(batches[2])))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(es) and int(ec) > 0
    counts = kernels.launch_counts()
    assert counts["gather"] and counts["adagrad"]
    assert counts["stencil"] == (rendering == "stencil")
    stage.close()
    assert stage.pending() == 0


def test_cuda_transfer_stages_items_exactly(dev):
    """Every numpy leaf arrives on the card unchanged; other leaves pass
    through; the pinned buffers are held until their copy completes."""
    from swiftmpi_tpu_torch.io.pipeline import CudaTransfer
    rng = np.random.default_rng(3)
    stage = CudaTransfer(dev)
    items = [("group", (rng.integers(0, 9, (4, 300)).astype(np.int32),
                        rng.random((4, 300, 8)) < 0.5), [3, 4, 5, 6])
             for _ in range(6)]
    got = [stage.ready(stage(it)) for it in items]
    assert stage.pending() <= 6
    torch.cuda.synchronize()
    for it, g in zip(items, got):
        assert g[0] == "group" and g[2] == it[2]
        for a, b in zip(it[1], g[1]):
            assert b.is_cuda and b.dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(b.cpu().numpy(), a)
    stage.close()
    assert stage.pending() == 0


def _graph_vs_plain(dev, rendering, B, n, deterministic, dtype="float32"):
    """Two models from one table and generator seed: one runs groups of
    ``n`` steps as ``_FusedSteps`` replays, the other the same steps one
    by one (after a warm-up on a side stream, as ``train()`` does before a
    capture).  Returns both, the per-group ``(err_sum, err_cnt)`` of each,
    and the launches of each."""
    from swiftmpi_tpu_torch.models.word2vec import _FusedSteps
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        warm, _ = _path_model(dev, rendering, seed=9, dtype=dtype)
        graph_m, sents = _path_model(dev, rendering, seed=1, dtype=dtype)
        plain_m, _ = _path_model(dev, rendering, seed=1, dtype=dtype)
        for f, t in plain_m.table.state.items():
            t.copy_(graph_m.table.state[f])
        groups = _items(graph_m, sents, B, 3, group=n)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(n):
                warm._step_fields(tuple(f[i] for f in groups[0]))
        torch.cuda.current_stream().wait_stream(side)
        staged = [tuple(torch.from_numpy(f).to(dev) for f in g)
                  for g in groups[1:]]
        kernels.reset_launches()
        fused = _FusedSteps(graph_m, staged[0])
        assert kernels.launch_counts() == dict.fromkeys(
            kernels.launch_counts(), 0)      # a capture launches nothing
        assert not graph_m.transfer.push_paths
        outs = [fused.replay(g) for g in staged]
        graph_counts = kernels.launch_counts()
        kernels.reset_launches()
        plain = []
        for g in staged:
            es_sum = ec_sum = 0
            for i in range(n):
                es, ec = plain_m._step_fields(tuple(f[i] for f in g))
                es_sum, ec_sum = es_sum + es, ec_sum + ec
            plain.append((es_sum, ec_sum))
        torch.cuda.synchronize()
        return (graph_m, plain_m, outs, plain, graph_counts,
                kernels.launch_counts())
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("rendering,dtype", [("gather", "float32"),
                                             ("stencil", "float32"),
                                             ("gather", "bfloat16")])
def test_graph_of_8_steps_matches_8_plain_steps(dev, rendering, dtype):
    """``inner_steps: 8`` as one CUDA graph against 8 plain steps from the
    same table and generator seed, two groups: bit for bit.  The batch is
    small enough that every push is sparse or a span push (no B3) and the
    run uses PyTorch's deterministic ``index_add_``, so no sum lands in a
    varying order; the replays then draw the same negatives as the plain
    steps (fresh ones each replay), compute the same updates, and count
    the launches the plain steps make."""
    graph_m, plain_m, outs, plain, gc, pc = _graph_vs_plain(
        dev, rendering, 32, 8, deterministic=True, dtype=dtype)
    assert graph_m.table.state["h"].dtype == getattr(torch, dtype)
    assert gc == pc and gc["scatter"] == 0
    assert gc["stencil"] == (16 if rendering == "stencil" else 0)
    assert dict(graph_m.transfer.push_paths) \
        == dict(plain_m.transfer.push_paths)
    assert not any(k.endswith(":dense") for k in graph_m.transfer.push_paths)
    for (es_g, ec_g), (es_p, ec_p) in zip(outs, plain):
        assert float(ec_g) == float(ec_p) > 0
        assert float(es_g) == float(es_p)
    assert outs[0][1] != outs[1][1] or float(outs[0][0]) != float(outs[1][0])
    for f, t in graph_m.table.state.items():
        assert torch.equal(t, plain_m.table.state[f]), f


@pytest.mark.parametrize("rendering", ["gather", "stencil", "sg", "dense"])
def test_graph_with_dense_push_tracks_plain_steps(dev, rendering):
    """Groups of 2 steps whose h push goes dense through B3 (atomic float
    sums, no fixed order), replayed twice, against 4 plain steps:
    round(err_cnt) equal, err_sum within 1e-4 relative; tables within
    1e-5 + 1e-3 |b| but for at most 0.01% of each field's elements, and
    every element within 1e-4.  The sums' last-bit differences reach a
    few elements past the envelope within a few steps, plain against
    plain as well (AdaGrad's first update divides a near-zero grad sum by
    about 1e-3; up to 1.4e-5 seen after 4 steps, 9.8e-5 after 16); a
    replay on wrong inputs or draws moves thousands of elements by far
    more."""
    graph_m, plain_m, outs, plain, gc, pc = _graph_vs_plain(
        dev, rendering, 100, 2, deterministic=False)
    assert gc == pc and gc["scatter"] == (0 if rendering == "dense" else 4)
    assert dict(graph_m.transfer.push_paths) \
        == dict(plain_m.transfer.push_paths)
    for (es_g, ec_g), (es_p, ec_p) in zip(outs, plain):
        assert round(float(ec_g)) == round(float(ec_p))
        np.testing.assert_allclose(float(es_g), float(es_p), rtol=1e-4)
    for f, t in graph_m.table.state.items():
        want = plain_m.table.state[f]
        gap = (t - want).abs()
        outside = (gap > 1e-5 + 1e-3 * want.abs()).sum().item()
        assert outside <= 1e-4 * t.numel(), (f, outside)
        assert gap.max().item() <= 1e-4, (f, gap.max().item())


@pytest.mark.parametrize("rendering", ["gather", "stencil"])
def test_train_with_pipeline_and_graphs_matches_plain_train(dev, rendering):
    """``Word2Vec.train`` with ``pipeline: 2`` and ``inner_steps: 4``
    (graph replays) against the plain loop from the same table and
    generator seed: the same steps and words, launches and push paths
    counted alike, each epoch's loss within 1e-4 relative and Σerr_cnt
    within 1e-6 (float32 sums folded in another grouping).  Tables are not
    compared after two epochs: the float sums' run-to-run differences
    outgrow the envelope within tens of steps, plain against plain too."""
    runs = []
    for worker in ({}, {"pipeline": 2, "inner_steps": 4}):
        m, sents = _path_model(dev, rendering, seed=4, **worker)
        batcher = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
        kernels.reset_launches()
        losses = m.train(batcher=batcher, niters=2, batch_size=100)
        runs.append((m, losses, kernels.launch_counts()))
    (a, la, ca), (b, lb, cb) = runs
    ma, mb = a.train_metrics, b.train_metrics
    assert (ma["steps"], ma["words"]) == (mb["steps"], mb["words"])
    assert mb["fused"] is True and mb["graph_replays"] > 0
    assert not ma["fused"] and mb["pipeline"]["produced"] > 0
    assert ca == cb and ma["push_paths"] == mb["push_paths"]
    np.testing.assert_allclose(lb, la, rtol=1e-4)
    np.testing.assert_allclose([c for _, c in mb["epoch_err"]],
                               [c for _, c in ma["epoch_err"]], rtol=1e-6)


def test_sharded_train_keeps_plain_steps_under_inner_steps(dev):
    """``transfer: tpu`` runs ``inner_steps`` as plain steps (the ring's
    epoch is a host counter a replay would repeat): ``fused`` is False and
    every step launches the ring for each exchange."""
    conf = {"cluster": {"transfer": "tpu", "server_num": 4},
            "word2vec": {"len_vec": 16, "window": 2, "negative": 5,
                         "sample": -1, "learning_rate": 0.05},
            "server": {"initial_learning_rate": 0.3},
            "worker": {"inner_steps": 4, "pipeline": 2}}
    m = Word2Vec(config=ConfigParser().update(conf), device=dev)
    sents = synthetic_corpus(60, 300, 16, seed=3)
    m.build(sents)
    kernels.reset_launches()
    m.train(sents, niters=1, batch_size=64)
    assert m.train_metrics["fused"] is False
    assert m.train_metrics["graph_replays"] == 0
    assert kernels.launch_counts()["ring"] == 8 * m.train_metrics["steps"]
    assert ring.timeouts() == 0


def test_graph_capture_survives_garbage_graphs(dev):
    """Graphs of dropped models, held in reference cycles, are freed by
    garbage collections; freeing a graph while another is being captured
    is not permitted, so the capture runs with collections off.  Here a
    collection is due at nearly every allocation."""
    import gc
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for i in range(3):
            m, sents = _path_model(dev, "gather", seed=i, inner_steps=2)
            batcher = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
            losses = m.train(batcher=batcher, niters=1, batch_size=100)
            assert m.train_metrics["graph_replays"] > 0
            assert np.isfinite(losses).all()
            junk = [m]
            junk.append(junk)          # a cycle that holds the graphs
            del m, junk
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()


def test_graphs_follow_a_replaced_table(dev):
    """Graphs are captured on the table's tensors: after ``table.state``
    is replaced, the next ``train()`` captures anew and updates the new
    tensors, never the old ones."""
    m, sents = _path_model(dev, "gather", seed=2, inner_steps=2)
    batcher = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
    m.train(batcher=batcher, niters=1, batch_size=100)
    assert m.train_metrics["graph_replays"] > 0
    old = m.table.state
    m.table.state = {f: t.clone() for f, t in old.items()}
    frozen = {f: t.clone() for f, t in old.items()}
    start = m.table.state["h"].clone()
    m.train(batcher=batcher, niters=1, batch_size=100)
    assert m.train_metrics["graph_replays"] > 0
    torch.cuda.synchronize()
    for f, t in old.items():
        assert torch.equal(t, frozen[f]), f
    assert not torch.equal(m.table.state["h"], start)


def _close(got, want, what):
    """float32 tables within 1e-5 + 1e-3 |b|."""
    for f in want:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-3, atol=1e-5,
                                   err_msg=f"{what}: {f}")


def _cpu_twin(card, workers=None):
    """The same model on the CPU, from the card model's table;
    ``workers``: its cluster holds the CPU that many times."""
    cluster = None if workers is None else Cluster(
        card.config, devices=["cpu"] * workers).initialize()
    cpu = Word2Vec(config=card.config, device="cpu", cluster=cluster)
    cpu.build_from_vocab(card.vocab)
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu")
    return cpu


@pytest.mark.parametrize("rendering", ["sg", "sg_shared", "dense"])
def test_new_rendering_step_on_card_matches_cpu(dev, rendering):
    """One step of ``sg``, ``sg_shared`` and ``dense`` at the reference
    widths on the card and on the CPU from the same table and draws:
    err_cnt exact (sg_shared within 1e-6 relative), err_sum rtol 1e-4,
    tables within the envelope; the path's kernels launched."""
    card, sents = _path_model(dev, rendering)
    cpu = _cpu_twin(card)
    batch = next(iter(CBOWBatcher(sents, card.vocab, card.window,
                                  card.sample, seed=5).epoch(100)))
    rng = np.random.default_rng(3)
    shape = card.draw_shape(100)
    draws = (rng.integers(0, len(card.vocab), shape),
             rng.random(shape, np.float32))
    kernels.reset_launches()
    es_c, ec_c = card.step_batch(batch, draws=draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu.step_batch(batch, draws=draws)
    if rendering == "sg_shared":
        assert ec_c == pytest.approx(ec_p, rel=1e-6)
    else:
        assert ec_c == ec_p
    np.testing.assert_allclose(es_c, es_p, rtol=1e-4)
    _close(state_to_numpy(card.table.state), state_to_numpy(cpu.table.state),
           rendering)
    assert counts["gather"] == 2 - (rendering == "dense")
    assert counts["scatter"] == {"sg": 1, "sg_shared": 0, "dense": 0}[
        rendering]
    assert counts["adagrad"] == (3 if rendering == "sg_shared" else 2)
    assert card.transfer.push_paths == cpu.transfer.push_paths


def test_hogwild_group_on_card_matches_cpu(dev):
    """A hogwild group of 4 workers (the card four times in the cluster)
    x 2 local steps on the card and on the CPU from the same table and
    draws: err_cnt exact, tables within the envelope; every step launches
    its kernels on the replica and again on the chain."""
    card, sents = _path_model(dev, "gather", w2v={"async_mode": "hogwild",
                                                  "local_steps": 2},
                              cluster=[dev] * 4)
    cpu = _cpu_twin(card, workers=4)
    it = iter(CBOWBatcher(sents, card.vocab, card.window, card.sample,
                          seed=5).epoch(100))
    group = [_batch_fields(next(it)) for _ in range(8)]
    rng = np.random.default_rng(4)
    draws = [(rng.integers(0, len(card.vocab), (100, 20)),
              rng.random((100, 20), np.float32)) for _ in range(8)]
    kernels.reset_launches()
    es_c, ec_c = card._hogwild_group(group, iter(draws))
    counts = kernels.launch_counts()
    es_p, ec_p = cpu._hogwild_group(group, iter(draws))
    assert int(ec_c) == int(ec_p)
    np.testing.assert_allclose(float(es_c), float(es_p), rtol=1e-4)
    _close(state_to_numpy(card.table.state), state_to_numpy(cpu.table.state),
           "hogwild")
    assert counts == {"gather": 16, "scatter": 16, "adagrad": 32,
                      "stencil": 0, "ring": 0}


@pytest.mark.parametrize("rendering", ["gather", "stencil"])
def test_snapshot_window_on_card_matches_cpu(dev, rendering):
    """One ``local_steps: 3`` window (3 steps against the snapshot, then
    the refresh) on the card and on the CPU, through ``train`` with the
    same draws: losses rtol 1e-4, tables within the envelope."""
    card, sents = _path_model(dev, rendering, w2v={"local_steps": 3})
    cpu = _cpu_twin(card)
    B = 100
    n = 0
    for b in (CBOWBatcher(sents[:30], card.vocab, card.window, card.sample,
                          seed=5).epoch_stencil(B) if card.stencil else
              CBOWBatcher(sents[:30], card.vocab, card.window, card.sample,
                          seed=5).epoch(B)):
        n += 1
    rng = np.random.default_rng(5)
    draws = [(rng.integers(0, len(card.vocab), (B, 20)),
              rng.random((B, 20), np.float32)) for _ in range(n)]
    out = []
    for m in (card, cpu):
        batcher = CBOWBatcher(sents[:30], m.vocab, m.window, m.sample, seed=5)
        out.append(m.train(batcher=batcher, niters=1, batch_size=B,
                           draws=iter(draws)))
    assert card.train_metrics["steps"] == n >= 3
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4)
    _close(state_to_numpy(card.table.state), state_to_numpy(cpu.table.state),
           f"{rendering} window")


# -- checkpoints, resume and sent2vec (port slice 9) ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_card_is_exact_and_in_place(dev, tmp_path,
                                                              dtype):
    """A trained card table saved as npz and resumed into a fresh card
    model: every field bit for bit, the tensors' addresses kept, the same
    key index; the CPU loads the card's file bit for bit too."""
    from swiftmpi_tpu_torch.io.checkpoint import save_checkpoint
    m, sents = _path_model(dev, "gather", dtype=dtype)
    m.train(batcher=CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5),
            niters=1, batch_size=100)
    save_checkpoint(m.table, str(tmp_path / "ck"),
                    extra={"iter": np.int64(1)})
    fresh, _ = _path_model(dev, "gather", seed=3, dtype=dtype)
    ptrs = [t.data_ptr() for t in fresh.table.state.values()]
    assert fresh.resume(str(tmp_path / "ck")) == 1
    assert [t.data_ptr() for t in fresh.table.state.values()] == ptrs
    cpu = _cpu_twin(m)
    cpu.resume(str(tmp_path / "ck"))
    for f, t in m.table.state.items():
        assert torch.equal(fresh.table.state[f], t), f
        assert torch.equal(cpu.table.state[f], t.cpu()), f
    assert list(fresh.table.key_index.items()) == \
        list(m.table.key_index.items())


def test_graphs_replay_after_an_in_place_resume(dev, tmp_path):
    """Resume restores in place, so the graphs captured before it stay
    the model's and replay after it: an epoch run by those replays equals,
    bit for bit, the same epoch of a model resumed from the same file that
    captures its graphs anew (sparse pushes only and deterministic sums,
    as in ``test_graph_of_8_steps_matches_8_plain_steps``; both generators
    seeded alike)."""
    from swiftmpi_tpu_torch.io.checkpoint import save_checkpoint
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        m, sents = _path_model(dev, "gather", inner_steps=4)
        batcher = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
        m.train(batcher=batcher, niters=1, batch_size=32)
        save_checkpoint(m.table, str(tmp_path / "ck"))
        graphs = dict(m._fused_cache)
        assert graphs
        m.train(batcher=batcher, niters=1, batch_size=32)   # moves the table
        m.resume(str(tmp_path / "ck"))
        twin, _ = _path_model(dev, "gather", inner_steps=4)
        twin.resume(str(tmp_path / "ck"))
        for x in (m, twin):
            x._gen.manual_seed(123)
            x.train(batcher=CBOWBatcher(sents, x.vocab, x.window, x.sample,
                                        seed=9), niters=1, batch_size=32)
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(m._fused_cache[L] is g for L, g in graphs.items())
    assert m.train_metrics["graph_replays"] > \
        twin.train_metrics["graph_replays"] > 0
    assert not any(k.endswith(":dense") for k in m.transfer.push_paths)
    assert m.train_metrics["epoch_err"] == twin.train_metrics["epoch_err"]
    for f, t in m.table.state.items():
        assert torch.equal(t, twin.table.state[f]), f


def test_sent2vec_on_card_matches_cpu(dev):
    """sent2vec over a card word table and over its CPU copy with the
    same draws: every element within 1e-5 + 1e-3|b|; B2 launched once for
    the context rows and once a pass for the target rows."""
    from swiftmpi_tpu_torch.models.sent2vec import Sent2Vec
    m, sents = _path_model(dev, "gather")
    cpu = _cpu_twin(m)
    lines = [" ".join(map(str, s[:n])) for s, n in
             zip(sents, [40, 17, 3, 40, 25, 9] * 6)]
    card_s2v, cpu_s2v = Sent2Vec(m, seed=1), Sent2Vec(cpu, seed=1)
    card_s2v.batchsize = cpu_s2v.batchsize = 16
    draws = [card_s2v.draw(16, 64, 3) for _ in range(3)]
    kernels.reset_launches()
    got = card_s2v.infer_sentences(lines, niters=3, draws=iter(draws))
    counts = kernels.launch_counts()
    want = cpu_s2v.infer_sentences(lines, niters=3, draws=iter(
        [(s0.cpu(), [tuple(t.cpu() for t in p) for p in ps])
         for s0, ps in draws]))
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose(np.stack([v for _, v in got]),
                               np.stack([v for _, v in want]),
                               rtol=1e-3, atol=1e-5)
    assert counts == {"gather": 3 * (1 + 3), "scatter": 0, "adagrad": 0,
                      "stencil": 0, "ring": 0}


# -- logistic regression and GloVe (width-1 rows, growth under graphs) --------

def _lr_conf(**worker):
    conf = ConfigParser().update({
        "cluster": {"server_num": 1, "transfer": "xla"},
        "server": {"initial_learning_rate": 0.1},
        "worker": {"minibatch": 4}})
    conf.update({"worker": worker})
    return conf


def test_width1_kernels_match_plain_on_card(dev):
    """B2, B3 and B1 on width-1 rows at logistic regression's a9a shape
    (114,688 slots onto 160 rows, ~930 a slot) and the ring on width-1
    buckets, aligned and not: gather, AdaGrad and the ring bit for bit,
    B3's sums of grads scaled as phase 2 of ``chip_smoke.py`` scales them
    within its tolerance, rtol 1e-3 and atol 1e-5 (930-term float sums in
    no fixed order), its counts exact.  One launch each."""
    rng = np.random.default_rng(70)
    cap, n = 160, 114_688
    slots = rng.integers(0, 124, n).astype(np.int32)
    slots[rng.random(n) < 0.05] = -1
    ts = torch.from_numpy(slots).to(dev)
    tv = ts >= 0
    table = torch.rand((cap, 1), device=dev)
    kernels.reset_launches()
    torch.testing.assert_close(gather.masked_gather(table, ts, tv),
                               gather.masked_gather_plain(table, ts, tv),
                               rtol=0, atol=0)
    g = torch.randn((n, 1), device=dev) * 1e-2
    acc, cnt = scatter.masked_scatter_add(ts, tv, g, cap, counts=True)
    acc_p, cnt_p = scatter.masked_scatter_add_plain(ts, tv, g, cap,
                                                    counts=True)
    torch.testing.assert_close(acc, acc_p, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(cnt, cnt_p, rtol=0, atol=0)
    assert cnt.max().item() > 800
    p, a = table.clone(), torch.rand((cap, 1), device=dev)
    p2, a2 = p.clone(), a.clone()
    gr = torch.randn((cap, 1), device=dev)
    adagrad.adagrad_update_(p, a, gr, 0.05, div=cnt_p.clamp(min=1.0))
    adagrad.adagrad_update_plain_(p2, a2, gr, 0.05, div=cnt_p.clamp(min=1.0))
    assert torch.equal(p, p2) and torch.equal(a, a2)
    rows = torch.unique(ts[tv]).to(torch.int32)
    inv = 1.0 / torch.randint(1, 9, (rows.numel(),), device=dev).float()
    gr = torch.randn((rows.numel(), 1), device=dev)
    adagrad.adagrad_update_rows_(p, a, rows, None, gr, 0.05, mul=inv)
    adagrad.adagrad_update_rows_plain_(p2, a2, rows, None, gr, 0.05,
                                       mul=inv)
    assert torch.equal(p, p2) and torch.equal(a, a2)
    for C in (n // 8, 1001, 3):
        x = torch.rand((8, 8, C, 1), device=dev)
        assert torch.equal(ring.ring_exchange_stacked(x),
                           ring.ring_exchange_stacked_plain(x))
    torch.cuda.synchronize()
    assert ring.timeouts() == 0
    assert kernels.launch_counts() == {"gather": 1, "scatter": 1,
                                       "adagrad": 2, "stencil": 0,
                                       "ring": 3}


def test_lr_grow_mid_epoch_under_graphs_matches_eager(dev):
    """``inner_steps: 4`` (graph replays) against one step at a time, both
    growing the table twice mid-epoch from 64 rows: every push sparse (no
    B3) and PyTorch's deterministic ``index_add_``, so the tables agree
    bit for bit; the growths drop the graphs, and the replays after them
    update the new tensors, never the freed ones."""
    from swiftmpi_tpu_torch.data.libsvm import synthetic_dataset
    from swiftmpi_tpu_torch.models.logistic import LogisticRegression
    data = synthetic_dataset(200, 200, 5, seed=4)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for inner in (4, 1):
            m = LogisticRegression(config=_lr_conf(inner_steps=inner),
                                   capacity_per_shard=64, device=dev, seed=3)
            kernels.reset_launches()
            losses = m.train(data, niters=2)
            runs.append((m, losses, kernels.launch_counts()))
    finally:
        torch.use_deterministic_algorithms(False)
    (g, lg, cg), (e, le, ce) = runs
    mg, me = g.train_metrics, e.train_metrics
    assert mg["growths"] == me["growths"] == 2
    assert mg["capacity"] == 256 and mg["fused"] and mg["graph_replays"] > 0
    assert set(mg["push_paths"]) == {"val:sparse"}
    assert cg == ce == {"gather": 100, "scatter": 0, "adagrad": 100,
                        "stencil": 0, "ring": 0}
    np.testing.assert_allclose(lg, le, rtol=1e-6)
    for f, t in g.table.state.items():
        assert torch.equal(t, e.table.state[f]), f


@pytest.mark.parametrize("path", ["lr", "lr_dense", "lr_graphs", "glove",
                                  "glove_graphs"])
def test_lr_and_glove_take_exactly_their_kernels(dev, path):
    """The train loops launch exactly their path's kernels each step, eager
    and under graphs: LR sparse with a dense push (B2, B3 with counts, B1
    over the table), LR dense (B1 only), GloVe with sparse pushes (B2 for
    four fields, B1 for four families); and the card's run agrees with the
    CPU's from the same table, losses within 1e-4 relative."""
    from swiftmpi_tpu_torch.data.libsvm import synthetic_dataset
    from swiftmpi_tpu_torch.data.text import synthetic_corpus
    from swiftmpi_tpu_torch.models.glove import GloVe
    from swiftmpi_tpu_torch.models.logistic import LogisticRegression
    graphs = path.endswith("_graphs")
    inner = 4 if graphs else 1
    if path.startswith("lr"):
        data = synthetic_dataset(256, 40, 5, seed=1)
        conf = _lr_conf(inner_steps=inner,
                        dense_features=int(path == "lr_dense"))
        conf.set("worker", "minibatch", 32)
        models = [LogisticRegression(config=conf, capacity_per_shard=64,
                                     device=d) for d in (dev, "cpu")]
        per = ({"adagrad": 1} if path == "lr_dense"
               else {"gather": 1, "scatter": 1, "adagrad": 1})

        def run(m):
            return m.train(data, niters=2)
    else:
        conf = ConfigParser().update({
            "cluster": {"transfer": "xla", "server_num": 1},
            "glove": {"len_vec": 16, "window": 4, "minibatch": 64},
            "worker": {"inner_steps": inner}})
        sents = synthetic_corpus(40, 60, 20, seed=2)
        models = [GloVe(config=conf, capacity_per_shard=256,
                        device=d).build(sents) for d in (dev, "cpu")]
        per = {"gather": 4, "adagrad": 4}

        def run(m):
            return m.train(niters=2)
    card, cpu = models
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu")
    kernels.reset_launches()
    got = run(card)
    counts = kernels.launch_counts()
    want = run(cpu)
    steps = card.train_metrics["steps"]
    assert counts == {**dict.fromkeys(counts, 0),
                      **{k: v * steps for k, v in per.items()}}
    assert card.train_metrics["fused"] is graphs
    assert (card.train_metrics["graph_replays"] > 0) is graphs
    np.testing.assert_allclose(got, want, rtol=1e-4)


# -- hybrid: the hot planes and the ledger ------------------------------------

def _hybrid_model(dev, rendering, n=8):
    """A ``transfer: hybrid`` model on ``n`` ranks at the reference widths,
    its partition calibrated from the corpus's counts."""
    conf = {"cluster": {"transfer": "hybrid", "server_num": n},
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": 1e-3, "learning_rate": 0.05,
                         **RENDERINGS[rendering]},
            "server": {"initial_learning_rate": 0.7},
            "worker": {"minibatch": 800}}
    m = Word2Vec(config=ConfigParser().update(conf), device=dev)
    sents = synthetic_corpus(400, 3000, 40, seed=8)
    m.build(sents)
    assert m.table.n_hot > 0
    return m, sents


@pytest.mark.parametrize("rendering", ["gather", "stencil"])
def test_hybrid_step_on_card_matches_cpu(dev, rendering):
    """One hybrid step on 8 ranks on the card and on the CPU from the same
    table (hot planes included) and draws: err_cnt exact, err_sum rtol
    1e-4, every field and hot plane within the envelope; the card's step
    launched B1, B2, B3 and B5 and not the stencil kernel (the hybrid
    stencil pulls its span through the transfer)."""
    card, sents = _hybrid_model(dev, rendering)
    cpu = Word2Vec(config=card.config, device="cpu")
    cpu.build_from_vocab(card.vocab)
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu",
                                     mesh=cpu.cluster.mesh)
    b = CBOWBatcher(sents, card.vocab, card.window, card.sample, seed=5)
    batch = next(iter(b.epoch_stencil(200) if card.stencil
                      else b.epoch(200)))
    rng = np.random.default_rng(3)
    shape = card.draw_shape(200)
    draws = (rng.integers(0, len(card.vocab), shape),
             rng.random(shape, np.float32))
    kernels.reset_launches()
    es_c, ec_c = card.step_batch(batch, draws=draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu.step_batch(batch, draws=draws)
    assert ec_c == ec_p
    np.testing.assert_allclose(es_c, es_p, rtol=1e-4)
    _close(state_to_numpy(card.table.state), state_to_numpy(cpu.table.state),
           f"hybrid {rendering}")
    assert all(counts[k] > 0 for k in ("adagrad", "gather", "scatter",
                                       "ring")), counts
    assert counts["stencil"] == 0
    assert card.transfer.push_paths == cpu.transfer.push_paths


def test_graphed_ledger_matches_eager_ledger(dev):
    """``transfer: xla`` with ``inner_steps: 8`` (graph replays) books the
    traffic ledger exactly as the plain loop does from the same table and
    generator seed: every counter equal, and the counters moved."""
    runs = []
    for worker in ({}, {"inner_steps": 8}):
        m, sents = _path_model(dev, "gather", seed=4, **worker)
        m.transfer.count_traffic = True
        batcher = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
        m.train(batcher=batcher, niters=1, batch_size=100)
        runs.append(m)
    plain, graphed = runs
    assert graphed.train_metrics["graph_replays"] > 0
    assert not plain.train_metrics["fused"]
    want = plain.train_metrics["transfer_traffic"]
    assert graphed.train_metrics["transfer_traffic"] == want
    assert want["dispatches"] == 2 * plain.train_metrics["steps"]
    assert want["pull_rows"] > 0 and want["wire_bytes"] > 0


# -- the window push ------------------------------------------------------------

def _window_model(dev, transfer, W, seed=0, n=8, **worker):
    """A model at the reference widths with ``[cluster] push_window: W``
    on ``transfer`` (``n`` ranks on ``tpu`` and ``hybrid``)."""
    conf = {"cluster": {"transfer": transfer, "push_window": W,
                        "server_num": 1 if transfer == "xla" else n},
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": 1e-3, "learning_rate": 0.05},
            "server": {"initial_learning_rate": 0.7},
            "worker": {"minibatch": 800, **worker}}
    m = Word2Vec(config=ConfigParser().update(conf), device=dev, seed=seed)
    sents = synthetic_corpus(400, 3000, 40, seed=8)
    m.build(sents)
    return m, sents


@pytest.mark.parametrize("transfer", ["tpu", "hybrid", "xla"])
def test_window_group_on_card_matches_cpu(dev, transfer):
    """One group of 4 steps at ``push_window: 2`` on the card and on the
    CPU from the same table and draws: err_cnt exact, err_sum rtol 1e-4,
    the tables within the envelope, the same window decisions and
    coalesced rows; the card ran the dedup's and the owners' sums on B3,
    the exchanges on B5 (``tpu``, ``hybrid``), the pulls on B2 and the
    applies on B1."""
    card, sents = _window_model(dev, transfer, 2, inner_steps=4)
    cpu = Word2Vec(config=card.config, device="cpu")
    cpu.build_from_vocab(card.vocab)
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu",
                                     mesh=cpu.cluster.mesh)
    for m in (card, cpu):
        m.transfer.count_traffic = True
    groups = _items(card, sents, 200, 1, group=4)
    rng = np.random.default_rng(3)
    shape = card.draw_shape(200)
    draws = [(rng.integers(0, len(card.vocab), shape),
              rng.random(shape, np.float32)) for _ in range(4)]
    kernels.reset_launches()
    es_c, ec_c = card._window_group(
        tuple(torch.from_numpy(f).to(dev) for f in groups[0]), draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu._window_group(
        tuple(torch.from_numpy(f) for f in groups[0]), draws)
    assert float(ec_c) == float(ec_p)
    np.testing.assert_allclose(float(es_c), float(es_p), rtol=1e-4)
    _close(state_to_numpy(card.table.state), state_to_numpy(cpu.table.state),
           f"window {transfer}")
    tc, tp = card.transfer.traffic(), cpu.transfer.traffic()
    for k in ("window_sparse", "window_dense", "coalesced_rows_in",
              "coalesced_rows_out", "wire_bytes", "routed_rows"):
        assert tc.get(k) == tp.get(k), (k, tc, tp)
    assert card.transfer.push_paths == cpu.transfer.push_paths
    want = {"adagrad", "gather", "scatter"} | (
        {"ring"} if transfer != "xla" else set())
    assert {k for k, v in counts.items() if v} >= want - (
        {"scatter"} if transfer == "xla" else set()), counts
    if transfer != "xla":
        assert tc["window_sparse"] + tc["window_dense"] == 4


def test_window_dense_rung_on_card_matches_cpu(dev):
    """The ``tpu`` dense rung at d = 100: a window over most of 8 shards of
    8 rows, one B3 launch a family onto the global plane with the counts,
    B1 over the block with the mean's reciprocal; card against CPU within
    JAX's rtol 1e-4 / atol 1e-5, one launch each."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
    from swiftmpi_tpu_torch.transfer import get_transfer
    from swiftmpi_tpu_torch.transfer.plan import clear_plan_cache
    acc = w2v_access(0.7, 100)
    rng = np.random.default_rng(4)
    ki = KeyIndex(8, 8)
    slots = np.asarray(ki.lookup(rng.integers(0, 24, 4 * 64).astype(
        np.uint64)), np.int32).reshape(4, 64)
    slots[:, ::7] = -1
    grads = {f: rng.normal(size=(4, 64, 100)).astype(np.float32)
             for f in ("h", "v")}
    start = SparseTable(acc, ki, "cpu", seed=2,
                        mesh=ps_mesh(8, ["cpu"])).to_numpy()
    out = []
    for where in (dev, "cpu"):
        layout = ps_mesh(8, [where])
        table = SparseTable(acc, ki, where, seed=2, mesh=layout)
        table.state = state_from_jax(start, where, mesh=layout)
        t = get_transfer("tpu", mesh=layout)
        t.count_traffic = True
        clear_plan_cache()            # each run compiles its plan
        kernels.reset_launches()
        t.push_window(table.state, torch.from_numpy(slots).to(where),
                      {f: torch.from_numpy(g).to(where)
                       for f, g in grads.items()}, acc, mean=True)
        out.append((state_to_numpy(table.state), kernels.launch_counts(),
                    t.traffic()))
    (card, counts, tr), (cpu, _, tr_cpu) = out
    assert tr["window_dense"] == 1 and tr == tr_cpu
    assert counts["scatter"] == 2 and counts["adagrad"] == 2
    assert counts["ring"] == 0
    for f in cpu:
        np.testing.assert_allclose(card[f], cpu[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)


def test_windowed_graph_replay_matches_plain_windows(dev):
    """``inner_steps: 4`` at ``push_window: 2`` on ``xla`` as one CUDA
    graph against the same windowed groups run plainly, from one table
    and generator seed, two groups: bit for bit (sparse pushes only and
    PyTorch's deterministic ``index_add_``), the same launches."""
    from swiftmpi_tpu_torch.models.word2vec import _FusedSteps
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        warm, _ = _window_model(dev, "xla", 2, seed=9, inner_steps=4)
        graph_m, sents = _window_model(dev, "xla", 2, seed=1, inner_steps=4)
        plain_m, _ = _window_model(dev, "xla", 2, seed=1, inner_steps=4)
        for f, t in plain_m.table.state.items():
            t.copy_(graph_m.table.state[f])
        # 16 centers: a window's 672 h rows stay under half the 1,635
        # rows, so both families push sparse (no B3)
        groups = _items(graph_m, sents, 16, 3, group=4)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm._window_group(tuple(torch.from_numpy(f).to(dev)
                                     for f in groups[0]))
        torch.cuda.current_stream().wait_stream(side)
        staged = [tuple(torch.from_numpy(f).to(dev) for f in g)
                  for g in groups[1:]]
        kernels.reset_launches()
        fused = _FusedSteps(graph_m, staged[0])
        outs = [fused.replay(g) for g in staged]
        graph_counts = kernels.launch_counts()
        kernels.reset_launches()
        plain = [plain_m._window_group(g) for g in staged]
        torch.cuda.synchronize()
        assert graph_counts == kernels.launch_counts()
        assert graph_counts["scatter"] == 0 and graph_counts["adagrad"] > 0
        assert dict(graph_m.transfer.push_paths) \
            == dict(plain_m.transfer.push_paths)
        for (es_g, ec_g), (es_p, ec_p) in zip(outs, plain):
            assert float(ec_g) == float(ec_p) > 0
            assert float(es_g) == float(es_p)
        for f, t in graph_m.table.state.items():
            assert torch.equal(t, plain_m.table.state[f]), f
    finally:
        torch.use_deterministic_algorithms(False)


def test_windowed_train_on_card_uses_graphs(dev):
    """``Word2Vec.train`` at ``push_window: 2``, ``inner_steps: 4`` on
    ``xla`` replays its groups as graphs (finite losses) and takes the
    push paths of the same training without graphs (draws given, so the
    groups run eagerly)."""
    runs = []
    for graphs in (True, False):
        m, sents = _window_model(dev, "xla", 2, seed=3, inner_steps=4)
        b = CBOWBatcher(sents, m.vocab, m.window, m.sample, seed=5)
        draws = None
        if not graphs:
            rng = np.random.default_rng(0)
            draws = iter(lambda: (rng.integers(0, len(m.vocab),
                                               m.draw_shape(100)),
                                  rng.random(m.draw_shape(100), np.float32)),
                         None)
        losses = m.train(batcher=b, niters=2, batch_size=100, draws=draws)
        assert all(np.isfinite(losses))
        runs.append(m)
    graphed, eager = runs
    assert graphed.train_metrics["fused"]
    assert graphed.train_metrics["graph_replays"] > 0
    assert not eager.train_metrics["fused"]
    assert graphed.train_metrics["push_window"] == 2
    assert graphed.train_metrics["push_paths"] \
        == eager.train_metrics["push_paths"]


# -- the wire stack -----------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4, 3])
def test_gather_int32_form_matches_plain_on_card(dev, d):
    """B2's int32 form (the ``@rowver`` plane is ``(cap, 1)`` int32; d = 4
    takes the group form, d = 3 the scalar one): bit for bit against the
    plain version, on a table and on an (R, cap, d) block, one launch
    each; d = 1 in float32 too (the column form)."""
    rng = np.random.default_rng(12)
    cap, n = 3000, 7000
    slots, valid = _slots(rng, n, cap)
    ts, tv = torch.from_numpy(slots).to(dev), torch.from_numpy(valid).to(dev)
    for dtype in (torch.int32, torch.float32):
        table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (cap, d),
                                              dtype=np.int64).astype(np.int32)
                                 ).to(dev)
        if dtype == torch.float32:
            table = table.view(torch.float32) if d == 1 else None
        if table is None:
            continue
        kernels.reset_launches()
        got = gather.masked_gather(table, ts, tv)
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.int32),
                           gather.masked_gather_plain(table, ts, tv).view(
                               torch.int32))
        block = table.expand(3, cap, d).contiguous()
        bs = torch.stack([ts, ts.flip(0), ts.roll(5)]).contiguous()
        bv = torch.stack([tv, tv.flip(0), tv.roll(5)]).contiguous()
        assert torch.equal(gather.masked_gather(block, bs, bv).view(
            torch.int32), gather.masked_gather_plain(block, bs, bv).view(
            torch.int32))
        torch.cuda.synchronize()
        assert kernels.launch_counts()["gather"] == 2


def test_ef_drain_and_bank_on_card_match_cpu(dev):
    """``ef_quantize_window`` on the card against the CPU on exact-sum
    grads with duplicate representatives: the shipped values and the
    planes bit for bit (an untouched -0.0 included), one gather and one
    scatter-add launch a field."""
    from swiftmpi_tpu_torch.transfer.api import ef_quantize_window
    rng = np.random.default_rng(9)
    cap, n, d = 4000, 6000, 100
    ded = rng.integers(0, cap, n).astype(np.int32)
    ded[rng.random(n) < 0.3] = -1
    g = (rng.integers(-64, 65, (n, d)) * 2.0 ** -10).astype(np.float32)
    ef0 = (rng.integers(-64, 65, (cap, d)) * 2.0 ** -10).astype(np.float32)
    ef0[np.setdiff1d(np.arange(cap), ded)[0]] = -0.0
    out = {}
    for where in (dev, "cpu"):
        planes = {f: torch.from_numpy(ef0.copy()).to(where) for f in "hv"}
        kernels.reset_launches()
        shipped = ef_quantize_window(
            planes, torch.from_numpy(ded).to(where),
            {f: torch.from_numpy(g).to(where) for f in "hv"}, cap, "int8")
        out[str(where)] = ({f: p.cpu() for f, p in planes.items()},
                           {f: x.cpu() for f, x in shipped.items()},
                           kernels.launch_counts())
    (pc, sc, counts), (pp, sp, _) = out[str(dev)], out["cpu"]
    for f in "hv":
        assert torch.equal(pc[f].view(torch.int32), pp[f].view(torch.int32))
        assert torch.equal(sc[f], sp[f])
    assert counts["gather"] == 2 and counts["scatter"] == 2


def test_sparse_hot_reconcile_on_card_matches_cpu(dev):
    """A hybrid window with ``collective: sparse_allreduce`` on the card
    against the CPU: the hot planes and the tail allclose (rtol 1e-5,
    atol 1e-6, JAX's own tolerance), the same ledger, the hot reconcile
    on B3 and B1."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
    from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
    from swiftmpi_tpu_torch.transfer import get_transfer
    from swiftmpi_tpu_torch.transfer.plan import clear_plan_cache
    acc = w2v_access(0.7, 100)
    rng = np.random.default_rng(5)
    keys = rng.choice(100_000, size=400, replace=False).astype(np.uint64)
    counts = np.maximum((1e6 / np.arange(1, 401)).astype(np.int64), 1)
    part = HotColdPartition.from_counts(keys, counts, batch_rows=64)
    p = counts / counts.sum()
    kk = keys[rng.choice(400, size=4 * 64, p=p)]
    out = []
    for where in (dev, "cpu"):
        ki = KeyIndex(8, 64, partition=part)
        slots = np.asarray(ki.lookup(kk), np.int32).reshape(4, 64)
        slots[:, ::7] = -1
        layout = ps_mesh(8, [where])
        table = SparseTable(acc, ki, "cpu", seed=2, mesh=ps_mesh(8, ["cpu"]))
        start = table.to_numpy()
        table = SparseTable(acc, ki, where, seed=2, mesh=layout)
        table.state = state_from_jax(start, where, mesh=layout)
        t = get_transfer("hybrid", mesh=layout)
        t.count_traffic, t.collective_mode = True, "sparse_allreduce"
        grads = {f: np.random.default_rng(1).normal(
            size=(4, 64, 100)).astype(np.float32) for f in ("h", "v")}
        clear_plan_cache()
        kernels.reset_launches()
        t.push_window(table.state, torch.from_numpy(slots).to(where),
                      {f: torch.from_numpy(g).to(where)
                       for f, g in grads.items()}, acc, mean=True)
        out.append((state_to_numpy(table.state), t.traffic(),
                    kernels.launch_counts(), dict(t.push_paths)))
    (card, tr, counts, paths), (cpu, tr_cpu, _, paths_cpu) = out
    assert tr == tr_cpu and tr["collective_sparse_ar"] >= 1
    assert paths == paths_cpu and paths["h,v:hot_sparse_span"] == 1
    assert counts["scatter"] >= 2 and counts["adagrad"] >= 2
    for f in cpu:
        np.testing.assert_allclose(card[f], cpu[f], rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_rowver_pull_on_tpu8_on_card_matches_cpu(dev):
    """``tpu@8`` with the pull cache: two routed pushes stamp each shard's
    rows with its own max + 1, the ``@rowver`` column rides the routed
    pull (B2's int32 form, B5's int32 words), and the cached, int8 pull
    ledger and the pulled rows equal the CPU's."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.parameter import KeyIndex, SparseTable, w2v_access
    from swiftmpi_tpu_torch.transfer import get_transfer
    from swiftmpi_tpu_torch.transfer.plan import clear_plan_cache
    acc = w2v_access(0.7, 100)
    rng = np.random.default_rng(8)
    ki = KeyIndex(8, 64)
    slots = np.asarray(ki.lookup(rng.integers(0, 300, 256).astype(
        np.uint64)), np.int32)
    slots[::9] = -1
    grads = {f: rng.normal(size=(256, 100)).astype(np.float32)
             for f in ("h", "v")}
    start = SparseTable(acc, ki, "cpu", seed=3,
                        mesh=ps_mesh(8, ["cpu"])).to_numpy()
    out = []
    for where in (dev, "cpu"):
        layout = ps_mesh(8, [where])
        table = SparseTable(acc, ki, where, seed=3, mesh=layout)
        table.state = state_from_jax(start, where, mesh=layout)
        table.ensure_row_versions()
        t = get_transfer("tpu", mesh=layout)
        t.count_traffic, t.pull_cache, t.pull_quant = True, 4096, "int8"
        ts = torch.from_numpy(slots).to(where)
        clear_plan_cache()            # each run compiles its plans
        kernels.reset_launches()
        t.push(table.state, ts[:128], {f: torch.from_numpy(g[:128]).to(where)
                                       for f, g in grads.items()}, acc)
        t.push(table.state, ts[128:], {f: torch.from_numpy(g[128:]).to(where)
                                       for f, g in grads.items()}, acc)
        first = t.pull(table.state, ts, acc)
        t.pull(table.state, ts, acc)
        out.append((state_to_numpy(table.state), t.traffic(),
                    {f: v.cpu() for f, v in first.items()},
                    kernels.launch_counts()))
    (card, tr, rows, counts), (cpu, tr_cpu, rows_cpu, _) = out
    np.testing.assert_array_equal(card["@rowver"], cpu["@rowver"])
    assert card["@rowver"].max() == 2 and tr["pull_cache_hits"] > 0
    assert tr == tr_cpu
    for f in rows:
        np.testing.assert_allclose(rows[f], rows_cpu[f], rtol=1e-5,
                                   atol=1e-6)
    # a pull gathers h, v and the versions (three launches) and exchanges
    # the requests and the three columns; a push the requests and the two
    # families
    assert counts["gather"] == 6 and counts["ring"] == 2 * 4 + 2 * 3


# -- the telemetry plane on the card ------------------------------------------

@pytest.mark.parametrize("case", ["gather", "stencil", "gather:bf16",
                                  "gather@8"])
def test_telemetry_planes_on_match_off_on_card(dev, case, tmp_path,
                                               monkeypatch):
    """Groups of 8 steps with ``[worker] telemetry``, ``[obs] numerics``
    and ``[obs] costs`` armed against the same groups with every plane
    off, from one table and generator seed: the same launches and push
    paths, one numerics bundle a group, the catalog's graph captures with
    no retrace.  On ``xla`` (three groups, each one CUDA graph replay, the
    bundle inside the graph; batches of 32 push sparse, and PyTorch's
    deterministic ``index_add_`` fixes every sum's order) the tables are
    bit for bit.  On ``tpu@8`` (one eager group) the owners sum through
    the scatter-add kernel's atomics, whose order varies run to run with
    or without the planes (two runs with every plane off differ by up to
    1.5e-5 after one group and 4.7e-4 after three, NVIDIA H100 80GB HBM3),
    so the tables are held as ``test_graph_with_dense_push_tracks_plain_
    steps`` holds them: at most 1e-4 of a field's elements outside ``1e-5
    + 1e-3 |b|``, every element within 1e-4."""
    from swiftmpi_tpu_torch import obs
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    from swiftmpi_tpu_torch.utils.timers import Throughput
    monkeypatch.chdir(tmp_path)
    rendering, _, bf16 = case.partition(":")
    sharded = rendering.endswith("@8")
    rendering = rendering.split("@")[0]
    dtype = "bfloat16" if bf16 else "float32"
    torch.use_deterministic_algorithms(True, warn_only=True)
    obs.reset_for_tests()
    runs = []
    try:
        for armed in (False, True):
            m, sents = _path_model(dev, rendering, seed=1, dtype=dtype,
                                   inner_steps=8)
            if sharded:
                c = m.config
                c.set("cluster", "transfer", "tpu")
                c.set("cluster", "server_num", 8)
                m = Word2Vec(config=c, device=dev, seed=1)
                m.build(sents)
            if armed:
                for sec, k, v in (("worker", "telemetry", 1),
                                  ("worker", "telemetry_path", "t.jsonl"),
                                  ("obs", "numerics", 1),
                                  ("obs", "costs", 1)):
                    m.config.set(sec, k, v)
                m.numerics_on = True
                rec, owns = m._arm_telemetry(Throughput(), True)
            n_groups = 1 if sharded else 3
            groups = [tuple(torch.from_numpy(f).to(dev) for f in g)
                      for g in _items(m, sents, 32, n_groups, group=8)]
            graphs = not sharded
            es_q, ec_q = LossAccum(None, dev), LossAccum(None, dev)
            kernels.reset_launches()
            replays = 0
            for g in groups:
                replays += m._run_group(g, graphs, None, es_q, ec_q)
                obs.record_step(8)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if armed:
                m._close_telemetry(rec, owns)
            runs.append((m, counts, replays, es_q.total(), ec_q.total()))
        (off, c_off, r_off, es0, ec0), (on, c_on, r_on, es1, ec1) = runs
        assert c_on == c_off and r_on == r_off == (0 if sharded else 2)
        assert dict(on.transfer.push_paths) == dict(off.transfer.push_paths)
        assert on._numerics.bundles == n_groups
        entry = obs.costs.get_catalog().entry("w2v_multi")
        if sharded:
            assert entry is None
        else:
            assert entry["compiles"] == 1 and entry["retraces"] == 0
            assert entry["peak_bytes"] > 0
            assert ec1 == ec0 and es1 == es0
        for f, t in on.table.state.items():
            want = off.table.state[f]
            if not sharded:
                assert torch.equal(t, want), f
                continue
            got, ref = torch.cat(list(t)).float(), torch.cat(
                list(want)).float()
            gap = (got - ref).abs()
            outside = (gap > 1e-5 + 1e-3 * ref.abs()).sum().item()
            assert outside <= 1e-4 * got.numel(), (f, outside)
            assert gap.max().item() <= 1e-4, (f, gap.max().item())
    finally:
        torch.use_deterministic_algorithms(False)
        obs.reset_for_tests()


# -- serving and control ---------------------------------------------------------

def _serve_model(dev, transfer="hybrid", seed=0, sections=None, **worker):
    """A model at the reference widths on ``transfer`` (8 ranks on
    ``hybrid``), with more config ``sections``."""
    conf = {"cluster": {"transfer": transfer,
                        "server_num": 1 if transfer == "xla" else 8},
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": 1e-3, "learning_rate": 0.05},
            "server": {"initial_learning_rate": 0.7},
            "worker": {"minibatch": 800, **worker}}
    c = ConfigParser().update(conf)
    for sec, kv in (sections or {}).items():
        for k, v in kv.items():
            c.set(sec, k, v)
    m = Word2Vec(config=c, device=dev, seed=seed)
    sents = synthetic_corpus(400, 3000, 40, seed=8)
    m.build(sents)
    return m, sents


def test_hybrid_repartition_on_card_keeps_every_row(dev):
    """A trained hybrid@8 table on the card repartitioned to another head
    (demotions, stays, promotions): every key's unified row after the
    change equals its row before it, bit for bit, read by key on the
    host; the tail tensors stay in place and the ledger of a step after
    it still conserves rows."""
    from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition
    m, sents = _serve_model(dev)
    m.train(sents, niters=1, batch_size=96)
    t = m.table
    keys = m.vocab.keys
    before = {f: t.unified_rows_host(f)[t.key_index.lookup(
        keys, create=False)] for f in t.access.fields}
    ptrs = [x.data_ptr() for x in t.state["v"]]
    order = np.argsort(-m.vocab.counts, kind="stable")
    head = keys[order[t.n_hot // 2: t.n_hot // 2 + 2 * t.n_hot]]
    plan = t.repartition(HotColdPartition(head))
    assert plan.moved_rows > 0 and plan.demote_src.size > 0
    after_slots = t.key_index.lookup(keys, create=False)
    for f in t.access.fields:
        np.testing.assert_array_equal(
            t.unified_rows_host(f)[after_slots].view(np.int32),
            before[f].view(np.int32), err_msg=f)
    assert [x.data_ptr() for x in t.state["v"]] == ptrs
    m._slot_of_vocab = torch.as_tensor(after_slots, dtype=torch.int32,
                                       device=dev)
    losses = m.train(sents, niters=1, batch_size=96)
    assert np.isfinite(losses).all()


def test_serve_and_control_train_on_card_with_readers(dev):
    """``[control]`` and ``[serve] every: 4`` on hybrid@8 with two reader
    threads: the readers see numpy planes only, every snapshot's bits
    equal the trainer's table at its version (checksums), and the run
    launches exactly B1-B3 and B5."""
    import threading
    from swiftmpi_tpu_torch.serve import EmbeddingReader

    def bits(planes):
        out = {}
        for f, v in sorted(planes.items()):
            parts = v if isinstance(v, (list, tuple)) else [v]
            out[f] = sum(int(np.asarray(p).view(np.int32).astype(
                np.int64).sum()) if isinstance(p, np.ndarray) else int(
                p.view(torch.int32).long().sum()) for p in parts)
        return out

    m, sents = _serve_model(dev, sections={
        "control": {"control": "on", "every": 4, "margin": 0.0,
                    "consecutive": 1},
        "serve": {"every": 4}})
    pub = m.serving_publisher()
    seen, publish = [], pub.publish

    def checked(*a, **kw):
        snap = publish(*a, **kw)
        seen.append((snap, bits(m.table.state)))
        return snap

    pub.publish = checked
    stop, failures = threading.Event(), []

    def query(seed):
        rng = np.random.default_rng(seed)
        r = EmbeddingReader(pub, cache_rows=64)
        if pub.wait_for_version(1, timeout=120) is None:
            failures.append("no snapshot")
            return
        while not stop.is_set():
            if not all(isinstance(v, np.ndarray)
                       for v in pub.require().state.values()):
                failures.append("a plane that is not numpy")
            r.read(rng.choice(m.vocab.keys, 8))
            r.topk(rng.choice(m.vocab.keys, 2), k=5)

    threads = [threading.Thread(target=query, args=(i,), daemon=True)
               for i in range(2)]
    for th in threads:
        th.start()
    kernels.reset_launches()
    try:
        losses = m.train(sents, niters=2, batch_size=96)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    counts = kernels.launch_counts()
    assert not any(th.is_alive() for th in threads) and not failures
    assert np.isfinite(losses).all() and len(seen) >= 3
    for snap, want in seen:
        assert bits(snap.state) == want, snap.version
    assert {k for k, v in counts.items() if v} \
        == {"gather", "scatter", "adagrad", "ring"}
    assert m.train_metrics["control"]["evaluations"] > 0


def test_push_window_apply_recaptures_and_matches_eager(dev):
    """An applied window width (the controller's knob, W 2 -> 4) drops
    the graphs; the next group recaptures at the new width, and the
    replayed group after it equals the same groups run eagerly at the new
    W, bit for bit (lossless windows of sparse pushes and deterministic
    sums; an int8 window folds its duplicate rows with B3's atomics)."""
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    sections = {"cluster": {"push_window": 2},
                "control": {"control": "on", "every": 10 ** 6}}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graph_m, sents = _serve_model(dev, "xla", seed=1,
                                      sections=sections, inner_steps=4)
        eager_m, _ = _serve_model(dev, "xla", seed=1, sections=sections,
                                  inner_steps=4)
        # 8 centers: a window of 4 steps pushes 672 h rows, under half
        # the 1,635 rows, so every push stays sparse (no B3)
        groups = [tuple(torch.from_numpy(f).to(dev) for f in g)
                  for g in _items(graph_m, sents, 8, 4, group=4)]
        outs = []
        for m, graphs in ((graph_m, True), (eager_m, False)):
            es_q, ec_q = LossAccum(None, dev), LossAccum(None, dev)
            replays, keys = [], []
            for i, g in enumerate(groups):
                if i == 2:
                    knob = next(k for k in m.controller.knobs
                                if k.name == "push_window")
                    assert knob.apply(4, {})
                    assert m._fused_cache == {}
                keys.append(m._graph_key())
                replays.append(m._run_group(g, graphs, None, es_q, ec_q))
            torch.cuda.synchronize()
            outs.append((es_q.total(), ec_q.total(), replays, keys))
    finally:
        torch.use_deterministic_algorithms(False)
    assert outs[0][2] == [False, True, False, True]
    assert outs[0][3][1] != outs[0][3][2]       # the width is in the key
    assert outs[0][:2] == outs[1][:2]
    assert graph_m.push_window_size == eager_m.push_window_size == 4
    for f, t in graph_m.table.state.items():
        assert torch.equal(t, eager_m.table.state[f]), f


def test_ef_runaway_demotes_wire_quant_on_card(dev):
    """An injected EF runaway parks in the controller and demotes
    ``wire_quant`` at the next safe point; the next graphed train books no
    quantized window."""
    from swiftmpi_tpu_torch import obs
    obs.reset_for_tests()
    try:
        m, sents = _serve_model(dev, "xla", sections={
            "cluster": {"push_window": 2, "wire_quant": "int8"},
            "control": {"control": "on", "every": 10 ** 6},
            "worker": {"telemetry": 1, "telemetry_path": ""},
            "obs": {"numerics": 1}}, inner_steps=4)
        m.transfer.count_traffic = True
        m.train(sents, niters=1, batch_size=96)
        assert m.transfer.traffic()["window_fmt_q"] > 0
        det = m._numerics.detector
        det.warmup, det.patience = 2, 2
        for v in (1.0, 1.0, 1.0, 1.0, 500.0, 500.0):
            det.observe("numerics/ef_mass{field=synthetic}", v)
        assert m.wire_quant == "int8"
        m.controller.on_steps(1)
        assert m.wire_quant == m.transfer.wire_quant == "off"
        before = m.transfer.traffic()
        m.train(sents, niters=1, batch_size=96)
        tr = m.transfer.traffic_delta(before)
        # a lossless window on xla is the per-step push: no decision
        assert tr["window_fmt_q"] == 0 and m.train_metrics["fused"]
    finally:
        obs.reset_for_tests()


def test_sent2vec_over_snapshot_on_card_matches_live(dev):
    """Sent2vec over a published snapshot (its planes uploaded to the
    card) equals sent2vec over the live table at that version, bit for
    bit with the same draws, after the live table moved on; B2 runs once
    a batch and once a pass."""
    from swiftmpi_tpu_torch.models.sent2vec import Sent2Vec
    m, sents = _serve_model(dev, "xla")
    m.train(sents, niters=1, batch_size=96)
    snap = m.serving_publisher().publish(
        m.table, keys=m.vocab.keys, slots=m._slot_of_vocab.cpu().numpy())
    lines = [" ".join(map(str, s[:12])) for s in sents[:32]]
    s2v = Sent2Vec(m, seed=1)
    s2v.batchsize = 32
    draws = s2v.draw(32, 16, 3)
    live = s2v.infer_sentences(lines, niters=3, draws=iter([draws]))
    m.table.state["h"].add_(1.0)
    kernels.reset_launches()
    over = s2v.infer_sentences(lines, niters=3, snapshot=snap,
                               draws=iter([draws]))
    assert kernels.launch_counts()["gather"] == 1 + 3
    for (sa, a), (sb, b) in zip(over, live):
        assert sa == sb
        np.testing.assert_array_equal(a, b)


def test_device_topk_matches_host_on_card(dev):
    """``snapshot_topk(device=True)`` against the host path over a hybrid
    snapshot: scores within 1e-5, the same neighbours wherever the gap
    to the next score exceeds 1e-5."""
    from swiftmpi_tpu_torch.serve import SnapshotPublisher
    from swiftmpi_tpu_torch.serve.query import snapshot_topk
    torch.backends.cuda.matmul.allow_tf32 = False
    m, _ = _serve_model(dev)
    snap = SnapshotPublisher().publish(
        m.table, keys=m.vocab.keys, slots=m._slot_of_vocab.cpu().numpy())
    q = np.random.default_rng(2).normal(size=(64, 100)).astype(np.float32)
    host = snapshot_topk(snap, q, k=11)
    card = snapshot_topk(snap, q, k=11, device=True)
    np.testing.assert_allclose(card[2][:, :10], host[2][:, :10], rtol=0,
                               atol=1e-5)
    for qi in range(64):
        for n in range(1, 11):
            if host[2][qi, n - 1] - host[2][qi, n] > 1e-5:
                assert set(host[1][qi, :n]) == set(card[1][qi, :n])


# -- more than one rank process on the card ------------------------------------

def _launch_children(*args, timeout=600, nprocs=2):
    """``launch -np nprocs -- mp_child ...`` from the repository root."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    return subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np",
         str(nprocs), "--", sys.executable, "-m",
         "swiftmpi_tpu_torch.testing.mp_child", *args], cwd=root,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, SMTPU_DIST_TIMEOUT="120"))


def test_cross_process_exchange_on_card(dev, tmp_path):
    """500 back-to-back exchanges between 2 processes on the card through
    B5's cross-process form, all-to-all and all-gather, float32, int32
    and bfloat16, every payload distinct and every result held to the
    numpy expectation; no wait timed out; the rank-ordered psum's bits
    are the same on both processes."""
    import json
    res = _launch_children("exchange", "-out", str(tmp_path), "-rounds",
                           "500")
    assert res.returncode == 0, res.stdout + res.stderr
    got = [json.loads((tmp_path / f"exchange_r{r}.json").read_text())
           for r in (0, 1)]
    for g in got:
        assert g["checked"] == 500 and g["timeouts"] == 0
        assert g["launches"] == 501       # the exchanges and one psum
        assert g["plain_checked"] == 18 and g["refused"] == 2
    assert got[0]["psum_sha"] == got[1]["psum_sha"]


@pytest.mark.parametrize("nprocs", [4, 8])
def test_cross_process_exchange_at_4_and_8_processes_on_card(dev, tmp_path,
                                                             nprocs):
    """B5's cross-process form between 4 and 8 processes (4 and 8 CUDA
    contexts on one card): 240 back-to-back exchanges, all-to-all and
    all-gather, float32, int32 and bfloat16, rows of 8, 7 and 6 elements
    (bfloat16: 8, 6 and 10) over odd row counts, so most blocks are not
    whole 16-byte chunks; every result bit for bit against the numpy
    expectation, each form and width once against the plain version
    (gloo) on the same operand; no wait timed out; one launch an
    exchange; a bfloat16 block of 18 bytes refused in both forms; the
    rank-ordered psum's bits the same on every process."""
    import json
    res = _launch_children("exchange", "-out", str(tmp_path), "-rounds",
                           "240", nprocs=nprocs)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-4000:]
    got = [json.loads((tmp_path / f"exchange_r{r}.json").read_text())
           for r in range(nprocs)]
    for g in got:
        assert g["checked"] == 240 and g["timeouts"] == 0
        assert g["launches"] == 241 and g["plain_checked"] == 18
        assert g["refused"] == 2
    assert len({g["psum_sha"] for g in got}) == 1


def test_a_waiting_process_holds_no_sm_on_card(dev, tmp_path):
    """While process 0 waits in a cross-process exchange for process 1's
    send, process 1's fixed work (chained float32 products, ~0.1 s) runs
    as fast as alone: the wait is a stream wait the card's front end
    holds, which leaves process 0's context nothing to run, where a
    waiter kernel made the card time-slice the two contexts (about twice
    the time).  Median of 3 rounds within 1.3x of alone; every exchange
    an exact copy, no timeout."""
    import json
    res = _launch_children("progress", "-out", str(tmp_path), "-rounds",
                           "3")
    assert res.returncode == 0, res.stdout + res.stderr
    got = [json.loads((tmp_path / f"progress_r{r}.json").read_text())
           for r in (0, 1)]
    assert all(g["exact"] and g["timeouts"] == 0 for g in got)
    alone = float(np.median(got[1]["work_alone_ms"]))
    during = float(np.median(got[1]["work_during_wait_ms"]))
    assert during < 1.3 * alone, (alone, during, got[0]["wait_ms"])
    # process 0 really waited on the work
    assert float(np.median(got[0]["wait_ms"])) > 0.5 * alone


def test_a_dead_peer_releases_the_wait_on_card(dev, tmp_path):
    """A peer that never sends holds a waiting stream only its deadline:
    process 0's all-gather (deadline 800,000 polls, 0.2 s) returns well
    before process 1 sends anything (it holds back 5 s), with one
    timeout counted on process 0 and none on process 1."""
    import json
    from swiftmpi_tpu_torch.testing import mp_child
    res = _launch_children("dead", "-out", str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    got = [json.loads((tmp_path / f"dead_r{r}.json").read_text())
           for r in (0, 1)]
    assert got[0]["timeouts"] == 1 and got[0]["epoch"] == 1
    assert got[1]["timeouts"] == 0
    assert got[0]["wall_s"] < 0.5 * mp_child.DEAD_HOLD_S, got


def _two_process_spec(tmp_path, steps: int = 1, **extra) -> dict:
    """A 2-process ``xla`` word2vec job of ``steps`` steps at d = 100: its
    spec (written to ``spec.json``), the corpus, vocab, conf, the
    processes' batches and draws."""
    import json
    from swiftmpi_tpu_torch.data.distributed import shard_sentences
    from swiftmpi_tpu_torch.data.text import build_vocab
    # 8 sentences of 32 keys a process: one batch of 256 centers each
    corpus = np.asarray(synthetic_corpus(16, 300, 32, seed=4), np.int32)
    vocab = build_vocab(corpus)
    conf = {"cluster": {"transfer": "xla", "server_num": 1},
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": -1, "learning_rate": 0.05},
            "server": {"initial_learning_rate": 0.7}}
    B = 256
    rng = np.random.default_rng(3)
    parts = [next(iter(CBOWBatcher(shard_sentences(corpus, r, 2), vocab, 4,
                                   -1, seed=2008 + r).epoch(B)))
             for r in (0, 1)]
    draws = [(rng.integers(0, len(vocab), (steps, B, 20)),
              rng.random((steps, B, 20), np.float32)) for _ in (0, 1)]
    np.savez(tmp_path / "data.npz", corpus=corpus, vocab_keys=vocab.keys,
             vocab_counts=vocab.counts,
             **{f"{k}{r}": draws[r][i] for r in (0, 1)
                for i, k in enumerate("ju")})
    spec = {"conf": conf, "data": str(tmp_path / "data.npz"),
            "device": "cuda", "batch_size": B, "niters": steps,
            "out": str(tmp_path / "out"), "state": True, **extra}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    return spec, conf, vocab, parts, draws


def test_a_ring_timeout_fails_both_processes_on_card(dev, tmp_path):
    """A forced timeout of the cross-process exchange: process 1 holds its
    stream ~25 ms before each send and every wait gives up after 100
    polls (the watchdog releases a cross-process wait 100 ``_POLL_S``
    after its send ran), so process 0's waits give up; ``Word2Vec.train``
    sums the count over the processes at the epoch's end and stops the
    run, and the launch fails (no dump of a corrupted run)."""
    _two_process_spec(tmp_path, stall={"rank": 1, "max_polls": 100,
                                       "cycles": 50_000_000})
    res = _launch_children("w2v", "-spec", str(tmp_path / "spec.json"))
    assert res.returncode != 0, res.stdout + res.stderr
    assert "ring exchange wait(s) timed out across 2 process(es)" \
        in res.stdout, res.stdout + res.stderr
    assert "MP_CHILD_OK" not in res.stdout
    assert not (tmp_path / "out" / "w2v_r0.json").exists()


def test_two_process_xla_step_matches_one_process_on_card(dev, tmp_path):
    """One step of 2 processes on ``xla`` (their batches and draws) equals
    the one-process step over the concatenated batch within the envelope;
    the replicas are bit-identical."""
    import json
    _, conf, vocab, parts, draws = _two_process_spec(tmp_path)
    res = _launch_children("w2v", "-spec", str(tmp_path / "spec.json"))
    assert res.returncode == 0, res.stdout + res.stderr
    got = [json.loads((tmp_path / "out" / f"w2v_r{r}.json").read_text())
           for r in (0, 1)]
    assert got[0]["sha"] == got[1]["sha"]
    assert got[0]["timeouts"] == got[1]["timeouts"] == 0
    assert got[0]["launches"]["ring_process"] >= 1
    m = Word2Vec(config=ConfigParser().update(conf), device=dev)
    m.build_from_vocab(vocab)
    es, ec = m.step(*(np.concatenate([getattr(b, k) for b in parts])
                      for k in ("centers", "contexts", "ctx_mask")),
                    draws=(np.concatenate([d[0][0] for d in draws]),
                           np.concatenate([d[1][0] for d in draws])))
    assert got[0]["losses"][0] == pytest.approx(es / ec, rel=1e-4)
    state = np.load(tmp_path / "out" / "w2v_state_r0.npz")
    for f, t in m.table.state.items():
        np.testing.assert_allclose(state[f], t.cpu().numpy(), rtol=1e-3,
                                   atol=1e-5)


def _elastic_pair(tmp_path, dev, world=3, n_shards=8):
    """The same elastic fleet twice, one fleet directory each: workers
    with their rows on the card and on the CPU."""
    from swiftmpi_tpu_torch.cluster import membership as mem
    from swiftmpi_tpu_torch.cluster.elastic import ElasticWorker
    dirs = {d: tmp_path / d for d in ("card", "cpu")}
    workers = {}
    for name, d in dirs.items():
        d.mkdir()
        mem.write_membership(str(d), mem.initial_table(world, n_shards))
        workers[name] = {r: ElasticWorker(
            r, str(d), world_size=world, n_shards=n_shards,
            rows_per_shard=64, dim=100, dump_every=2,
            device=dev if name == "card" else "cpu") for r in range(world)}
    return dirs, workers


def test_elastic_worker_on_card_matches_cpu(dev, tmp_path):
    """Rows on the card against rows on the CPU, bit for bit, over a
    death (adoption from the last dump) and a two-phase rejoin; every
    dump and migration npz equal; dumps and exports read through B2."""
    from swiftmpi_tpu_torch.cluster import membership as mem
    from swiftmpi_tpu_torch.control.controller import plan_placement
    dirs, workers = _elastic_pair(tmp_path, dev)

    def every(fn):
        out = {n: {r: fn(w) for r, w in ws.items()}
               for n, ws in workers.items()}
        assert out["card"] == out["cpu"]
        return out["card"]

    def publish(make):
        for name, d in dirs.items():
            mem.write_membership(str(d), make(mem.read_membership(str(d))))

    def step_all():
        for r, b in workers["cpu"].items():
            a = workers["card"][r]
            assert a.step() == pytest.approx(b.step(), rel=1e-6, abs=1e-12)

    gather.launches = 0
    every(lambda w: w.boot(timeout_s=2.0))
    for _ in range(4):
        every(lambda w: w.sync())
        step_all()
    assert gather.launches == 2 * 3          # two dumps a rank
    for ws in workers.values():
        ws.pop(2)
    t = mem.read_membership(str(dirs["cpu"]))
    assign = plan_placement(t.shards_of(2), [0, 1],
                            current_owner=t.owner_of_shard)
    publish(lambda t: mem.plan_death(t, 2, assign))
    every(lambda w: w.sync())
    t = mem.read_membership(str(dirs["cpu"]))
    publish(lambda t: mem.plan_rejoin(t, 2, {t.shards_of(0)[0]: 2,
                                            t.shards_of(1)[0]: 2}))
    launches = gather.launches
    every(lambda w: w.sync())
    assert gather.launches == launches + 2   # one export a source
    publish(lambda t: mem.commit_table(t))
    every(lambda w: w.sync())
    from swiftmpi_tpu_torch.cluster.elastic import ElasticWorker
    for name, d in dirs.items():
        workers[name][2] = ElasticWorker(
            2, str(d), world_size=3, n_shards=8, rows_per_shard=64,
            dim=100, dump_every=2, device=dev if name == "card" else "cpu")
    every(lambda w: w.boot(timeout_s=2.0))
    for _ in range(3):
        every(lambda w: w.sync())
        step_all()
    for r in range(3):
        a, b = workers["card"][r], workers["cpu"][r]
        assert a.rows.device.type == "cuda"
        ra, rb = a.rows_dict(), b.rows_dict()
        assert sorted(ra) == sorted(rb)
        for k in ra:
            assert np.array_equal(ra[k], rb[k]), (r, k)
        assert a.loss() == pytest.approx(b.loss(), rel=1e-6)
        assert a.migration_bytes == b.migration_bytes
    names = sorted(n for n in dirs["cpu"].iterdir() if n.suffix == ".npz")
    assert names
    for p in names:
        with np.load(p) as zc, np.load(dirs["card"] / p.name) as zg:
            for f in zc.files:
                np.testing.assert_array_equal(zg[f], zc[f])


def test_serve_trainer_update_on_card_matches_numpy(dev):
    """The serve child's trainer: planes on the card, numpy's draws,
    ``index_add_`` onto the distinct touched rows, bit for bit against
    the numpy update of the JAX child."""
    from swiftmpi_tpu_torch.testing.serve_child import _Table, _zipf_slots
    vocab, dim, n_hot = 4096, 16, 256
    tbl = _Table(vocab, dim, n_hot, seed=7, device=dev)
    ref = {f: v.cpu().numpy().copy() for f, v in tbl.state.items()}
    rng = np.random.default_rng(1000)
    for _ in range(40):
        rows = np.unique(_zipf_slots(rng, 128, vocab, 1.3))
        upd = rng.normal(scale=0.05, size=(len(rows), dim)).astype(
            np.float32)
        tbl.apply(rows, upd)
        hot, tail = rows[rows < n_hot], rows[rows >= n_hot] - n_hot
        ref["v@hot"][hot] += upd[:len(hot)]
        ref["v"][tail] += upd[len(rows) - len(tail):]
    for f, v in tbl.state.items():
        assert v.device.type == "cuda"
        np.testing.assert_array_equal(v.cpu().numpy(), ref[f])


# -- the transformer family (seq, expert and stage axes on one card) ----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_exchange_autograd_on_card(dev, dtype):
    """RingExchange at an Ulysses shape (4 ranks' (4, B, S/4, H/4, D)
    chunks): forward and backward bit-equal to the plain exchange, one
    kernel launch each way."""
    gen = torch.Generator(device=dev).manual_seed(19)
    shape = (4, 4, 2, 128, 2, 64)
    x = torch.rand(shape, generator=gen, device=dev).to(dtype)
    w = torch.rand(shape, generator=gen, device=dev).to(dtype)
    xg = x.clone().requires_grad_(True)
    kernels.reset_launches()
    y = ring.RingExchange.apply(xg)
    assert ring.launches == 1
    (y * w).sum().backward()
    torch.cuda.synchronize()
    assert ring.launches == 2 and ring.timeouts() == 0
    assert torch.equal(y, ring.ring_exchange_stacked_plain(x))
    assert torch.equal(xg.grad, ring.ring_exchange_stacked_plain(w))


def test_ulysses_and_moe_go_through_b5_on_card(dev):
    """On the card the Ulysses and MoE all-to-alls launch B5, forward and
    backward, and agree with full attention and the dense MoE reference
    (rtol 2e-4, atol 2e-5, float32)."""
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.parallel import moe
    from swiftmpi_tpu_torch.parallel.ring_attention import (
        full_attention, ulysses_attention)
    gen = torch.Generator(device=dev).manual_seed(20)
    q, k, v = (torch.randn((2, 64, 8, 16), generator=gen, device=dev)
               .requires_grad_(True) for _ in range(3))
    kernels.reset_launches()
    o = ulysses_attention(q, k, v, Mesh({"seq": 4}, dev), causal=True)
    assert ring.launches == 4
    o.sum().backward()
    torch.cuda.synchronize()
    assert ring.launches == 8
    torch.testing.assert_close(o, full_attention(q, k, v, causal=True),
                               rtol=2e-4, atol=2e-5)
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 8,
                            device=dev)
    x = torch.randn((64, 16), generator=gen, device=dev)
    kernels.reset_launches()
    y, aux = moe.moe_ffn(p, x, Mesh({"expert": 4}, dev), capacity_factor=8.0)
    y_ref, aux_ref = moe.moe_ffn_reference(p, x)
    torch.cuda.synchronize()
    assert ring.launches == 2
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(aux, aux_ref, rtol=1e-5, atol=0)


def test_trainer_step_on_card_matches_cpu(dev):
    """bench.py's transformer width (vocab 8,192, d_model 512, 4 layers, 8
    heads, d_ff 2,048) in float32, 2 sequences of 128: two AdamW steps
    (warmup 1, so the second has the peak rate) on the card against the
    CPU port's from the same init and tokens.  Losses within 1e-4
    relative; every leaf of params and optimizer state within |a - b| <=
    1e-5 + 1e-3 |b| but for at most 1e-3 of its elements (AdamW's m /
    sqrt(v) moves a param whose gradient is noise by up to the rate)."""
    from swiftmpi_tpu_torch.models.trainer import Trainer
    from swiftmpi_tpu_torch.models.transformer import TransformerConfig
    from swiftmpi_tpu_torch.utils import tree
    cfg = TransformerConfig(vocab_size=8192, d_model=512, n_layers=4,
                            n_heads=8, d_ff=2048, max_seq=512)
    rng = np.random.default_rng(21)
    toks = [rng.integers(0, 8192, (2, 128)).astype(np.int32)
            for _ in range(2)]
    runs = {}
    for d in (dev, torch.device("cpu")):
        tr = Trainer(cfg, device=d, learning_rate=1e-3, warmup_steps=1)
        state = tr.init_state(0)
        losses = [float(tr.step(state, t)[1]) for t in toks]
        runs[d.type] = (losses, [x.cpu().double()
                                 for x in tree.leaves(state.tree())])
    (lc, fc), (lh, fh) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc, lh, rtol=1e-4)
    for i, (a, b) in enumerate(zip(fc, fh)):
        outside = ((a - b).abs() > 1e-5 + 1e-3 * b.abs()).double().mean()
        assert float(outside) <= 1e-3, (i, float(outside))


def test_trainer_across_two_processes_on_card(dev, tmp_path):
    """The transformer trainer over 2 processes on the card at a tiny size
    (vocab 256, d_model 64, 2 layers, 8 x 32 global tokens, float32, and
    the same with 4 experts over expert = 2 in each process): the
    replicas equal by sha256, the losses and every leaf within the
    envelope of one process's steps over the same global batches, B5
    launched across processes once a step (MoE: and twice a layer
    more for the densities, forward and backward)."""
    import json
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.models.trainer import Trainer, leaf_to_numpy
    from swiftmpi_tpu_torch.testing.mp_child import trainer_config
    from swiftmpi_tpu_torch.utils import tree
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, 256, (3, 8, 32)).astype(np.int32)
    np.savez(tmp_path / "data.npz", tokens=tokens)
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128)
    specs = [{"job": "trainer", "cfg": dict(base, **extra), "mesh": mesh,
              "opt": {"learning_rate": 1e-2, "warmup_steps": 1},
              "data": str(tmp_path / "data.npz"), "device": "cuda",
              "out": str(tmp_path / name), "state": True}
             for name, extra, mesh in (
                 ("dense", {}, None),
                 ("moe", {"n_experts": 4, "moe_capacity_factor": 4.0},
                  {"expert": 2}))]
    (tmp_path / "specs.json").write_text(json.dumps(specs))
    res = _launch_children("w2v", "-spec", str(tmp_path / "specs.json"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for spec in specs:
        out = tmp_path / spec["out"]
        got = [json.loads((out / f"trainer_r{r}.json").read_text())
               for r in (0, 1)]
        assert got[0]["leaf_sha"] == got[1]["leaf_sha"]
        assert got[0]["losses"] == got[1]["losses"]
        assert got[0]["timeouts"] == got[1]["timeouts"] == 0
        moe = spec["mesh"] is not None
        assert got[0]["launches"]["ring_process"] == 3 * (1 + 4 * moe)
        assert got[0]["launches"]["ring"] == 3 * 8 * moe
        mesh = Mesh(spec["mesh"], dev) if moe else None
        tr = Trainer(trainer_config(spec), mesh=mesh,
                     device=None if moe else dev, **spec["opt"])
        state = tr.init_state(0)
        losses = [float(tr.step(state, t)[1]) for t in tokens]
        np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-3,
                                   atol=1e-5)
        final = np.load(out / "trainer_state_r0.npz")
        for i, want in enumerate(tree.leaves(state.tree())):
            a = final[f"leaf_{i}"].astype(np.float64)
            b = leaf_to_numpy(want).astype(np.float64)
            share = np.mean(np.abs(a - b) > 1e-5 + 1e-3 * np.abs(b))
            assert share <= 1e-3, (spec["out"], i, share)


@pytest.mark.parametrize("stencil", [0, 1])
def test_data_plane_routes_on_card(dev, stencil):
    """word2vec on ``tpu@4`` (stencil 0) and with ``stencil`` on ``xla``
    (stencil 1) at d = 100 under ``data_plane: auto`` (B5, B4) and
    ``xla`` (the transpose, the chain of torch ops) from one table and
    one draw stream: every epoch's loss within 1e-5 relative (B3 sums in
    no fixed order, so later steps drift by its last bits), and B4 and
    B5 launch only under ``auto``."""
    corpus = synthetic_corpus(40, 300, 32, seed=8)
    runs = {}
    for plane in ("auto", "xla"):
        c = ConfigParser().update({
            "cluster": ({"transfer": "xla", "server_num": 1} if stencil
                        else {"transfer": "tpu", "server_num": 4}),
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": -1, "learning_rate": 0.05,
                         "stencil": stencil},
            "server": {"initial_learning_rate": 0.7}})
        c.set("cluster", "data_plane", plane)
        m = Word2Vec(config=c, device=dev, seed=5)
        m.build(corpus)
        kernels.reset_launches()
        losses = m.train(corpus, niters=2, batch_size=256)
        torch.cuda.synchronize()
        runs[plane] = (losses, kernels.launch_counts(), m.data_plane_routes)
    (la, ca, ra), (lx, cx, rx) = runs["auto"], runs["xla"]
    name, kernel = (("stencil_fused", "stencil") if stencil
                    else ("ring_push", "ring"))
    assert ra == {name: "kernel"} and rx == {name: "library"}
    assert ca[kernel] > 0 and cx["stencil"] == cx["ring"] == 0
    np.testing.assert_allclose(lx, la, rtol=1e-5)


# -- the last of the JAX package's surface: grow, SGDAccess, reduce-scatter ---

def test_grow_under_graphs_matches_an_eager_twin(dev):
    """``Word2Vec.grow`` between two graphed ``train`` calls (``inner_steps:
    4``, batch 32: sparse pushes, deterministic sums) against a twin that
    grows at the same point and runs every group eagerly: the probe rows
    keep their bits across the growth, the next ``train`` captures new
    graphs (the table's tensors moved) and replays them, B1 and B2 launch
    after the growth, and both tables and losses are equal bit for
    bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        m, sents = _path_model(dev, "gather", inner_steps=4)
        twin, _ = _path_model(dev, "gather", inner_steps=4)
        twin._run_group = lambda fields, graphs, *a: Word2Vec._run_group(
            twin, fields, False, *a)
        prefix = sents[:60]
        for x in (m, twin):
            x.train(prefix, niters=1, batch_size=32)
        assert m.train_metrics["graph_replays"] > 0
        assert twin.train_metrics["graph_replays"] == 0
        graphs = dict(m._fused_cache)
        probe = [int(k) for k in m.vocab.keys[:16]]
        before = [m.embedding(k) for k in probe]
        cap = m.table.key_index.capacity_per_shard
        for x in (m, twin):
            x.grow(2 * cap)
        assert all(np.array_equal(m.embedding(k), b)
                   for k, b in zip(probe, before))
        kernels.reset_launches()
        m.train(prefix, niters=1, batch_size=32)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        twin.train(prefix, niters=1, batch_size=32)
    finally:
        torch.use_deterministic_algorithms(False)
    assert m.table.capacity == 2 * cap and m.table.generation == 1
    assert counts["gather"] > 0 and counts["adagrad"] > 0
    assert m.train_metrics["graph_replays"] > 0
    assert m._fused_cache and not any(
        m._fused_cache.get(L) is g for L, g in graphs.items())
    assert m.train_metrics["epoch_err"] == twin.train_metrics["epoch_err"]
    for f, t in m.table.state.items():
        assert torch.equal(t, twin.table.state[f]), f


def test_grow_on_8_ranks_on_card_matches_cpu(dev):
    """``tpu@8`` on the card and its CPU twin with the same draws: a step,
    a growth, a step; the occupied rows moved bit for bit, and after the
    second step within 1e-5 + 1e-3 |b| of the CPU's; B1, B2, B3 and B5
    launch after the growth."""
    conf = {"cluster": {"transfer": "tpu", "server_num": 8},
            "word2vec": {"len_vec": 100, "window": 4, "negative": 20,
                         "sample": 1e-3, "learning_rate": 0.05},
            "server": {"initial_learning_rate": 0.7}}
    sents = synthetic_corpus(200, 3000, 40, seed=8)
    card = Word2Vec(config=ConfigParser().update(conf), device=dev)
    card.build(sents)
    cpu = _cpu_twin(card)
    cpu.table.state = state_from_jax(state_to_numpy(card.table.state), "cpu",
                                     mesh=cpu.cluster.mesh)
    batches = [next(iter(CBOWBatcher(sents, card.vocab, card.window,
                                     card.sample, seed=s).epoch(200)))
               for s in (5, 6)]
    rng = np.random.default_rng(4)
    shape = card.draw_shape(200)
    draws = [(rng.integers(0, len(card.vocab), shape),
              rng.random(shape, np.float32)) for _ in range(2)]
    keys = card.vocab.keys
    for x in (card, cpu):
        x.step_batch(batches[0], draws=draws[0])
    rows = state_to_numpy(card.table.state)
    slots0 = card.table.key_index.lookup(keys, create=False)
    cap = card.table.key_index.capacity_per_shard
    for x in (card, cpu):
        x.grow(2 * cap)
    slots1 = card.table.key_index.lookup(keys, create=False)
    grown = state_to_numpy(card.table.state)
    for f in rows:
        np.testing.assert_array_equal(grown[f][slots1], rows[f][slots0])
    kernels.reset_launches()
    card.step_batch(batches[1], draws=draws[1])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu.step_batch(batches[1], draws=draws[1])
    assert all(counts[k] > 0 for k in ("gather", "scatter", "adagrad",
                                       "ring")), counts
    # the growth's new rows are each device's own draws: compare the
    # occupied rows
    got, want = (state_to_numpy(x.table.state) for x in (card, cpu))
    _close({f: v[slots1] for f, v in got.items()},
           {f: v[slots1] for f, v in want.items()}, "tpu@8 after the growth")


@pytest.mark.parametrize("mean", [False, True])
def test_sgd_access_through_tpu_at_8_on_card(dev, mean):
    """``SGDAccess`` pulls and pushes through 8 ranks on the card against
    the same calls on the CPU's plain path: the pull bit for bit, the
    push within 1e-5 + 1e-3 |b|; B2, B3 and B5 launch."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.parameter import FieldSpec, SGDAccess
    from swiftmpi_tpu_torch.transfer import get_transfer
    d, cap, n = 100, 4096, 8
    acc = SGDAccess(0.3, {"h": FieldSpec(d), "v": FieldSpec(d)},
                    ("h", "v"), ("h", "v"))
    rng = np.random.default_rng(7)
    table = {f: rng.normal(size=(n * cap, d)).astype(np.float32)
             for f in "hv"}
    slots = rng.integers(-1, n * cap, size=8000).astype(np.int32)
    grads = {f: rng.normal(size=(8000, d)).astype(np.float32) for f in "hv"}
    out = {}
    for where in (dev, torch.device("cpu")):
        layout = ps_mesh(n, [where])
        state = state_from_jax(table, where, mesh=layout)
        t = get_transfer("tpu", mesh=layout)
        s = torch.from_numpy(slots).to(where)
        kernels.reset_launches()
        pulled = t.pull(state, s, acc)
        t.push(state, s, {f: torch.from_numpy(g).to(where)
                          for f, g in grads.items()}, acc, mean=mean)
        if where.type == "cuda":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        out[where.type] = ({f: v.cpu().numpy() for f, v in pulled.items()},
                           state_to_numpy(state))
    for f in "hv":
        np.testing.assert_array_equal(out["cuda"][0][f], out["cpu"][0][f])
    _close(out["cuda"][1], out["cpu"][1], "SGD through tpu@8")
    assert counts["gather"] > 0 and counts["scatter"] > 0 \
        and counts["ring"] > 0 and counts["adagrad"] == 0, counts


def test_rank_reduce_scatter_on_card(dev):
    """``rank_reduce_scatter`` over 4 stacked ranks on the card: forward
    and backward bit for bit to the CPU's (B5's plain version, the same
    sums in source order), one B5 launch each way."""
    from swiftmpi_tpu_torch.parallel import rank_reduce_scatter
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((4, 3, 64, 50), generator=gen)
    w = torch.randn((4, 3, 16, 50), generator=gen)
    out = {}
    for where in (dev, torch.device("cpu")):
        xg = x.to(where).requires_grad_(True)
        kernels.reset_launches()
        y = rank_reduce_scatter(xg, scatter_dimension=1)
        launched = ring.launches
        (y * w.to(where)).sum().backward()
        if where.type == "cuda":
            torch.cuda.synchronize()
            assert launched == 1 and ring.launches == 2
        out[where.type] = (y.detach().cpu(), xg.grad.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
