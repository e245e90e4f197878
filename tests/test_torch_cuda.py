"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one; none imports
JAX, so the file runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.kernels import adagrad, gather, scatter
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import synthetic_corpus
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
                                       "adagrad": 1}


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
    with pytest.raises(TypeError, match="bf16"):
        gather.masked_gather(table.bfloat16(), slots, valid)
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
    assert all(kernels.launch_counts().values())
