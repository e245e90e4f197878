"""The reference's LCG (``swiftmpi_tpu_torch/utils/rng.py``) and the
numpy word2vec oracle (``swiftmpi_tpu_torch/testing/w2v_oracle.py``)
against the JAX package's copies, bit for bit."""

import numpy as np
import pytest

from swiftmpi_tpu.testing import w2v_oracle as joracle
from swiftmpi_tpu.utils import rng as jrng
from swiftmpi_tpu_torch.testing import w2v_oracle as poracle
from swiftmpi_tpu_torch.utils import rng as prng


@pytest.mark.parametrize("seed", [0, 1, 2008, 2 ** 63 + 12345, -7])
def test_random_streams_equal_jax(seed):
    """The integer and float streams, scalar and batched, interleaved,
    equal JAX's draw for draw (the state advances alike)."""
    a, b = prng.Random(seed), jrng.Random(seed)
    assert a.next_random == b.next_random
    assert a.next_float_random == b.next_float_random
    for _ in range(3):
        assert [a() for _ in range(17)] == [b() for _ in range(17)]
        assert [a.gen_float() for _ in range(9)] == \
            [b.gen_float() for _ in range(9)]
        ba, bb = a.batch(33), b.batch(33)
        assert ba.dtype == bb.dtype == np.uint64
        np.testing.assert_array_equal(ba, bb)
        fa, fb = a.batch_float(11), b.batch_float(11)
        np.testing.assert_array_equal(fa, fb)
    assert (a.next_random, a.next_float_random) == \
        (b.next_random, b.next_float_random)


def test_global_random_is_seeded_2008_and_resets():
    prng.reset_global_random()
    jrng.reset_global_random()
    g = prng.global_random()
    assert g is prng.global_random()
    assert g.next_random == 2008
    assert [g() for _ in range(5)] == \
        [jrng.global_random()() for _ in range(5)]
    prng.reset_global_random(7)
    assert prng.global_random().next_random == 7
    prng.reset_global_random()


def _corpus(seed=3, n=40, vocab=30, length=12):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(map(int, rng.choice(np.arange(1, vocab + 1), size=length,
                                     p=p))) for _ in range(n)]


def _tiny(sample):
    return (dict(len_vec=8, window=2, negative=3, alpha=0.05, server_lr=0.3,
                 sample=sample, minibatch_lines=7, table_size=5_000,
                 seed=2008, init_seed=1), _corpus(), 2)


def _word2vec_test():
    from tests import test_torch_word2vec as tw
    return (tw.ORACLE_KW, tw.corpus(**tw.ORACLE_CORPUS), tw.ORACLE_ITERS)


@pytest.mark.parametrize("case", [
    pytest.param(lambda: _tiny(-1.0), id="-1.0"),
    pytest.param(lambda: _tiny(1e-2), id="0.01"),
    pytest.param(_word2vec_test, id="word2vec_loss_parity")])
def test_oracle_equals_jax_oracle(case):
    """The port's oracle over a tiny corpus, and at the settings, corpus
    and epochs of ``test_torch_word2vec.py::
    test_loss_parity_vs_reference_oracle``: the same per-iteration
    losses and the same rows, bit for bit, as JAX's (both draw from
    their own package's LCG)."""
    kw, sents, niters = case()
    a, b = poracle.W2VOracle(**kw), joracle.W2VOracle(**kw)
    assert a.train(sents, niters=niters) == b.train(sents, niters=niters)
    assert sorted(a.h) == sorted(b.h)
    for f in ("h", "v", "h2sum", "v2sum"):
        for w in a.h:
            np.testing.assert_array_equal(getattr(a, f)[w],
                                          getattr(b, f)[w])
    assert a.lcg.next_random == b.lcg.next_random


def test_oracle_helpers_equal_jax():
    freq = {3: 5, 1: 2, 9: 1}
    np.testing.assert_array_equal(poracle.gen_unigram_table(freq, 100),
                                  joracle.gen_unigram_table(freq, 100))
    for f in (-5.99, -1.5, 0.0, 0.3, 5.99):
        assert poracle.exp_table_sigmoid(f) == joracle.exp_table_sigmoid(f)
    rng = np.random.default_rng(0)
    h = rng.normal(size=(6, 4)).astype(np.float32)
    v = rng.normal(size=(6, 4)).astype(np.float32)
    args = dict(centers=np.array([0, 1, 2]),
                contexts=np.array([[1, 2], [0, 3], [4, 5]]),
                ctx_mask=np.array([[1, 1], [1, 0], [0, 1]], bool),
                negatives=np.array([[3, 4], [5, 0], [1, 2]]), alpha=0.05)
    for x, y in zip(poracle.cbow_batch_grads(h, v, **args),
                    joracle.cbow_batch_grads(h, v, **args)):
        np.testing.assert_array_equal(x, y)
