"""The port's sigmoid and sampling ops (swiftmpi_tpu_torch/ops) against
the JAX package's on the same inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.ops import sampling as jax_sampling
from swiftmpi_tpu.ops.sigmoid import sigmoid_clipped as jax_sigmoid
from swiftmpi_tpu_torch.ops import sampling
from swiftmpi_tpu_torch.ops.sigmoid import MAX_EXP, sigmoid_clipped


def _zipf_counts(V, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.zipf(1.3, V).astype(np.int64))[::-1] + 1


def test_sigmoid_saturates_exactly_beyond_max_exp():
    """Exactly 0/1 beyond +/-6 (the reference ExpTable clip), exactly the
    clipped value at +/-6 itself."""
    f = torch.tensor([-1e30, -100.0, -6.0001, -MAX_EXP, MAX_EXP, 6.0001,
                      100.0, 1e30], dtype=torch.float32)
    got = sigmoid_clipped(f).numpy()
    want = np.asarray(jax_sigmoid(jnp.asarray(f.numpy())))
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == got[2] == 0.0
    assert got[5] == got[6] == got[7] == 1.0
    assert 0.0 < got[3] < got[4] < 1.0


def test_sigmoid_matches_jax_inside_the_clip():
    """Inside [-6, 6] both are the exact float32 sigmoid: equal to 1 ulp."""
    f = np.linspace(-6.0, 6.0, 2001, dtype=np.float32)
    got = sigmoid_clipped(torch.from_numpy(f)).numpy()
    want = np.asarray(jax_sigmoid(jnp.asarray(f)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-9)


@pytest.mark.parametrize("V", [1, 7, 300])
def test_alias_tables_equal(V):
    counts = _zipf_counts(V, seed=V)
    prob, alias = sampling.build_unigram_alias(counts)
    jprob, jalias = jax_sampling.build_unigram_alias(counts)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(alias, jalias)
    assert prob.dtype == np.float32 and alias.dtype == np.int32


@pytest.mark.parametrize("sample", [-1.0, 1e-3, 1e-5])
def test_subsample_keep_prob_equal(sample):
    counts = _zipf_counts(300, seed=1)
    np.testing.assert_array_equal(
        sampling.subsample_keep_prob(counts, sample),
        jax_sampling.subsample_keep_prob(counts, sample))


def _jax_draws(key, V, shape):
    """The (j, u) that ``_alias_draw_packed`` derives from ``key``."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


@pytest.mark.parametrize("seed", [0, 11])
def test_alias_slots_from_replayed_draws_equal_jax(seed):
    """Fed the (j, u) JAX derives from a key, the port resolves exactly
    the negatives and slots JAX ``sample_alias_slots`` returns."""
    V, shape = 300, (64, 5)
    counts = _zipf_counts(V, seed=seed)
    prob, alias = sampling.build_unigram_alias(counts)
    rng = np.random.default_rng(seed)
    slot_of_vocab = rng.permutation(V + 50)[:V].astype(np.int32)
    key = jax.random.key(seed)
    jnegs, jslots = jax_sampling.sample_alias_slots(
        key, jnp.asarray(prob), jnp.asarray(alias),
        jnp.asarray(slot_of_vocab), shape)
    j, u = _jax_draws(key, V, shape)
    negs, slots = sampling.sample_alias_slots_from_draws(
        torch.from_numpy(j), torch.from_numpy(u), torch.from_numpy(prob),
        torch.from_numpy(alias), torch.from_numpy(slot_of_vocab))
    np.testing.assert_array_equal(negs.numpy(), np.asarray(jnegs))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(slots.numpy(), slot_of_vocab[negs.numpy()])
    assert slots.dtype == torch.int32


def test_alias_draws_follow_the_unigram_distribution():
    """The port's own draws (torch.Generator) give the alias tables'
    distribution: counts^0.75 over 50 words within 0.01 absolute per
    word over 200k draws."""
    V = 50
    counts = _zipf_counts(V, seed=2)
    prob, alias = sampling.build_unigram_alias(counts)
    gen = torch.Generator().manual_seed(0)
    j, u = sampling.alias_draws(gen, V, (200_000,))
    assert j.dtype == torch.int64 and u.dtype == torch.float32
    assert int(j.min()) >= 0 and int(j.max()) < V
    negs, _ = sampling.sample_alias_slots_from_draws(
        j, u, torch.from_numpy(prob), torch.from_numpy(alias),
        torch.arange(V, dtype=torch.int32))
    freq = np.bincount(negs.numpy(), minlength=V) / 200_000
    want = counts ** 0.75 / (counts ** 0.75).sum()
    np.testing.assert_allclose(freq, want, atol=0.01)
