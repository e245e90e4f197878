"""The port's key index against the JAX package's: the same seeded keys
give the same slots through the hash probe, with and without a hot/cold
partition — creating passes, lookup-only passes, duplicates in a batch,
``grow``, ``restore`` — and ``calibrate_hot_k`` / ``from_counts`` pick
the same head.  All exact (slots are integers)."""

import numpy as np
import pytest

from swiftmpi_tpu.cluster.hashfrag import HashFrag as JaxHashFrag
from swiftmpi_tpu.cluster.hashfrag import expected_unique_rows as jax_eur
from swiftmpi_tpu.cluster.hashfrag import shard_load_histogram as jax_slh
from swiftmpi_tpu.cluster.hashfrag import split_route as jax_split_route
from swiftmpi_tpu.parameter.key_index import HotColdPartition as JaxPart
from swiftmpi_tpu.parameter.key_index import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter.key_index import \
    calibrate_hot_k as jax_calibrate
from swiftmpi_tpu_torch.cluster.hashfrag import (HashFrag,
                                                 expected_unique_rows,
                                                 shard_load_histogram,
                                                 split_route)
from swiftmpi_tpu_torch.parameter.key_index import (CapacityError,
                                                    HotColdPartition,
                                                    KeyIndex,
                                                    calibrate_hot_k)


def zipf_counts(v, s=1.0, total=1_000_000):
    p = np.arange(1, v + 1, dtype=np.float64) ** -s
    return np.maximum((total * p / p.sum()).astype(np.int64), 1)


def _keys_counts(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.choice(10**12, size=n, replace=False).astype(np.uint64)
    counts = zipf_counts(n)[rng.permutation(n)]
    return keys, counts


def _pair(partitioned, shards=4, cap=1200, seed=0):
    keys, counts = _keys_counts(seed=seed)
    jp = JaxPart.from_counts(keys, counts, batch_rows=256) \
        if partitioned else None
    pp = HotColdPartition.from_counts(keys, counts, batch_rows=256) \
        if partitioned else None
    return (JaxKeyIndex(shards, cap, partition=jp),
            KeyIndex(shards, cap, partition=pp), keys)


@pytest.mark.parametrize("partitioned", [False, True])
def test_slots_match_jax_through_passes(partitioned):
    """Creating passes (with duplicates in a batch), lookup-only passes
    over present and absent keys, the introspection views."""
    jki, pki, keys = _pair(partitioned)
    rng = np.random.default_rng(1)
    for _ in range(6):
        batch = rng.choice(keys, size=900)       # duplicates inside
        np.testing.assert_array_equal(pki.lookup(batch), jki.lookup(batch))
    absent = rng.integers(10**12, 2 * 10**12, size=400).astype(np.uint64)
    probe = np.concatenate([rng.choice(keys, size=600), absent])
    np.testing.assert_array_equal(pki.lookup(probe, create=False),
                                  jki.lookup(probe, create=False))
    assert (pki.lookup(absent, create=False) == -1).all()
    assert list(pki.items()) == list(jki.items())
    assert list(pki.keys()) == list(jki.keys())
    assert len(pki) == len(jki) and pki.n_hot == jki.n_hot
    np.testing.assert_array_equal(pki.shard_fill(), jki.shard_fill())
    for k in keys[:50]:
        assert (int(k) in pki) == (int(k) in jki)
        if int(k) in jki:
            assert pki.slot(int(k)) == jki.slot(int(k))
    assert pki.total_capacity == jki.total_capacity


@pytest.mark.parametrize("partitioned", [False, True])
def test_grow_and_restore_match_jax(partitioned):
    jki, pki, keys = _pair(partitioned, cap=800, seed=2)
    rng = np.random.default_rng(3)
    first = rng.choice(keys, size=1500)
    np.testing.assert_array_equal(pki.lookup(first), jki.lookup(first))
    hot_before = [s for _, s in pki.items() if s < pki.n_hot]
    jki.grow(1600)
    pki.grow(1600)
    assert list(pki.items()) == list(jki.items())
    assert [s for _, s in pki.items() if s < pki.n_hot] == hot_before
    more = rng.choice(keys, size=1500)
    np.testing.assert_array_equal(pki.lookup(more), jki.lookup(more))
    ks = np.fromiter(jki.keys(), np.uint64)
    ss = np.array([s for _, s in jki.items()], np.int64)
    jr = JaxKeyIndex(4, 1600, partition=jki.partition)
    pr = KeyIndex(4, 1600, partition=pki.partition)
    jr.restore(ks, ss)
    pr.restore(ks, ss)
    assert list(pr.items()) == list(jr.items())
    np.testing.assert_array_equal(pr.shard_fill(), jr.shard_fill())
    rest = rng.choice(keys, size=2000)
    np.testing.assert_array_equal(pr.lookup(rest), jr.lookup(rest))


def test_calibrate_and_from_counts_match_jax():
    counts = zipf_counts(50_000)
    for batch_rows in (None, 512, 8192, 10**9):
        assert calibrate_hot_k(counts, batch_rows=batch_rows) == \
            jax_calibrate(counts, batch_rows=batch_rows)
    assert calibrate_hot_k(np.array([], np.int64)) == (0, 0.0)
    assert calibrate_hot_k(np.zeros(5, np.int64)) == (0, 0.0)
    keys, c = _keys_counts(5000, seed=4)
    c[10:40] = c[10]                    # a tie block across the cut
    for batch_rows in (None, 64, 4096):
        p = HotColdPartition.from_counts(keys, c, batch_rows=batch_rows)
        j = JaxPart.from_counts(keys, c, batch_rows=batch_rows)
        np.testing.assert_array_equal(p.hot_keys, j.hot_keys)
        assert p.head_mass == j.head_mass
        np.testing.assert_array_equal(p.hot_slot(keys), j.hot_slot(keys))
    perm = np.random.default_rng(5).permutation(len(keys))
    assert HotColdPartition.from_counts(keys[perm], c[perm]) == \
        HotColdPartition.from_counts(keys, c)
    with pytest.raises(ValueError, match="distinct"):
        HotColdPartition(np.array([3, 3], np.uint64))


def test_restore_guard_raises():
    """A hot pair the active partition does not map, a hot pair with no
    partition at all, and a tail slot past the layout all raise."""
    keys = np.arange(1, 101, dtype=np.uint64)
    part = HotColdPartition(keys[:16])
    ki = KeyIndex(4, 64, partition=part)
    with pytest.raises(ValueError, match="HotColdPartition"):
        ki.restore(np.array([int(keys[20])], np.uint64),
                   np.array([3], np.int64))
    with pytest.raises(ValueError, match="HotColdPartition"):
        KeyIndex(4, 64).restore([5], [-1])
    with pytest.raises(ValueError, match="outside"):
        ki.restore([int(keys[20])], [16 + 4 * 64])
    ok = np.asarray(ki.lookup(keys), np.int64)
    ki2 = KeyIndex(4, 64, partition=part)
    ki2.restore(keys, ok)
    assert list(ki2.items()) == list(ki.items())


def test_capacity_error_leaves_index_unchanged():
    ki = KeyIndex(2, 4, partition=HotColdPartition(
        np.array([7], np.uint64)))
    ki.lookup(np.arange(1, 5, dtype=np.uint64))
    before = list(ki.items())
    with pytest.raises(CapacityError):
        ki.lookup(np.arange(100, 140, dtype=np.uint64))
    assert list(ki.items()) == before
    assert ki.lookup([7])[0] == 0


def test_hashfrag_routing_helpers_match_jax():
    keys, counts = _keys_counts(2000, seed=6)
    hf, jhf = HashFrag(8), JaxHashFrag(8)
    np.testing.assert_array_equal(shard_load_histogram(hf, keys),
                                  jax_slh(jhf, keys))
    np.testing.assert_array_equal(shard_load_histogram(hf, keys, counts),
                                  jax_slh(jhf, keys, counts))
    for rows in (0, 10, 5000, 10**6):
        assert expected_unique_rows(counts, rows) == jax_eur(counts, rows)
    part = HotColdPartition(keys[:30])
    for p, jp in ((part, JaxPart(keys[:30])), (None, None)):
        got, want = split_route(hf, p, keys), jax_split_route(jhf, jp, keys)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
