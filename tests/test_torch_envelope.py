"""The snapshot mode (``[word2vec] local_steps``) at the reference
configuration's width against the JAX package's, on the CPU.

``chip_smoke.py`` phase 20 (c) sweeps ``local_steps`` over 8 processes at
the reference configuration: demo.conf's word2vec and server settings
(len_vec 100, window 4, negative 20, sample 1e-5, server lr 0.7, 5,000
centers a step) with the vocab of the whole text8-shaped corpus (69,627
words, 90,516 rows a field).  Here the port's snapshot mode is held to
JAX's ``train`` loop at that width in one process, from JAX's initial
table with JAX's draws replayed: two and a half windows of
``local_steps`` 4 (grads against the snapshot, pushes onto the live
table, the snapshot refreshed every 4 steps), and sync beside it.  The
losses within 1e-4 relative; every field's elements within ``|a - b| <=
1e-5 + 1e-3 |b|`` but for at most ``DRIFT_SHARE`` of them, each of those
within ``DRIFT_ABS``: at this width the two packages add a row's many
contributions in different orders, and sync's own run leaves 54 of h's
9,051,600 elements and 43 of v's outside the envelope (the snapshot run
1 of h's), all within 1.02e-3.  So a gap the sweep shows there against
sync is JAX's algorithm's, not the port's.

``tests/_envelope_witness.py`` sweeps both packages over the whole
configuration; its last test runs it at a tiny size.
"""

import numpy as np
import pytest

import jax

from swiftmpi_tpu.data.text import Vocab as JaxVocab
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps.w2v_profile import BATCH, DEMO_CONF, \
    TEXT8_CORPUS
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher, build_vocab, \
    synthetic_corpus_bulk
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import ConfigParser

import _envelope_witness

#: sentences of the corpus's head: 10 steps of 5,000 centers in one epoch
SENTS = 300
#: the share of a field's elements allowed outside the envelope (90 of
#: 9,051,600), and how far each of those may be off
DRIFT_SHARE, DRIFT_ABS = 1e-5, 2e-3


@pytest.fixture(scope="module")
def reference_data():
    """The text8-shaped corpus's head and the whole corpus's vocab."""
    full = synthetic_corpus_bulk(**TEXT8_CORPUS)
    return np.ascontiguousarray(full[:SENTS]), build_vocab(full)


def _train_draws(V, shape, n):
    """The per-step ``(j, u)`` of JAX ``train``'s key stream (seed 0), as
    ``ops/sampling._alias_draw_packed`` derives them."""
    key, out = jax.random.key(0 ^ 0x5EED), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append((np.array(jax.random.randint(k1, shape, 0, V)),
                    np.array(jax.random.uniform(k2, shape))))
    return out


@pytest.mark.parametrize("local_steps", [1, 4])
def test_snapshot_mode_tracks_jax_at_the_reference_width(reference_data,
                                                         local_steps):
    """Sync and ``local_steps`` 4 at demo.conf's width, the whole vocab,
    against JAX's ``train`` with its draws: losses, and every field within
    the envelope but for the summation orders' drift."""
    corpus, vocab = reference_data
    conf = {**DEMO_CONF, "word2vec": {**DEMO_CONF["word2vec"],
                                      "local_steps": local_steps}}
    keys = np.asarray(vocab.keys)
    jm = JaxWord2Vec(config=JaxConfig().update(conf))
    jm.build_from_vocab(JaxVocab(keys, np.asarray(vocab.counts),
                                 {int(k): i for i, k in enumerate(keys)}))
    pm = Word2Vec(config=ConfigParser().update(conf), device="cpu")
    pm.build_from_vocab(vocab)
    assert len(pm.vocab) == 69_627
    assert pm.table.state["v"].shape == (90_516, 100)
    init = {f: np.array(a) for f, a in jm.table.state.items()}
    pm.table.state = state_from_jax(init, "cpu")
    n_steps = sum(1 for _ in CBOWBatcher(
        corpus, pm.vocab, pm.window, pm.sample, seed=1).epoch(BATCH))
    assert n_steps == 10
    want = jm.train(corpus.tolist(), niters=1, batch_size=BATCH)
    got = pm.train(corpus, niters=1, batch_size=BATCH, draws=iter(
        _train_draws(len(vocab), (BATCH, pm.negative), n_steps)))
    m = pm.train_metrics
    assert m["steps"] == n_steps and m["local_steps"] == local_steps
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        b = np.asarray(a)
        gap = np.abs(final[f] - b)
        outside = gap > 1e-5 + 1e-3 * np.abs(b)
        assert outside.mean() <= DRIFT_SHARE, (f, int(outside.sum()))
        assert gap.max() <= DRIFT_ABS, (f, float(gap.max()))
        assert not np.array_equal(final[f], init[f]), f


def test_the_envelope_witness_sweeps_both_packages(capsys):
    """``tests/_envelope_witness.py`` at a tiny size: a line a package and
    setting, sync's gap 0, every loss finite, the whole vocab."""
    lines = _envelope_witness.main(["-sents", "20", "-epochs", "2",
                                    "-sweep", "1,2"])
    assert [(ln["package"], ln["local_steps"]) for ln in lines] == [
        ("jax", 1), ("jax", 2), ("torch", 1), ("torch", 2)]
    for ln in lines:
        assert ln["vocab"] == 69_627 and len(ln["losses"]) == 2
        assert np.isfinite(ln["losses"]).all()
    assert lines[0]["vs_sync_pct"] == lines[2]["vs_sync_pct"] == 0.0
    assert capsys.readouterr().out.count('"package"') == 4
