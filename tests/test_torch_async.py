"""The async modes in the port against the JAX package's, on the CPU,
from JAX's initial table with JAX's draws replayed:

* the snapshot mode (``[word2vec] local_steps: L``): grads against a
  snapshot of the table, pushes onto the live table, the snapshot
  refreshed every L steps of a ``train`` call (JAX ``train``'s
  ``grads_fn(frozen)`` / ``apply_fn(state)`` loop);
* hogwild (``async_mode: hogwild``): ``n_workers * local_steps`` batches a
  group, each worker training its own replica with its own draws, then
  every push applied to the shared table worker-major (JAX
  ``_build_hogwild_step``, its workers the 8 devices of the CPU mesh; the
  port's the 8 entries of its ``Cluster``'s device list, all the CPU).

JAX's hogwild draws come from ``fold_in(group key, worker)`` split per
step; the tests replay them per (worker, step), worker-major.  Tables
within ``|a - b| <= 1e-5 + 1e-3 |b|``, ``err_cnt`` exact, losses rtol
1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.text import CBOWBatcher
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, _batch_fields
from swiftmpi_tpu_torch.utils import ConfigParser

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": -1,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
CAP = 600
B = 16
WORKERS = 8


def _envelope(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                               err_msg=err_msg)


def corpus(n_sent, vocab=300, length=8, seed=3):
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


def _confs(conf):
    jc, pc = JaxConfig().update(CONF), ConfigParser().update(CONF)
    for sec, kv in conf.items():
        for k, v in kv.items():
            jc.set(sec, k, v)
            pc.set(sec, k, v)
    return jc, pc


def _models(sents, workers=None, cap=CAP, **conf):
    """The JAX model and the port's from one conf; ``workers``: the
    port's cluster gets the CPU that many times (its hogwild workers)."""
    jc, pc = _confs(conf)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=cap).build(sents)
    cluster = None if workers is None else Cluster(
        pc, devices=["cpu"] * workers).initialize()
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=cap,
                  cluster=cluster)
    pm.build(sents)
    pm.table.state = state_from_jax(
        {f: np.asarray(a) for f, a in jm.table.state.items()}, "cpu",
        mesh=pm.cluster.mesh if pm.transfer.name == "tpu" else None)
    return jm, pm


def _train_draws(V, shape, n):
    """The per-step draws of JAX ``train``'s key stream (seed 0)."""
    key, out = jax.random.key(0 ^ 0x5EED), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_jax_draws(sub, V, shape))
    return out


# -- the snapshot mode --------------------------------------------------------

@pytest.mark.parametrize("stencil", [0, 1])
def test_local_steps_train_tracks_jax(stencil):
    """``local_steps: 3`` over 6 steps (3 epochs of 2 batches, so one
    window spans an epoch boundary) against JAX's loop of ``grads_fn`` on
    the snapshot and ``apply_fn`` on the live table; the stencil rendering
    composes with it."""
    sents = corpus(n_sent=16, length=8)          # 128 centers: 2 batches
    w2v = {"local_steps": 3, "stencil": stencil}
    jm, pm = _models(sents, word2vec=w2v)
    Bs = 64
    want = jm.train(sents, niters=3, batch_size=Bs)
    n_steps = 3 * sum(1 for _ in (CBOWBatcher(
        sents, pm.vocab, pm.window, pm.sample, seed=1).epoch_stencil(Bs)
        if stencil else CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                                    seed=1).epoch(Bs)))
    assert n_steps == 6 or stencil
    got = pm.train(sents, niters=3, batch_size=Bs,
                   draws=iter(_train_draws(len(pm.vocab), (Bs, pm.negative),
                                           n_steps)))
    m = pm.train_metrics
    assert m["steps"] == n_steps and m["local_steps"] == 3
    assert not m["fused"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


@pytest.mark.parametrize("transfer", ["xla", "tpu"])
def test_snapshot_is_a_copy(transfer):
    """With ``local_steps: 3`` the grads of steps 0, 1 and 2 read step
    0's table while the live table moves under them; step 3 reads the
    refreshed copy, equal to the live table.  The snapshot shares no
    memory with the table (a snapshot that aliased it would make the mode
    silently sync), and on ``transfer: tpu`` its shards stay one block."""
    sents = corpus(n_sent=48, length=8)
    cluster = {"transfer": transfer, "server_num": 4 if transfer == "tpu"
               else 1}
    _, pc = _confs({"cluster": cluster, "word2vec": {"local_steps": 3}})
    pm = Word2Vec(config=pc, device="cpu", capacity_per_shard=CAP)
    pm.build(sents)

    def flat(v):
        return torch.cat(v) if isinstance(v, list) else v

    def storages(v):
        return {t.untyped_storage().data_ptr()
                for t in (v if isinstance(v, list) else [v])}

    seen = []
    grads_for = pm._grads_for

    def spy(state, fields, draws=None):
        live = pm.table.state
        if transfer == "tpu":
            assert all(len(storages(state[f])) == 1 for f in ("h", "v"))
        seen.append((flat(state["h"]).clone(), flat(live["h"]).clone(),
                     not any(storages(state[f]) & storages(live[g])
                             for f in ("h", "v") for g in live)))
        return grads_for(state, fields, draws)

    pm._grads_for = spy
    h0 = flat(pm.table.state["h"]).clone()
    pm.train(sents, niters=1, batch_size=64)
    assert len(seen) == 6
    for i in range(3):
        assert torch.equal(seen[i][0], h0), i        # step 0's table
        assert seen[i][2]                            # not the live tensors
    assert not torch.equal(seen[2][1], h0)           # the live one moved
    assert torch.equal(seen[3][0], seen[3][1])       # refreshed at step 3
    assert not torch.equal(seen[3][0], h0)
    assert torch.equal(seen[5][0], seen[3][0])


def test_sync_steps_read_the_live_table():
    """The control: without ``local_steps`` every step's grads read the
    live table itself."""
    sents = corpus(n_sent=24, length=8)
    pm = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    pm.build(sents)
    seen = []
    grads_for = pm._grads_for
    pm._grads_for = lambda state, fields, draws=None: (
        seen.append(state is pm.table.state), grads_for(state, fields,
                                                        draws))[1]
    pm.train(sents, niters=1, batch_size=64)
    assert seen and all(seen)


# -- hogwild ------------------------------------------------------------------

def _hogwild_draws(key, n_workers, steps, V, shape):
    """JAX's per-worker streams of one group: ``fold_in(key, w)`` split
    into ``steps`` keys, replayed worker-major."""
    out = []
    for w in range(n_workers):
        for k in jax.random.split(jax.random.fold_in(key, w), steps):
            out.append(_jax_draws(k, V, shape))
    return out


def test_hogwild_group_matches_jax_and_the_worker_major_replay(devices8):
    """8 workers x ``local_steps`` 2 against JAX ``_build_hogwild_step``
    on the 8-device mesh, and against the literal worker-major replay of
    the port's own grads and applies (mirrors
    test_word2vec.py::test_w2v_hogwild_reconciliation_is_exact_worker_
    major_apply)."""
    steps = 2
    sents = corpus(n_sent=120, vocab=60, length=12, seed=21)
    w2v = {"async_mode": "hogwild", "local_steps": steps}
    jm, pm = _models(sents, workers=WORKERS, word2vec=w2v)
    step, n_workers = jm._build_hogwild_step(steps)
    assert n_workers == len(pm.cluster.devices) == WORKERS
    batches = []
    for b in CBOWBatcher(sents, pm.vocab, pm.window, pm.sample,
                         seed=9).epoch(B):
        batches.append(b)
        if len(batches) == WORKERS * steps:
            break
    assert len(batches) == WORKERS * steps
    key = jax.random.key(42)
    base = {f: np.asarray(a).copy() for f, a in jm.table.state.items()}
    stack = [jnp.asarray(np.stack([np.asarray(f) for f in fs]))
             for fs in zip(*map(_batch_fields, batches))]
    out, es, ec = step({f: jnp.asarray(v) for f, v in base.items()},
                       jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
                       *stack, key)
    draws = _hogwild_draws(key, WORKERS, steps, len(pm.vocab),
                           pm.draw_shape(B))
    fields = [_batch_fields(b) for b in batches]
    got_es, got_ec = pm._hogwild_group(fields, iter(draws))
    assert int(got_ec) == int(ec)
    np.testing.assert_allclose(float(got_es), float(es), rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f in base:
        _envelope(got[f], np.asarray(out[f]), f)
        assert not np.array_equal(got[f], base[f])
    # the literal replay: each worker from the base, then every push of
    # worker 0 in step order, then worker 1's, ...
    chain = []
    for w in range(WORKERS):
        local = state_from_jax(base, "cpu")
        for s in range(steps):
            i = w * steps + s
            pushes, _, _ = pm._grads_for(local, fields[i], draws[i])
            pm._apply(local, pushes)
            chain.append(pushes)
    ref = state_from_jax(base, "cpu")
    for pushes in chain:
        pm._apply(ref, pushes)
    ref = state_to_numpy(ref)
    for f in base:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_hogwild_train_tracks_jax_and_counts_the_tail(devices8):
    """``train`` in hogwild mode (8 workers x 1 local step) with JAX's
    group keys replayed: the same loss, table and skipped tail words (the
    last partial group's batches) as JAX's train.  One epoch of 4 groups
    (32 worker steps): the jitted JAX group and the port's eager steps sum
    in another order, and AdaGrad carries that last-bit difference on
    (the largest gap is 0.03 of the envelope after this epoch and reaches
    it at one element of 9,600 after a second)."""
    sents = corpus(n_sent=60, vocab=60, length=10, seed=8)
    jm, pm = _models(sents, workers=WORKERS,
                     word2vec={"async_mode": "hogwild"})
    niters = 1
    want = jm.train(sents, niters=niters, batch_size=B)
    n_batches = sum(1 for _ in CBOWBatcher(sents, pm.vocab, pm.window,
                                           pm.sample).epoch(B))
    groups = n_batches // WORKERS
    assert groups == 4 and n_batches % WORKERS
    key, draws = jax.random.key(0 ^ 0x5EED), []
    for _ in range(niters * groups):
        key, sub = jax.random.split(key)
        draws += _hogwild_draws(sub, WORKERS, 1, len(pm.vocab),
                                pm.draw_shape(B))
    got = pm.train(sents, niters=niters, batch_size=B, draws=iter(draws))
    m = pm.train_metrics
    assert m["steps"] == niters * groups * WORKERS
    assert m["hogwild_skipped_tail_words"] \
        == jm.train_metrics["hogwild_skipped_tail_words"] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = state_to_numpy(pm.table.state)
    for f, a in jm.table.state.items():
        _envelope(final[f], np.asarray(a), f)


def test_hogwild_guards():
    """As JAX's (mirrors test_word2vec.py::test_w2v_hogwild_guards): the
    sharded transfer and the stencil rendering are ValueErrors; an epoch
    that fills no group raises instead of reporting a zero loss; a
    pipeline request runs the synchronous loop."""
    sents = corpus(n_sent=150, vocab=50, length=12, seed=4)
    for conf, match in (
            ({"cluster": {"transfer": "tpu", "server_num": 2},
              "word2vec": {"async_mode": "hogwild"}}, "transfer: xla"),
            ({"word2vec": {"async_mode": "hogwild", "stencil": 1}},
             "snapshot")):
        with pytest.raises(ValueError, match=match):
            Word2Vec(config=_confs(conf)[1], device="cpu")
    _, pc = _confs({"word2vec": {"async_mode": "hogwild",
                                 "local_steps": 64},
                    "worker": {"pipeline": 2}})
    m = Word2Vec(config=pc, device="cpu")
    with pytest.raises(RuntimeError, match="dispatched NO group"):
        m.train(sents, niters=1, batch_size=64)
    _, pc = _confs({"word2vec": {"async_mode": "hogwild",
                                 "local_steps": 2},
                    "worker": {"pipeline": 2, "inner_steps": 4}})
    m = Word2Vec(config=pc, device="cpu")
    losses = m.train(sents, niters=1, batch_size=64)
    assert np.isfinite(losses).all()
    assert m.train_metrics["pipeline_depth"] == 0
    assert "pipeline" not in m.train_metrics and not m.train_metrics["fused"]


def test_hogwild_group_size_is_checked():
    sents = corpus(n_sent=20)
    _, pc = _confs({"word2vec": {"async_mode": "hogwild",
                                 "local_steps": 2}})
    m = Word2Vec(config=pc, device="cpu")
    m.build(sents)
    batch = next(iter(CBOWBatcher(sents, m.vocab, m.window).epoch(B)))
    with pytest.raises(ValueError, match="1 workers x 2"):
        m._hogwild_group([_batch_fields(batch)] * 3)
