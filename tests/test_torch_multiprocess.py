"""More than one rank process: the port's bootstrap, launcher, collectives,
lockstep batcher and data-parallel word2vec, on the CPU over gloo.

Children are started by the port's launcher (``python -m
swiftmpi_tpu_torch.launch``) and import only the port
(``swiftmpi_tpu_torch.testing.mp_child``, ``apps.w2v_main``); every
launch has its own ``timeout=`` and the children's collectives a bounded
``SMTPU_DIST_TIMEOUT``.  The JAX references run in this process on the
CPU mesh with a data axis (``devices8``: ``transfer: xla`` is an (8, 1)
data x model mesh): one JAX step over the concatenation of the two
processes' batches, the port's processes fed their slices of JAX's
draws.  Tables are held to the envelope ``|a - b| <= 1e-5 + 1e-3 |b|``
(the reconcile sums in process order, JAX in its own order), losses to
1e-4 relative, and the replicas of the processes to the bit.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftmpi_tpu.data.distributed import \
    shard_sentences as jax_shard_sentences
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch import launch
from swiftmpi_tpu_torch.cluster import Cluster, bootstrap
from swiftmpi_tpu_torch.cluster import cluster as cluster_mod
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data.distributed import (DistributedBatcher,
                                                 shard_sentences)
from swiftmpi_tpu_torch.data.text import (CBOWBatch, CBOWBatcher,
                                          build_vocab, write_tokens_file)
from swiftmpi_tpu_torch.models.glove import GloVe
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.models.sent2vec import Sent2Vec
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.parallel import (all_gather, all_to_all, axis_index,
                                         axis_size, psum)
from swiftmpi_tpu_torch.parameter import KeyIndex
from swiftmpi_tpu_torch.utils import ConfigParser

REPO = Path(__file__).resolve().parents[1]
B, K, W, D = 32, 5, 2, 8
STEPS = 3
#: capacity per shard: the h push (B * (1 + K) rows a process) goes dense,
#: the v push (B * 2W) sparse, on xla by the global batch and on tpu by
#: the data axis's crossover at 2 shards
CAP = 600

CONF = {"word2vec": {"len_vec": D, "window": W, "negative": K,
                     "sample": -1, "learning_rate": 0.05,
                     "min_sentence_length": 2},
        "server": {"initial_learning_rate": 0.3}}


def run_launch(*args, timeout=60, env_extra=None):
    env = dict(os.environ, SMTPU_DIST_TIMEOUT="60", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _child(*args):
    return [sys.executable, "-m", "swiftmpi_tpu_torch.testing.mp_child",
            *args]


# -- bootstrap and launcher (JAX tests/test_multiprocess.py) ------------------

def test_single_process_bootstrap_is_noop(monkeypatch):
    for k in (bootstrap.ENV_COORDINATOR, bootstrap.ENV_NUM_PROCESSES,
              bootstrap.ENV_PROCESS_ID):
        monkeypatch.delenv(k, raising=False)
    assert bootstrap.distributed_env() is None
    assert bootstrap.init_distributed() is False
    assert bootstrap.init_distributed(ConfigParser()) is False
    assert (bootstrap.process_index(), bootstrap.process_count()) == (0, 1)
    assert bootstrap.is_writer() and bootstrap.store() is None
    np.testing.assert_array_equal(
        bootstrap.host_array(torch.arange(4.0)), np.arange(4.0))
    bootstrap.barrier()
    bootstrap.shutdown_distributed()
    x = torch.arange(6.0).view(3, 2)
    assert axis_index() == 0 and axis_size() == 1
    assert torch.equal(psum(x), x) and torch.equal(all_gather(x), x)
    assert torch.equal(all_gather(x, tiled=False), x[None])
    assert torch.equal(all_to_all(x[:1]), x[:1])
    with pytest.raises(ValueError, match="data"):
        psum(x, "shard")


def test_launcher_rank_prefixes_output():
    prog = "import os; print('hello from', os.environ['SMTPU_PROCESS_ID'])"
    res = run_launch("-np", "2", "--", sys.executable, "-c", prog)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[rank 0] hello from 0" in res.stdout
    assert "[rank 1] hello from 1" in res.stdout


def test_launcher_propagates_child_failure():
    prog = ("import os, sys; "
            "sys.exit(3 if os.environ['SMTPU_PROCESS_ID'] == '1' else 0)")
    res = run_launch("-np", "2", "--", sys.executable, "-c", prog)
    assert res.returncode == 3, res.stdout + res.stderr


def test_signal_death_maps_to_128_plus_signum():
    prog = "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"
    res = run_launch("-np", "1", "--", sys.executable, "-c", prog)
    assert res.returncode == 128 + signal.SIGKILL, res.stdout + res.stderr


def test_launcher_kills_stragglers_and_leaks_nothing(tmp_path):
    prog = ("import os, sys, time\n"
            "r = os.environ['SMTPU_PROCESS_ID']\n"
            "d = os.environ['SMTPU_TEST_DIR']\n"
            "open(os.path.join(d, 'pid_' + r), 'w')"
            ".write(str(os.getpid()))\n"
            "if r == '0':\n"
            "    time.sleep(0.5)\n"
            "    sys.exit(7)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    res = run_launch("-np", "2", "--", sys.executable, "-c", prog,
                     env_extra={"SMTPU_TEST_DIR": str(tmp_path)})
    assert res.returncode == 7, res.stdout + res.stderr
    assert time.monotonic() - t0 < 30
    pid = int((tmp_path / "pid_1").read_text())
    with pytest.raises(OSError):             # the straggler is gone
        os.kill(pid, 0)


def test_launcher_refuses_what_is_not_ported(capsys):
    """``-cpu``, a missing ``--`` and a missing program are refused (rc
    2); ``-elastic`` and ``-serve`` without ``-fleet-dir`` return 2, as
    the JAX launcher's do."""
    assert launch.main(["-np", "2"]) == 2                  # no "--"
    assert launch.main(["-np", "2", "--"]) == 2            # no program
    assert launch.main(["-cpu", "4", "--", "true"]) == 2
    assert "no torch meaning" in capsys.readouterr().err
    assert launch.main(["-np", "2", "-elastic", "1", "--", "true"]) == 2
    assert "-elastic requires -fleet-dir" in capsys.readouterr().err
    assert launch.main(["-serve", "2", "--", "true"]) == 2
    assert "-serve requires -fleet-dir" in capsys.readouterr().err
    assert launch._normalize_rc(-9) == 137 and launch._normalize_rc(3) == 3


@pytest.fixture(scope="module")
def four_processes(tmp_path_factory):
    """One launch of ``mp_child collectives`` in 4 processes over gloo:
    the output directory."""
    out = tmp_path_factory.mktemp("collectives")
    res = run_launch("-np", "4", "--", *_child(
        "collectives", "-out", str(out), "-device", "cpu"), timeout=90)
    assert res.returncode == 0, res.stdout + res.stderr
    return out


def test_four_process_collectives(four_processes):
    """all_gather, psum (bit for bit against numpy's sum in process
    order), barrier, all_to_all and the cross-process exchange's plain
    forms against numpy, in 4 processes over gloo."""
    got = [json.loads((four_processes / f"collectives_r{r}.json")
                      .read_text()) for r in range(4)]
    assert [g["rank"] for g in got] == [0, 1, 2, 3]
    assert len({g["psum_sha"] for g in got}) == 1


def test_four_process_overflow_count_is_jax_global_count(four_processes,
                                                         devices8):
    """``tpu`` at 2 shard ranks in each of 4 processes, bucket capacity
    2: every process's ``overflow_count()`` (after the pull, and
    ``traffic()``'s after the push) is JAX's, psum'd over the data and
    shard axes of its (4, 2) mesh; the pulled rows are JAX's slice
    exactly and the pushed tables within the envelope of JAX's."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from swiftmpi_tpu.cluster import SHARD_AXIS
    from swiftmpi_tpu.cluster.mesh import DATA_AXIS
    from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
    from swiftmpi_tpu.transfer.tpu import TpuTransfer
    from swiftmpi_tpu_torch.testing import mp_child
    dp = 4
    slots, grads, init = mp_child.overflow_inputs(dp)
    mesh = Mesh(np.asarray(devices8).reshape(dp, mp_child.OVF_SHARDS),
                (DATA_AXIS, SHARD_AXIS))
    jt = TpuTransfer(mesh, bucket_capacity=mp_child.OVF_C)
    assert jt.dp_axis == DATA_AXIS
    jacc = jax_w2v_access(learning_rate=mp_child.OVF_LR,
                          len_vec=mp_child.OVF_D)
    state = {f: jax.device_put(a, NamedSharding(mesh,
                                                PartitionSpec(SHARD_AXIS)))
             for f, a in init.items()}
    pulled = jt.pull(state, slots, jacc)
    after_pull = jt.overflow_count()
    assert after_pull > 0
    state = jt.push(state, slots, grads, jacc, mean=True)
    after_push = jt.overflow_count()
    assert after_push > after_pull
    for r in range(dp):
        got = dict(np.load(four_processes / f"overflow_r{r}.npz"))
        assert got["overflow"].tolist() == [after_pull, after_push]
        mine = slice(r * mp_child.OVF_B, (r + 1) * mp_child.OVF_B)
        for f, v in pulled.items():
            np.testing.assert_array_equal(got[f"pulled__{f}"],
                                          np.asarray(v)[mine])
        for f, v in state.items():
            _envelope(got[f"table__{f}"], np.asarray(v))
            if f in ("h", "v"):
                assert not np.array_equal(got[f"table__{f}"], init[f])


# -- the data axis's batcher ---------------------------------------------------

@pytest.mark.parametrize("nprocs", [1, 2, 3])
def test_shard_sentences_matches_jax(nprocs):
    sents = [[i, i + 1, i + 2] for i in range(11)]
    for r in range(nprocs):
        assert shard_sentences(sents, r, nprocs) \
            == jax_shard_sentences(sents, rank=r, nprocs=nprocs)
    arr = np.arange(40).reshape(10, 4)
    np.testing.assert_array_equal(shard_sentences(arr, 1, 3), arr[1::3])


class _Batches:
    def __init__(self, sizes):
        self.sizes = sizes
        self.vocab = "v"

    def epoch(self, batch_size):
        for i, n in enumerate(self.sizes):
            yield CBOWBatch(np.full(n, i), np.zeros((n, 2)),
                            np.ones((n, 2), bool), n - 1)


def test_distributed_batcher_lockstep(monkeypatch):
    """Ragged batches are dropped; the epoch ends at the first dry shard;
    ``n_words`` is the sum over the processes (the peer's flags scripted
    through gloo's all_gather)."""
    import torch.distributed as dist
    peer = iter([[1, 10], [1, 20], [0, 0]])
    monkeypatch.setattr(bootstrap, "process_count", lambda: 2)

    def fake_all_gather(parts, flag):
        parts[0].copy_(flag)
        parts[1].copy_(torch.tensor(next(peer), dtype=torch.int64))
    monkeypatch.setattr(dist, "all_gather", fake_all_gather)
    db = DistributedBatcher(_Batches([4, 3, 4, 4, 4]))
    got = list(db.epoch(4))
    # batch 1 (3 rows) is ragged; the peer runs dry at the third flag
    assert [int(b.centers[0]) for b in got] == [0, 2]
    assert [b.n_words for b in got] == [3 + 10, 3 + 20]
    assert db.vocab == "v" and db.lockstep_steps == 3


# -- word2vec across processes ------------------------------------------------

def _corpus():
    """8 sentences of 8 keys: each of two processes' shards is one batch
    of B = 32 centers an epoch (no subsampling)."""
    rng = np.random.default_rng(3)
    return rng.integers(1, 60, size=(8, 8)).astype(np.int32)


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _rank_batches(corpus, vocab, nprocs=2):
    """What each process's batcher yields, epoch by epoch: its shard,
    seed 2008 + rank."""
    out = []
    for r in range(nprocs):
        b = CBOWBatcher(shard_sentences(corpus, r, nprocs), vocab, W, -1,
                        seed=2008 + r)
        out.append([next(iter(b.epoch(B))) for _ in range(STEPS)])
    for r in range(nprocs):
        assert all(len(x) == B for x in out[r])
    return out


def _jax_reference(corpus, async_mode=False):
    """JAX's model (xla on the 8-device CPU mesh, data x model = 8 x 1)
    stepped over the concatenated batches: returns the model, its initial
    table, the final table, the per-step losses and every step's draws."""
    jc = JaxConfig().update(CONF)
    jc.set("cluster", "transfer", "xla")
    jc.set("cluster", "server_num", 1)
    jm = JaxWord2Vec(config=jc, capacity_per_shard=CAP).build(
        corpus.tolist())
    init = {f: np.array(a) for f, a in jm.table.state.items()}
    vocab = build_vocab(corpus)
    batches = _rank_batches(corpus, vocab)
    V = len(vocab)
    state = jm.table.state
    frozen = {f: jnp.array(a) for f, a in init.items()}
    if async_mode:
        grads_fn, apply_fn = jax.jit(jm._build_grads()), \
            jax.jit(jm._build_apply())
    else:
        step = jm._build_step()
    losses, draws = [], []
    key = jax.random.key(11)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        cat = [np.concatenate([batches[r][i].__dict__[k] for r in (0, 1)])
               for k in ("centers", "contexts", "ctx_mask")]
        args = (jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
                *map(jnp.asarray, cat), sub)
        if async_mode:
            pushes, es, ec = grads_fn(frozen, *args)
            state = apply_fn(state, pushes)
            if (i + 1) % 2 == 0:
                frozen = {f: jnp.array(a) for f, a in state.items()}
        else:
            state, es, ec = step(state, *args)
        losses.append(float(es) / max(int(round(float(ec))), 1))
        draws.append(_jax_draws(sub, V, (2 * B, K)))
    final = {f: np.array(a) for f, a in state.items()}
    return vocab, init, final, losses, draws


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def _spec(tmp_path, corpus, vocab, init, draws, conf, name):
    data = {"corpus": corpus, "vocab_keys": vocab.keys,
            "vocab_counts": vocab.counts}
    data.update({f"init__{f}": a for f, a in init.items()})
    for r in (0, 1):
        data[f"j{r}"] = np.stack([d[0][r * B:(r + 1) * B] for d in draws])
        data[f"u{r}"] = np.stack([d[1][r * B:(r + 1) * B] for d in draws])
    np.savez(tmp_path / f"{name}.npz", **data)
    return {"conf": conf, "data": str(tmp_path / f"{name}.npz"),
            "device": "cpu", "batch_size": B, "niters": STEPS,
            "capacity_per_shard": CAP, "out": str(tmp_path / name),
            "state": True}


def _by_key(state, ki: KeyIndex, keys):
    slots = ki.lookup(keys)
    return {f: a[slots] for f, a in state.items()}


@pytest.fixture(scope="module")
def w2v_runs(tmp_path_factory):
    """One launch of 2 processes for three jobs, one after the other in
    one process group: sync word2vec on ``xla`` and on ``tpu`` (2 shards
    a process) from JAX's initial table with JAX's draws, and
    ``async_mode: hogwild`` on ``xla``; with the JAX references each is
    held against.  Returns ``{job: (reference, children's JSON, rank 0's
    table)}`` and the launch's output."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("w2v_runs")
    corpus = _corpus()
    sync = _jax_reference(corpus)
    hog = _jax_reference(corpus, async_mode=True)
    vocab, init = sync[0], sync[1]
    keys = vocab.keys
    # the tpu job's 2-shard layout, every vocab key's row at its slot
    rows = _by_key(init, KeyIndex(1, CAP), keys)
    init2 = {f: np.zeros((2 * CAP, a.shape[1]), a.dtype)
             for f, a in init.items()}
    for f in init2:
        init2[f][KeyIndex(2, CAP).lookup(keys)] = rows[f]
    hog_w2v = {**CONF["word2vec"], "async_mode": "hogwild"}
    jobs = {
        "xla": (sync, init, {**CONF, "cluster": {"transfer": "xla",
                                                  "server_num": 1}}),
        "tpu": (sync, init2, {**CONF, "cluster": {"transfer": "tpu",
                                                   "server_num": 2}}),
        "hog": (hog, init, {**CONF, "word2vec": hog_w2v,
                            "cluster": {"transfer": "xla",
                                        "server_num": 1}})}
    specs = [_spec(tmp, corpus, vocab, job_init, ref[4], conf, name)
             for name, (ref, job_init, conf) in jobs.items()]
    (tmp / "specs.json").write_text(json.dumps(specs))
    res = run_launch("-np", "2", "--", *_child(
        "w2v", "-spec", str(tmp / "specs.json")), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    out = {}
    for name, (ref, job_init, _) in jobs.items():
        got = [json.loads((tmp / name / f"w2v_r{r}.json").read_text())
               for r in (0, 1)]
        out[name] = (ref, job_init, got,
                     dict(np.load(tmp / name / "w2v_state_r0.npz")))
    return out, res


@pytest.mark.parametrize("job", ["xla", "tpu", "hog"])
def test_two_process_replicas_are_one_table(w2v_runs, job):
    got = w2v_runs[0][job][2]
    assert got[0]["sha"] == got[1]["sha"]
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["rank"] == 0 and got[1]["rank"] == 1


@pytest.mark.parametrize("transfer", ["xla", "tpu"])
def test_two_process_word2vec_matches_jax_global_step(w2v_runs, transfer):
    (vocab, init0, want, losses, _), init, got, final = \
        w2v_runs[0][transfer]
    keys = vocab.keys
    port_ki = KeyIndex(2 if transfer == "tpu" else 1, CAP)
    jax_ki = KeyIndex(1, CAP)
    m = got[0]["metrics"]
    assert m["steps"] == STEPS and m["processes"] == 2
    assert m["words"] == STEPS * 2 * B
    if transfer == "xla":
        assert m["push_paths"] == {"h:dense": STEPS, "v:sparse": STEPS}
    else:
        assert m["push_paths"] == {"h:routed": STEPS, "v:routed": STEPS}
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
    a, b = _by_key(final, port_ki, keys), _by_key(want, jax_ki, keys)
    for f in want:
        _envelope(a[f], b[f])
        assert not np.array_equal(a[f], _by_key(init, port_ki, keys)[f])


def test_a_ring_timeout_fails_the_run(monkeypatch):
    """A ring wait that gave up during an epoch (``kernels.ring.timeouts()``
    grew: its step read stale data) stops ``Word2Vec.train`` at the
    epoch's end; across processes the count is summed first, so every
    process stops together (the card test forces a real timeout)."""
    from swiftmpi_tpu_torch.kernels import ring
    reads = iter([3, 3, 4])          # before the run, 2 epochs' ends
    monkeypatch.setattr(ring, "timeouts", lambda: next(reads))
    m = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    with pytest.raises(RuntimeError, match=r"iteration 1: 1 ring exchange "
                                           r"wait\(s\) timed out"):
        m.train(_corpus(), niters=3, batch_size=B)


def test_two_process_hogwild_runs_the_snapshot_mode(w2v_runs):
    """``async_mode: hogwild`` across processes is the snapshot mode with
    ``local_steps >= 2`` and JAX's warning; held against JAX's snapshot
    loop (grads against the frozen table, refreshed every 2 steps)."""
    (_, _, want, losses, _), _, got, final = w2v_runs[0]["hog"]
    assert "falls back to snapshot bounded staleness (local_steps=2" \
        in w2v_runs[1].stdout
    assert got[0]["metrics"]["local_steps"] == 2
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
    for f in want:
        _envelope(final[f], want[f])


def test_cli_under_the_launcher_writes_one_dump(tmp_path):
    """``launch -np 2 -- w2v_main -device cpu`` on xla with a checkpoint:
    process 0 writes the dump and the npz; the npz loads in one process
    and its dump is the CLI's, byte for byte."""
    corpus = np.random.default_rng(5).integers(1, 40, size=(40, 10))
    data = tmp_path / "corpus.txt"
    write_tokens_file(corpus, str(data))
    conf = tmp_path / "w.conf"
    conf.write_text("[cluster]\nserver_num: 1\ntransfer: xla\n"
                    "[word2vec]\nlen_vec: 8\nwindow: 2\nnegative: 3\n"
                    "sample: -1\n[worker]\nminibatch: 256\n")
    out, ck = tmp_path / "vectors.txt", tmp_path / "ck"
    res = run_launch("-np", "2", "--", sys.executable, "-m",
                     "swiftmpi_tpu_torch.apps.w2v_main", "-config",
                     str(conf), "-data", str(data), "-niters", "2",
                     "-output", str(out), "-checkpoint", str(ck),
                     "-device", "cpu", timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[rank 0]" in res.stdout and "[rank 1]" in res.stdout
    wrote = [ln for ln in res.stdout.splitlines() if "wrote" in ln]
    assert len(wrote) == 1 and wrote[0].startswith("[rank 0]")
    assert "process 0 writes them" in res.stdout
    ck_files = sorted(p.name for p in tmp_path.iterdir()
                      if p.name.startswith("ck"))
    assert "ck.npz" in ck_files and not any("tmp" in n for n in ck_files)
    from swiftmpi_tpu_torch.io.checkpoint import load_checkpoint
    from swiftmpi_tpu_torch.utils import reset_global_config
    reset_global_config()
    pc = ConfigParser(str(conf))
    m = Word2Vec(config=pc, device="cpu")
    m.build(corpus.tolist())
    assert load_checkpoint(m.table, str(ck))["iter"] == 2
    m.save(str(tmp_path / "one.txt"))
    assert (tmp_path / "one.txt").read_bytes() == out.read_bytes()


def test_cli_under_the_launcher_trains_tpu(tmp_path):
    corpus = np.random.default_rng(6).integers(1, 40, size=(40, 10))
    data = tmp_path / "corpus.txt"
    write_tokens_file(corpus, str(data))
    conf = tmp_path / "w.conf"
    conf.write_text("[cluster]\ntransfer: tpu\n[word2vec]\nlen_vec: 8\n"
                    "window: 2\nnegative: 3\nsample: -1\n")
    out = tmp_path / "vectors.txt"
    res = run_launch("-np", "2", "--", sys.executable, "-m",
                     "swiftmpi_tpu_torch.apps.w2v_main", "-config",
                     str(conf), "-data", str(data), "-shards", "2",
                     "-output", str(out), "-device", "cpu", timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "'axis_names': ['data', 'shard'], 'axis_sizes': [2, 2]" \
        in res.stdout
    lines = out.read_text().splitlines()
    assert len(lines) == len(build_vocab(corpus))


# -- refusals ------------------------------------------------------------------

def _cluster_of(dp, **cluster):
    c = Cluster(ConfigParser().update({"cluster": cluster}),
                devices=["cpu"]).initialize()
    c.dp = dp
    return c


@pytest.mark.parametrize("section,key,value", [
    ("cluster", "push_window", 2), ("cluster", "wire_quant", "int8"),
    ("cluster", "wire_sketch", 1), ("cluster", "collective", "auto"),
    ("cluster", "pull_quant", "bf16"), ("cluster", "pull_cache", 8),
    ("serve", "every", 4), ("control", "control", "on")])
def test_unported_hooks_refuse_across_processes(section, key, value):
    """Under ``dp = 2`` every hook the JAX package runs across processes
    is armed as in one process and the model steps (the 2-process launch
    of ``test_torch_data_axis.py`` holds each against JAX); ``[control]``
    alone still refuses, with JAX's reason and no ROADMAP A11e."""
    c = ConfigParser().update(CONF)
    c.set(section, key, value)
    if key in ("wire_quant", "wire_sketch", "collective"):
        c.set("cluster", "push_window", 2)
    if key == "control":
        with pytest.raises(NotImplementedError,
                           match="cannot run across processes") as err:
            Word2Vec(config=c, device="cpu", cluster=_cluster_of(2))
        assert "A11e" not in str(err.value)
        Word2Vec(config=c, device="cpu", cluster=_cluster_of(1))
        return
    corpus = _corpus()
    models = [Word2Vec(config=c, device="cpu", cluster=_cluster_of(dp))
              for dp in (2, 1)]
    batch = _rank_batches(corpus, build_vocab(corpus))[0][0]
    for m in models:
        m.build(corpus.tolist())
        m.step_batch(batch, draws=_jax_draws(jax.random.key(2),
                                            len(m.vocab), (B, K)))
    two, one = models
    for knob in ("window_expected_unique", "wire_quant", "wire_sketch",
                 "collective_mode", "pull_quant", "pull_cache"):
        assert getattr(two.transfer, knob) == getattr(one.transfer, knob)
    assert sorted(two.table.state) == sorted(one.table.state)
    for f, v in one.table.state.items():
        assert torch.equal(two.table.state[f], v)
    assert (two.serve_every, two.push_window_size) \
        == (one.serve_every, one.push_window_size)


def test_models_and_backends_refuse_across_processes(monkeypatch):
    """LR, GloVe and sent2vec build under ``dp = 2`` (the launch of
    ``test_torch_data_axis.py`` trains them against JAX); ``hybrid``
    brings its tail onto the data axis; ``local`` still refuses, with
    JAX's reason and no ROADMAP A11e."""
    assert LogisticRegression(device="cpu", cluster=_cluster_of(2)).table
    assert GloVe(device="cpu", cluster=_cluster_of(2)).cluster.dp == 2
    wm = Word2Vec(config=ConfigParser().update(CONF), device="cpu")
    wm.cluster.dp = 2
    assert Sent2Vec(wm).word_model is wm
    monkeypatch.setattr(cluster_mod, "process_count", lambda: 2)
    c = Cluster(ConfigParser().update({"cluster": {
        "transfer": "hybrid", "server_num": 2}}),
        devices=["cpu"]).initialize()
    assert (c.transfer.dp, c.transfer.tail.dp) == (2, 2)
    with pytest.raises(NotImplementedError,
                       match="cannot train on it") as err:
        Cluster(ConfigParser().update({"cluster": {
            "transfer": "local"}}), devices=["cpu"]).initialize()
    assert "A11e" not in str(err.value)


def test_stencil_refuses_across_processes_as_jax():
    c = ConfigParser().update(CONF)
    c.set("word2vec", "stencil", 1)
    m = Word2Vec(config=c, device="cpu", cluster=_cluster_of(2))
    with pytest.raises(ValueError, match="single-process"):
        m.train(_corpus().tolist(), niters=1, batch_size=B)


# -- A11a: server_num > 1 on xla ------------------------------------------------

def test_xla_server_num_2_matches_jax_sharded_table(devices8):
    """``server_num: 2`` on ``xla``: the (2 * cap, d) table against JAX's
    model-axis sharded table on the (4, 2) mesh, by slot and by key, over
    three steps with JAX's draws."""
    corpus = _corpus()
    conf = {**CONF, "cluster": {"transfer": "xla", "server_num": 2}}
    jm = JaxWord2Vec(config=JaxConfig().update(conf),
                     capacity_per_shard=CAP // 2).build(corpus.tolist())
    pm = Word2Vec(config=ConfigParser().update(conf), device="cpu",
                  capacity_per_shard=CAP // 2)
    pm.build(corpus.tolist())
    assert pm.table.key_index.num_shards == 2 and pm.transfer.name == "xla"
    assert pm.table.state["h"].shape == jm.table.state["h"].shape \
        == (CAP, D)
    np.testing.assert_array_equal(pm._slot_of_vocab.numpy(),
                                  np.asarray(jm._slot_of_vocab))
    pm.table.state = state_from_jax(
        {f: np.array(a) for f, a in jm.table.state.items()}, "cpu")
    batches = _rank_batches(corpus, build_vocab(corpus))[0]
    step = jm._build_step()
    state = jm.table.state
    key = jax.random.key(5)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        bt = batches[i]
        state, es, ec = step(state, jm._slot_of_vocab, jm._alias_prob,
                             jm._alias_idx, jnp.asarray(bt.centers),
                             jnp.asarray(bt.contexts),
                             jnp.asarray(bt.ctx_mask), sub)
        got_es, got_ec = pm.step_batch(
            bt, draws=_jax_draws(sub, len(pm.vocab), (B, K)))
        assert got_ec == int(ec)
        np.testing.assert_allclose(got_es, float(es), rtol=1e-5)
    got = state_to_numpy(pm.table.state)
    for f, a in state.items():
        _envelope(got[f], np.asarray(a))
    ki = pm.table.key_index
    by_key = _by_key(got, ki, build_vocab(corpus).keys)
    for f, a in _by_key({f: np.asarray(a) for f, a in state.items()}, ki,
                        build_vocab(corpus).keys).items():
        _envelope(by_key[f], a)
