"""The reference's deployment width on the CPU: 4 and 8 rank processes
(``mpirun -np 8``, the reference's ``cluster_run.sh``), bf16 tables
across processes, and bounded staleness across 8 processes with its
envelope.

JAX cannot run across processes on this CPU (``tests/test_multiprocess.py``
skips: jaxlib has no multiprocess CPU collectives), so N port processes
are held against the JAX package's one-process step over their global
batches, as ``tests/test_torch_multiprocess.py`` holds 2: JAX's model on
the 8-device CPU mesh (``xla``: a data x model = 8 x 1 mesh) steps over
the concatenation of the N processes' batches in process order, and each
port process is fed its slice of JAX's draws.  Tables within the
envelope ``|a - b| <= 1e-5 + 1e-3 |b|`` (bfloat16 fields: within one
bfloat16 ulp or the envelope, whichever is wider: the reconcile sums in
process order, JAX in its own, and a float32 difference can cross a
bfloat16 rounding boundary), losses within 1e-4 relative, the replicas
of the processes equal to the bit.

The children are the port's (``swiftmpi_tpu_torch.testing.mp_child``),
started by its launcher, each launch under a hard ``timeout=`` and the
children's collectives under a bounded ``SMTPU_DIST_TIMEOUT`` and one
intra-op thread each (``OMP_NUM_THREADS=1``: 8 children at these sizes
gain nothing from the cores, and the suite runs beside them).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import async_envelope
from swiftmpi_tpu_torch.data.distributed import shard_sentences
from swiftmpi_tpu_torch.data.text import CBOWBatcher, build_vocab
from swiftmpi_tpu_torch.parameter import KeyIndex
from swiftmpi_tpu_torch.testing import mp_child

REPO = Path(__file__).resolve().parents[1]
B, K, W, D = 32, 5, 2, 8
STEPS = 3
#: capacity a shard: every key of the corpus (< 60) has its row
CAP = 600
CONF = {"word2vec": {"len_vec": D, "window": W, "negative": K,
                     "sample": -1, "learning_rate": 0.05,
                     "min_sentence_length": 2},
        "server": {"initial_learning_rate": 0.3}}
BF16_SERVER = {"initial_learning_rate": 0.3, "dtype": "bfloat16"}
XLA = {"transfer": "xla", "server_num": 1}
BF16 = ml_dtypes.bfloat16
#: transfer-level windows of bf16 tables over 4 processes (2 shard ranks
#: each): ``tpu`` with int8 wire quantization, whose error feedback runs on
#: the gathered global window, and ``hybrid`` with a hot head of 16 rows,
#: whose hot planes are summed across the processes
BF16_WINDOWS = [
    ("win_tpu_q_bf16", {"transfer": "tpu", "server_num": 2},
     {"wire_quant": "int8", "window_expected_unique": 60.0},
     {"seed": 5, "ef": True}),
    ("win_hybrid_bf16", {"transfer": "hybrid", "server_num": 2},
     {"window_expected_unique": 60.0}, {"seed": 6, "n_hot": 16})]
#: ``reduce_scatter`` and ``pmean`` at 8 processes: a plane cut on dim 0
#: and one cut on dim 1
COLL_SHAPES = [["plane", [16, 5], 0], ["wide", [3, 24], 1]]


#: the children's environment beside the caller's
CHILD_ENV = {"SMTPU_DIST_TIMEOUT": "90", "OMP_NUM_THREADS": "1"}


def run_launch(nprocs: int, *args, timeout: float = 120):
    env = dict(os.environ, **CHILD_ENV)
    return subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np",
         str(nprocs), "--", sys.executable, "-m",
         "swiftmpi_tpu_torch.testing.mp_child", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _corpus(nprocs: int) -> np.ndarray:
    """4 sentences of 8 keys a process: each shard is one batch of B = 32
    centers an epoch (no subsampling)."""
    rng = np.random.default_rng(3)
    return rng.integers(1, 60, size=(4 * nprocs, 8)).astype(np.int32)


def _jax_draws(key, V, shape):
    """The (j, u) ``ops/sampling._alias_draw_packed`` derives from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _rank_batches(corpus, vocab, nprocs):
    """What each process's batcher yields, epoch by epoch: its shard,
    seed 2008 + rank."""
    out = []
    for r in range(nprocs):
        b = CBOWBatcher(shard_sentences(corpus, r, nprocs), vocab, W, -1,
                        seed=2008 + r)
        out.append([next(iter(b.epoch(B))) for _ in range(STEPS)])
        assert all(len(x) == B for x in out[r])
    return out


def _jax_reference(corpus, nprocs: int, server: dict,
                   local_steps: int = 1):
    """JAX's model (xla on the 8-device CPU mesh) stepped over the N
    processes' batches concatenated in process order: ``(vocab, initial
    table, final table, losses, draws)``.  ``local_steps > 1``: JAX
    ``train``'s snapshot loop, grads against a frozen table refreshed
    every ``local_steps`` steps, pushes onto the live one."""
    conf = {**CONF, "server": server, "cluster": XLA}
    jm = JaxWord2Vec(config=JaxConfig().update(conf),
                     capacity_per_shard=CAP).build(corpus.tolist())
    init = {f: np.array(a) for f, a in jm.table.state.items()}
    vocab = build_vocab(corpus)
    batches = _rank_batches(corpus, vocab, nprocs)
    if local_steps > 1:
        grads_fn, apply_fn = jax.jit(jm._build_grads()), \
            jax.jit(jm._build_apply())
        frozen = {f: jnp.array(a) for f, a in init.items()}
    else:
        step = jm._build_step()
    state = jm.table.state
    losses, draws = [], []
    key = jax.random.key(11)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        cat = [np.concatenate([batches[r][i].__dict__[k]
                               for r in range(nprocs)])
               for k in ("centers", "contexts", "ctx_mask")]
        args = (jm._slot_of_vocab, jm._alias_prob, jm._alias_idx,
                *map(jnp.asarray, cat), sub)
        if local_steps > 1:
            pushes, es, ec = grads_fn(frozen, *args)
            state = apply_fn(state, pushes)
            if (i + 1) % local_steps == 0:
                frozen = {f: jnp.array(a) for f, a in state.items()}
        else:
            state, es, ec = step(state, *args)
        losses.append(float(es) / max(int(round(float(ec))), 1))
        draws.append(_jax_draws(sub, len(vocab), (nprocs * B, K)))
    return (vocab, init, {f: np.array(a) for f, a in state.items()},
            losses, draws)


def _spec(tmp, name, corpus, ref, nprocs, conf, init=None, **extra):
    """A ``w2v`` job of N processes from the reference's initial table
    (or ``init``) with its draws, each process its slice."""
    vocab, jinit, _, _, draws = ref
    data = {"corpus": corpus, "vocab_keys": vocab.keys,
            "vocab_counts": vocab.counts}
    data.update({f"init__{f}": a
                 for f, a in (jinit if init is None else init).items()})
    for r in range(nprocs):
        data[f"j{r}"] = np.stack([d[0][r * B:(r + 1) * B] for d in draws])
        data[f"u{r}"] = np.stack([d[1][r * B:(r + 1) * B] for d in draws])
    np.savez(tmp / f"{name}.npz", **data)
    return {"conf": conf, "data": str(tmp / f"{name}.npz"),
            "device": "cpu", "batch_size": B, "niters": STEPS,
            "capacity_per_shard": CAP, "out": str(tmp / name),
            "state": True, **extra}


def _tpu_init(init, keys, shards: int):
    """The reference's rows by key laid out over ``shards`` shard ranks."""
    rows = {f: a[KeyIndex(1, CAP).lookup(keys)] for f, a in init.items()}
    out = {f: np.zeros((shards * CAP, a.shape[1]), a.dtype)
           for f, a in init.items()}
    for f in out:
        out[f][KeyIndex(shards, CAP).lookup(keys)] = rows[f]
    return out


def _launched(tmp, nprocs, specs, timeout=150):
    (tmp / "specs.json").write_text(json.dumps(specs))
    res = run_launch(nprocs, "w2v", "-spec", str(tmp / "specs.json"),
                     timeout=timeout)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    return res


def _results(spec, nprocs, job="w2v"):
    out = Path(spec["out"])
    return [json.loads((out / f"{job}_r{r}.json").read_text())
            for r in range(nprocs)]


@pytest.fixture(scope="module")
def four_runs(tmp_path_factory):
    """One launch of 4 processes: sync word2vec on ``xla`` and on ``tpu``
    (2 shard ranks a process) with float32 tables, and on ``xla`` with
    bfloat16 tables, each from JAX's initial table with JAX's draws.
    Returns ``{job: (reference, spec)}``."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("four")
    corpus = _corpus(4)
    f32 = _jax_reference(corpus, 4, CONF["server"])
    bf16 = _jax_reference(corpus, 4, BF16_SERVER)
    jobs = {
        "xla": (f32, _spec(tmp, "xla", corpus, f32, 4,
                           {**CONF, "cluster": XLA})),
        "tpu": (f32, _spec(tmp, "tpu", corpus, f32, 4,
                           {**CONF, "cluster": {"transfer": "tpu",
                                                "server_num": 2}},
                           init=_tpu_init(f32[1], f32[0].keys, 2))),
        "xla_bf16": (bf16, _spec(tmp, "xla_bf16", corpus, bf16, 4,
                                 {**CONF, "server": BF16_SERVER,
                                  "cluster": XLA}, wire=True))}
    for name, cluster, knobs, gen in BF16_WINDOWS:
        jobs[name] = (None, {
            "job": "window", "device": "cpu", "out": str(tmp / name),
            "conf": {"cluster": cluster}, "knobs": knobs,
            "reference": True, "lr": 0.7, "wire": True,
            "gen": {"rows": 4 * 2 * 40, "d": D, "W": 4, "B": 24,
                    "dtype": "bfloat16", **gen}})
    _launched(tmp, 4, [spec for _, spec in jobs.values()])
    return jobs


@pytest.fixture(scope="module")
def two_bf16(tmp_path_factory):
    """One launch of 2 processes: sync word2vec on ``xla`` with bfloat16
    tables from JAX's table with JAX's draws."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("two_bf16")
    corpus = _corpus(2)
    ref = _jax_reference(corpus, 2, BF16_SERVER)
    spec = _spec(tmp, "xla_bf16", corpus, ref, 2,
                 {**CONF, "server": BF16_SERVER, "cluster": XLA}, wire=True)
    _launched(tmp, 2, [spec])
    return {"xla_bf16": (ref, spec)}


@pytest.fixture(scope="module")
def eight_runs(tmp_path_factory):
    """One launch of 8 processes: sync word2vec on ``xla`` from JAX's
    table with JAX's draws, ``async_mode: hogwild`` on ``xla`` (which
    across processes runs the snapshot mode at ``local_steps: 2``; its
    reference JAX's snapshot loop over the same global batches and
    draws), and a ``collectives`` job (``reduce_scatter`` and ``pmean``
    at ``COLL_SHAPES``).  Returns the jobs and the launch's output."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("eight")
    corpus = _corpus(8)
    ref = _jax_reference(corpus, 8, CONF["server"])
    snap = _jax_reference(corpus, 8, CONF["server"], local_steps=2)
    xla = _spec(tmp, "xla", corpus, ref, 8, {**CONF, "cluster": XLA})
    hog = _spec(tmp, "hog", corpus, snap, 8, {
        **CONF, "word2vec": {**CONF["word2vec"], "async_mode": "hogwild"},
        "cluster": XLA})
    coll = {"job": "collectives", "device": "cpu",
            "out": str(tmp / "collectives"), "shapes": COLL_SHAPES}
    res = _launched(tmp, 8, [xla, hog, coll])
    return {"xla": (ref, xla), "hog": (snap, hog),
            "coll": (None, coll)}, res


@pytest.mark.parametrize("w2v", [{}, {"sg": 1},
                                 {"shared_negatives": 1,
                                  "shared_pool": 64}])
def test_each_process_draws_its_rows_of_one_global_draw(w2v):
    """Across processes every process seeds its negatives' generator
    alike: each draws the global batch's ``(dp * B, ...)`` and keeps its
    block of rows (JAX draws once over the global batch), so the 4
    processes' draws together are one process's draw over 4 * B centers,
    never the same rows 4 times; a shared pool is the one global pool.
    Before the fix every process drew the same ``(B, K)`` rows."""
    import torch

    from swiftmpi_tpu_torch.cluster import Cluster
    from swiftmpi_tpu_torch.models.word2vec import Word2Vec
    from swiftmpi_tpu_torch.utils import ConfigParser

    def model(dp, rank):
        conf = {**CONF, "word2vec": {**CONF["word2vec"], **w2v}}
        c = Cluster(ConfigParser().update({"cluster": XLA}),
                    devices=["cpu"]).initialize()
        c.dp, c.dp_rank = dp, rank
        m = Word2Vec(config=ConfigParser().update(conf), device="cpu",
                     cluster=c)
        m.build(_corpus(4).tolist())
        return m
    dp = 4
    parts = [model(dp, r)._draws(B, None) for r in range(dp)]
    one = model(1, 0)._draws(dp * B, None)
    if w2v.get("shared_negatives"):
        for j, u in parts:
            assert torch.equal(j, parts[0][0]) and torch.equal(u, parts[0][1])
        assert parts[0][0].shape == (64,)
        return
    for k in (0, 1):
        assert torch.equal(torch.cat([p[k] for p in parts]), one[k])
    assert not torch.equal(parts[0][0], parts[1][0])
    assert parts[0][0].shape[0] == B


def test_an_npz_bf16_table_reaches_the_port_with_its_bits(tmp_path):
    """A bfloat16 table saved in an npz (JAX's initial table handed to the
    processes) comes back as 2-byte void arrays; ``state_from_jax`` reads
    them as bfloat16 with the same bits, as it reads ``ml_dtypes``'
    arrays."""
    import torch

    from swiftmpi_tpu_torch.convert import state_from_jax
    a = np.random.default_rng(1).standard_normal((6, 4)).astype(BF16)
    np.savez(tmp_path / "t.npz", h=a)
    held = np.load(tmp_path / "t.npz")["h"]
    assert held.dtype.kind == "V" and held.dtype.itemsize == 2
    for src in (held, a):
        t = state_from_jax({"h": src}, "cpu")["h"]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16))


def _envelope(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def _ordinal(a: np.ndarray) -> np.ndarray:
    """bfloat16 values as integers in the order of the reals."""
    bits = np.asarray(a, BF16).view(np.uint16).astype(np.int64)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def _bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    """Every element within one bfloat16 ulp or the envelope."""
    ulp = np.abs(_ordinal(got) - _ordinal(want)) <= 1
    a, b = got.astype(np.float32), want.astype(np.float32)
    env = np.abs(a - b) <= 1e-5 + 1e-3 * np.abs(b)
    assert (ulp | env).all(), (int((~(ulp | env)).sum()),
                               float(np.abs(a - b).max()))


def _by_key(state, ki: KeyIndex, keys):
    slots = ki.lookup(keys)
    return {f: a[slots] for f, a in state.items()}


def _hold_against_jax(ref, spec, nprocs, shards=1):
    """The replicas one table, the losses within 1e-4 of JAX's global
    step's, every field by key within the envelope (bfloat16 fields: or
    one ulp) and moved by the run."""
    vocab, init, want, losses, _ = ref
    got = _results(spec, nprocs)
    assert [g["rank"] for g in got] == list(range(nprocs))
    assert all(g["sha"] == got[0]["sha"] for g in got)
    assert all(g["losses"] == got[0]["losses"] for g in got)
    m = got[0]["metrics"]
    assert m["steps"] == STEPS and m["processes"] == nprocs
    assert m["words"] == STEPS * nprocs * B
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
    final = dict(np.load(Path(spec["out"]) / "w2v_state_r0.npz"))
    keys = vocab.keys
    a = _by_key(final, KeyIndex(shards, CAP), keys)
    b = _by_key(want, KeyIndex(1, CAP), keys)
    start = _by_key(init, KeyIndex(1, CAP), keys)
    for f in want:
        if b[f].dtype == BF16:
            _bf16_close(a[f].astype(BF16), b[f])
        else:
            _envelope(a[f], b[f])
        assert not np.array_equal(a[f], start[f].astype(np.float32))
    return got


@pytest.mark.parametrize("job", ["xla", "tpu"])
def test_four_process_word2vec_matches_jax_global_step(four_runs, job):
    """4 processes on ``xla`` and on ``tpu`` (``server_num: 2``: 2 shard
    ranks in each process) equal JAX's one-process step over the 4
    processes' batches: replicas one table, losses within 1e-4, every
    key's rows within the envelope."""
    ref, spec = four_runs[job]
    got = _hold_against_jax(ref, spec, 4, shards=2 if job == "tpu" else 1)
    paths = got[0]["metrics"]["push_paths"]
    if job == "tpu":
        assert paths == {"h:routed": STEPS, "v:routed": STEPS}
    else:
        assert sum(paths.values()) == 2 * STEPS
        assert {k.split(":")[1] for k in paths} <= {"dense", "sparse"}


@pytest.mark.parametrize("nprocs", [2, 4])
def test_bf16_tables_across_processes_match_jax(four_runs, two_bf16,
                                                nprocs):
    """bfloat16 tables (``[server] dtype: bfloat16``) on ``xla`` over 2 and
    4 processes against JAX's bf16 global step: h and v within one bf16
    ulp or the envelope, the accumulators in the envelope, the losses
    within 1e-4, the replicas one table.  What crossed the processes is
    float32 (and int32 slots): the dense planes with their counts, and
    where v's push is sparse (2 processes: 256 global rows) the v fold's
    rows; no bfloat16 goes on the exchange."""
    ref, spec = (four_runs if nprocs == 4 else two_bf16)["xla_bf16"]
    got = _hold_against_jax(ref, spec, nprocs)
    wire = got[0]["wire"]
    paths = got[0]["metrics"]["push_paths"]
    assert wire["psum"] == ["float32"]
    assert wire["rows"] == (["float32", "int32"] if "v:sparse" in paths
                            else [])
    assert ("v:sparse" in paths) == (nprocs == 2)
    assert wire["ef"] == []


@pytest.mark.parametrize("job,shipped", [
    ("win_tpu_q_bf16", {"psum": ["float32"], "rows": [],
                        "ef": ["float32"]}),
    ("win_hybrid_bf16", {"psum": ["float32"], "rows": [], "ef": []})])
def test_bf16_windows_across_four_processes_ship_float32(four_runs, job,
                                                         shipped):
    """A window of bf16 tables across 4 processes: ``tpu`` with int8 wire
    quantization (its ``@ef`` window gathered across the processes) and
    ``hybrid`` (its hot planes summed across them).  The exchanges carry
    float32 only; the replicas are one table; against the one-process
    push over the 4 processes' windows in process order, the bf16 fields
    are bit for bit equal and the float32 accumulators in the envelope."""
    got = _results(four_runs[job][1], 4, "window")
    assert all(g["sha"] == got[0]["sha"] for g in got)
    assert got[0]["wire"] == shipped
    for f, gap in got[0]["reference_gap"].items():
        assert gap["share_outside_envelope"] == 0.0, (f, gap)
        if "2sum" not in f:
            assert gap["max_abs_gap"] == 0.0, (f, gap)


def test_eight_process_word2vec_matches_jax_global_step(eight_runs):
    """8 processes on ``xla`` (the reference's ``-np 8``): one table,
    JAX's global step's losses and rows."""
    ref, spec = eight_runs[0]["xla"]
    _hold_against_jax(ref, spec, 8)


def test_eight_process_hogwild_runs_the_snapshot_mode(eight_runs):
    """``async_mode: hogwild`` across 8 processes falls back to the
    snapshot mode at ``local_steps: 2``, with JAX's warning, on every
    process; held against JAX's snapshot loop over the 8 processes'
    global batches (steps 0 and 1 against the initial table, step 2
    against the table after them): the replicas one table, the losses
    within 1e-4, every key's rows within the envelope."""
    jobs, res = eight_runs
    ref, spec = jobs["hog"]
    got = _hold_against_jax(ref, spec, 8)
    assert res.stdout.count("falls back to snapshot bounded staleness "
                            "(local_steps=2") == 8
    assert all(g["metrics"]["local_steps"] == 2 for g in got)


def test_eight_process_collectives_sum_in_process_order(eight_runs):
    """``reduce_scatter`` and ``pmean`` over 8 processes: every process's
    results equal numpy's sums of the 8 seeded parts in process order,
    bit for bit (the child holds them too)."""
    jobs, _ = eight_runs
    spec = jobs["coll"][1]
    got = _results(spec, 8, "collectives")
    assert [g["dp"] for g in got] == [8] * 8
    for r in range(8):
        z = np.load(Path(spec["out"]) / f"collectives_state_r{r}.npz")
        for label, shape, dim in COLL_SHAPES:
            parts = [mp_child._part(300 + p, tuple(shape), np.float32)
                     for p in range(8)]
            total = parts[0].copy()
            for p in parts[1:]:
                total += p
            block = shape[dim] // 8
            want = np.take(total, np.arange(r * block, (r + 1) * block),
                           axis=dim)
            assert np.array_equal(z[f"rs__{label}"], want)
            assert np.array_equal(z[f"pm__{label}"], total / np.float32(8))


def test_two_process_async_passes_the_jax_childs_checks():
    """``mp_child async`` at 2 processes, the JAX child's main mode: sync
    against ``local_steps`` 4 on ``xla`` within 20%, ``tpu`` and
    ``hybrid`` at ``local_steps`` 4 finite and falling, and hogwild at
    ``local_steps`` 2."""
    res = run_launch(2, "async", "-device", "cpu", timeout=150)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    for r in range(2):
        assert f"MP_ASYNC_OK proc={r}/2" in res.stdout, res.stdout


def _sweep_line(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if "MP_SWEEP_JSON " in ln]
    assert len(lines) == 1 and lines[0].startswith("[rank 0]"), stdout
    return json.loads(lines[0].split("MP_SWEEP_JSON ", 1)[1])


def test_eight_process_async_staleness():
    """8 processes at ``local_steps`` 16, 2 epochs of 200 sentences (the
    JAX package's ``test_eight_process_async_staleness``): rank 0's
    ``MP_SWEEP_JSON`` line, finite losses, the global words of 8
    processes."""
    res = run_launch(8, "async", "-device", "cpu", "-sweep", "16",
                     "-epochs", "2", "-sents", "200", timeout=150)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    rec = _sweep_line(res.stdout)
    assert rec["processes"] == 8 and rec["epochs"] == 2
    assert rec["cpu_count"] == os.cpu_count()
    run = rec["sweep"]["16"]
    assert run["local_steps"] == 16 and np.isfinite(run["losses"]).all()
    assert len(run["losses"]) == 2 and run["steps"] > 0
    # the global words: every process's shard, each epoch (200 sentences
    # of 12 words)
    assert run["words"] == 2 * 200 * 12
    assert res.stdout.count("MP_CHILD_OK async") == 8


def test_async_envelope_app_prints_a_line_a_setting(tmp_path, capsys,
                                                    monkeypatch):
    """``apps/async_envelope.py -device cpu`` at a tiny size over two
    shapes in one launch (the JAX child's, and demo.conf's on a small
    ``-data`` corpus): for each shape one JSON line a setting (sync's gap
    0), the markdown table, and the record appended to ``-out``."""
    out = tmp_path / "env.jsonl"
    corpus = np.random.default_rng(4).integers(1, 100, size=(40, 30))
    vocab = build_vocab(corpus)
    np.savez(tmp_path / "ref.npz", corpus=corpus, vocab_keys=vocab.keys,
             vocab_counts=vocab.counts)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = async_envelope.main(["-device", "cpu", "-np", "2", "-sweep",
                              "1,4", "-epochs", "2", "-sents", "100",
                              "-shape", "small,reference", "-data",
                              str(tmp_path / "ref.npz"), "-out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")]
    assert [(ln["shape"], ln["local_steps"]) for ln in lines] == [
        ("small", 1), ("small", 4), ("reference", 1), ("reference", 4)]
    for sync, stale in (lines[:2], lines[2:]):
        assert sync["vs_sync_pct"] == 0.0
        want = 100 * (stale["final_loss"] - sync["final_loss"]) \
            / sync["final_loss"]
        assert stale["vs_sync_pct"] == pytest.approx(want)
    for ln in lines:
        assert ln["processes"] == 2 and ln["card"] is None
        assert np.isfinite(ln["final_loss"]) and ln["global_words_per_s"] > 0
    # the reference shape trains the npz's corpus (demo.conf's sample
    # 1e-5 keeps a share of it), every epoch
    assert 0 < lines[2]["words"] <= 2 * corpus.size
    assert text.count("| local_steps | final loss | vs sync |") == 2
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["shape"] for r in recs] == ["small", "reference"]
    assert all(r["processes"] == 2 and len(r["lines"]) == 2 for r in recs)
