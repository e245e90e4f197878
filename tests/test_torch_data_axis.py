"""The rest of the data axis: every hook the JAX package runs across
processes, run by the port across 2 processes on the CPU over gloo.

One launch of the port's launcher (``python -m swiftmpi_tpu_torch.launch
-np 2 -- mp_child w2v -spec``) runs every job one after the other in one
process group, with its own ``timeout=`` and a bounded
``SMTPU_DIST_TIMEOUT``; the JAX references are computed in this process
while the children run:

* word2vec on ``hybrid`` (its hot head), on ``hybrid`` with
  ``collective: sparse_allreduce``, on ``xla`` with ``pull_quant: bf16``
  and ``pull_cache: 8``, on ``xla`` with ``[serve] every: 2``, and on
  ``tpu`` with ``push_window: 4, wire_quant: int8`` beside its
  ``push_window: 1`` run; each against JAX's step over the processes'
  batches concatenated, with JAX's draws;
* the transfer-level window push on ``tpu``, ``hybrid`` and ``xla``, with
  and without ``wire_quant: int8`` and with both hot collectives,
  against JAX's ``TpuTransfer``/``HybridTransfer`` on a single-process
  ``(data=2, shard=2)`` mesh (``XlaTransfer`` on one program) over the
  global window;
* LR and GloVe on ``xla`` and ``tpu``, against JAX's one-process runs on
  ``xla`` from the same rows by key;
* sent2vec over a ``hybrid`` word table, against JAX's sent2vec over an
  ``xla`` table holding the same rows by key.

Tables are held to the envelope ``|a - b| <= 1e-5 + 1e-3 |b|``, losses to
1e-4 relative, and the processes' replicas to the bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swiftmpi_tpu.data.libsvm import synthetic_dataset
from swiftmpi_tpu.models.glove import GloVe as JaxGloVe
from swiftmpi_tpu.models.logistic import LogisticRegression as JaxLR
from swiftmpi_tpu.models.sent2vec import Sent2Vec as JaxSent2Vec
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.data.distributed import batch_share, shard_sentences
from swiftmpi_tpu_torch.data.text import CBOWBatcher, build_vocab
from swiftmpi_tpu_torch.parameter import KeyIndex
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition

REPO = Path(__file__).resolve().parents[1]
B, K, W, D = 32, 5, 2, 8
STEPS = 3
CAP = 600
SHARDS = 2
CONF = {"word2vec": {"len_vec": D, "window": W, "negative": K,
                     "sample": -1, "learning_rate": 0.05,
                     "min_sentence_length": 2},
        "server": {"initial_learning_rate": 0.3}}
#: the window jobs: steps a window, rows a step and process, table rows
#: a shard, hot rows
WW, WB, WCAP, WHOT = 2, 16, 16, 6
S2V_LINES = ["1 2 3 4 5 6", "7 1 1 2", "3 9 4", "2 2 5 8 1 6 3",
             "4 1", "6 5 4 3 2 1 9", "8 8 2", "1 3 5 7"]
S2V_S, S2V_NITERS = 8, 2


def _corpus():
    """8 sentences of 8 keys drawn with Zipf weights (a hot head for
    ``hybrid``): each process's shard is one batch of B = 32 centers an
    epoch."""
    rng = np.random.default_rng(3)
    keys = np.arange(1, 41)
    p = 1.0 / keys
    return rng.choice(keys, size=(8, 8), p=p / p.sum()).astype(np.int32)


def _jax_draws(key, V, shape):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, shape, 0, V)),
            np.array(jax.random.uniform(k2, shape)))


def _rank_batches(corpus, vocab):
    out = []
    for r in (0, 1):
        b = CBOWBatcher(shard_sentences(corpus, r, 2), vocab, W, -1,
                        seed=2008 + r)
        out.append([next(iter(b.epoch(B))) for _ in range(STEPS)])
    return out


def _jax_w2v(corpus, cluster, **sections):
    """JAX's word2vec stepped over the processes' batches concatenated:
    ``(vocab, initial table, final table, losses, draws, model)``."""
    conf = dict(CONF, cluster=cluster, **sections)
    jm = JaxWord2Vec(config=JaxConfig().update(conf),
                     capacity_per_shard=CAP).build(corpus.tolist())
    init = {f: np.array(a) for f, a in jm.table.state.items()}
    vocab = build_vocab(corpus)
    batches = _rank_batches(corpus, vocab)
    step = jm._build_step()
    state, losses, draws = jm.table.state, [], []
    key = jax.random.key(11)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        cat = [np.concatenate([batches[r][i].__dict__[k] for r in (0, 1)])
               for k in ("centers", "contexts", "ctx_mask")]
        state, es, ec = step(state, jm._slot_of_vocab, jm._alias_prob,
                             jm._alias_idx, *map(jnp.asarray, cat), sub)
        losses.append(float(es) / max(int(round(float(ec))), 1))
        draws.append(_jax_draws(sub, len(vocab), (2 * B, K)))
    final = {f: np.array(a) for f, a in state.items()}
    return vocab, init, final, losses, draws, jm


def _envelope(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                               err_msg=what)


def _by_key(state, ki, keys):
    slots = ki.lookup(keys)
    return {f: a[slots] for f, a in state.items() if "@" not in f}


# -- the jobs' inputs ----------------------------------------------------------

def _w2v_spec(tmp, name, corpus, vocab, init, draws, conf, **extra):
    data = {"corpus": corpus, "vocab_keys": vocab.keys,
            "vocab_counts": vocab.counts}
    data.update({f"init__{f}": a for f, a in init.items()})
    for r in (0, 1):
        data[f"j{r}"] = np.stack([d[0][r * B:(r + 1) * B] for d in draws])
        data[f"u{r}"] = np.stack([d[1][r * B:(r + 1) * B] for d in draws])
    np.savez(tmp / f"{name}.npz", **data)
    return {"conf": conf, "data": str(tmp / f"{name}.npz"), "device": "cpu",
            "batch_size": B, "niters": STEPS, "capacity_per_shard": CAP,
            "out": str(tmp / name), "state": True, **extra}


def _window_inputs(seed, backend, quant, n_hot=0, cap=WCAP):
    """A window job's table (the JAX package's layout) and each process's
    ``(W, B)`` window: slots over the unified space with repeats and
    ``-1`` padding, h and v grads."""
    rng = np.random.default_rng(seed)
    rows = cap * (1 if backend == "xla" else SHARDS)
    init = {f: (0.1 * rng.normal(size=(rows, D))).astype(np.float32)
            for f in ("h", "v")}
    init.update({f: np.zeros((rows, D), np.float32)
                 for f in ("h2sum", "v2sum")})
    if n_hot:
        init.update({f"{f}@hot": (0.1 * rng.normal(size=(n_hot, D)))
                     .astype(np.float32) for f in ("h", "v")})
        init.update({f"{f}@hot": np.zeros((n_hot, D), np.float32)
                     for f in ("h2sum", "v2sum")})
    if quant != "off":
        init.update({f"{f}@ef": np.zeros((rows, D), np.float32)
                     for f in ("h", "v")})
    total = rows + n_hot
    win = {}
    for r in (0, 1):
        # a Zipf-ish spread: the low slots (the hot head) repeat
        s = np.minimum(rng.zipf(1.3, size=(WW, WB)) - 1, total - 1)
        s[rng.random(s.shape) < 0.1] = -1
        win[f"slots{r}"] = s.astype(np.int32)
        for f in ("h", "v"):
            win[f"grads{r}__{f}"] = rng.normal(
                size=(WW, WB, D)).astype(np.float32)
    return init, win


#: window job -> (backend, knobs, wire_quant, n_hot, table rows a shard,
#: mean)
WINDOWS = {
    "win_tpu_dense": ("tpu", {}, "off", 0, WCAP, True),
    "win_tpu_q": ("tpu", {}, "int8", 0, 16 * WCAP, False),
    "win_hybrid": ("hybrid", {}, "off", WHOT, 8 * WCAP, False),
    "win_hybrid_sar_q": ("hybrid", {"collective_mode": "sparse_allreduce"},
                         "int8", WHOT, 16 * WCAP, True),
    "win_xla_q": ("xla", {}, "int8", 0, 32 * WCAP, True),
}


def _window_spec(tmp, name):
    backend, knobs, quant, n_hot, cap, mean = WINDOWS[name]
    init, win = _window_inputs(len(name), backend, quant, n_hot, cap)
    np.savez(tmp / f"{name}.npz",
             **{f"init__{f}": a for f, a in init.items()}, **win)
    knobs = dict(knobs, wire_quant=quant)
    return {"job": "window", "data": str(tmp / f"{name}.npz"),
            "device": "cpu", "out": str(tmp / name), "mean": mean,
            "knobs": knobs, "conf": {"cluster": {
                "transfer": backend,
                "server_num": 1 if backend == "xla" else SHARDS}}}


def _jax_window(name, devices8):
    """JAX's push_window over the global window (the processes' windows
    concatenated): the ``(data=2, shard=2)`` mesh for tpu and hybrid,
    one program for xla."""
    from jax.sharding import Mesh
    from swiftmpi_tpu.cluster import SHARD_AXIS
    from swiftmpi_tpu.cluster.mesh import DATA_AXIS
    from swiftmpi_tpu.parameter import w2v_access
    from swiftmpi_tpu.transfer.hybrid import HybridTransfer
    from swiftmpi_tpu.transfer.tpu import TpuTransfer
    from swiftmpi_tpu.transfer.xla import XlaTransfer
    backend, knobs, quant, n_hot, cap, mean = WINDOWS[name]
    init, win = _window_inputs(len(name), backend, quant, n_hot, cap)
    if backend == "xla":
        t = XlaTransfer()
    else:
        mesh = Mesh(np.asarray(devices8[:4]).reshape(2, SHARDS),
                    (DATA_AXIS, SHARD_AXIS))
        t = (TpuTransfer if backend == "tpu" else HybridTransfer)(mesh)
    for k, v in dict(knobs, wire_quant=quant).items():
        setattr(t, k, v)
    state = {f: jnp.asarray(a) for f, a in init.items()}
    slots = np.concatenate([win["slots0"], win["slots1"]])
    grads = {f: np.concatenate([win[f"grads0__{f}"], win[f"grads1__{f}"]])
             for f in ("h", "v")}
    out = t.push_window(state, jnp.asarray(slots),
                        {f: jnp.asarray(g) for f, g in grads.items()},
                        w2v_access(learning_rate=0.3, len_vec=D), mean=mean)
    return init, {f: np.asarray(v) for f, v in out.items()}


def _lr_inputs(tmp):
    """A libSVM file of 160 rows (5 features over 40; batches of 32 with a
    padded tail) and JAX's one-process LR over it from the rows of every
    key: ``(path, keys, JAX's initial rows by key, JAX's model, losses)``."""
    data = synthetic_dataset(150, 40, 5, seed=12)
    path = tmp / "lr.svm"
    with open(path, "w") as f:
        for y, feats in data:
            f.write(f"{int(y)} " + " ".join(f"{k}:{v:.6f}"
                                            for k, v in feats) + "\n")
    keys = np.unique(np.concatenate(
        [[0]] + [[k for k, _ in feats] for _, feats in data])).astype(
            np.uint64)
    return path, keys


LR_CONF = {"worker": {"minibatch": 32},
           "server": {"initial_learning_rate": 0.1}}
GLOVE_CONF = {"glove": {"len_vec": D, "window": 3, "minibatch": 64,
                        "learning_rate": 0.05}}


# -- the launch ----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job in one launch of 2 processes, and the JAX references:
    ``{job: (reference, children's JSON, rank 0's npz)}``."""
    devices8 = jax.devices()
    if len(devices8) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("data_axis")
    corpus = _corpus()
    refs, specs = {}, []
    xla = {"transfer": "xla", "server_num": 1}
    # JAX's hybrid takes one shard a device (8 here): the port's
    # processes hold the same layout, 8 shard ranks each
    hyb = {"transfer": "hybrid", "server_num": 8}
    tpu = {"transfer": "tpu", "server_num": SHARDS}
    w2v_jobs = {
        "hybrid": (hyb, {}, {}),
        "hybrid_sar": (hyb, {}, {"push_window": 4,
                                 "collective": "sparse_allreduce"}),
        "xla_pull": (xla, {}, {"pull_quant": "bf16", "pull_cache": 8}),
        "xla_serve": (xla, {"serve": {"every": 2}}, {}),
        "tpu_w1": (tpu, {}, {}),
        "tpu_w4q": (tpu, {"worker": {"inner_steps": 4}},
                    {"push_window": 4, "wire_quant": "int8"}),
    }
    # JAX's references: the hybrid run (its knobs are inert at one step a
    # push), xla with the pull knobs, plain xla (for xla_serve and, by
    # key, tpu); the tpu runs start from xla's rows by key
    refs["hybrid"] = _jax_w2v(corpus, hyb)
    refs["xla_pull"] = _jax_w2v(corpus, dict(xla, pull_quant="bf16",
                                             pull_cache=8))
    refs["xla"] = _jax_w2v(corpus, xla)
    vocab = refs["xla"][0]
    rows = _by_key(refs["xla"][1], KeyIndex(1, CAP), vocab.keys)
    init_tpu = {f: np.zeros((SHARDS * CAP, D), np.float32) for f in rows}
    for f in init_tpu:
        init_tpu[f][KeyIndex(SHARDS, CAP).lookup(vocab.keys)] = rows[f]
    for name, (cluster, sections, knobs) in w2v_jobs.items():
        ref = {"hybrid": refs["hybrid"], "hybrid_sar": refs["hybrid"],
               "xla_pull": refs["xla_pull"]}.get(name, refs["xla"])
        init = init_tpu if cluster is tpu else ref[1]
        conf = dict(CONF, cluster=dict(cluster, **knobs), **sections)
        extra = ({"checkpoint": str(tmp / "tpu_w4q" / "ck")}
                 if name == "tpu_w4q" else {})
        specs.append(_w2v_spec(tmp, name, corpus, vocab, init, ref[4],
                               conf, **extra))
    for name in WINDOWS:
        specs.append(_window_spec(tmp, name))
    # LR and GloVe: the rows JAX's model starts from, by key
    lr_path, lr_keys = _lr_inputs(tmp)
    jlr = JaxLR(config=JaxConfig().update(dict(LR_CONF, cluster=xla)),
                capacity_per_shard=256)
    lr_slots = jlr.table.key_index.lookup(lr_keys)
    lr_rows = {f: np.asarray(a)[lr_slots] for f, a in
               jlr.table.state.items()}
    np.savez(tmp / "lr.npz", keys=lr_keys,
             **{f"rows__{f}": a for f, a in lr_rows.items()})
    jg = JaxGloVe(config=JaxConfig().update(dict(GLOVE_CONF, cluster=xla)))
    jg.build(corpus.tolist())
    g_slots = jg.table.key_index.lookup(jg.vocab.keys)
    g_rows = {f: np.asarray(a)[g_slots] for f, a in jg.table.state.items()}
    np.savez(tmp / "glove.npz", corpus=corpus, keys=jg.vocab.keys,
             **{f"rows__{f}": a for f, a in g_rows.items()})
    for job, cluster in (("lr", xla), ("lr", tpu), ("glove", xla),
                         ("glove", tpu)):
        name = f"{job}_{cluster['transfer']}"
        conf = dict(LR_CONF if job == "lr" else GLOVE_CONF,
                    cluster=cluster)
        specs.append({"job": job, "conf": conf, "device": "cpu",
                      "data": str(tmp / f"{job}.npz"),
                      "dataset": str(lr_path), "niters": 2,
                      "capacity_per_shard": 256 if job == "lr" else 64,
                      "out": str(tmp / name)})
    # sent2vec over the hybrid word table JAX's hybrid run starts from
    hv = refs["hybrid"]
    s2v_draws = _s2v_jax_draws(len(hv[0]))
    sent0, passes = s2v_draws
    np.savez(tmp / "s2v.npz", vocab_keys=hv[0].keys,
             vocab_counts=hv[0].counts, lines=np.array(S2V_LINES),
             s2v_sent0=sent0, s2v_b=np.stack([p[0] for p in passes]),
             s2v_j=np.stack([p[1] for p in passes]),
             s2v_u=np.stack([p[2] for p in passes]),
             **{f"init__{f}": a for f, a in hv[1].items()})
    specs.append({"job": "s2v", "device": "cpu", "seed": 1,
                  "data": str(tmp / "s2v.npz"), "niters": S2V_NITERS,
                  "capacity_per_shard": CAP, "out": str(tmp / "s2v"),
                  "conf": dict(CONF, cluster=hyb),
                  "s2v_conf": dict(CONF, worker={"minibatch": S2V_S})})
    (tmp / "specs.json").write_text(json.dumps(specs))
    env = dict(os.environ, SMTPU_DIST_TIMEOUT="60")
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np", "2",
         "--", sys.executable, "-m", "swiftmpi_tpu_torch.testing.mp_child",
         "w2v", "-spec", str(tmp / "specs.json")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        # the references the launch does not need, while it runs
        for name in WINDOWS:
            refs[name] = _jax_window(name, devices8)
        refs["lr"] = (lr_keys, jlr, jlr.train(str(lr_path), niters=2))
        refs["glove"] = (jg.vocab.keys, jg, jg.train(niters=2))
        refs["s2v"] = _jax_s2v_over_xla_rows(corpus, hv, s2v_draws)
        stdout, stderr = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout[-6000:] + stderr[-3000:]
    out = {}
    for spec in specs:
        job = spec.get("job", "w2v")
        name = Path(spec["out"]).name
        got = [json.loads((Path(spec["out"]) / f"{job}_r{r}.json")
                          .read_text()) for r in (0, 1)]
        npz = Path(spec["out"]) / f"{job}_state_r0.npz"
        out[name] = (got, dict(np.load(npz)) if npz.exists() else None)
    refs["tmp"] = tmp
    return refs, out, stdout


def _s2v_jax_draws(V, d=D):
    """JAX ``infer_sentences``'s draws for the one batch of S2V_LINES."""
    key = jax.random.key(1 ^ 0xD0C)
    L = 1 << (max(len(ln.split()) for ln in S2V_LINES) - 1).bit_length()
    key, sub = jax.random.split(key)
    k_init, k = jax.random.split(sub)
    sent0 = np.asarray((jax.random.uniform(k_init, (S2V_S, d)) - 0.5) / d)
    passes = []
    for _ in range(S2V_NITERS):
        k, kb, kn = jax.random.split(k, 3)
        k1, k2 = jax.random.split(kn)
        passes.append((
            np.asarray(jax.random.randint(kb, (S2V_S, L), 0, W)),
            np.asarray(jax.random.randint(k1, (S2V_S, L, K), 0, V)),
            np.asarray(jax.random.uniform(k2, (S2V_S, L, K)))))
    return sent0, passes


def _jax_s2v_over_xla_rows(corpus, hv, draws):
    """JAX's sent2vec over an ``xla`` table holding the hybrid table's
    initial rows by key (the case JAX gets right)."""
    conf = dict(CONF, cluster={"transfer": "xla", "server_num": 1},
                worker={"minibatch": S2V_S})
    xm = JaxWord2Vec(config=JaxConfig().update(conf),
                     capacity_per_shard=CAP).build(corpus.tolist())
    jm = hv[5]
    hslots = np.asarray(jm._slot_of_vocab)
    xslots = np.asarray(xm._slot_of_vocab)
    n_hot = jm.table.n_hot
    state = {}
    for f, a in xm.table.state.items():
        uni = np.concatenate([hv[1][f"{f}@hot"], hv[1][f]]) if n_hot \
            else hv[1][f]
        state[f] = jnp.asarray(np.asarray(a).copy()).at[xslots].set(
            uni[hslots])
    xm.table.state = state
    return JaxSent2Vec(xm, seed=1).infer_sentences(S2V_LINES,
                                                   niters=S2V_NITERS)


JOBS = (["hybrid", "hybrid_sar", "xla_pull", "xla_serve", "tpu_w1",
         "tpu_w4q"] + list(WINDOWS)
        + ["lr_xla", "lr_tpu", "glove_xla", "glove_tpu", "s2v"])


# -- every job ----------------------------------------------------------------

@pytest.mark.parametrize("job", JOBS)
def test_replicas_are_equal_to_the_bit(runs, job):
    got = runs[1][job][0]
    assert [g["rank"] for g in got] == [0, 1]
    assert got[0]["sha"] == got[1]["sha"]
    assert got[0].get("losses") == got[1].get("losses")
    assert got[0]["timeouts"] == got[1]["timeouts"] == 0


# -- word2vec ------------------------------------------------------------------

@pytest.mark.parametrize("job", ["hybrid", "xla_pull", "xla_serve",
                                 "tpu_w1"])
def test_word2vec_hook_matches_jax_global_step(runs, job):
    refs, out, _ = runs
    ref = {"hybrid": refs["hybrid"], "xla_pull": refs["xla_pull"]}.get(
        job, refs["xla"])
    vocab, _, want, losses = ref[:4]
    got, state = out[job]
    m = got[0]["metrics"]
    assert m["steps"] == STEPS and m["processes"] == 2
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
    if job == "tpu_w1":
        a = _by_key(state, KeyIndex(SHARDS, CAP), vocab.keys)
        b = _by_key(want, KeyIndex(1, CAP), vocab.keys)
    else:
        a, b = state, want
    for f in b:
        _envelope(a[f], b[f], f"{job} {f}")
    if job == "hybrid":
        n_hot = want["h@hot"].shape[0]
        assert n_hot > 0 and a["h@hot"].shape == (n_hot, D)
        assert any(k.endswith(":hot") for k in m["push_paths"])


def test_hybrid_collective_knob_is_inert_per_step(runs):
    """``collective: sparse_allreduce`` with ``push_window: 4``: ``train``
    fuses no group across processes (JAX's rule), so every push is a
    per-step push and the table is the plain hybrid run's, bit for bit,
    as JAX's probe printed them equal."""
    out = runs[1]
    assert out["hybrid_sar"][0][0]["sha"] == out["hybrid"][0][0]["sha"]
    assert out["hybrid_sar"][0][0]["metrics"]["push_window"] == 4


def test_window_knobs_leave_train_at_push_window_1(runs):
    """``push_window: 4, wire_quant: int8`` with ``inner_steps: 4`` across
    processes trains the ``push_window: 1`` run's tables bit for bit; the
    ``@ef`` planes exist, stay zero and ride the checkpoint."""
    out = runs[1]
    w1, w4 = out["tpu_w1"], out["tpu_w4q"]
    for f in ("h", "v", "h2sum", "v2sum"):
        assert w4[0][0]["sha"][f] == w1[0][0]["sha"][f]
    assert w4[0][0]["metrics"]["push_window"] == 4
    assert not w4[0][0]["metrics"]["fused"]
    for f in ("h@ef", "v@ef"):
        assert f in w4[1] and not np.any(w4[1][f])
    ck = np.load(runs[0]["tmp"] / "tpu_w4q" / "ck.npz")
    for f in ("h@ef", "v@ef"):
        assert not np.any(ck[f"field__{f}"])


def test_serve_every_publishes_each_processs_replica(runs):
    got = runs[1]["xla_serve"][0]
    for g in got:
        assert g["serve"]["equal"] and g["serve"]["version"] >= 2
    assert got[0]["serve"] == got[1]["serve"]


# -- the transfer-level window push -----------------------------------------------

@pytest.mark.parametrize("job", list(WINDOWS))
def test_window_push_matches_jax_global_window(runs, job):
    init, want = runs[0][job]
    got, state = runs[1][job]
    for f in want:
        _envelope(state[f], want[f], f"{job} {f}")
    moved = [f for f in ("h", "v") if not np.array_equal(state[f], init[f])]
    assert moved == ["h", "v"]
    tr = got[0]["traffic"]
    assert tr["psum_bytes"] > 0
    assert tr["plan_compiles"] + tr["plan_cache_hits"] >= 1
    if WINDOWS[job][2] != "off":
        # the sparse_q rung ran: the residuals were banked
        assert tr["window_fmt_q"] >= 1
        assert any(np.any(state[f]) for f in state if f.endswith("@ef"))
    if job == "win_tpu_dense":
        assert tr["window_fmt_dense"] >= 1
    if job == "win_hybrid_sar_q":
        assert tr["collective_sparse_ar"] >= 1


# -- LR, GloVe and sent2vec -------------------------------------------------------

@pytest.mark.parametrize("job", ["lr_xla", "lr_tpu", "glove_xla",
                                 "glove_tpu"])
def test_lr_and_glove_match_jax_one_process_run(runs, job):
    refs, out, _ = runs
    model = job.split("_")[0]
    keys, jm, losses = refs[model]
    got, state = out[job]
    assert np.array_equal(state["keys"], keys)
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
    slots = jm.table.key_index.lookup(keys, create=False)
    for f, a in jm.table.state.items():
        _envelope(state[f], np.asarray(a)[slots], f"{job} {f}")
    assert got[0]["metrics"]["shards"] == (1 if job.endswith("xla")
                                           else SHARDS)


def test_sent2vec_matches_jax_over_the_rows_by_key(runs):
    want = runs[0]["s2v"]
    got, vecs = runs[1]["s2v"]
    assert got[0]["n_hot"] > 0 and got[0]["sentences"] == len(want)
    np.testing.assert_array_equal(vecs["ids"],
                                  np.array([i for i, _ in want], np.uint64))
    for a, (_, b) in zip(vecs["vectors"], want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_batch_share_pads_and_splits_process_major():
    a = np.arange(10).reshape(5, 2)
    t = np.arange(5, dtype=np.float32)
    s0 = batch_share((a, t), (-1, 0.0), 0, 2)
    s1 = batch_share((a, t), (-1, 0.0), 1, 2)
    np.testing.assert_array_equal(np.concatenate([s0[0], s1[0]])[:5], a)
    np.testing.assert_array_equal(s1[0][-1], [-1, -1])
    assert s0[1].shape == s1[1].shape == (3,)
    g = batch_share((np.ones((2, 6)),), (0,), 1, 2, axis=1, multiple=2)
    assert g[0].shape == (2, 4) and g[0][:, 2:].sum() == 0


def test_hot_head_is_the_same_in_every_process():
    """Every process computes ``HotColdPartition.from_counts`` over the
    whole vocab's counts: the head depends on the histogram only."""
    vocab = build_vocab(_corpus())
    a = HotColdPartition.from_counts(vocab.keys, vocab.counts)
    order = np.random.default_rng(0).permutation(len(vocab.keys))
    b = HotColdPartition.from_counts(vocab.keys[order], vocab.counts[order])
    assert a.n_hot > 0
    np.testing.assert_array_equal(a.hot_keys, b.hot_keys)


def test_local_shares_sum_to_the_global_batch():
    slots = np.arange(12).reshape(6, 2)
    parts = [batch_share((slots,), (-1,), r, 2)[0] for r in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(parts), slots)
