"""The port's transformer trainer across processes (``models/trainer.py``
under ``python -m swiftmpi_tpu_torch.launch -np 2``) against the JAX
package's ``Trainer`` in one process on a CPU mesh with a ``data`` axis of
2, at JAX's test size (vocab 64, d_model 32, 2 layers, 4 heads, d_ff 64,
global batch 8, seq 16, AdamW, 3 steps).

One launch of 2 children (``mp_child w2v -spec``, ``job: trainer``) runs
every case; each child steps on its rows of every global batch.  Both
packages start from JAX's initial state (the children load JAX's
checkpoint).  Held: the losses and every leaf of params and optimizer
state within the repo envelope ``|a - b| <= 1e-5 + 1e-3 |b|`` (AdamW's
normalization may push up to ``ADAM_OUTSIDE_SHARE`` of a leaf's elements
out, as in ``test_torch_trainer.py``); bf16 losses within
``BF16_LOSS_RTOL``; the two replicas equal by the sha256 of every leaf;
process 0's checkpoint read by JAX's ``Trainer.load`` and by the port in
one process, bit for bit; the hooks seeing the same global values in
both processes.  The MoE case (4 experts, top 2) runs ``expert`` = 2
ranks inside each process against JAX's ``(data 2, expert 2)`` mesh,
with a capacity factor that drops no token on either side (JAX's expert
ranks take the global batch's halves, the port's each process's
halves).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from swiftmpi_tpu.models import transformer as jtfm
from swiftmpi_tpu.models.trainer import Trainer as JaxTrainer
from swiftmpi_tpu_torch.models import transformer as tfm
from swiftmpi_tpu_torch.models.trainer import Trainer, leaf_to_numpy
from swiftmpi_tpu_torch.utils import tree

REPO = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=100)
STEPS, B, S = 3, 8, 16
ADAM_OUTSIDE_SHARE = 1e-3
BF16_LOSS_RTOL = 2e-3
BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
MOE = dict(n_experts=4, moe_capacity_factor=4.0)

#: case -> (extra config, dtype, the port's in-process mesh, JAX's mesh
#: axes after ``data``)
CASES = {
    "dense": ({}, "float32", None, ()),
    "moe": (MOE, "float32", {"expert": 2}, (("expert", 2),)),
    "bf16": ({}, "bfloat16", None, ()),
}


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 64, (STEPS, B, S)).astype(np.int32)


def _jax_mesh(devices8, extra):
    names = ("data",) + tuple(a for a, _ in extra) + ("model",)
    shape = (2,) + tuple(n for _, n in extra) + (1,)
    n = int(np.prod(shape))
    return JaxMesh(np.array(devices8[:n]).reshape(shape), names)


def _jax_run(case, tmp, devices8, tokens):
    """JAX with data = 2: its initial state saved, then STEPS steps over
    the global batches; host copies of the losses and the final leaves."""
    extra, dtype, _, axes = CASES[case]
    jcfg = jtfm.TransformerConfig(**BASE, **extra,
                                  dtype=getattr(jnp, dtype))
    tr = JaxTrainer(jcfg, mesh=_jax_mesh(devices8, axes), **OPT)
    state = tr.init_state(jax.random.key(0))
    init = str(tmp / f"jax_init_{case}")
    tr.save(state, init)
    losses = []
    for t in tokens:
        state, loss = tr.step(state, jnp.asarray(t))
        losses.append(float(loss))
    final = [np.asarray(x) for x in jax.tree.leaves(state.tree())]
    return dict(init=init + ".npz", losses=losses, final=final)


def _spec(case, tmp, data):
    extra, dtype, mesh, _ = CASES[case]
    return {"job": "trainer", "cfg": dict(BASE, **extra, dtype=dtype),
            "opt": OPT, "mesh": mesh,
            "init": str(tmp / f"jax_init_{case}.npz"),
            "data": data, "device": "cpu", "out": str(tmp / case),
            "state": True, "hooks": case == "dense",
            "checkpoint": str(tmp / f"ck_{case}")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references (in this process) and one launch of 2 children
    over every case."""
    devices8 = jax.devices()
    if len(devices8) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("trainer_dp")
    tokens = _tokens()
    np.savez(tmp / "data.npz", tokens=tokens)
    jax_runs = {c: _jax_run(c, tmp, devices8, tokens) for c in CASES}
    specs = [_spec(c, tmp, str(tmp / "data.npz")) for c in CASES]
    (tmp / "specs.json").write_text(json.dumps(specs))
    env = dict(os.environ, SMTPU_DIST_TIMEOUT="60")
    r = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np", "2",
         "--", sys.executable, "-m", "swiftmpi_tpu_torch.testing.mp_child",
         "w2v", "-spec", str(tmp / "specs.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = {}
    for c in CASES:
        got = [json.loads((tmp / c / f"trainer_r{k}.json").read_text())
               for k in (0, 1)]
        state = np.load(tmp / c / "trainer_state_r0.npz")
        out[c] = dict(ranks=got, final=[state[f"leaf_{i}"]
                                        for i in range(len(state.files))])
    return dict(tmp=tmp, tokens=tokens, jax=jax_runs, port=out)


def _f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return a.astype(np.float32)


def _outside(got, want) -> float:
    a, b = _f32(got), _f32(want)
    return float(np.mean(np.abs(a - b) > 1e-5 + 1e-3 * np.abs(b)))


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_trainer_across_processes_matches_jax_data_axis(runs, case):
    """Two processes, each on its rows, against JAX's data = 2 mesh: the
    global losses within 1e-5 + 1e-3|b| on both processes, every leaf in
    the envelope (AdamW: up to ADAM_OUTSIDE_SHARE outside), the step
    counter exact."""
    port, ref = runs["port"][case], runs["jax"][case]
    for g in port["ranks"]:
        np.testing.assert_allclose(g["losses"], ref["losses"], rtol=1e-3,
                                   atol=1e-5)
    assert len(port["final"]) == len(ref["final"])
    for i, (got, want) in enumerate(zip(port["final"], ref["final"])):
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            assert _outside(got, want) <= ADAM_OUTSIDE_SHARE, (i, got.shape)


def test_bf16_trainer_across_processes_tracks_jax(runs):
    """bf16 params and moments: the two processes' global losses within
    the trainer's bf16 tolerance of JAX's data = 2 run."""
    for g in runs["port"]["bf16"]["ranks"]:
        np.testing.assert_allclose(g["losses"], runs["jax"]["bf16"]["losses"],
                                   rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_replicas_are_equal_to_the_bit(runs, case):
    """Every leaf of params and optimizer state has one sha256 on both
    processes, and so has the reported loss of every step."""
    a, b = runs["port"][case]["ranks"]
    assert (a["rank"], b["rank"]) == (0, 1) and a["dp"] == 2
    assert a["leaf_sha"] == b["leaf_sha"]
    assert a["losses"] == b["losses"]


def test_two_processes_match_one_process_over_the_same_batches(runs):
    """The port's two processes against the port's one process stepping
    on the whole global batches: the losses and leaves within the
    envelope (the grads are summed in another order)."""
    tr = Trainer(tfm.TransformerConfig(**BASE), device="cpu", **OPT)
    state = tr.load(runs["jax"]["dense"]["init"])
    losses = [float(tr.step(state, t)[1]) for t in runs["tokens"]]
    np.testing.assert_allclose(runs["port"]["dense"]["ranks"][0]["losses"],
                               losses, rtol=1e-3, atol=1e-5)
    for got, want in zip(runs["port"]["dense"]["final"],
                         tree.leaves(state.tree())):
        assert _outside(got, leaf_to_numpy(want)) <= ADAM_OUTSIDE_SHARE


@pytest.mark.parametrize("case", ["dense", "bf16"])
def test_process_zeros_checkpoint_crosses_both_ways(runs, case, devices8):
    """Process 0's checkpoint (written after the steps, every process at
    a barrier) loads bit for bit in JAX's Trainer and in the port's in
    one process, which then steps on as a fresh one-process trainer does
    from the same state; the children's start was JAX's file.  JAX's own
    ``Trainer.load`` refuses any bf16 file, its own included (the npz
    holds 2-byte void leaves, which ``make_array_from_callback`` does not
    take), so the bf16 case holds the port's load only."""
    extra, dtype, _, axes = CASES[case]
    ck = str(runs["tmp"] / f"ck_{case}")
    final = runs["port"][case]["final"]
    jcfg = jtfm.TransformerConfig(**BASE, **extra,
                                  dtype=getattr(jnp, dtype))
    if dtype == "float32":
        js = JaxTrainer(jcfg, mesh=_jax_mesh(devices8, axes),
                        **OPT).load(ck)
        for a, b in zip(jax.tree.leaves(js.tree()), final):
            np.testing.assert_array_equal(np.asarray(a), b)
    cfg = tfm.TransformerConfig(**BASE, dtype=getattr(torch, dtype))
    tr = Trainer(cfg, device="cpu", **OPT)
    ps = tr.load(ck)
    for a, b in zip(tree.leaves(ps.tree()), final):
        np.testing.assert_array_equal(leaf_to_numpy(a), b)
    assert int(ps.step) == STEPS
    twin = Trainer(cfg, device="cpu", **OPT).load(ck)
    t = runs["tokens"][0]
    # the embedding's backward sums repeated tokens in no fixed order
    # unless torch picks its deterministic kernels
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, la = tr.step(ps, t)
        _, lb = Trainer(cfg, device="cpu", **OPT).step(twin, t)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert float(la) == float(lb)
    for a, b in zip(tree.leaves(ps.tree()), tree.leaves(twin.tree())):
        assert torch.equal(a, b)


def test_hooks_see_the_global_values_on_every_process(runs):
    """The serving publisher's last snapshot equals the params, the
    numerics plane stages one bundle a step over the summed grads (the
    same numbers on both processes), the controller evaluates every 2
    steps, and the reported losses are the global ones."""
    a, b = (g["hooks"] for g in runs["port"]["dense"]["ranks"])
    for h in (a, b):
        assert h["snapshot"] == [STEPS, STEPS] and h["snapshot_equal"]
        assert h["numerics"]["bundles"] == STEPS
        assert h["numerics"]["nonfinite"] == 0
        assert h["evaluations"] == 1
    assert a["numerics"]["latest"] == b["numerics"]["latest"]
    np.testing.assert_allclose(a["numerics"]["latest"]["loss_sum"],
                               runs["port"]["dense"]["ranks"][0]["losses"][-1],
                               rtol=1e-6)


def test_run_ignores_the_pipeline_across_processes(monkeypatch):
    """``run(pipeline=K)`` prefetches in one process only (JAX's rule):
    with a data axis of 2 it steps the batches as they come, through the
    grads' sum (here an identity stand-in for the exchange)."""
    from swiftmpi_tpu_torch.models import trainer as tmod
    one = Trainer(tfm.TransformerConfig(**BASE), device="cpu", **OPT)
    monkeypatch.setattr(tmod, "process_count", lambda: 2)
    monkeypatch.setattr(tmod, "psum_many",
                        lambda xs: [x.clone() * 2 for x in xs])
    tr = Trainer(tfm.TransformerConfig(**BASE), device="cpu", **OPT)
    assert (tr.dp, one.dp) == (2, 1)
    s2, l2 = tr.run(tr.init_state(0), _tokens()[:, :4], pipeline=2)
    s1, l1 = one.run(one.init_state(0), _tokens()[:, :4])
    assert tr.pipeline_stats == {}
    assert [float(x) for x in l2] == [float(x) for x in l1]
    for a, b in zip(tree.leaves(s2.params), tree.leaves(s1.params)):
        assert torch.equal(a, b)
    assert tr.meter.stats()["items"] == 2 * one.meter.stats()["items"]
