"""The port's transformer trainer (``swiftmpi_tpu_torch/models/
{trainer,optim}.py``) against the JAX package's, on the CPU, at JAX's
test size (vocab 64, d_model 32, 2 layers, 4 heads, d_ff 64, batch 8,
seq 16).

The JAX trainer takes one step and saves; the port loads that file
through ``convert.trainer_state_from_jax_npz`` (leaf by leaf, in the
order ``jax.tree.flatten(state.tree())`` gives), then both take the same
4 steps.  Tolerances: the losses within 1e-4 relative; the params and the
optimizer's moments within the repo envelope ``|a - b| <= 1e-5 + 1e-3
|b|``, except that AdamW's normalization ``m / (sqrt(v) + eps)`` turns a
last-bit difference of a gradient element near zero into an update that
differs by up to the learning rate: at most ``ADAM_OUTSIDE_SHARE`` of a
leaf's elements may leave the envelope (SGD none); a bf16 trainer's
losses within 2e-3 relative.  Save and load on the port resume exactly;
checkpoints cross between the packages both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmpi_tpu.models import transformer as jtfm
from swiftmpi_tpu.models.trainer import Trainer as JaxTrainer
from swiftmpi_tpu.obs import numerics as jnum
from swiftmpi_tpu_torch.cluster.mesh import Mesh
from swiftmpi_tpu_torch.convert import trainer_state_from_jax_npz
from swiftmpi_tpu_torch.models import transformer as tfm
from swiftmpi_tpu_torch.models.optim import warmup_cosine_decay
from swiftmpi_tpu_torch.models.trainer import Trainer, TrainState
from swiftmpi_tpu_torch.obs import numerics as pnum
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.testing.faults import FaultPlan, InjectedFault
from swiftmpi_tpu_torch.utils import tree

JCFG = jtfm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, d_ff=64)
CFG = tfm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=4, d_ff=64)
OPT = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=100)
STEPS = 4
ADAM_OUTSIDE_SHARE = 1e-3
BF16_LOSS_RTOL = 2e-3


def batches(n=STEPS, B=8, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (B, S)).astype(np.int32) for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _outside(got, want) -> float:
    """Share of elements outside |a - b| <= 1e-5 + 1e-3 |b|."""
    a, b = _np(got), _np(want)
    return float(np.mean(np.abs(a - b) > 1e-5 + 1e-3 * np.abs(b)))


def _jax_from(optimizer, tmp, jcfg=JCFG):
    """JAX: one step, save, then STEPS more; host copies of what the
    comparisons need (the steps donate their state)."""
    tr = JaxTrainer(jcfg, optimizer=optimizer, **OPT)
    state = tr.init_state(jax.random.key(0))
    state, _ = tr.step(state, jnp.asarray(batches(1, seed=9)[0]))
    path = str(tmp / f"jax_{optimizer}_{jcfg.dtype.__name__}")
    tr.save(state, path)
    saved = [np.asarray(x) for x in jax.tree.flatten(state.tree())[0]]
    treedef = repr(jax.tree.structure(state.tree()))
    losses = []
    for toks in batches():
        state, loss = tr.step(state, jnp.asarray(toks))
        losses.append(float(loss))
    final = [np.asarray(x) for x in jax.tree.flatten(state.tree())[0]]
    return dict(path=path, saved=saved, treedef=treedef, losses=losses,
                final=final)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    return {opt: _jax_from(opt, tmp) for opt in ("adamw", "sgd")}


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_steps_from_a_jax_checkpoint_match_jax(jax_runs, optimizer):
    """The port loads JAX's checkpoint leaf for leaf (exactly, in JAX's
    flatten order, under JAX's treedef string) and its next steps track
    JAX's: losses within 1e-4, every leaf of params and optimizer state
    within the envelope up to ADAM_OUTSIDE_SHARE (AdamW) or 0 (SGD)."""
    run = jax_runs[optimizer]
    tr = Trainer(CFG, optimizer=optimizer, device="cpu", **OPT)
    state = trainer_state_from_jax_npz(run["path"], tr)
    flat = tree.leaves(state.tree())
    assert len(flat) == len(run["saved"])
    for i, (got, want) in enumerate(zip(flat, run["saved"])):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"leaf {i}")
    assert tree.treedef_repr(state.tree()) == run["treedef"]
    losses = []
    for toks in batches():
        state, loss = tr.step(state, toks)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    share = ADAM_OUTSIDE_SHARE if optimizer == "adamw" else 0.0
    for i, (got, want) in enumerate(zip(tree.leaves(state.tree()),
                                        run["final"])):
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert _outside(got, want) <= share, (i, _outside(got, want))
    assert int(state.step) == 1 + STEPS


def test_bf16_trainer_tracks_jax(tmp_path):
    """bf16 params and moments: from JAX's bf16 checkpoint, the losses of
    the next steps within BF16_LOSS_RTOL of JAX's."""
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    run = _jax_from("adamw", tmp_path, jcfg)
    tr = Trainer(dataclasses.replace(CFG, dtype=torch.bfloat16),
                 device="cpu", **OPT)
    state = tr.load(run["path"])
    assert state.params["embed"].dtype == torch.bfloat16
    assert tree.leaves(state.opt_state)[1].dtype == torch.bfloat16
    losses = [float(tr.step(state, t)[1]) for t in batches()]
    np.testing.assert_allclose(losses, run["losses"], rtol=BF16_LOSS_RTOL)


def test_schedule_matches_optax():
    import optax
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 20)
    for c in (0, 1, 2, 3, 4, 11, 19, 20, 25):
        got = warmup_cosine_decay(torch.tensor(c, dtype=torch.int32), 0.0,
                                  1e-2, 3, 20)
        np.testing.assert_allclose(float(got), float(sched(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))
    assert float(warmup_cosine_decay(torch.tensor(0, dtype=torch.int32),
                                     0.0, 1e-2, 3, 20)) == 0.0


def test_treedef_matches_jax_for_each_layout():
    """The checkpoint's treedef string is JAX's for adamw, sgd and an MoE
    model (its MoEParams named tuple)."""
    for opt, jcfg, cfg in (
            ("adamw", JCFG, CFG), ("sgd", JCFG, CFG),
            ("adamw", dataclasses.replace(JCFG, n_experts=4),
             dataclasses.replace(CFG, n_experts=4))):
        js = JaxTrainer(jcfg, optimizer=opt).init_state(jax.random.key(0))
        ps = Trainer(cfg, optimizer=opt, device="cpu").init_state(0)
        assert tree.treedef_repr(ps.tree()) == repr(
            jax.tree.structure(js.tree()))
        assert [tuple(x.shape) for x in tree.leaves(ps.tree())] == [
            tuple(x.shape) for x in jax.tree.leaves(js.tree())]


def test_save_load_resume_exact_and_cross_packages(tmp_path, jax_runs):
    """Port save -> port load resumes bit for bit; JAX's Trainer.load
    reads the port's file and the port's Trainer.load reads JAX's."""
    tr = Trainer(CFG, device="cpu", **OPT)
    state = tr.init_state(0)
    for toks in batches(3, seed=4):
        state, _ = tr.step(state, toks)
    tr.save(state, str(tmp_path / "ck"))
    saved = [x.clone() for x in tree.leaves(state.tree())]
    tr2 = Trainer(CFG, device="cpu", **OPT)
    sb = tr2.load(str(tmp_path / "ck"))
    assert int(sb.step) == 3
    for a, b in zip(tree.leaves(sb.tree()), saved):
        assert torch.equal(a, b)
    la = lb = None
    for toks in batches(2, seed=10):
        state, la = tr.step(state, toks)
        sb, lb = tr2.step(sb, toks)
    assert float(la) == float(lb)
    for a, b in zip(tree.leaves(state.params), tree.leaves(sb.params)):
        assert torch.equal(a, b)
    # the JAX package reads the port's file, leaf for leaf
    js = JaxTrainer(JCFG, **OPT).load(str(tmp_path / "ck"))
    for a, b in zip(jax.tree.leaves(js.tree()), saved):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and the port's Trainer.load reads JAX's
    ps = Trainer(CFG, device="cpu", **OPT).load(jax_runs["adamw"]["path"])
    for a, b in zip(tree.leaves(ps.tree()), jax_runs["adamw"]["saved"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_load_rejects_config_and_optimizer_mismatch(tmp_path):
    tr = Trainer(CFG, device="cpu")
    tr.save(tr.init_state(0), str(tmp_path / "ck"))
    other = Trainer(dataclasses.replace(CFG, d_model=64, n_heads=8),
                    device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        other.load(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="mismatch"):
        Trainer(CFG, optimizer="sgd", device="cpu").load(
            str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="config mismatch"):
        Trainer(dataclasses.replace(CFG, dtype=torch.bfloat16),
                device="cpu").load(str(tmp_path / "ck"))


def test_run_pipeline_matches_run_and_faults_count_consumed_steps():
    """run(pipeline=2) gives run(0)'s losses and params bit for bit on the
    (4, 2) data x model layout, with the producer's stats; a
    crash-at-step-3 plan trips after exactly 3 consumed steps with the
    pipeline 4 deep."""
    mesh = Mesh({"data": 4, "model": 2}, "cpu")

    def run(pipeline):
        tr = Trainer(CFG, mesh=mesh, **OPT)
        state, losses = tr.run(tr.init_state(0), batches(6), pipeline)
        return tr, state, [float(x) for x in losses]

    tr0, s0, l0 = run(0)
    tr1, s1, l1 = run(2)
    assert l0 == l1
    assert torch.equal(s0.params["blocks"]["wq"], s1.params["blocks"]["wq"])
    assert tr0._host_steps == tr1._host_steps == 6
    assert tr0.pipeline_stats == {}
    assert tr1.pipeline_stats["produced"] == 6
    assert tr1.pipeline_stats["consumed"] == 6
    assert tr1.param_specs["blocks"]["wq"] == (None, None, "model")
    tr = Trainer(CFG, mesh=mesh, **OPT)
    seen = []

    def observer(ev, step):
        seen.append((ev, step))

    faults.add_observer(observer)
    try:
        faults.install(FaultPlan().crash_at_step(3))
        with pytest.raises(InjectedFault):
            tr.run(tr.init_state(0), batches(10), pipeline=4)
    finally:
        faults.clear()
        faults.remove_observer(observer)
    assert tr._host_steps == 3
    assert [s for ev, s in seen if ev == "step"] == [0, 1, 2, 3]


def test_data_model_layout_matches_unsharded_and_checks_the_batch():
    """data x model changes no value on one device: the same step as
    without a mesh; a batch the data axis does not divide raises."""
    t = batches(1)[0]
    s_mesh, l_mesh = Trainer(CFG, mesh=Mesh({"data": 4, "model": 2}, "cpu"),
                             **OPT).step(Trainer(CFG, device="cpu")
                                         .init_state(0), t)
    s_one, l_one = Trainer(CFG, device="cpu", **OPT).step(
        Trainer(CFG, device="cpu").init_state(0), t)
    assert float(l_mesh) == float(l_one)
    for a, b in zip(tree.leaves(s_mesh.params), tree.leaves(s_one.params)):
        assert torch.equal(a, b)
    tr = Trainer(CFG, mesh=Mesh({"data": 3}, "cpu"))
    with pytest.raises(ValueError, match="data axis"):
        tr.step(tr.init_state(0), t)


def test_snapshot_numerics_and_controller_hooks():
    """A serving publisher gets a params-only snapshot equal to the
    params; an armed NumericsCollector one bundle a step; an observe-only
    controller an evaluation every ``every`` steps."""
    from swiftmpi_tpu_torch.control.controller import (ControlSettings,
                                                       Controller)
    from swiftmpi_tpu_torch.serve import SnapshotPublisher
    tr = Trainer(CFG, device="cpu", **OPT)
    tr.serve_publisher = SnapshotPublisher(every=2)
    tr.controller = Controller(ControlSettings(enabled=True, every=2))
    col = pnum.NumericsCollector()
    tr.arm_numerics(col)
    state = tr.init_state(0)
    for toks in batches(4):
        state, loss = tr.step(state, toks)
    snap = tr.serve_publisher.latest()
    assert snap.version == 2 and snap.step == 4
    for a, b in zip(tree.leaves(snap.state), tree.leaves(state.params)):
        np.testing.assert_array_equal(a, b.numpy())
    assert isinstance(snap.state["blocks"], dict)
    r = col.read()
    assert r["bundles"] == 4 and r["nonfinite"] == 0
    assert r["latest"]["gsq"] > 0 and r["latest"]["loss_n"] == 1.0
    np.testing.assert_allclose(r["latest"]["loss_sum"], float(loss),
                               rtol=1e-6)
    assert tr.controller._evals == 2


class _Catch:
    """A collector that keeps the bundle handed to stage_traced."""

    def stage_traced(self, bundle, ef_mass):
        self.bundle = {k: float(np.asarray(v)) for k, v in bundle.items()}
        self.ef_mass = ef_mass


def test_stage_dense_matches_jax():
    """The dense bundle over poisoned pytrees (NaN and inf elements
    masked out of the norms, counted as nonfinite): within the envelope
    of JAX's, the counts exact."""
    rng = np.random.default_rng(2)

    def pytree(scale):
        t = {"a": rng.normal(size=(5, 3)).astype(np.float32) * scale,
             "b": {"c": rng.normal(size=(7,)).astype(np.float32) * scale}}
        return t

    params, grads, updates = pytree(1.0), pytree(0.1), pytree(0.01)
    grads["a"][1, 2] = np.nan
    updates["b"]["c"][3] = np.inf
    loss = np.float32(2.5)
    jc, pc = _Catch(), _Catch()
    jnum.stage_dense(jc, *(jax.tree.map(jnp.asarray, t)
                           for t in (params, grads, updates)),
                     jnp.asarray(loss))
    tt = [jax.tree.map(lambda a: torch.from_numpy(a.copy()), t)
          for t in (params, grads, updates)]
    pnum.stage_dense(pc, *tt, torch.tensor(loss))
    assert pc.bundle.keys() == jc.bundle.keys() and pc.ef_mass == {}
    assert pc.bundle["nonfinite"] == jc.bundle["nonfinite"] == 2
    for k, v in jc.bundle.items():
        np.testing.assert_allclose(pc.bundle[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    sq, nf = pnum.tree_stats(tt[1])
    jsq, jnf = jnum.tree_stats(jax.tree.map(jnp.asarray, grads))
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-5)
    assert int(nf) == int(jnf) == 1


def test_trainer_refuses_processes_and_the_cpu_unless_asked(monkeypatch):
    """More than one process (refused until ROADMAP A15b was ported) puts
    the data axis across them (``tests/test_torch_trainer_dp.py`` holds it
    against JAX); with no CUDA device the trainer, a mesh and fresh
    params raise unless ``device="cpu"``."""
    from swiftmpi_tpu_torch.models import trainer as tmod
    monkeypatch.setattr(tmod, "process_count", lambda: 2)
    tr = Trainer(CFG, device="cpu")
    assert (tr.dp, tr.dp_rank) == (2, 0)
    monkeypatch.setattr(tmod, "process_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh({"seq": 4})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(0, CFG)
    assert isinstance(Trainer(CFG, device="cpu").init_state(0), TrainState)
