"""The port's decoder LM (``swiftmpi_tpu_torch/models/transformer.py``)
against the JAX package's, on the CPU, at JAX's test size (vocab 64,
d_model 32, 2 layers, 4 heads, d_ff 64, batch 4, seq 16).

JAX's parameters cross through ``convert.transformer_params_from_jax``;
the JAX references run jitted on its 8-device CPU mesh (``devices8``).
The seq- and expert-axis models are in ``test_torch_parallel.py``.
Tolerances: float32 logits, losses, aux and gradients within the repo
envelope ``|a - b| <= 1e-5 + 1e-3 |b|`` (products and reductions sum in
another order than XLA's); the pipelined logits within JAX's own test's
rtol 1e-4, atol 1e-5; a bf16 model's loss
within 2e-3 relative (bf16 rounds at other places in the two
frameworks: its products and norms round to bf16 8 bits of mantissa);
remat against no remat on the port exactly (the recompute runs the same
kernels on the same inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from swiftmpi_tpu.models import transformer as jtfm
from swiftmpi_tpu_torch.cluster.mesh import Mesh
from swiftmpi_tpu_torch.convert import transformer_params_from_jax
from swiftmpi_tpu_torch.models import transformer as tfm
from swiftmpi_tpu_torch.utils import tree

JCFG = jtfm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, d_ff=64, max_seq=64)
CFG = tfm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=4, d_ff=64, max_seq=64)
ENVELOPE = dict(rtol=1e-3, atol=1e-5)
BF16_LOSS_RTOL = 2e-3


def jax_params(jcfg=JCFG, seed=0):
    return jtfm.init_params(jax.random.key(seed), jcfg)


def port_params(jparams, device="cpu"):
    return transformer_params_from_jax(jax.tree.map(np.asarray, jparams),
                                       device)


def tokens(B=4, S=17, seed=1, vocab=64):
    """``(B, S)`` tokens; S = 17 leaves lm_loss 16 positions, which split
    over 8 ranks."""
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _grads_close(got, want, **tol):
    """Port grads (a pytree of tensors) against JAX's, leaf by leaf in
    flatten order."""
    jl = jax.tree.leaves(want)
    pl = tree.leaves(got)
    assert len(jl) == len(pl)
    for i, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   **tol, err_msg=f"leaf {i}")


def jax_ref(jcfg, jp, toks, jmesh=None):
    """One jitted JAX program: the logits and aux of ``forward`` on
    ``toks[:, :-1]`` (lm_loss's inputs), and lm_loss with its grads."""
    @jax.jit
    def run(p, t):
        logits, aux = jtfm.forward(p, t[:, :-1], jcfg, jmesh)
        loss, grads = jax.value_and_grad(
            lambda p: jtfm.lm_loss(p, t, jcfg, jmesh))(p)
        return logits, aux, loss, grads

    logits, aux, loss, grads = run(jp, jnp.asarray(toks))
    return dict(logits=np.asarray(logits), aux=float(aux),
                loss=float(loss), grads=grads)


def port_run(cfg, pp, toks, mesh=None):
    """The port's counterpart of :func:`jax_ref`."""
    t = torch.from_numpy(toks)
    logits, aux = tfm.forward(pp, t[:, :-1], cfg, mesh)
    loss, grads = tfm.value_and_grad(tfm.lm_loss, pp, t, cfg, mesh)
    return logits, aux, loss, grads


@pytest.fixture(scope="module")
def ref():
    """JAX's params, tokens and forward/loss references."""
    jp = jax_params()
    toks = tokens()
    return dict(jp=jp, toks=toks, **jax_ref(JCFG, jp, toks))


def test_forward_loss_and_grads_match_jax(ref):
    logits, aux, loss, grads = port_run(CFG, port_params(ref["jp"]),
                                        ref["toks"])
    assert logits.shape == (4, 16, 64) and float(aux) == ref["aux"] == 0.0
    np.testing.assert_allclose(_np(logits), ref["logits"], **ENVELOPE)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    _grads_close(grads, ref["grads"], **ENVELOPE)


def test_bf16_loss_matches_jax():
    """A bf16 model (bf16 params, products and norms): the loss within
    BF16_LOSS_RTOL of JAX's on the same bf16 parameters."""
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    jp = jax_params(jcfg)
    toks = tokens()
    want = float(jax.jit(lambda p, t: jtfm.lm_loss(p, t, jcfg))(
        jp, jnp.asarray(toks)))
    pp = port_params(jp)
    assert pp["blocks"]["wq"].dtype == torch.bfloat16
    got = float(tfm.lm_loss(pp, torch.from_numpy(toks), cfg))
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)


def test_causality_and_moe_variant():
    """Changing a future token never changes past logits; the MoE model
    (reference path, no mesh) is finite with a positive aux."""
    pp = tfm.init_params(0, CFG, "cpu")
    t1 = torch.from_numpy(tokens(S=16))
    t2 = t1.clone()
    t2[:, -1] = (t2[:, -1] + 1) % 64
    l1, _ = tfm.forward(pp, t1, CFG)
    l2, _ = tfm.forward(pp, t2, CFG)
    torch.testing.assert_close(l1[:, :-1], l2[:, :-1], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(l1[:, -1], l2[:, -1])
    cfg = dataclasses.replace(CFG, n_experts=4)
    logits, aux = tfm.forward(tfm.init_params(0, cfg, "cpu"), t1, cfg)
    assert torch.isfinite(logits).all() and float(aux) > 0.0


def test_moe_model_matches_jax():
    """The MoE model without an expert axis (the dense reference FFN):
    logits, aux and loss grads against JAX's."""
    jcfg = dataclasses.replace(JCFG, n_experts=4)
    jp = jax_params(jcfg)
    toks = tokens()
    want = jax_ref(jcfg, jp, toks)
    logits, aux, loss, grads = port_run(
        dataclasses.replace(CFG, n_experts=4), port_params(jp), toks)
    np.testing.assert_allclose(_np(logits), want["logits"], **ENVELOPE)
    np.testing.assert_allclose(float(aux), want["aux"], rtol=1e-5)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    _grads_close(grads, want["grads"], **ENVELOPE)


@pytest.mark.parametrize("n_stages,microbatches", [(2, 4), (4, 8)])
def test_pipelined_trunk_matches_jax(devices8, n_stages, microbatches):
    """forward_pipelined over stage = 2 and 4 (one block a stage): logits
    against JAX's pipelined model and the port's plain forward, and the
    grads of the next-token loss on its logits against JAX's."""
    jcfg = dataclasses.replace(JCFG, n_layers=n_stages)
    cfg = dataclasses.replace(CFG, n_layers=n_stages)
    jp = jax_params(jcfg)
    toks = tokens(B=8, S=16)
    tgt = tokens(B=8, S=16, seed=3)
    jmesh = JaxMesh(np.array(devices8[:n_stages]), ("stage",))

    def jloss(p, t):
        logits, _ = jtfm.forward_pipelined(p, t, jcfg, jmesh,
                                           num_microbatches=microbatches)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(logp, tgt[..., None], -1).mean(), logits

    (_, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, jnp.asarray(toks))
    pp = port_params(jp)
    mesh = Mesh({"stage": n_stages}, "cpu")
    t = torch.from_numpy(toks)

    def ploss(p, t):
        logits, _ = tfm.forward_pipelined(p, t, cfg, mesh,
                                          num_microbatches=microbatches)
        logp = torch.log_softmax(logits, -1)
        return -torch.gather(logp, -1,
                             torch.from_numpy(tgt).long()[..., None]).mean()

    logits, _ = tfm.forward_pipelined(pp, t, cfg, mesh,
                                      num_microbatches=microbatches)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    plain, _ = tfm.forward(pp, t, cfg)
    np.testing.assert_allclose(_np(logits), _np(plain), rtol=1e-5,
                               atol=1e-6)
    _, grads = tfm.value_and_grad(ploss, pp, t)
    _grads_close(grads, jg, **ENVELOPE)


def test_pipelined_rejects_moe_and_ring():
    mesh = Mesh({"stage": 2}, "cpu")
    t = torch.from_numpy(tokens())
    for cfg in (dataclasses.replace(CFG, n_experts=4),
                dataclasses.replace(CFG, attention="ring")):
        with pytest.raises(ValueError, match="pipelined trunk"):
            tfm.forward_pipelined(tfm.init_params(0, cfg, "cpu"), t, cfg, mesh)


def test_tp_dp_step_matches_jax(devices8, ref):
    """One SGD step under JAX's (4, 2) data x model mesh with Megatron
    shardings against the port's unsharded step: the loss and every
    updated leaf within the envelope; param_shardings' specs are JAX's
    PartitionSpecs, leaf for leaf."""
    jmesh = JaxMesh(np.array(devices8).reshape(4, 2), ("data", "model"))
    jp = jax_params()
    pp = port_params(jp)            # before sgd_step donates jp's buffers
    sh = jtfm.param_shardings(jp, JCFG, jmesh)
    toks = tokens(B=8, S=16)
    jnew, jloss = jtfm.sgd_step(jax.device_put(jp, sh),
                                jax.device_put(jnp.asarray(toks),
                                               NamedSharding(jmesh,
                                                             P("data"))),
                                JCFG)
    mesh = Mesh({"data": 4, "model": 2}, "cpu")
    specs = tfm.param_shardings(pp, CFG, mesh)
    for s, j in zip(_spec_leaves(specs), jax.tree.leaves(sh)):
        assert s == tuple(j.spec), (s, j.spec)
    new, loss = tfm.sgd_step(pp, torch.from_numpy(toks), CFG)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _grads_close(new, jnew, **ENVELOPE)


def _spec_leaves(specs):
    """param_shardings' specs (tuples) in flatten order."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(specs)
    return out


def test_sgd_loss_decreases():
    """A memorizable task (JAX's TestTraining): 30 SGD steps halve the
    loss; the step updates the params in place."""
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=32, n_layers=2,
                                n_heads=4, d_ff=64)
    params = tfm.init_params(0, cfg, "cpu")
    wq = params["blocks"]["wq"]
    t = torch.arange(16, dtype=torch.int32)[None].repeat(4, 1)
    first = None
    for _ in range(30):
        params, loss = tfm.sgd_step(params, t, cfg, lr=0.5)
        first = float(loss) if first is None else first
    assert params["blocks"]["wq"] is wq
    assert float(loss) < first * 0.5, (first, float(loss))


def _mm_in_backward(cfg, pp, t):
    """aten.mm calls during the backward of lm_loss (recomputed weight
    products show up here)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    flat = [p.detach().requires_grad_(True) for p in tree.leaves(pp)]
    loss = tfm.lm_loss(tree.unflatten(pp, flat), t, cfg)
    with Count():
        torch.autograd.grad(loss, flat)
    return Count.n


def test_remat_policies_match_no_remat_and_save_the_weight_products(ref):
    """remat with "dots" and "full" against no remat: two SGD steps, the
    losses and the updated params equal exactly.  "dots" saves the
    weight products (no aten.mm recomputed in the backward beyond no
    remat's), "full" recomputes them."""
    t = torch.from_numpy(ref["toks"])
    results = {}
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "full")):
        cfg = dataclasses.replace(CFG, remat=remat, remat_policy=policy)
        pp = port_params(ref["jp"])
        pp, l1 = tfm.sgd_step(pp, t, cfg, lr=0.1)
        pp, l2 = tfm.sgd_step(pp, t, cfg, lr=0.1)
        results[(remat, policy)] = (float(l1), float(l2),
                                    pp["embed"].clone())
    base = results[(False, "dots")]
    for k, (l1, l2, embed) in results.items():
        assert (l1, l2) == base[:2], (k, results)
        torch.testing.assert_close(embed, base[2], rtol=0, atol=0)
    pp = port_params(ref["jp"])
    plain = _mm_in_backward(CFG, pp, t)
    dots, full = (_mm_in_backward(dataclasses.replace(
        CFG, remat=True, remat_policy=p), pp, t) for p in ("dots", "full"))
    # no remat's backward is the product grads alone: "dots" adds none
    assert plain == dots < full, (plain, dots, full)


def test_unknown_remat_policy_rejected(ref):
    cfg = dataclasses.replace(CFG, remat=True, remat_policy="bogus")
    with pytest.raises(ValueError, match="remat_policy"):
        tfm.forward(port_params(ref["jp"]), torch.from_numpy(ref["toks"]),
                    cfg)
