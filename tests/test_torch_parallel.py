"""The port's rank-axis collectives, ring and Ulysses attention,
expert-parallel MoE and the GPipe pipeline (``swiftmpi_tpu_torch/
parallel/``) against the JAX package's on its 8-device CPU mesh, alone
and inside the transformer (its ring@8, ulysses@4 and expert = 8 models,
at ``test_torch_transformer.py``'s size).

Every axis of the port runs as n logical ranks on one device, its
tensors stacked over the ranks; the JAX side runs ``shard_map`` over
``devices8``.  The same numpy inputs go to both.  Tolerances: the
exchanges and permutations are copies, so exact; attention, MoE and the
pipeline in float32 within JAX's own tests' tolerance (rtol 2e-4, atol
2e-5: the online softmax and the products sum in another order than
XLA's), their gradients within the repo envelope ``|a - b| <= 1e-5 +
1e-3 |b|``; the aux losses within 1e-5 relative.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from swiftmpi_tpu.parallel import collectives as jcoll
from swiftmpi_tpu.parallel import moe as jmoe
from swiftmpi_tpu.parallel import pipeline as jpipe
from swiftmpi_tpu_torch.cluster.mesh import Mesh
from swiftmpi_tpu_torch.convert import transformer_params_from_jax
from swiftmpi_tpu_torch.kernels import ring
from swiftmpi_tpu_torch.models import transformer as tfm
from swiftmpi_tpu_torch.parallel import (moe, pipeline, rank_all_to_all,
                                         rank_pmean, rank_psum, ring_permute)
from tests.test_torch_transformer import (CFG, JCFG, _grads_close, _np,
                                          jax_params, jax_ref, port_params,
                                          port_run, tokens)

# the packages export functions named like these modules
jra = importlib.import_module("swiftmpi_tpu.parallel.ring_attention")
pra = importlib.import_module("swiftmpi_tpu_torch.parallel.ring_attention")

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)
ENVELOPE = dict(rtol=1e-3, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jmesh(devices8, name, n):
    return JaxMesh(np.array(devices8[:n]), (name,))


# -- collectives -------------------------------------------------------------

def test_rank_collectives_match_jax(devices8):
    """psum/pmean reduce the rank dim; ring_permute moves block j to j+1
    (JAX's test_collective_wrappers on the same values)."""
    mesh = _jmesh(devices8, "seq", 8)
    x = jnp.arange(8.0)

    def body(x):
        return (jcoll.psum(x, "seq"), jcoll.pmean(x, "seq"),
                jcoll.ring_permute(x, "seq"))

    s, m, r = jax.shard_map(body, mesh=mesh, in_specs=P("seq"),
                            out_specs=(P(), P(), P("seq")))(x)
    xs = torch.arange(8.0).reshape(8, 1)
    assert float(rank_psum(xs)) == float(s[0]) == 28.0
    assert float(rank_pmean(xs)) == float(m[0])
    np.testing.assert_array_equal(ring_permute(xs).reshape(-1).numpy(),
                                  np.asarray(r))
    np.testing.assert_array_equal(ring_permute(xs, shift=3)[:, 0].numpy(),
                                  np.roll(np.arange(8.0), 3))


@pytest.mark.parametrize("split,concat", [(2, 1), (1, 2), (0, 1), (1, 0)])
def test_rank_all_to_all_matches_jax(devices8, split, concat):
    """JAX's tiled all_to_all inside shard_map over 4 devices against the
    port's over 4 stacked ranks: the same values, exactly."""
    n = 4
    mesh = _jmesh(devices8, "seq", n)
    local = (8, 4, 12)
    x = _normal(3, (n, *local))
    spec = P("seq")

    def body(xl):
        return jcoll.all_to_all(xl[0], "seq", split, concat)[None]

    want = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)(
        jnp.asarray(x))
    got = rank_all_to_all(_t(x), split_axis=split, concat_axis=concat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rank_all_to_all_gradient_is_the_inverse_exchange():
    """RingExchange's backward is the same exchange of the gradient:
    d/dx sum(w * a2a(x)) is a2a's inverse applied to w (the plain
    version on the CPU); the port's own exchange is an involution."""
    n = 4
    x = _t(_normal(4, (n, 2, 8, 3))).requires_grad_(True)
    w = _t(_normal(5, (n, 2 * n, 2, 3)))
    y = rank_all_to_all(x, split_axis=1, concat_axis=0)
    (y * w).sum().backward()
    back = rank_all_to_all(w, split_axis=0, concat_axis=1)
    np.testing.assert_array_equal(x.grad.numpy(), back.numpy())
    z = _t(_normal(6, (n, n, 5, 2)))
    np.testing.assert_array_equal(
        ring.RingExchange.apply(ring.RingExchange.apply(z)).numpy(),
        z.numpy())
    with pytest.raises(ValueError, match="does not split"):
        rank_all_to_all(_t(_normal(7, (n, 6, 2))), 0, 1)


# -- attention ---------------------------------------------------------------

def _qkv(B=2, S=64, H=8, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _jax_attn(fn, qkv, w, *args, **kw):
    """JAX's output and the grads of sum(w * out) w.r.t. q, k, v."""
    def loss(q, k, v):
        out = fn(q, k, v, *args, **kw)
        return (out * w).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in qkv))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_attn(fn, qkv, w, *args, **kw):
    ts = [_t(a).requires_grad_(True) for a in qkv]
    out = fn(*ts, *args, **kw)
    (out * _t(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode,n", [("ring", 8), ("ulysses", 4)])
def test_context_parallel_attention_matches_jax(devices8, mode, n, causal):
    """Ring at n = 8 and Ulysses at n = 4 (heads % n == 0), forward and
    the grads of q, k, v, against JAX's on the same mesh size and
    against the port's full_attention."""
    qkv = _qkv(seed=1 if causal else 2)
    w = _normal(9, qkv[0].shape)
    jfn = {"ring": jra.ring_attention, "ulysses": jra.ulysses_attention}
    pfn = {"ring": pra.ring_attention, "ulysses": pra.ulysses_attention}
    want, wgrads = _jax_attn(jfn[mode], qkv, w, _jmesh(devices8, "seq", n),
                             causal=causal)
    got, grads = _port_attn(pfn[mode], qkv, w, Mesh({"seq": n}, "cpu"),
                            causal=causal)
    np.testing.assert_allclose(got, want, **ATTN_TOL, err_msg=mode)
    for g, wg in zip(grads, wgrads):
        np.testing.assert_allclose(g, wg, **ENVELOPE, err_msg=mode)
    full, _ = _port_attn(pra.full_attention, qkv, w, causal=causal)
    np.testing.assert_allclose(got, full, **ATTN_TOL, err_msg=mode)


def test_full_attention_matches_jax_in_bf16():
    """bf16 q, k, v: float32 scores and softmax, probabilities cast to
    bf16 before the PV product, the output in bf16; within two bf16 ulps
    of JAX's (the products sum in another order)."""
    q, k, v = (a[:, :32] for a in _qkv(seed=5))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jra.full_attention(*jb, causal=True), np.float32)
    pb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = pra.full_attention(*pb, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_ulysses_rejects_indivisible_heads():
    q, k, v = (_t(a) for a in _qkv(H=6))
    with pytest.raises(ValueError, match="heads=6"):
        pra.ulysses_attention(q, k, v, Mesh({"seq": 4}, "cpu"))


# -- the transformer over the seq and expert axes ----------------------------

@pytest.fixture(scope="module")
def model_ref():
    """The transformer test's JAX params, tokens and references."""
    jp = jax_params()
    toks = tokens()
    return dict(jp=jp, toks=toks, **jax_ref(JCFG, jp, toks))


@pytest.mark.parametrize("mode,n", [("ring", 8), ("ulysses", 4)])
def test_context_parallel_model_matches_jax(devices8, model_ref, mode, n):
    """attention="ring" over seq = 8 and "ulysses" over seq = 4: logits
    and loss grads against JAX's on the same mesh, logits against the
    full-attention model."""
    jcfg = dataclasses.replace(JCFG, attention=mode)
    want = jax_ref(jcfg, model_ref["jp"], model_ref["toks"],
                   JaxMesh(np.array(devices8[:n]), ("seq",)))
    logits, _, loss, grads = port_run(
        dataclasses.replace(CFG, attention=mode),
        port_params(model_ref["jp"]), model_ref["toks"],
        Mesh({"seq": n}, "cpu"))
    np.testing.assert_allclose(_np(logits), want["logits"], **ATTN_TOL)
    np.testing.assert_allclose(_np(logits), model_ref["logits"], **ATTN_TOL)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    _grads_close(grads, want["grads"], **ENVELOPE)


def test_expert_parallel_model_matches_jax_and_reference(devices8):
    """8 experts over expert = 8 at capacity factor 8 (no drops): logits
    and aux against JAX's expert-parallel model and against the port's
    reference path; loss grads against JAX's."""
    jcfg = dataclasses.replace(JCFG, n_experts=8, moe_capacity_factor=8.0)
    cfg = dataclasses.replace(CFG, n_experts=8, moe_capacity_factor=8.0)
    jp = jax_params(jcfg)
    toks = tokens()
    want = jax_ref(jcfg, jp, toks, JaxMesh(np.array(devices8), ("expert",)))
    pp = port_params(jp)
    logits, aux, loss, grads = port_run(cfg, pp, toks,
                                        Mesh({"expert": 8}, "cpu"))
    np.testing.assert_allclose(_np(logits), want["logits"], **ATTN_TOL)
    np.testing.assert_allclose(float(aux), want["aux"], rtol=1e-4)
    ref_logits, ref_aux = tfm.forward(pp, torch.from_numpy(toks[:, :-1]),
                                      cfg)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **ATTN_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-4)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    _grads_close(grads, want["grads"], **ENVELOPE)


# -- MoE ---------------------------------------------------------------------

def _moe_params(seed, d, dff, E):
    return jmoe.init_moe_params(jax.random.key(seed), d, dff, E)


def _to_port(jparams):
    return transformer_params_from_jax(
        {"moe": jax.tree.map(np.asarray, jparams)}, "cpu")["moe"]


@pytest.mark.parametrize("k", [1, 2])
def test_moe_expert_parallel_matches_jax_and_reference(devices8, k):
    """Expert axis of 8 ranks, capacity factor 8 (no token drops): the
    output, the aux loss and the grads of every weight and of x against
    JAX's moe_ffn on the 8-device mesh, and the output against the port's
    dense reference."""
    n, d, dff, E, T = 8, 8, 16, 8, 64
    jp = _moe_params(0, d, dff, E)
    x = _normal(1, (T, d))
    w = _normal(2, (T, d))
    jmesh = _jmesh(devices8, "expert", n)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jmesh, k=k, capacity_factor=8.0)
        return (y * w).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    pp = moe.MoEParams(*(t.requires_grad_(True) for t in _to_port(jp)))
    px = _t(x).requires_grad_(True)
    y, aux = moe.moe_ffn(pp, px, Mesh({"expert": n}, "cpu"), k=k,
                         capacity_factor=8.0)
    ((y * _t(w)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **ATTN_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    for f, g in zip(moe.MoEParams._fields, pp):
        np.testing.assert_allclose(g.grad.numpy(),
                                   np.asarray(getattr(jg, f)), **ENVELOPE,
                                   err_msg=f)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jgx), **ENVELOPE)
    y_ref, aux_ref = moe.moe_ffn_reference(_to_port(jp), _t(x), k=k)
    np.testing.assert_allclose(y.detach().numpy(), y_ref.numpy(), **ATTN_TOL)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)


def test_moe_capacity_drops_are_passthrough_zero(devices8):
    """Everything routed to expert 0 at capacity factor 0.25: the dropped
    tokens' rows are zero, the kept ones equal JAX's."""
    n, d, dff, E, T = 2, 4, 8, 2, 16
    jp = _moe_params(0, d, dff, E)
    jp = jp._replace(router=jnp.zeros_like(jp.router).at[:, 0].set(10.0))
    x = _normal(1, (T, d))
    jmesh = _jmesh(devices8, "expert", n)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_ffn(
        p, x, jmesh, k=1, capacity_factor=0.25))(jp, jnp.asarray(x))
    y, _ = moe.moe_ffn(_to_port(jp), _t(x), Mesh({"expert": n}, "cpu"), k=1,
                       capacity_factor=0.25)
    kept = np.abs(y.numpy()).sum(-1) > 0
    np.testing.assert_array_equal(kept, np.abs(np.asarray(jy)).sum(-1) > 0)
    assert 0 < kept.sum() < T
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **ATTN_TOL)


def test_moe_refuses_indivisible_experts_and_tokens():
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 4, 8, 6,
                            device="cpu")
    with pytest.raises(ValueError, match="experts=6"):
        moe.moe_ffn(p, torch.zeros(8, 4), Mesh({"expert": 4}, "cpu"))
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 4, 8, 4,
                            device="cpu")
    with pytest.raises(ValueError, match="tokens=6"):
        moe.moe_ffn(p, torch.zeros(6, 4), Mesh({"expert": 4}, "cpu"))


# -- pipeline ----------------------------------------------------------------

def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _pstage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _stage_params(seed, n_stages, d):
    ws = [_normal(seed + i, (d, d)) * 0.5 for i in range(n_stages)]
    return {"w": np.stack(ws), "b": np.zeros((n_stages, d), np.float32)}


@pytest.mark.parametrize("n_stages,microbatches", [(2, 4), (4, 8)])
def test_pipeline_forward_and_grad_match_jax(devices8, n_stages,
                                             microbatches):
    """The GPipe schedule at 2 and 4 stages: the output and the grads of
    the stacked stage params and of x against JAX's pipeline_loss on the
    mesh."""
    d, B = 8, 16
    sp = _stage_params(10, n_stages, d)
    x, tgt = _normal(1, (B, d)), _normal(2, (B, d))
    jmesh = _jmesh(devices8, "stage", n_stages)

    def jl(p, x):
        y = jpipe.pipeline_apply(_jstage, p, x, jmesh,
                                 num_microbatches=microbatches)
        return jnp.mean((y - tgt) ** 2), y

    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(
        jl, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, sp), jnp.asarray(x))
    pp = {k: _t(v).requires_grad_(True) for k, v in sp.items()}
    px = _t(x).requires_grad_(True)
    mesh = Mesh({"stage": n_stages}, "cpu")
    y = pipeline.pipeline_apply(_pstage, pp, px, mesh,
                                num_microbatches=microbatches)
    loss = pipeline.pipeline_loss(
        _pstage, lambda y, t: torch.mean((y - t) ** 2), pp, px, _t(tgt),
        mesh, num_microbatches=microbatches)
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    for f in ("w", "b"):
        np.testing.assert_allclose(pp[f].grad.numpy(), np.asarray(jg[f]),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)


def test_pipeline_refusals():
    """A stage count that differs from the axis size and a batch that
    the microbatches do not divide raise, as in JAX."""
    mesh = Mesh({"stage": 2}, "cpu")
    sp = {k: _t(v) for k, v in _stage_params(0, 4, 4).items()}
    with pytest.raises(ValueError, match="stage_params leading dims"):
        pipeline.pipeline_apply(_pstage, sp, torch.zeros(8, 4), mesh,
                                num_microbatches=4)
    sp = {k: _t(v) for k, v in _stage_params(0, 2, 4).items()}
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(_pstage, sp, torch.zeros(10, 4), mesh,
                                num_microbatches=4)


def test_stack_stage_params_matches_jax():
    parts = [{"w": _normal(i, (3, 2)), "b": _normal(10 + i, (2,))}
             for i in range(3)]
    want = jpipe.stack_stage_params(
        [jax.tree.map(jnp.asarray, p) for p in parts])
    got = pipeline.stack_stage_params(
        [{k: _t(v) for k, v in p.items()} for p in parts])
    for f in ("w", "b"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


def test_mesh_names_axes_like_jax():
    m = Mesh({"data": 4, "model": 2}, "cpu")
    assert m.axis_names == ("data", "model")
    assert m.shape["data"] == 4 and m.shape["model"] == 2 and m.size == 8
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="positive"):
        Mesh({"seq": 0}, "cpu")
