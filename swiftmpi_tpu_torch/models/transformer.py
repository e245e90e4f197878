"""Decoder-only transformer LM: the long-context, multi-axis model family
(counterpart of ``swiftmpi_tpu/models/transformer.py``).

Pre-RMSNorm, RoPE positions, causal multi-head attention, a SiLU-gated
or mixture-of-experts FFN, a weight-tied output head.  The parameters
keep the JAX package's pytree: a dict of tensors, the blocks' leaves
stacked on a leading ``(n_layers)`` dim, an MoE block's as a
:class:`~swiftmpi_tpu_torch.parallel.moe.MoEParams`; plain functions act
on them, and leaf ``i`` in flatten order is the JAX package's leaf ``i``
(``utils/tree.py``).  Every parallel axis runs as logical ranks of a
:class:`~swiftmpi_tpu_torch.cluster.mesh.Mesh` on one device:

* **seq** — attention as :func:`ring_attention` or
  :func:`ulysses_attention` (``cfg.attention``), the latter through B5;
* **expert** — the FFN as :func:`moe_ffn`, both all-to-alls through B5;
* **stage** — :func:`forward_pipelined` runs the blocks as a GPipe
  pipeline;
* **data** and **model** — GSPMD annotations in JAX, which change no
  value: on one card the port computes the same unsharded function and
  records :func:`param_shardings`' specs.  Placement across cards waits
  on ROADMAP A11d.

Precision follows the JAX package's type promotion: norms, softmax and
RoPE's angles in float32, a bfloat16 value times float32 cos/sin gives
float32 and is cast back, weight products in the parameters' dtype.
Remat is ``torch.utils.checkpoint`` (non-reentrant) per block:
``"full"`` saves nothing, ``"dots"`` saves the weight products
(``aten.mm``/``addmm``: JAX's ``dots_with_no_batch_dims_saveable``) and
recomputes the rest, the batched score and PV products (``aten.bmm``)
included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import torch
import torch.nn.functional as F

from swiftmpi_tpu_torch.device import DeviceLike, resolve_device
from swiftmpi_tpu_torch.parallel.moe import (MoEParams, init_moe_params,
                                             moe_ffn, moe_ffn_reference)
from swiftmpi_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                  stack_stage_params)
from swiftmpi_tpu_torch.parallel.ring_attention import (full_attention,
                                                        ring_attention,
                                                        ulysses_attention)
from swiftmpi_tpu_torch.utils import tree


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 2048
    attention: str = "full"          # full | ring | ulysses
    n_experts: int = 0               # 0 => dense SiLU-gated FFN
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    rope_base: float = 10_000.0
    remat: bool = False              # checkpoint each block
    remat_policy: str = "dots"       # dots: keep the weight products
                                     # full: recompute everything
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


# -- params ----------------------------------------------------------------

def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def init_params(key, cfg: TransformerConfig,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters from ``key`` (a seed or a CPU ``torch.Generator``;
    drawn on the CPU, so a card and the CPU get the same values) on
    ``device`` (the current CUDA card unless ``"cpu"``), the blocks
    stacked on a leading ``(n_layers)`` dim.  The numbers are not JAX's:
    parity tests load JAX's parameters through ``convert.py``."""
    device = resolve_device(device)
    gen = _generator(key)
    s = 1.0 / math.sqrt(cfg.d_model)
    d, h = cfg.d_model, cfg.d_ff

    def normal(*shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
        return w.to(device=device, dtype=cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    def one_block():
        blk = {"ln1": ones(d), "ln2": ones(d),
               "wq": normal(d, d, scale=s), "wk": normal(d, d, scale=s),
               "wv": normal(d, d, scale=s), "wo": normal(d, d, scale=s)}
        if cfg.n_experts:
            blk["moe"] = init_moe_params(gen, d, h, cfg.n_experts,
                                         cfg.dtype, device)
        else:
            blk["w_gate"] = normal(d, h, scale=s)
            blk["w_up"] = normal(d, h, scale=s)
            blk["w_down"] = normal(h, d, scale=1.0 / math.sqrt(h))
        return blk

    embed = normal(cfg.vocab_size, d, scale=s)
    blocks = stack_stage_params([one_block() for _ in range(cfg.n_layers)])
    return {"embed": embed, "blocks": blocks, "ln_f": ones(d)}


def param_shardings(params, cfg: TransformerConfig, mesh=None, *,
                    model_axis: str = "model",
                    data_axis: str = "data") -> Any:
    """Megatron-style tensor parallelism as per-leaf specs, JAX's
    ``PartitionSpec``s as tuples of axis names: the FFN hidden dim and
    the q/k/v/o head dim over ``model_axis``, the embedding's rows over
    it, everything else replicated (``()``).  A pytree like ``params``.
    On one card the specs are recorded, not applied (ROADMAP A11d)."""
    del cfg, mesh, data_axis     # params are never dp-sharded

    def spec(path: str) -> tuple:
        if path in ("wq", "wk", "wv", "w_gate", "w_up"):
            return (None, None, model_axis)       # (L, d, d|dff) columns
        if path in ("wo", "w_down"):
            return (None, model_axis, None)       # (L, dff|d, d) rows
        if path == "w_in":
            return (None, None, None, model_axis)   # (L, E, d, dff)
        if path == "w_out":
            return (None, None, model_axis, None)   # (L, E, dff, d)
        if path == "embed":
            return (model_axis, None)
        return ()

    def walk(t, name=""):
        if isinstance(t, MoEParams):
            return MoEParams(*(walk(v, f) for f, v in zip(t._fields, t)))
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return spec(name)

    return walk(params)


# -- forward ---------------------------------------------------------------

def _rms_norm(x, g, eps=1e-6):
    x32 = x.float()
    r = torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * g


def _rope(x, base: float):
    """(B, S, H, D) rotary position embedding."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = (torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
           * freqs[None])                                        # (S, h)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], -1).to(x.dtype)


def _attention(blk, x, cfg: TransformerConfig, mesh, seq_axis: str):
    B, S, d = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    h = _rms_norm(x, blk["ln1"])
    q = (h @ blk["wq"]).reshape(B, S, H, Dh)
    k = (h @ blk["wk"]).reshape(B, S, H, Dh)
    v = (h @ blk["wv"]).reshape(B, S, H, Dh)
    q, k = _rope(q, cfg.rope_base), _rope(k, cfg.rope_base)
    # the collective variants need their axis on the mesh; otherwise the
    # numerically identical local computation
    has_seq = mesh is not None and seq_axis in mesh.axis_names
    if cfg.attention == "ring" and has_seq:
        o = ring_attention(q, k, v, mesh, axis=seq_axis, causal=True)
    elif cfg.attention == "ulysses" and has_seq:
        o = ulysses_attention(q, k, v, mesh, axis=seq_axis, causal=True)
    else:
        o = full_attention(q, k, v, causal=True)
    return x + o.reshape(B, S, d) @ blk["wo"]


def _ffn(blk, x, cfg: TransformerConfig, mesh, expert_axis: str):
    B, S, d = x.shape
    h = _rms_norm(x, blk["ln2"])
    if cfg.n_experts:
        tokens = h.reshape(B * S, d)
        if mesh is not None and expert_axis in mesh.axis_names:
            y, aux = moe_ffn(blk["moe"], tokens, mesh, axis=expert_axis,
                             k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor)
        else:
            y, aux = moe_ffn_reference(blk["moe"], tokens, k=cfg.moe_top_k)
        return x + y.reshape(B, S, d), aux
    y = (F.silu(h @ blk["w_gate"]) * (h @ blk["w_up"])) @ blk["w_down"]
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: save the weight products
    (no batch dims), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: TransformerConfig):
    """``fn`` under ``torch.utils.checkpoint`` with ``cfg``'s policy."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if cfg.remat_policy == "full":
        context_fn = None
    elif cfg.remat_policy == "dots":
        context_fn = partial(create_selective_checkpoint_contexts,
                             _dots_policy)
    else:
        raise ValueError(f"unknown remat_policy: {cfg.remat_policy!r}")

    def run(*args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def block_apply(blk, x, cfg: TransformerConfig, mesh=None, *,
                seq_axis: str = "seq", expert_axis: str = "expert"):
    x = _attention(blk, x, cfg, mesh, seq_axis)
    return _ffn(blk, x, cfg, mesh, expert_axis)


def _layer(blocks, i: int):
    return tree.tree_map(lambda p: p[i], blocks)


def forward(params, tokens, cfg: TransformerConfig, mesh=None, *,
            seq_axis: str = "seq", expert_axis: str = "expert"):
    """tokens (B, S) integer -> (logits (B, S, V), aux_loss)."""
    x = params["embed"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, blk):
        return block_apply(blk, x, cfg, mesh, seq_axis=seq_axis,
                           expert_axis=expert_axis)

    if cfg.remat:
        body = _remat(body, cfg)
    for i in range(cfg.n_layers):
        x, a = body(x, _layer(params["blocks"], i))
        aux = aux + a
    x = _rms_norm(x, params["ln_f"])
    return x @ params["embed"].T, aux


def forward_pipelined(params, tokens, cfg: TransformerConfig, mesh, *,
                      stage_axis: str = "stage", num_microbatches: int = 4):
    """The same function, the trunk run as a stage pipeline over
    ``stage_axis`` (one block a stage: n_layers must equal the axis
    size); embedding and head stay outside.  Full attention and the dense
    FFN only, as in the JAX package."""
    if cfg.n_experts or cfg.attention != "full":
        raise ValueError("pipelined trunk requires full attention and "
                         "dense FFN (nested shard_map is not supported)")
    x = params["embed"][tokens]

    def stage_fn(blk, act):
        out, _ = block_apply(blk, act, cfg, None)
        return out

    if cfg.remat:
        stage_fn = _remat(stage_fn, cfg)
    x = pipeline_apply(stage_fn, params["blocks"], x, mesh,
                       axis=stage_axis, num_microbatches=num_microbatches)
    x = _rms_norm(x, params["ln_f"])
    return (x @ params["embed"].T,
            torch.zeros((), dtype=torch.float32, device=x.device))


# -- training --------------------------------------------------------------

def lm_loss(params, tokens, cfg: TransformerConfig, mesh=None,
            aux_weight: float = 0.01, **fwd_kwargs):
    """Next-token cross entropy (+ weighted MoE aux)."""
    logits, aux = forward(params, tokens[:, :-1], cfg, mesh, **fwd_kwargs)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, targets[..., None]).mean()
    return nll + aux_weight * aux


def value_and_grad(loss_fn, params, *args, **kwargs):
    """``(loss, grads)`` of ``loss_fn(params, ...)``: the leaves are taken
    as detached tensors that require grad (the caller's stay as they
    are), and the grads come back as a pytree like ``params``."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, flat), *args, **kwargs)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tree.unflatten(params, list(grads))


def sgd_step(params, tokens, cfg: TransformerConfig, lr: float = 0.1):
    """One SGD step, in place: ``p - lr * g`` into each leaf of ``params``
    (JAX's donated functional update).  Returns ``(params, loss)``."""
    loss, grads = value_and_grad(lm_loss, params, tokens, cfg)
    with torch.no_grad():
        for p, g in zip(tree.leaves(params), tree.leaves(grads)):
            p.copy_(p - lr * g.to(p.dtype))
    return params, loss
