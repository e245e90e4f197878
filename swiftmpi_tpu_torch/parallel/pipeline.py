"""Pipeline parallelism: the GPipe schedule of microbatches over a
``stage`` axis (counterpart of ``swiftmpi_tpu/parallel/pipeline.py``).

The model is a chain of ``n_stages`` stage functions of one signature
whose parameters are stacked on a leading axis (:func:`stack_stage_params`);
stage ``i`` owns row ``i``.  The batch splits into M microbatches and the
schedule runs ``M + n - 1`` ticks: stage 0 takes microbatch ``t`` at tick
``t``, every stage applies its function to the activation it holds, the
last stage emits microbatch ``t - (n - 1)``, and the activations move one
stage on by :func:`~swiftmpi_tpu_torch.parallel.collectives.ring_permute`
(JAX's ``ppermute`` hop).  The result is the masked sum over the stage
dim of every stage's emissions, the last stage's and zeros, as JAX's
``psum`` replicates it, so the zeros add exactly.

The ``stage`` axis runs as n logical ranks on one device.  A stage that
holds no microbatch at a tick (the pipeline's bubble) passes its
activation on without computing: JAX computes it and the result never
reaches the output, so the output is the same.  Gradients flow through
torch autograd, where JAX transposes the scan.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from swiftmpi_tpu_torch.parallel.collectives import ring_permute
from swiftmpi_tpu_torch.utils import tree

STAGE_AXIS = "stage"


def stack_stage_params(params_list) -> Any:
    """Per-stage parameter pytrees stacked on a new leading ``stage``
    axis: leaves ``(n_stages, ...)``, what :func:`pipeline_apply` takes."""
    return tree.tree_map(lambda *xs: torch.stack(xs), *params_list)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, *, axis: str = STAGE_AXIS,
                   num_microbatches: int) -> torch.Tensor:
    """``x`` through the stage pipeline; returns the final activation.

    ``stage_fn(params_i, act) -> act`` keeps the activation's shape (the
    homogeneous-pipeline rule: embeddings and heads stay outside).
    ``stage_params`` leaves have leading dim ``n_stages``, the size of
    ``axis``; ``x`` is the global batch ``(B, ...)`` with ``B %
    num_microbatches == 0``."""
    n = int(mesh.shape[axis])
    n_stacked = {leaf.shape[0] for leaf in tree.leaves(stage_params)}
    if n_stacked != {n}:
        raise ValueError(
            f"stage_params leading dims {sorted(n_stacked)} must all equal "
            f"the '{axis}' axis size {n} (one stage per rank)")
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} % microbatches {num_microbatches} != 0")
    M = num_microbatches
    mb = B // M
    params = [tree.tree_map(lambda p, i=i: p[i], stage_params)
              for i in range(n)]
    x_mb = x.reshape(M, mb, *x.shape[1:])

    state = torch.zeros((n, mb, *x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    emitted = []
    for t in range(M + n - 1):
        acts = list(state.unbind(0))
        if t < M:
            acts[0] = x_mb[t]                   # stage 0 takes microbatch t
        ys = [stage_fn(params[i], acts[i]) if 0 <= t - i < M else acts[i]
              for i in range(n)]
        if t >= n - 1:
            emitted.append(ys[n - 1])           # microbatch t - (n - 1)
        # hand activations to the +1 neighbour (the wrap into stage 0 is
        # overwritten by the next feed)
        state = ring_permute(torch.stack(ys))
    out = torch.stack(emitted)                  # the last stage's (M, mb..)
    # every stage's emissions, zeros off the last stage: the masked sum
    # over the stage dim is the last stage's exactly
    last = torch.arange(n, device=x.device) == n - 1
    per_stage = torch.where(last.reshape(n, *([1] * out.dim())),
                            out.unsqueeze(0), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    return per_stage.sum(0).reshape(x.shape)


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params: Any,
                  x: torch.Tensor, target: Any, mesh, *,
                  axis: str = STAGE_AXIS, num_microbatches: int):
    """Scalar ``loss_fn(final_act, target)`` over the pipeline output: what
    to differentiate for pipelined training."""
    y = pipeline_apply(stage_fn, stage_params, x, mesh, axis=axis,
                       num_microbatches=num_microbatches)
    return loss_fn(y, target)
