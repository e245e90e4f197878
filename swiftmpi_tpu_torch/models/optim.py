"""The transformer trainer's optimizer: optax's math, written out in torch.

The JAX package's ``make_optimizer`` (``swiftmpi_tpu/models/
trainer.py``) chains ``optax.clip_by_global_norm(grad_clip)`` with
``optax.adamw`` or ``optax.sgd(momentum=0.9)``, both driven by
``warmup_cosine_decay_schedule(0.0, lr, warmup, max(decay, warmup + 1))``.
The port has no optax, so this module carries the same arithmetic, in
the same order and dtypes:

* clip: ``g_norm = sqrt(sum over leaves of sum(g * g))`` in the grads'
  dtype; every leaf ``g`` if ``g_norm < max_norm``, else ``g / g_norm *
  max_norm``;
* adamw: ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8; ``mu`` and ``nu``
  in the params' dtype; ``mu / (1 - b1**count)`` and ``nu / (1 -
  b2**count)`` with float32 corrections cast to the moments' dtype), then
  ``add_decayed_weights`` (``u + wd * p``), then the learning rate at the
  schedule's count (``-lr(count) * u``, the rate cast to ``u``'s dtype);
* sgd: ``trace`` (``t = g + 0.9 * t``, the update being ``t``), then the
  learning rate;
* the schedule: a linear warmup from 0.0 to ``lr`` over ``warmup``
  updates, then a cosine decay to 0 over the rest, in float32 on the
  device from the int32 count (so the first update has a rate of 0.0, as
  in optax).

The state keeps optax's pytree, leaf for leaf and in optax's order:
``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState(),
ScaleByScheduleState(count)))`` for adamw, ``(EmptyState(),
(TraceState(trace), ScaleByScheduleState(count)))`` for sgd; the
named tuples carry optax's names, so :func:`~swiftmpi_tpu_torch.utils.
tree.treedef_repr` of a trainer's state is JAX's.  :meth:`Optimizer.
update` returns new updates and writes the state's tensors in place.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from swiftmpi_tpu_torch.utils import tree


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (clip_by_global_norm, add_decayed_weights)."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: Any


def _zeros_like(params):
    return tree.tree_map(torch.zeros_like, params)


def _count(params) -> torch.Tensor:
    dev = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _increment(count: torch.Tensor) -> None:
    """optax's ``safe_increment``, in place: +1 until int32's max."""
    count.copy_(torch.where(count < torch.iinfo(torch.int32).max,
                            count + 1, count))


def warmup_cosine_decay(count: torch.Tensor, init_value: float,
                        peak_value: float, warmup_steps: int,
                        decay_steps: int) -> torch.Tensor:
    """optax's ``warmup_cosine_decay_schedule(init, peak, warmup, decay)``
    (end value 0, exponent 1) at the int32 ``count``, as a float32 device
    scalar."""
    f32 = torch.float32
    if warmup_steps <= 0:
        warm = torch.full((), init_value, dtype=f32, device=count.device)
    else:
        c = torch.clamp(count, 0, warmup_steps)
        frac = 1 - c.to(f32) / warmup_steps
        warm = (init_value - peak_value) * frac + peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError("the cosine decay needs decay_steps > "
                         f"warmup_steps, got {decay_steps=}, "
                         f"{warmup_steps=}")
    c = torch.minimum((count - warmup_steps).to(f32),
                      torch.tensor(float(span), dtype=f32,
                                   device=count.device))
    cosine = 0.5 * (1 + torch.cos(math.pi * c / float(span)))
    decayed = peak_value * cosine
    return torch.where(count < warmup_steps, warm, decayed)


class Optimizer:
    """Global-norm clip around adamw or sgd, on a warmup-cosine schedule:
    ``make_optimizer``'s arguments and defaults."""

    def __init__(self, name: str = "adamw", learning_rate: float = 3e-4,
                 warmup_steps: int = 100, decay_steps: int = 10_000,
                 weight_decay: float = 0.01, grad_clip: float = 1.0):
        if name not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.learning_rate = float(learning_rate)
        self.warmup_steps = int(warmup_steps)
        self.decay_steps = max(int(decay_steps), self.warmup_steps + 1)
        self.weight_decay = float(weight_decay)
        self.grad_clip = float(grad_clip)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.momentum = 0.9

    def init(self, params) -> tuple:
        if self.name == "adamw":
            inner = (ScaleByAdamState(_count(params), _zeros_like(params),
                                      _zeros_like(params)),
                     EmptyState(), ScaleByScheduleState(_count(params)))
        else:
            inner = (TraceState(_zeros_like(params)),
                     ScaleByScheduleState(_count(params)))
        return (EmptyState(), inner)

    def rate(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule's learning rate at ``count`` (float32 scalar)."""
        return warmup_cosine_decay(count, 0.0, self.learning_rate,
                                   self.warmup_steps, self.decay_steps)

    def _clip(self, grads: list) -> list:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < self.grad_clip
        return [torch.where(trigger, g,
                            (g / g_norm.to(g.dtype)) * self.grad_clip)
                for g in grads]

    def update(self, grads, state: tuple, params) -> Tuple[Any, tuple]:
        """``(updates, state)``: the updates as a pytree like ``params``;
        the state's tensors are updated in place and returned."""
        g = self._clip(tree.leaves(grads))
        p = tree.leaves(params)
        inner = state[1]
        if self.name == "adamw":
            adam, _, sched = inner
            mu, nu = tree.leaves(adam.mu), tree.leaves(adam.nu)
            _increment(adam.count)
            b1, b2 = self.b1, self.b2
            bc1 = 1 - b1 ** adam.count.to(torch.float32)
            bc2 = 1 - b2 ** adam.count.to(torch.float32)
            u = []
            for gi, mi, vi in zip(g, mu, nu):
                mi.copy_((1 - b1) * gi + b1 * mi)
                vi.copy_((1 - b2) * (gi * gi) + b2 * vi)
                m_hat = mi / bc1.to(mi.dtype)
                v_hat = vi / bc2.to(vi.dtype)
                u.append(m_hat / (torch.sqrt(v_hat) + self.eps))
            u = [ui + self.weight_decay * pi for ui, pi in zip(u, p)]
        else:
            trace, sched = inner
            u = []
            for gi, ti in zip(g, tree.leaves(trace.trace)):
                ti.copy_(gi + self.momentum * ti)
                u.append(ti.clone())
        step = -self.rate(sched.count)
        u = [step.to(ui.dtype) * ui for ui in u]
        _increment(sched.count)
        return tree.unflatten(params, u), state


def apply_updates(params, updates) -> None:
    """``p + u`` cast to ``p``'s dtype, into each leaf of ``params``."""
    with torch.no_grad():
        for p, u in zip(tree.leaves(params), tree.leaves(updates)):
            p.copy_((p + u).to(p.dtype))
