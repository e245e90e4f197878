"""Pull/push access methods (counterpart of
``swiftmpi_tpu/parameter/access.py``).

An access method bundles the table schema (parameter and optimizer
fields), the initial-value distribution of each field, the fields a pull
returns, and the update rule ``apply_push``.  Where the JAX rule is a pure
function returning new arrays, the port updates the row tensors it is
handed **in place** — the counterpart of the JAX step donating its table
state — and returns the updated fields.

Sign convention as in the reference: gradients are pushed in the ascent
direction and the update adds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from swiftmpi_tpu_torch.kernels.adagrad import (adagrad_update_,
                                                adagrad_update_rows_)

Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.device],
                       torch.Tensor]


def zeros_init(generator: torch.Generator, shape: Tuple[int, ...],
               device: torch.device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def vec_rand_init(generator: torch.Generator, shape: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """(U(0,1) - 0.5) / dim — the reference ``Vec::randInit`` embedding
    init (vec1.h:229-232)."""
    dim = shape[-1]
    return (torch.rand(shape, generator=generator, device=device)
            - 0.5) / dim


@dataclass(frozen=True)
class FieldSpec:
    dim: int
    init: Initializer = zeros_init
    dtype: torch.dtype = torch.float32


class AccessMethod:
    """Base: schema + init + pull view + push rule."""

    #: name -> FieldSpec; the full server-side row (params + optimizer state)
    fields: Dict[str, FieldSpec] = {}
    #: subset of ``fields`` a pull returns (worker-visible view)
    pull_fields: Tuple[str, ...] = ()
    #: gradient entries a push must provide
    grad_fields: Tuple[str, ...] = ()

    def apply_push(self, params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor],
                   mul: Optional[torch.Tensor] = None,
                   div: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Update ``params`` rows in place from ``grads`` (which may carry
        a subset of ``grad_fields``; absent rules are skipped) and return
        the updated fields.  ``params`` are ``(cap, d)`` tables or ``(R,
        cap, d)`` blocks of shards; ``mul`` / ``div``, one value per row
        (``params``' shape without ``d``), multiply or divide every grad
        row first."""
        raise NotImplementedError

    def apply_push_rows(self, state: Dict[str, torch.Tensor],
                        slots: torch.Tensor, mask: Optional[torch.Tensor],
                        grads: Dict[str, torch.Tensor],
                        mul: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """Row-indexed push, in place on the table's own ``(cap, d)``
        tensors: grad row ``i`` (times ``mul[i]``) updates row
        ``slots[i]`` where ``mask`` (None: every row) keeps it.  The kept
        slots must be distinct.  Returns the updated fields."""
        raise NotImplementedError

    def touched_fields(self, grad_fields) -> Tuple[str, ...]:
        """Fields ``apply_push`` reads or writes for these grad entries."""
        return tuple(self.fields)


@dataclass
class AdaGradRule:
    """One (param, accumulator, grad) triple updated AdaGrad-style."""
    param: str
    accum: str
    grad: str


class AdaGradAccess(AccessMethod):
    """Server-side AdaGrad, the reference's only optimizer.

    Per element (word2vec.h:177-185, fudge_factor 1e-6):
        accum += g^2
        param += lr * g / sqrt(accum + fudge)      # accum already updated

    Executed by the CUDA kernel ``kernels/adagrad.py`` on the card (the
    port of ``PallasAdaGradAccess``) and by its plain version on the CPU:
    ``apply_push`` over whole tables or blocks of shards, ``apply_push_rows``
    over the rows a sparse or span push touches.  A bfloat16 param with
    its float32 accumulator and grads takes the JAX rule's mixed form
    (``swiftmpi_tpu/parameter/access.py`` ``AdaGradAccess.apply_push``):
    the same float32 math, one round-to-nearest-even on the param's store.
    """

    def __init__(self, learning_rate: float,
                 rules: Tuple[AdaGradRule, ...],
                 fields: Dict[str, FieldSpec],
                 pull_fields: Tuple[str, ...],
                 fudge_factor: float = 1e-6):
        self.learning_rate = float(learning_rate)
        self.rules = tuple(rules)
        self.fields = dict(fields)
        self.pull_fields = tuple(pull_fields)
        self.grad_fields = tuple(r.grad for r in self.rules)
        self.fudge_factor = float(fudge_factor)
        for r in self.rules:
            if r.param not in self.fields or r.accum not in self.fields:
                raise ValueError(f"rule {r} references unknown field")

    def apply_push(self, params, grads, mul=None, div=None):
        out = {}
        for r in self.rules:
            if r.grad not in grads:
                continue
            # in place on the table's own tensors, or a block of shards
            adagrad_update_(params[r.param], params[r.accum],
                            grads[r.grad].contiguous(), self.learning_rate,
                            self.fudge_factor, mul=mul, div=div)
            out[r.param] = params[r.param]
            out[r.accum] = params[r.accum]
        return out

    def apply_push_rows(self, state, slots, mask, grads, mul=None):
        out = {}
        for r in self.rules:
            if r.grad not in grads:
                continue
            adagrad_update_rows_(state[r.param], state[r.accum], slots, mask,
                                 grads[r.grad].contiguous(),
                                 self.learning_rate, self.fudge_factor,
                                 mul=mul)
            out[r.param] = state[r.param]
            out[r.accum] = state[r.accum]
        return out

    def touched_fields(self, grad_fields):
        gf = set(grad_fields)
        out = []
        for r in self.rules:
            if r.grad in gf:
                out += [r.param, r.accum]
        return tuple(out)


def w2v_access(learning_rate: float, len_vec: int,
               param_dtype: torch.dtype = torch.float32) -> AdaGradAccess:
    """word2vec row: h,v embeddings + per-element AdaGrad sums
    (reference WParam, word2vec.h:32-46,167-191).

    ``param_dtype=torch.bfloat16`` (``[server] dtype: bfloat16``) stores
    the embedding fields at half width, as the JAX package does: pulls
    are upcast to float32 before any math, the AdaGrad accumulators stay
    float32, and the update computes in float32 and rounds once on store
    (the AdaGrad kernel's mixed form)."""
    return AdaGradAccess(
        learning_rate,
        rules=(AdaGradRule("h", "h2sum", "h"),
               AdaGradRule("v", "v2sum", "v")),
        fields={"h": FieldSpec(len_vec, vec_rand_init, param_dtype),
                "v": FieldSpec(len_vec, vec_rand_init, param_dtype),
                "h2sum": FieldSpec(len_vec, zeros_init),
                "v2sum": FieldSpec(len_vec, zeros_init)},
        pull_fields=("h", "v"),
    )
