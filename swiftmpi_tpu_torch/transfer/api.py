"""Transfer interface (counterpart of ``swiftmpi_tpu/transfer/api.py``).

A transfer moves rows between workers and the table: ``pull`` gathers
rows at slots, ``push`` combines gradient rows by slot and applies the
access method's update rule to the table.  Four backends:

* ``xla`` (``transfer/single.py``): one device, in place;
* ``tpu`` (``transfer/sharded.py``): the sharded parameter server, in
  place;
* ``hybrid`` (``transfer/hybrid.py``): the frequency head in hot planes,
  reconciled by one dense sum a push, the tail through ``tpu``;
* ``local`` (``transfer/local.py``): the numpy oracle, functional.

``pull`` is the pull interpreter: it dispatches on the backend's
:func:`~swiftmpi_tpu_torch.transfer.plan.pull_route` placement, books
the pull ledger and calls the backend's one primitive, ``_prim_pull``.
Armed (``pull_quant``, ``pull_cache``), it compiles a ``PullPlan``: an
encoded format round-trips the pulled rows through
:func:`quantize_dequantize` (the forward read changes, the table does
not), and with the ``@rowver`` plane present the versions ride the same
gather and feed a host-side :class:`~swiftmpi_tpu_torch.transfer.
pull_cache.PullCache`, which books the cached wire.  ``push_span`` is the
sort-free push of the stencil rendering's span family.

``push_window`` is the TrafficPlan interpreter of the window-coalesced
push (``[cluster] push_window: W``): W steps' pushes of one family,
stacked ``(W, B, ...)``, exchanged once.  It compiles a plan per window
(``transfer/plan.py``: the host-static wire-format and collective
decisions) and runs it over the backend's primitives:
``_prim_window_dedup`` (the representative trick: a scatter-min of
positions names each slot's first occurrence, grads and counts fold into
it through the scatter-add kernel), ``_prim_ef_drain`` (the ``sparse_q``
rung's error feedback, :func:`ef_quantize_window`),
``_prim_window_exchange`` (booked at the plan's encoded size for the
``bitmap``, ``sparse_q`` and ``sparse_sketch`` rungs, whose values ride
the routed push as dequantized float32), ``_push_window_dense`` and
``_prim_sparse_allreduce``.  A W == 1 window, and a W > 1 window on
``local`` or ``xla`` with every compression knob off, flattens and takes
the per-step ``push`` or ``push_span``.

Observation taps (the telemetry plane, ``obs/``), each a no-op unless
armed: the numerics tap (:func:`set_numerics_tap`) takes each quantized
window's error sum-of-squares as a device scalar, in place; an installed
wire tracer (``obs.get_tracer()``) gets the plan's pricing
(``on_decision``), the window's keys and EF mass (``stage_keys``,
``stage_ef``), and a window record per dedup and exchange
(``on_window``, ``on_exchange``), each count read back to the host where
the JAX package's callback lands; a model runs its steps eagerly while a
tracer is installed.

Every push bumps the ``@rowver`` plane of the rows it applies to, when the
state has one (:func:`bump_row_versions`): the pull cache's hits are
exact only because of that.

The data axis (a multi-process run, ``Cluster.initialize`` calls
:meth:`Transfer.set_data_axis`): every process holds a full replica and
pushes its own batch; ``xla`` and ``tpu`` reconcile each push across the
``dp`` processes (``parallel/collectives.py``: gloo for CPU tensors,
B5's cross-process exchange for CUDA ones) before the one update every
replica applies.  The parts are combined in process order, so every
replica computes the same bits: :meth:`Transfer._dp_psum` sums dense
planes ``p0 + p1 + ...``, and :meth:`Transfer._dp_reconcile_rows` folds
each process's rows on their own (B3), gathers the folded rows and adds
them up per process in order, one scatter-add launch whose every
process slice holds distinct slots, so no two float atomics meet.  The
dense/sparse crossover reads the global batch (``dp`` times the local
one), as the JAX package's global arrays do.  The bytes that cross
processes are booked as ``psum_bytes`` (the key the JAX package's ledger
reports its cross-process collectives under).  The window push runs
under ``dp > 1`` as the JAX package's runs over its global window (the
processes' flat windows in process order): each process deduplicates its
own window (B3), the exchange and the dense rung reconcile as a push
does, the plans are priced at the global rows (``dp`` times the local
ones), and every process checks that its peers compiled the same plan
(``parallel.collectives.host_agree``).  The ``sparse_q`` rung's error
feedback runs on the gathered global window
(:meth:`Transfer._dp_ef_drain`), so every replica banks the same ``@ef``
residuals, as the JAX package's replicated planes do.

The wire ledger (off until ``count_traffic`` is set) keeps the JAX
package's keys and contract: totals that never decrease, no reset,
intervals by :meth:`Transfer.traffic_delta`.  A count the step computes on
the device is added in place to an int64 counter vector on that device
(one per device the backend booked on), together with the static
quantities booked with it, so a replayed CUDA graph books exactly what
the eager steps book and a step reads nothing back; only
:meth:`Transfer.traffic` reads the counters to the host.  The telemetry
registry mirrors the ledger as ``transfer/<key>{backend=<name>}`` (the
window formats as ``transfer/window_fmt{fmt=}``, the collectives as
``transfer/collective{kind=}``, the pull formats as
``transfer/pull_fmt{fmt=}``): a host booking increments its series where
it is booked, as the JAX package's ``_obs_inc`` does, and
:meth:`Transfer.mirror_traffic`, a recorder sampler, brings every series
to the ledger's total once a recorded step, so the device counters are
read only then.  As in the JAX
package, which books them through callbacks per execution, the window
decisions (``window_*``), ``coalesced_rows_*``, ``wire_bytes`` and
``hot_psum_bytes_saved`` are such device counts; ``plan_compiles``,
``plan_cache_hits``, ``collective_*`` and ``pull_fmt_*`` are booked on the
host once per ``push_window`` or ``pull`` call (JAX: once per trace).  The
cached pull's keys (``pull_cache_hits``, ``pull_delta_rows``,
``pull_bytes_saved`` and its ``pull_bytes``) are booked on the host after
each pull reads its slots and versions back, so a step that books them
cannot be captured in a CUDA graph (``Word2Vec`` runs such groups
eagerly).  The host oracle's counts are host integers.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.parameter.access import AccessMethod
from swiftmpi_tpu_torch.parameter.sparse_table import ROWVER_KEY, ef_name

TableState = Dict[str, torch.Tensor]

#: seed dense/sparse crossover ratio of every family: a push goes dense
#: once its batch is at least ``capacity / ratio`` rows (``int(cap / 2.0)
#: == cap // 2``), a window once its sparse volume reaches ``dense /
#: ratio``
DENSE_RATIO = 2.0

#: the wire ledger's keys, named and ordered as the JAX package's
#: ``Transfer._wire_state``
WIRE_KEYS = (
    "wire_bytes", "dispatches",
    "window_sparse", "window_dense",
    "window_fmt_dense", "window_fmt_sparse", "window_fmt_q",
    "window_fmt_bitmap", "window_fmt_sketch",
    "collective_psum", "collective_sparse_ar", "hot_psum_bytes_saved",
    "plan_compiles", "plan_cache_hits",
    "coalesced_rows_in", "coalesced_rows_out",
    "pull_bytes", "pull_rows", "pull_hot_rows",
    "pull_cache_hits", "pull_delta_rows", "pull_bytes_saved",
    "pull_fmt_full", "pull_fmt_bf16", "pull_fmt_q")

#: routing counters of the sharded and hybrid backends, kept beside the
#: wire keys
ROUTE_KEYS = ("routed_rows", "hot_rows", "psum_bytes")

_INDEX = {k: i for i, k in enumerate(WIRE_KEYS + ROUTE_KEYS)}


def obs_series(key: str):
    """The registry series of a ledger key: ``(name, labels)``, the JAX
    package's ``_obs_inc`` names (a format or collective key folds into
    its family with a label)."""
    for fam, label in (("window_fmt", "fmt"), ("collective", "kind"),
                       ("pull_fmt", "fmt")):
        if key.startswith(fam + "_"):
            return "transfer/" + fam, {label: key[len(fam) + 1:]}
    return "transfer/" + key, {}


# When the numerics plane is armed it installs a tap here; every EF
# quantize path (ef_quantize_window for xla/tpu/hybrid, the local
# oracle's numpy twin) books its quantization error sum-of-squares
# through it.  None (the default) computes nothing extra.
_NUMERICS_TAP = None


def set_numerics_tap(fn) -> None:
    global _NUMERICS_TAP
    _NUMERICS_TAP = fn


def clear_numerics_tap() -> None:
    set_numerics_tap(None)


def numerics_quant_err(err_sq) -> None:
    """Book one quantized window's error sum-of-squares (a device scalar
    or a host number) into the armed numerics tap; no-op when off."""
    tap = _NUMERICS_TAP
    if tap is not None:
        tap(err_sq)


def _width_bytes(x) -> int:
    """Bytes of one row of ``x`` (a tensor, a numpy array, or a sharded
    field's list of shard tensors): the last dimension at the dtype."""
    if isinstance(x, (list, tuple)):
        x = x[0]
    if isinstance(x, torch.Tensor):
        return x.element_size() * int(x.shape[-1])
    x = np.asarray(x)
    return x.dtype.itemsize * int(x.shape[-1])


def grad_row_bytes(grads, with_index: bool = True,
                   with_counts: bool = False) -> int:
    """Wire bytes per pushed row: the grad fields' widths at their dtypes,
    plus an int32 index in the sparse representation and a float32
    counts column when a span family ships data counts."""
    total = 4 if with_index else 0
    total += sum(_width_bytes(g) for g in grads.values())
    return total + (4 if with_counts else 0)


def quant_grad_row_bytes(grads, quant: str,
                         with_counts: bool = False) -> int:
    """Encoded wire bytes per pushed row under ``sparse_q``: the int32
    index, each grad field at 1 byte an element plus a 4-byte scale
    (``int8``) or 2 bytes an element (``bf16``), the float32 counts
    column unchanged.  The pricer's input when ``wire_quant`` is set."""
    if quant not in ("int8", "bf16"):
        raise ValueError(f"quant_grad_row_bytes: unknown quant {quant!r}")
    total = 4
    for g in grads.values():
        d = int(g[0].shape[-1] if isinstance(g, (list, tuple))
                else g.shape[-1])
        total += d + 4 if quant == "int8" else 2 * d
    return total + (4 if with_counts else 0)


def quant_pull_row_bytes(state, fields, quant: str) -> int:
    """Encoded wire bytes per pulled row: the int32 request index, each
    field at 1 byte an element plus a 4-byte scale (``int8``) or 2 bytes
    an element (``bf16``).  The pull pricer's input when ``pull_quant`` is
    set."""
    if quant not in ("int8", "bf16"):
        raise ValueError(f"quant_pull_row_bytes: unknown quant {quant!r}")
    total = 4
    for f in fields:
        d = int(state[f][0].shape[-1] if isinstance(state[f], (list, tuple))
                else state[f].shape[-1])
        total += d + 4 if quant == "int8" else 2 * d
    return total


def quantize_dequantize(g, quant: str):
    """One grad (or row) block through the ``sparse_q`` value encoding and
    back, as the receiver reconstructs it, always float32: ``int8`` scales
    each row (last axis) by ``max|g| * (1 / 127)`` (a multiply, as JAX
    does), rounds half to even and clips to +-127; ``bf16`` is a dtype
    round trip.  Takes a tensor or a numpy array and returns the same
    kind."""
    if not isinstance(g, torch.Tensor):
        return quantize_dequantize(torch.from_numpy(
            np.asarray(g, np.float32)), quant).numpy()
    g = g.to(torch.float32)
    if quant == "bf16":
        return g.to(torch.bfloat16).to(torch.float32)
    if quant != "int8":
        raise ValueError(f"quantize_dequantize: unknown quant {quant!r}")
    scale = g.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    pos = scale > 0
    q = torch.clamp(torch.round(g / torch.where(pos, scale, 1.0)),
                    -127.0, 127.0)
    return q * torch.where(pos, scale, 0.0)


def touched_rows(slots: torch.Tensor, ok: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """``(..., capacity)`` bool: the rows of ``capacity`` that ``slots``
    (``(..., N)``, rank by rank for a leading R) hit where ``ok``."""
    safe = torch.where(ok & (slots >= 0) & (slots < capacity), slots,
                       capacity).long()
    plane = torch.zeros(tuple(slots.shape[:-1]) + (capacity + 1,),
                        dtype=torch.bool, device=slots.device)
    plane.scatter_(-1, safe, True)
    return plane[..., :capacity]


def bump_row_versions(ver: torch.Tensor, touched: torch.Tensor) -> None:
    """In place: the ``touched`` rows of a ``@rowver`` plane (``(cap, 1)``
    int32, or an ``(R, cap, 1)`` block of R shards with ``(R, cap)``
    ``touched``) take their shard's max + 1: per shard monotonic, no host
    counter (JAX's max runs over the shard inside its ``shard_map``).
    Every push path stamps the rows it applies to through here (or the
    oracle's numpy twin): the pull cache's exact hits depend on it."""
    newv = ver.amax(dim=(-2, -1), keepdim=True) + 1
    ver.copy_(torch.where(touched[..., None], newv, ver))


def ef_quantize_window(planes, ded_slots: torch.Tensor, ded_grads,
                       capacity: int, quant: str,
                       trace_backend: Optional[str] = None,
                       slices: int = 1):
    """Error feedback around one deduplicated window's quantization (JAX
    ``ef_quantize_window``): each touched slot's residual drains into its
    first occurrence's sum, the sum is quantized and dequantized, and the
    new error is banked in the residual plane.  ``planes``: ``{f: (capacity,
    d)}`` float32 ``f@ef`` planes, updated in place; fields without one pass
    through.  Returns the grads to ship, dequantized (float32).

    A slot can be a representative in several ranks' slices of the
    sharded backend's per-rank dedup: the residual drains into the
    globally first occurrence only (a scatter-min of positions over the
    whole window), and the errors of all occurrences are summed into the
    cleared slot, so ``sum(shipped) + residual' == sum(grads) + residual``
    per slot.  The residual rows are read by the gather kernel (valid: the
    first occurrences) and the errors banked by the scatter-add kernel
    (its counts name the touched rows); untouched rows keep their bits,
    ``-0.0`` included.

    The errors bank onto one ``(capacity, d)`` plane in ``slices``
    launches, one for each of the window's equal slices, in order.  With
    ``slices`` > 1 (the data axis's gathered window: the ranks'
    deduplicated slices in process order, each holding distinct slots) a
    launch adds at most once to an element, so a slot's errors sum in one
    fixed order and every replica banks the same bits (one launch's
    atomics would sum a slot's occurrences in no fixed order).

    Armed, the numerics tap gets the window's error sum-of-squares (a
    float32 device scalar, summed over the fields) and an installed
    tracer the drained and re-banked residual mass (``stage_ef`` under
    ``trace_backend``, read back to the host); the values shipped and
    banked do not change."""
    from swiftmpi_tpu_torch.kernels.gather import masked_gather
    from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
    ded_slots = ded_slots.to(torch.int32).contiguous()
    valid = ded_slots >= 0
    first = valid & (window_owners(ded_slots[None], capacity)[0][0]
                     == torch.arange(ded_slots.shape[0], dtype=torch.int32,
                                     device=ded_slots.device))
    out = dict(ded_grads)
    touched = None
    tap = _NUMERICS_TAP
    tracer = obs.get_tracer()
    err_sq = drained = rebanked = None
    for f, g in ded_grads.items():
        ef = planes.get(f)
        if ef is None:
            continue
        res = masked_gather(ef, ded_slots, first)
        tot = g.to(torch.float32) + res
        deq = torch.where(valid[:, None], quantize_dequantize(tot, quant),
                          0.0)
        take = touched is None
        d = tot.shape[-1]
        bank = torch.zeros((capacity, d), dtype=torch.float32,
                           device=tot.device)
        cnt = (torch.zeros(capacity, dtype=torch.float32, device=tot.device)
               if take else None)
        for s_slots, s_valid, s_err in zip(
                ded_slots.view(slices, -1), valid.view(slices, -1),
                (tot - deq).contiguous().view(slices, -1, d)):
            masked_scatter_add(s_slots, s_valid, s_err, capacity,
                               counts=take,
                               out=(bank, cnt) if take else bank)
        if take:
            touched = cnt > 0
        ef.copy_(torch.where(touched[:, None], bank, ef))
        out[f] = deq
        if tap is not None or tracer is not None:
            err = torch.where(valid[:, None], tot - deq, 0.0)
        if tap is not None:
            fsq = err.square().sum()
            err_sq = fsq if err_sq is None else err_sq + fsq
        if tracer is not None:
            d, e = res.abs().sum(), err.abs().sum()
            drained = d if drained is None else drained + d
            rebanked = e if rebanked is None else rebanked + e
    if err_sq is not None:
        numerics_quant_err(err_sq)
    if tracer is not None and drained is not None:
        tracer.stage_ef(trace_backend or "?", float(drained),
                        float(rebanked))
    return out


def _state_capacity(state) -> int:
    """Rows of the table's slot space: a field's rows, summed over its
    shards for a sharded state."""
    v = next(iter(state.values()))
    if isinstance(v, (list, tuple)):
        return sum(int(t.shape[0]) for t in v)
    return int(v.shape[0])


def _flat(x):
    """A ``(W, B, ...)`` window array (tensor or numpy) as ``(W*B, ...)``."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def pull_row_bytes(state, fields) -> int:
    """Wire bytes per pulled row: an int32 request index plus the pulled
    fields' widths at the table's stored dtypes."""
    return 4 + sum(_width_bytes(state[f]) for f in fields)


class PushSpec:
    """One gradient-family push ``(slots, grads, mean)``.  A span family
    (stencil rendering) also carries ``counts``: rows indexed by span
    position, each the sum of ``counts[i]`` contributions, pushed through
    :meth:`Transfer.push_span`.  A ``dense`` family (the dense-logits
    rendering) has no slots: its grads are capacity-shaped and already
    normalized, and the access method applies them to the whole table."""

    def __init__(self, slots, grads, mean: bool = False, counts=None,
                 dense: bool = False):
        self.slots = slots
        self.grads = grads
        self.mean = bool(mean)
        self.counts = counts
        self.dense = bool(dense)


class Transfer:
    """Backend interface: pull through the interpreter and
    ``_prim_pull``, push through the dense or sparse apply by the
    per-call crossover."""

    name: str = "?"
    #: book the wire ledger (off by default, as in the JAX package)
    count_traffic: bool = False

    # -- the window plan's knobs (read by the plan cache key) ---------------
    #: post-dedup unique rows of a window, for the sparse/dense crossover
    #: (set by the model from the vocab's counts); None: the raw rows
    window_expected_unique: Optional[float] = None
    #: value quantization of the window's sparse rungs: ``off``, ``int8``
    #: or ``bf16`` (arms ``sparse_q`` and its ``@ef`` error feedback)
    wire_quant: str = "off"
    #: ``sparse_q`` wins only when its volume times this beats the best
    #: lossless rung
    wire_quant_guard: float = 1.25
    #: arm the ``sparse_sketch`` rung (lossless: a counting sketch in place
    #: of the index stream)
    wire_sketch: bool = False
    #: the dense and hot reconciles' collective: ``psum``, ``auto`` (priced
    #: by the touched fraction) or ``sparse_allreduce``
    collective_mode: str = "psum"
    #: expected touched fraction of the hot plane a window (``auto``'s
    #: density signal); None: unknown, the dense collective wins
    hot_touched_fraction: Optional[float] = None
    #: the sparse collective must beat the dense one by this factor
    sparse_ar_ratio: float = 2.0

    # -- the pull plan's knobs --------------------------------------------
    #: value quantization of the pull wire (``transfer.plan.
    #: PULL_QUANT_MODES``); the table is never written through it
    pull_quant: str = "off"
    #: an encoded pull format wins only when its volume times this beats
    #: ``full_f32``
    pull_quant_guard: float = 1.25
    #: lines of the versioned pull cache (0: off); needs the table's
    #: ``@rowver`` plane
    pull_cache: int = 0
    #: the cache stores rows and checks every hit against the fresh row
    pull_cache_oracle: bool = False

    #: window decision -> its ``window_fmt_*`` key
    _WINDOW_FMT_KEY = {"dense": "window_fmt_dense",
                       "sparse": "window_fmt_sparse",
                       "sparse_q": "window_fmt_q",
                       "bitmap": "window_fmt_bitmap",
                       "sparse_sketch": "window_fmt_sketch"}
    #: collective -> its ``collective_*`` key
    _COLLECTIVE_KEY = {"psum": "collective_psum",
                       "psum_scatter": "collective_psum",
                       "sparse_allreduce": "collective_sparse_ar"}
    #: pull decision -> its ``pull_fmt_*`` key
    _PULL_FMT_KEY = {"full_f32": "pull_fmt_full",
                     "bf16": "pull_fmt_bf16",
                     "sparse_q": "pull_fmt_q"}

    #: processes on the data axis, each holding a replica, and this one's
    #: position (``set_data_axis``)
    dp: int = 1
    dp_rank: int = 0

    def __init__(self):
        #: pushes per (grad families, path) — e.g. ``{"h:dense": 20}``
        self.push_paths: Counter = Counter()
        self._host_ledger = np.zeros(len(_INDEX), np.int64)
        self._ledgers: Dict[torch.device, torch.Tensor] = {}

    # -- the data axis -----------------------------------------------------
    def set_data_axis(self, dp: int, rank: int) -> None:
        """Run as process ``rank`` of ``dp``, each holding a replica: every
        push is reconciled across them."""
        self.dp, self.dp_rank = int(dp), int(rank)

    def _book_dp(self, words: torch.Tensor) -> None:
        """Book the bytes an all-gather of ``words`` sends to the other
        processes."""
        if self.count_traffic:
            self._book(None, psum_bytes=(self.dp - 1) * words.numel()
                       * words.element_size())

    def _dp_psum(self, tensors):
        """The process-ordered sums of ``tensors`` (4-byte dtypes, one
        device) over the data axis, through one exchange."""
        from swiftmpi_tpu_torch.parallel.collectives import psum_many
        if self.dp > 1 and self.count_traffic:
            self._book(None, psum_bytes=(self.dp - 1) * sum(
                t.numel() * 4 for t in tensors))
        return psum_many(tensors)

    def _dp_agree(self, what: str, value) -> None:
        """Under ``dp > 1``: raise unless every process holds the same
        host ``value`` (a plan, a decision)."""
        if self.dp > 1:
            from swiftmpi_tpu_torch.parallel.collectives import host_agree
            host_agree(f"{self.name}: {what}", value)

    def _dp_reconcile_rows(self, slots: torch.Tensor, grads, counts,
                           capacity: int):
        """The rows of R owners, ``slots`` ``(R, L)`` int32 over a
        ``capacity``-row space (``-1`` padding), ``grads`` ``{f: (R, L,
        d)}``, ``counts`` ``(R, L)`` or None (one a row), reconciled over
        the data axis.  Each process folds its rows per slot (B3,
        :func:`window_dedup`); the folded rows cross the processes in one
        exchange; every process then sums them in process order: a
        scatter-add of each process's slice onto the first position of
        its slot in the process-major concatenation, one launch for the
        ``R * dp`` slices (distinct slots within each, so no two atomics
        meet), then the slices' planes added in process order.  Returns
        ``(slots_g, grads_g, counts_g)``: ``(R, dp * L)`` int32 with
        ``-1`` off the first positions, ``{f: (R, dp * L, d)}`` and
        ``(R, dp * L)``."""
        from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
        from swiftmpi_tpu_torch.parallel.collectives import all_gather
        R, L = slots.shape
        dp = self.dp
        ded, dgrads, dcounts = window_dedup(slots, grads, counts, capacity)
        fields = sorted(dgrads)
        widths = [dgrads[f].shape[-1] for f in fields]
        words = torch.cat(
            [ded[..., None]] + [dgrads[f].view(torch.int32) for f in fields]
            + [dcounts.view(torch.int32)[..., None]], -1)
        self._book_dp(words)
        K = words.shape[-1]
        got = all_gather(words, tiled=False)            # (dp, R, L, K)
        got = got.transpose(0, 1).reshape(R, dp * L, K)
        gslots = got[..., 0].contiguous()
        owner, valid = window_owners(gslots, capacity)
        vals = got[..., 1:].contiguous().view(torch.float32)
        planes = masked_scatter_add(
            owner.view(R * dp, L), valid.view(R * dp, L),
            vals.view(R * dp, L, K - 1), dp * L).view(R, dp, dp * L, K - 1)
        acc = planes[:, 0].clone()
        for p in range(1, dp):
            acc += planes[:, p]
        pos = torch.arange(dp * L, dtype=torch.int32, device=slots.device)
        first = torch.where(valid & (owner == pos), gslots, -1)
        out, at = {}, 0
        for f, w in zip(fields, widths):
            out[f] = acc[..., at:at + w]
            at += w
        return first, out, acc[..., at]

    # -- the wire ledger ---------------------------------------------------
    def _ledger(self, device: torch.device) -> torch.Tensor:
        """The counter vector on ``device``, made on first use.  It must
        exist before a CUDA graph that books on it is captured: made
        during a capture, its zero fill would be replayed."""
        led = self._ledgers.get(device)
        if led is None:
            if device.type == "cuda" \
                    and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the traffic ledger has no counters on "
                    f"{device} yet: run a step eagerly with count_traffic "
                    "set before capturing a CUDA graph")
            led = self._ledgers[device] = torch.zeros(
                len(_INDEX), dtype=torch.int64, device=device)
        return led

    def _book(self, on, **counts) -> None:
        """Add ``counts`` (device scalars or ints) to the ledger: in place
        on the counters of ``on``'s device when ``on`` is a tensor, else
        on the host.  A no-op unless ``count_traffic`` (callers that
        compute a count on the device check it first)."""
        if not self.count_traffic:
            return
        if isinstance(on, torch.Tensor):
            led = self._ledger(on.device)
            for k, n in counts.items():
                if isinstance(n, torch.Tensor) or n:
                    led[_INDEX[k]].add_(n)
        else:
            for k, n in counts.items():
                self._host_ledger[_INDEX[k]] += int(n)
                self._obs_inc(k, int(n))

    def _obs_counter(self, reg, key: str):
        """The registry counter mirroring ``key`` for this backend (handles
        cached per registry: a test's registry reset makes new ones)."""
        cache = self.__dict__.get("_obs_cache")
        if cache is None or cache[0] is not reg:
            cache = self.__dict__["_obs_cache"] = (reg, {})
        c = cache[1].get(key)
        if c is None:
            name, labels = obs_series(key)
            c = cache[1][key] = reg.counter(name, backend=self.name,
                                            **labels)
        return c

    def _obs_inc(self, key: str, n: int) -> None:
        """Mirror a host ledger increment into the telemetry registry
        (one branch when telemetry is off)."""
        reg = obs.get_registry()
        if reg.enabled:
            self._obs_counter(reg, key).inc(n)

    #: ledger keys mirrored even at 0 (the JAX package books them on
    #: every read)
    _mirror_always: tuple = ()

    def _ledger_owners(self) -> list:
        """The transfers whose own ledgers make up :meth:`traffic` (the
        hybrid: itself and its tail)."""
        return [self]

    def _own_totals(self) -> Dict[str, int]:
        """This backend's own ledger (not its tail's), key by key."""
        c = self._counts()
        return {k: int(c[_INDEX[k]]) for k in WIRE_KEYS + ROUTE_KEYS}

    def mirror_traffic(self, reg) -> None:
        """Recorder sampler: bring every ``transfer/<key>{backend=}``
        series to its backend's ledger total (one read of the device
        counters).  A key that never moved creates no series; the sum of
        a key's series over the backends equals :meth:`traffic`'s."""
        if not reg.enabled:
            return
        for owner in self._ledger_owners():
            for k, v in owner._own_totals().items():
                if not v and k not in owner._mirror_always \
                        and k not in owner.__dict__.get(
                            "_obs_cache", (None, {}))[1]:
                    continue
                c = owner._obs_counter(reg, k)
                if v != c.value:
                    c.inc(v - c.value)

    def _decision_counts(self, decision: Optional[str]) -> dict:
        """The ledger keys one window decision books: the 2-way
        ``window_dense``/``window_sparse`` and its ``window_fmt_*``."""
        if not decision:
            return {}
        two_way = "window_dense" if decision == "dense" else "window_sparse"
        return {two_way: 1, self._WINDOW_FMT_KEY[decision]: 1}

    def _record_exchange(self, rows, row_bytes: int, base_bytes: int = 0,
                         on=None, decision: Optional[str] = None) -> None:
        """One push exchange of ``rows`` rows at ``row_bytes`` each, plus
        ``base_bytes`` of per-exchange overhead, and the window
        ``decision`` that chose it; ``on`` (default ``rows``) names the
        device whose counters book it."""
        self._book(rows if on is None else on,
                   wire_bytes=rows * int(row_bytes) + int(base_bytes),
                   dispatches=1, **self._decision_counts(decision))
        tr = obs.get_tracer()
        if tr is not None and self.count_traffic:
            # the tracer reads the count where the JAX package's ledger
            # callback lands (an armed tracer runs the steps eagerly)
            tr.on_exchange(self.name, int(rows), int(row_bytes),
                           base_bytes=int(base_bytes), decision=decision)

    def _record_coalesce(self, rows_in, rows_out,
                         decision: Optional[str] = None, on=None) -> None:
        """One window's pre-exchange dedup (rows before and after) and its
        wire-format decision, per execution: on the counters of ``on``'s
        device (default ``rows_in``'s), host integers for the oracle."""
        self._book(rows_in if on is None else on, coalesced_rows_in=rows_in,
                   coalesced_rows_out=rows_out,
                   **self._decision_counts(decision))
        tr = obs.get_tracer()
        if tr is not None and decision and self.count_traffic:
            # a decision-carrying dedup opens this backend's window
            # record; the following exchange seals it
            tr.on_window(self.name, decision, int(rows_in), int(rows_out))

    def _count_collective(self, collective: str) -> None:
        """One reconcile's collective decision, on the host once per
        ``push_window`` call (the plan is host-static)."""
        self._book(None, **{self._COLLECTIVE_KEY[collective]: 1})

    def _record_pull(self, rows, row_bytes: int) -> None:
        """One pull of ``rows`` rows at ``row_bytes`` each; ``row_bytes``
        0 still counts the rows (the hybrid's hot hits ship nothing)."""
        self._book(rows, pull_bytes=rows * int(row_bytes), pull_rows=rows)

    def _record_pull_hot(self, rows) -> None:
        """``rows`` pull hits answered by the local hot plane (also in
        ``pull_rows``, at 0 bytes)."""
        self._book(rows, pull_hot_rows=rows)

    def _record_saved(self, nbytes, on=None) -> None:
        """The wire bytes a sparse-allreduce reconcile saved over the
        dense collective it replaced (the dense model minus what was
        booked; negative when the window touched most rows)."""
        self._book(nbytes if on is None else on, hot_psum_bytes_saved=nbytes)

    def _count_pull_decision(self, decision: str) -> None:
        """One armed pull's format decision, on the host once per ``pull``
        call (the plan is host-static)."""
        self._book(None, **{self._PULL_FMT_KEY[decision]: 1})

    def _pull_shadow_get(self):
        """This worker's :class:`~swiftmpi_tpu_torch.transfer.pull_cache.
        PullCache` shadow, rebuilt when ``pull_cache`` (its lines) or the
        oracle mode moved."""
        from swiftmpi_tpu_torch.transfer.pull_cache import PullCache
        sh = self.__dict__.get("_pull_shadow")
        lines, oracle = int(self.pull_cache), bool(self.pull_cache_oracle)
        if sh is None or sh.lines != lines or sh.store_rows != oracle:
            sh = self.__dict__["_pull_shadow"] = PullCache(
                lines, store_rows=oracle)
        return sh

    def pull_shadow_flush(self) -> None:
        """Drop every cached ``(slot, version)`` tag: the worker starts
        cold (after a restore, which can rewind the version stamps)."""
        sh = self.__dict__.get("_pull_shadow")
        if sh is not None:
            sh.flush()

    def _accum_pull_cached(self, val_bytes: int, full_row_bytes: int,
                           capacity: int, fields, slots, versions,
                           *rows) -> None:
        """One cached pull on the host: the shadow looks ``(slots,
        versions)`` up, and the ledger books the delta-pull wire, 8 bytes
        a valid row (key and watermark), ``ceil(valid / 8)`` bytes of hit
        bitmap and ``val_bytes`` a missed row, against the uncached
        ``full_row_bytes`` a row (the difference on ``pull_bytes_saved``).
        ``rows`` (oracle mode) are the fresh fields the shadow checks hits
        against."""
        sh = self._pull_shadow_get()
        slots = np.asarray(slots).ravel()
        rowmap = dict(zip(fields, rows)) if rows else None
        hit = sh.lookup(slots, versions, int(capacity), rows=rowmap)
        n_valid = int((slots >= 0).sum())
        n_hit = int(hit.sum())
        n_miss = n_valid - n_hit
        booked = 8 * n_valid + (n_valid + 7) // 8 + n_miss * int(val_bytes)
        self._book(None, pull_bytes=booked, pull_rows=n_valid,
                   pull_cache_hits=n_hit, pull_delta_rows=n_miss,
                   pull_bytes_saved=max(
                       0, n_valid * int(full_row_bytes) - booked))

    def _counts(self) -> np.ndarray:
        """Host copy of the ledger: the host counters plus every device's
        (one read a device)."""
        total = self._host_ledger.copy()
        for led in self._ledgers.values():
            total += led.cpu().numpy()
        return total

    def _count(self, key: str) -> int:
        return int(self._counts()[_INDEX[key]])

    def wire_traffic(self) -> Dict[str, int]:
        """The cumulative wire ledger: ``wire_bytes`` and ``dispatches``
        of the push exchanges, ``pull_bytes``/``pull_rows``/
        ``pull_hot_rows`` of the pulls, the window push's decisions,
        coalesced rows, collectives and plan counters, and the pull
        plan's format and cache keys.  Every value is a total that never
        decreases; there is no reset (see :meth:`traffic_delta`)."""
        c = self._counts()
        return {k: int(c[_INDEX[k]]) for k in WIRE_KEYS}

    def traffic(self) -> Dict[str, int]:
        """Cumulative traffic counters: the wire ledger, extended by the
        backends with routed and hot paths, and ``psum_bytes`` (the bytes
        sent to other processes) on the data axis.  Same contract as
        :meth:`wire_traffic`."""
        out = self.wire_traffic()
        if self.dp > 1:
            out["psum_bytes"] = self._count("psum_bytes")
        return out

    def traffic_delta(self, since: Optional[Dict[str, int]] = None
                      ) -> Dict[str, int]:
        """:meth:`traffic` minus an earlier snapshot ``since`` (itself a
        ``traffic()`` value); a key absent from ``since`` subtracts 0."""
        cur = self.traffic()
        if not since:
            return cur
        return {k: v - since.get(k, 0) for k, v in cur.items()}

    # -- pull: the interpreter ---------------------------------------------
    def pull(self, state: TableState, slots, access: AccessMethod,
             fields=None) -> TableState:
        """Rows of ``fields`` (default: the access method's pull fields) at
        int32 ``slots``; ``-1`` yields zero rows.  Dispatches on the
        backend's pull route and books the pull ledger here; backends
        keep only ``_prim_pull``."""
        from swiftmpi_tpu_torch.transfer.plan import pull_route
        fields = tuple(fields or access.pull_fields)
        if pull_route(self.name).placement == "hot_split":
            return self._interpret_pull_hot_split(state, slots, access,
                                                  fields)
        return self._interpret_pull_flat(state, slots, fields)

    def _interpret_pull_flat(self, state: TableState, slots,
                             fields) -> TableState:
        """One gather over the whole slot space through ``_prim_pull``.
        Armed, the plan's format prices the wire (an encoded format
        quantizes and dequantizes the pulled rows) and, with the
        ``@rowver`` plane in the state, the versions ride the same gather
        and the cache shadow books the delta wire on the host."""
        from swiftmpi_tpu_torch.transfer.plan import pull_route
        eager = pull_route(self.name).eager
        row_bytes = pull_row_bytes(state, fields)

        def n_valid():
            return (int((np.asarray(slots) >= 0).sum()) if eager
                    else (slots >= 0).sum())
        quant = self.pull_quant
        if quant == "off" and not self.pull_cache:
            if self.count_traffic:
                self._record_pull(n_valid(), row_bytes)
            return self._prim_pull(state, slots, fields)
        qrb = (quant_pull_row_bytes(state, fields, quant)
               if quant != "off" else None)
        plan = self._pull_plan(int(np.prod(slots.shape)),
                               _state_capacity(state), row_bytes, qrb)
        if plan.cached and ROWVER_KEY in state:
            out = self._prim_pull(state, slots, fields + (ROWVER_KEY,))
            vers = out.pop(ROWVER_KEY)
            if self.count_traffic:
                rows = (tuple(_host_copy(out[f]) for f in fields)
                        if self.pull_cache_oracle else ())
                self._accum_pull_cached(
                    plan.wire_row_bytes - 4, row_bytes,
                    _state_capacity(state), fields, _host_copy(slots),
                    _host_copy(vers), *rows)
        else:
            out = self._prim_pull(state, slots, fields)
            if self.count_traffic:
                self._record_pull(n_valid(), plan.wire_row_bytes)
        if plan.wire_format != "full_f32":
            out = {f: quantize_dequantize(out[f], plan.quant)
                   for f in fields}
        return out

    def _pull_plan(self, rows: int, capacity: int, row_bytes: int,
                   quant_row_bytes: Optional[int] = None):
        """Compile (or fetch) the pull's :class:`~swiftmpi_tpu_torch.
        transfer.plan.PullPlan`, booking the compile or the hit and the
        format decision on the host."""
        from swiftmpi_tpu_torch.transfer.plan import compile_pull_plan
        plan, hit = compile_pull_plan(self, int(rows), int(capacity),
                                      int(row_bytes), quant_row_bytes)
        self._book(None, **{"plan_cache_hits" if hit else "plan_compiles":
                            1})
        self._count_pull_decision(plan.wire_format)
        tr = obs.get_tracer()
        if tr is not None:
            tr.on_decision(self.name, "pull_" + plan.wire_format,
                           plan.prices, plan.rows, plan.capacity,
                           plan.row_bytes, quant=plan.quant)
        return plan

    def _interpret_pull_hot_split(self, state: TableState, slots, access,
                                  fields) -> TableState:
        """The ``hot_split`` placement (hybrid): tail slots re-based by
        ``-n_hot`` and pulled through the tail backend (whose ledger,
        pull plan and cache book them), hot hits read from the hot planes
        by the gather kernel at 0 wire bytes and never quantized, the two
        merged by a select, not a sum (``-0.0`` rows keep their sign).  Uses the hybrid backend's ``_pad_batch``,
        ``_split_state`` and ``_n_hot``."""
        from swiftmpi_tpu_torch.kernels.gather import masked_gather
        slots = slots.to(torch.int32)
        slots, _, _, B = self._pad_batch(slots)
        tail_state, hot_state = self._split_state(state)
        n_hot = self._n_hot(state)
        if n_hot == 0:
            out = self.tail.pull(tail_state, slots, access, fields=fields)
            return {f: v[:B] for f, v in out.items()}
        is_hot = (slots >= 0) & (slots < n_hot)
        tail_slots = torch.where(slots >= n_hot, slots - n_hot, -1)
        out = self.tail.pull(tail_state, tail_slots, access, fields=fields)
        if self.count_traffic:
            n = is_hot.sum()
            self._record_hot(n, 0)
            self._record_pull(n, 0)
            self._record_pull_hot(n)
        return {f: torch.where(is_hot[:, None],
                               masked_gather(hot_state[f], slots, is_hot),
                               out[f])[:B]
                for f in fields}

    # -- push -----------------------------------------------------------------
    def push(self, state: TableState, slots: torch.Tensor, grads,
             access: AccessMethod, mean: bool = False) -> TableState:
        """Combine ``grads`` rows by int32 ``slots`` (``-1`` = padding),
        optionally mean-normalized per slot, and apply them to ``state``
        in place.  Dense once the batch reaches ``int(capacity / 2.0)``
        rows, exactly the JAX ``XlaTransfer.push`` rule; the ledger books
        a dense push as every row without the index, a sparse one as its
        valid rows."""
        capacity = next(iter(state.values())).shape[0]
        dense = self._push_is_dense(slots, capacity)
        self.push_paths[f"{','.join(grads)}:"
                        f"{'dense' if dense else 'sparse'}"] += 1
        if self.count_traffic:
            if dense:
                self._record_exchange(
                    capacity, grad_row_bytes(grads, with_index=False),
                    on=slots)
            else:
                self._record_exchange((slots >= 0).sum(),
                                      grad_row_bytes(grads))
        if dense:
            return self._push_dense(state, slots, grads, access, mean)
        return self._push_sparse(state, slots, grads, access, mean)

    def _push_is_dense(self, slots: torch.Tensor, capacity: int) -> bool:
        """:meth:`push`'s crossover: dense once the global batch (as the
        JAX package's global arrays see it) reaches ``capacity / ratio``
        rows."""
        return slots.shape[0] * self.dp >= int(
            capacity / self.wire_dense_ratio("push_apply"))

    def push_span(self, state: TableState, slots: torch.Tensor, grads,
                  counts: torch.Tensor, access: AccessMethod,
                  mean: bool = False, _wire=None) -> TableState:
        """Push a position-indexed span family: row ``i`` of ``grads`` is
        the sum of ``counts[i]`` contributions to slot ``slots[i]``
        (``-1`` = padding); duplicate slots are combined without a sort and
        ``mean=True`` divides by the summed counts.  The JAX package's
        ``XlaTransfer.push_span``.  ``_wire`` (an encoded window's
        ``(row_bytes, base_bytes)``) replaces the ledger's row model."""
        self.push_paths[f"{','.join(grads)}:span"] += 1
        if self.count_traffic:
            rb, bb = (_wire if _wire is not None
                      else (grad_row_bytes(grads, with_counts=True), 0))
            self._record_exchange((slots >= 0).sum(), rb, base_bytes=bb)
        return self._push_span(state, slots, grads, counts, access, mean)

    # -- the window push: the TrafficPlan interpreter -------------------------
    def wire_dense_ratio(self, family: Optional[str] = None) -> float:
        """The sparse/dense crossover ratio of a push family (None: the
        default family)."""
        ratios = self.__dict__.get("_wire_ratios", {})
        return float(ratios.get(family, ratios.get(None, DENSE_RATIO)))

    def set_wire_dense_ratio(self, ratio: float,
                             family: Optional[str] = None) -> None:
        """Set the crossover ratio of ``family`` (None: the default); the
        next plan compile prices with it."""
        self.__dict__.setdefault("_wire_ratios", {})[family] = float(ratio)

    def _window_plan(self, rows: int, capacity: int, row_bytes: int,
                     quant_row_bytes: Optional[int] = None,
                     family: Optional[str] = "window",
                     with_counts: bool = True):
        """Compile (or fetch) the :class:`~swiftmpi_tpu_torch.transfer.
        plan.TrafficPlan` of one window shape and book the compile or the
        cache hit on the host."""
        from swiftmpi_tpu_torch.transfer.plan import compile_window_plan
        # the global window's rows, as the JAX package's global arrays
        # price them
        plan, hit = compile_window_plan(
            self, int(rows) * self.dp, int(capacity), int(row_bytes),
            quant_row_bytes, with_counts, family=family)
        self._dp_agree("the window plan", plan)
        self._book(None, **{"plan_cache_hits" if hit else "plan_compiles":
                            1})
        tr = obs.get_tracer()
        if tr is not None:
            tr.on_decision(self.name, plan.wire_format, plan.prices,
                           plan.rows, plan.capacity, plan.row_bytes,
                           quant=plan.quant)
        return plan

    def _hot_plan(self, n_hot: int, width_bytes: int):
        """Compile (or fetch) the hot plane's reconcile plan, booked as
        :meth:`_window_plan` books."""
        from swiftmpi_tpu_torch.transfer.plan import compile_hot_plan
        plan, hit = compile_hot_plan(self, int(n_hot), int(width_bytes))
        self._dp_agree("the hot plan", plan)
        self._book(None, **{"plan_cache_hits" if hit else "plan_compiles":
                            1})
        tr = obs.get_tracer()
        if tr is not None:
            tr.on_decision(self.name, "hot_" + plan.collective,
                           plan.prices, plan.rows, plan.capacity,
                           plan.row_bytes)
        return plan

    def decide_wire_format(self, rows: int, capacity: int, row_bytes: int,
                           family: Optional[str] = None,
                           quant_row_bytes: Optional[int] = None) -> str:
        """The wire format of one exchange of ``rows`` candidate rows
        against a ``capacity``-row dense alternative: the window plan's
        decision."""
        return self._window_plan(rows, capacity, row_bytes,
                                 quant_row_bytes=quant_row_bytes,
                                 family=family).wire_format

    def push_window(self, state: TableState, slots, grads,
                    access: AccessMethod, mean: bool = False,
                    counts=None) -> TableState:
        """Window-coalesced push: ``slots`` ``(W, B)``, ``grads`` ``{f: (W,
        B, d)}``, ``counts`` (optional, a span family) ``(W, B)``; W
        steps' pushes summed and exchanged once.  Push's rule extended
        over the window: every (step, position) contribution to a slot is
        summed, ``mean`` divides by the window's total count, and the
        access rule runs once per slot a window.

        W == 1 is the flatten of a unit axis and the per-step
        ``push``/``push_span``, bit for bit; so is a W > 1 window on a
        route that does not always decide (``local``, ``xla``) with every
        compression knob off.  Otherwise one plan a window, executed
        over the backend's primitives."""
        from swiftmpi_tpu_torch.transfer.plan import window_route
        route = window_route(self.name)
        shaped = (np.asarray(slots, np.int64) if route.eager
                  else slots.to(torch.int32))
        if shaped.ndim < 2 or shaped.shape[0] == 1:
            return self._push_window_passthrough(state, slots, grads, access,
                                                 mean=mean, counts=counts)
        armed = self.wire_quant != "off" or bool(self.wire_sketch)
        if not route.always_decide and not armed:
            return self._push_window_passthrough(state, slots, grads, access,
                                                 mean=mean, counts=counts)
        # flatten the (W, B) window once, in the route's element space
        flat = shaped.reshape(-1)
        if route.eager:
            fgrads = {f: _flat(np.asarray(g, np.float32))
                      for f, g in grads.items()}
            fcounts = (None if counts is None
                       else np.asarray(counts, np.float32).reshape(-1))
        else:
            fgrads = {f: _flat(g) for f, g in grads.items()}
            fcounts = (None if counts is None
                       else counts.to(torch.float32).reshape(-1))
        if not route.counts_follow_data and fcounts is None:
            # the oracle routes price and ship counts rows regardless
            fcounts = (np.ones(flat.shape, np.float32) if route.eager
                       else torch.ones(flat.shape, dtype=torch.float32,
                                       device=flat.device))
        if route.placement == "hot_split":
            return self._interpret_window_hot_split(
                state, flat, fgrads, fcounts, access, mean,
                counts_present=counts is not None)
        return self._interpret_window_flat(
            state, flat, fgrads, access, mean, fcounts,
            passthrough=(slots, grads, counts))

    def _push_window_passthrough(self, state: TableState, slots, grads,
                                 access: AccessMethod, mean: bool = False,
                                 counts=None) -> TableState:
        """The no-plan window: flatten, then the per-step ``push`` (or
        ``push_span`` with ``counts``)."""
        flat = slots.reshape(-1)
        fgrads = {f: _flat(g) for f, g in grads.items()}
        if counts is not None:
            return self.push_span(state, flat, fgrads, counts.reshape(-1),
                                  access, mean=mean)
        return self.push(state, flat, fgrads, access, mean=mean)

    def _prim_window_dedup(self, flat, fgrads, fcounts, capacity: int):
        """Collapse the repeated slots of a flattened window into their
        first occurrence, summing grads and counts: ``(ded_slots,
        ded_grads, ded_counts)`` of the same shapes, non-representatives
        ``-1``.  Default: the single-device representative trick over a
        ``(capacity + 1,)`` plane (:func:`window_dedup`)."""
        ded, dg, dc = window_dedup(
            flat[None], {f: g[None] for f, g in fgrads.items()},
            None if fcounts is None else fcounts[None], capacity)
        return ded[0], {f: g[0] for f, g in dg.items()}, dc[0]

    def _side_plane(self, state, key: str) -> torch.Tensor:
        """A tail-shaped side plane (``@ef``) as one ``(capacity, d)``
        tensor that updates in place: the state's own tensor here."""
        return state[key]

    def _prim_ef_drain(self, state, ded_slots, ded_grads, capacity: int,
                       quant: str):
        """Drain the ``@ef`` residuals into the deduplicated sums,
        quantize and dequantize them, bank the new error
        (:func:`ef_quantize_window`, the planes in place).  Returns
        ``(state, grads)``."""
        planes = {f: self._side_plane(state, ef_name(f))
                  for f in ded_grads if ef_name(f) in state}
        if self.dp > 1:
            return state, self._dp_ef_drain(planes, ded_slots, ded_grads,
                                            capacity, quant)
        return state, ef_quantize_window(planes, ded_slots, ded_grads,
                                         capacity, quant,
                                         trace_backend=self.name)

    def _dp_ef_drain(self, planes, ded_slots, ded_grads, capacity: int,
                     quant: str):
        """The error feedback over the data axis: the processes'
        deduplicated windows gathered in process order (one exchange, the
        JAX package's global window) and :func:`ef_quantize_window` run on
        the whole of it, so every replica drains into the same first
        occurrences and banks the same residuals; this process ships its
        own slice of the dequantized sums."""
        from swiftmpi_tpu_torch.parallel.collectives import all_gather
        fields = sorted(ded_grads)
        L = ded_slots.shape[0]
        words = torch.cat(
            [ded_slots.to(torch.int32).reshape(L, 1)]
            + [ded_grads[f].to(torch.float32).view(torch.int32)
               for f in fields], -1)
        self._book_dp(words)
        got = all_gather(words)                       # (dp * L, K)
        gslots, gg, at = got[:, 0].contiguous(), {}, 1
        for f in fields:
            w = ded_grads[f].shape[-1]
            gg[f] = got[:, at:at + w].contiguous().view(torch.float32)
            at += w
        # each rank's slice of each process's window holds distinct slots
        out = ef_quantize_window(planes, gslots, gg, capacity, quant,
                                 trace_backend=self.name,
                                 slices=self.dp * getattr(self, "n", 1))
        mine = slice(self.dp_rank * L, (self.dp_rank + 1) * L)
        return {f: out[f][mine] for f in fields}

    def _prim_window_exchange(self, state, ded_slots, ded_grads,
                              ded_counts, access, mean: bool,
                              need_counts: bool, wire):
        """Ship a deduplicated window's surviving rows, booked at the
        plan's encoded ``wire`` when it has one.  Default: the span family
        (counts always ride)."""
        return self.push_span(state, ded_slots, ded_grads, ded_counts,
                              access, mean=mean, _wire=wire)

    def _prim_sparse_allreduce(self, state, flat, fgrads, access,
                               mean: bool, fcounts):
        """The sparse allreduce of a window that densified: on one
        program the split-and-exchange is the merge of the window's rows
        (``merge_rows``, one scatter-add launch a family; the mean's counts
        by ``merge_counts``) and one AdaGrad launch over the table, the
        mean's reciprocal inside it; the touched rows' versions bumped."""
        from swiftmpi_tpu_torch.transfer.sparse_allreduce import (
            merge_counts, merge_rows)
        capacity = _state_capacity(state)
        self.push_paths[f"{','.join(sorted(fgrads))}:sparse_ar"] += 1
        dense = {f: merge_rows(flat, g, capacity) for f, g in fgrads.items()}
        inv = None
        if mean:
            counts = (fcounts if fcounts is not None
                      else torch.ones(flat.shape, dtype=torch.float32,
                                      device=flat.device))
            inv = 1.0 / merge_counts(flat, counts, capacity).clamp(min=1.0)
        access.apply_push(state, dense, mul=inv)
        if ROWVER_KEY in state:
            bump_row_versions(state[ROWVER_KEY], touched_rows(
                flat, flat >= 0, capacity))
        return state

    def _push_window_dense(self, state, flat, fgrads, access, mean: bool,
                           fcounts):
        raise NotImplementedError

    def _interpret_window_flat(self, state, flat, fgrads, access,
                               mean: bool, fcounts, pre_deduped=False,
                               passthrough=None):
        """Run one window's plan over a flattened W > 1 window.
        ``pre_deduped``: the rows already went through the hybrid's
        unified-space dedup, so the dedup primitive is skipped and the
        decision is booked with zero rows.  ``passthrough``: the original
        ``(slots, grads, counts)``, for routes whose lossless decisions
        run as the per-step push."""
        from swiftmpi_tpu_torch.transfer.plan import window_route
        route = window_route(self.name)
        capacity = _state_capacity(state)
        with_counts = ((fcounts is not None) if route.counts_follow_data
                       else True)
        row_bytes = grad_row_bytes(fgrads, with_counts=with_counts)
        quant = self.wire_quant
        qrb = (quant_grad_row_bytes(fgrads, quant, with_counts=with_counts)
               if quant != "off" else None)
        plan = self._window_plan(flat.shape[0], capacity, row_bytes,
                                 quant_row_bytes=qrb, family="window",
                                 with_counts=with_counts)
        spec, decision = plan.spec, plan.wire_format
        if decision == "dense" and route.always_decide:
            self._count_collective(plan.collective)
            if plan.collective == "sparse_allreduce":
                if self.count_traffic:
                    self._book_sparse_allreduce(flat, fgrads, capacity, mean,
                                                route.eager)
                return self._prim_sparse_allreduce(state, flat, fgrads,
                                                   access, mean, fcounts)
            if self.count_traffic:
                # the static table size, not the row count
                self._record_exchange(
                    capacity, grad_row_bytes(fgrads, with_index=False,
                                             with_counts=mean),
                    on=flat, decision="dense")
            return self._push_window_dense(state, flat, fgrads, access,
                                           mean, fcounts)
        if not spec.dedup and not route.dedups_lossless:
            # the oracle routes run their lossless decisions as the
            # per-step push; the decision is still booked
            if self.count_traffic:
                self._record_coalesce(0, 0, decision=decision,
                                      on=None if route.eager else flat)
            slots0, grads0, counts0 = passthrough
            return self._push_window_passthrough(
                state, slots0, grads0, access, mean=mean, counts=counts0)
        if pre_deduped:
            ded_slots, ded_grads, ded_counts = flat, fgrads, fcounts
            self._trace_keys(ded_slots, **self._trace_shard_args(capacity))
            if self.count_traffic:
                self._record_coalesce(0, 0, decision=decision, on=flat)
        else:
            ded_slots, ded_grads, ded_counts = self._prim_window_dedup(
                flat, fgrads, fcounts, capacity)
            # the key reservoir before the dedup's booking opens the
            # window record (obs/trace.py)
            self._trace_keys(ded_slots, **self._trace_shard_args(capacity))
            if self.count_traffic:
                if route.eager:
                    self._record_coalesce(int((flat >= 0).sum()),
                                          int((ded_slots >= 0).sum()),
                                          decision=decision)
                else:
                    self._record_coalesce((flat >= 0).sum(),
                                          (ded_slots >= 0).sum(),
                                          decision=decision)
        if spec.ef:
            state, ded_grads = self._prim_ef_drain(
                state, ded_slots, ded_grads, capacity, quant)
        # a mean needs the contribution counts the dedup collapsed; plain
        # sums need none
        need_counts = ((mean or with_counts) if route.counts_follow_data
                       else True)
        wire = (spec.wire(ded_grads, quant, capacity, need_counts)
                if spec.encoded else None)
        return self._prim_window_exchange(state, ded_slots, ded_grads,
                                          ded_counts, access, mean,
                                          need_counts, wire)

    def _trace_shard_args(self, capacity: int) -> dict:
        """What :meth:`_trace_keys` needs to split a window's surviving
        rows by destination shard (``cap_per_shard``, ``n_shards``); none
        here (one shard)."""
        return {}

    def _trace_keys(self, ded_slots, cap_per_shard: Optional[int] = None,
                    n_shards: Optional[int] = None) -> None:
        """Hand an installed tracer a bounded strided reservoir of the
        window's surviving (deduplicated, ``-1``-padded) slots and, where
        the backend knows its ``slot // cap_per_shard`` owners, the
        surviving rows per destination shard (read back to the host).
        Nothing without a tracer with a key reservoir."""
        tr = obs.get_tracer()
        if tr is None or tr.keys <= 0:
            return
        B = int(ded_slots.shape[0])
        if B == 0:
            return
        stride = max(B // int(tr.keys), 1)
        sample = _host_copy(ded_slots[::stride][:int(tr.keys)])
        shard_rows = None
        if cap_per_shard and n_shards:
            d = _host_copy(ded_slots).astype(np.int64)
            own = d[d >= 0] // int(cap_per_shard)
            shard_rows = np.bincount(own, minlength=int(n_shards))[
                :int(n_shards)]
        tr.stage_keys(self.name, sample, shard_rows)

    def _book_sparse_allreduce(self, flat, fgrads, capacity: int,
                               mean: bool, eager: bool) -> None:
        """The dense rung's sparse allreduce on the ledger: the touched
        rows (distinct valid slots of the window) at an int32 row id plus
        the value row each, and what that saved over the capacity-shaped
        buffer."""
        from swiftmpi_tpu_torch.transfer.sparse_allreduce import ROW_ID_BYTES
        val_bytes = grad_row_bytes(fgrads, with_index=False,
                                   with_counts=mean)
        if eager:
            f = np.asarray(flat)
            touched = int(np.unique(f[(f >= 0) & (f < capacity)]).size)
        else:
            touched = touched_rows(flat, flat >= 0, capacity).sum()
        self._record_exchange(touched, ROW_ID_BYTES + val_bytes,
                              on=None if eager else flat, decision="dense")
        self._record_saved(capacity * val_bytes
                           - touched * (ROW_ID_BYTES + val_bytes),
                           on=None if eager else flat)

    def _interpret_window_hot_split(self, state, flat, fgrads, fcounts,
                                    access, mean: bool,
                                    counts_present: bool):
        """The ``hot_split`` placement (hybrid): pad, dedup once in the
        unified slot space, reconcile the hot slice with the hot push
        and run the tail slice's plan on the tail backend
        (``pre_deduped``).  Uses the hybrid's ``_pad_batch``,
        ``_split_state``, ``_n_hot`` and ``_hot_push``."""
        flat, fgrads, fcounts, _ = self._pad_batch(flat, fgrads, fcounts)
        tail_state, hot_state = self._split_state(state)
        n_hot = self._n_hot(state)
        if n_hot == 0:
            self.tail._interpret_window_flat(tail_state, flat, fgrads,
                                             access, mean, fcounts)
            return state
        cap_tail = _state_capacity(tail_state)
        ded_slots, ded_grads, ded_counts = self.tail._prim_window_dedup(
            flat, fgrads, fcounts, n_hot + cap_tail)
        if self.count_traffic:
            self._record_coalesce((flat >= 0).sum(), (ded_slots >= 0).sum())
        is_hot = (ded_slots >= 0) & (ded_slots < n_hot)
        tail_slots = torch.where(ded_slots >= n_hot, ded_slots - n_hot, -1)
        # the grad widths plus the float32 counts column, which is also
        # the sparse wire's index cost: one number prices both collectives
        width_bytes = grad_row_bytes(ded_grads, with_index=False) + 4
        hot_plan = self._hot_plan(n_hot, width_bytes)
        self._count_collective(hot_plan.collective)
        tr = obs.get_tracer()
        if tr is not None:
            # the hot/tail split rides the TAIL's window record, which the
            # tail's plan opens below
            tr.stage(self.tail.name, hot_rows=int(is_hot.sum()),
                     hot_collective=hot_plan.collective)
        # the mean now depends on the collapsed multiplicities, so both
        # slices take the counts
        need_counts = mean or counts_present
        self.tail._interpret_window_flat(
            tail_state, tail_slots, ded_grads, access, mean,
            ded_counts if need_counts else None, pre_deduped=True)
        n = is_hot.sum()
        if hot_plan.collective == "sparse_allreduce":
            if self.count_traffic:
                # the touched hot rows of every rank's slice (the dedup is
                # per rank): what each feeds the reduce-scatter
                self._record_hot_sparse(n, width_bytes)
                self._record_exchange(n, width_bytes)
                self._record_saved((n_hot - n) * width_bytes)
            self._hot_push_sparse(hot_state, ded_slots, is_hot, ded_grads,
                                  access, mean,
                                  ded_counts if need_counts else None)
            return state
        if self.count_traffic:
            self._record_hot(n, n_hot * width_bytes)
            self._record_exchange(n_hot, width_bytes, on=n)
        self._hot_push(hot_state, ded_slots, is_hot, ded_grads, access,
                       mean, ded_counts if need_counts else None)
        return state

    def _prim_pull(self, state: TableState, slots, fields) -> TableState:
        """Masked row gather of ``fields`` at ``slots`` (``-1``: zero
        rows), no ledger."""
        raise NotImplementedError

    def _push_span(self, state, slots, grads, counts, access, mean=False):
        raise NotImplementedError

    def _push_dense(self, state, slots, grads, access, mean=False):
        raise NotImplementedError

    def _push_sparse(self, state, slots, grads, access, mean=False):
        raise NotImplementedError


def _host_copy(x) -> np.ndarray:
    """A host numpy copy of a tensor (read back from the card) or an
    array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def window_dedup(slots: torch.Tensor, grads, counts, capacity: int):
    """The window dedup of R ranks at once (the JAX package's
    representative trick, ``_prim_window_dedup``): ``slots`` ``(R, L)``
    int32 over a ``capacity``-row slot space, ``grads`` ``{f: (R, L,
    d)}`` float32, ``counts`` ``(R, L)`` or None (one a row).  Rank by
    rank, a scatter-min of positions into an ``(R, capacity + 1)`` plane
    names each slot's first position (its representative); every row's
    grads and count fold into its representative through the scatter-add
    kernel (one launch a family, the counts from the first family's when
    ``counts`` is None).  Returns ``(ded_slots, ded_grads, ded_counts)``
    of the same shapes: ``-1`` and zero rows off the representatives."""
    from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
    R, L = slots.shape
    owner, valid = window_owners(slots, capacity)
    ded_grads, ded_counts = {}, None
    for f in sorted(grads):
        take = counts is None and ded_counts is None
        res = masked_scatter_add(owner, valid, grads[f].contiguous(), L,
                                 counts=take)
        if take:
            res, ded_counts = res
        ded_grads[f] = res
    if counts is not None:
        ded_counts = masked_scatter_add(
            owner, valid, counts.to(torch.float32).reshape(R, L, 1)
            .contiguous(), L)[..., 0]
    pos = torch.arange(L, dtype=torch.int32, device=slots.device)
    return (torch.where(valid & (owner == pos), slots, -1), ded_grads,
            ded_counts)


def window_owners(slots: torch.Tensor, capacity: int):
    """Each row's representative position in its rank's slice of ``(R,
    L)`` int32 slots (the first position holding its slot: a scatter-min
    of positions into an ``(R, capacity + 1)`` plane, outside any kernel
    as in the JAX package) and the rows' validity; an invalid row's owner
    is ``L``, which the scatter-add drops.  Returns ``(owner, valid)``,
    ``owner`` int32."""
    R, L = slots.shape
    dev = slots.device
    valid = slots >= 0
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(R, L)
    safe = torch.where(valid, slots, capacity).long()
    rep = torch.full((R, capacity + 1), L, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(1, safe, torch.where(valid, pos, L), "amin")
    return torch.where(valid, rep.gather(1, safe), L).contiguous(), valid


def get_transfer(name: str, **kwargs) -> Transfer:
    """Backend by its ``[cluster] transfer`` name; ``tpu`` and ``hybrid``
    take the rank layout as ``mesh=`` (and ``bucket_capacity``,
    ``debug_overflow``, ``data_plane``)."""
    if name == "xla":
        from swiftmpi_tpu_torch.transfer.single import SingleTransfer
        return SingleTransfer(**kwargs)
    if name == "tpu":
        from swiftmpi_tpu_torch.transfer.sharded import ShardedTransfer
        return ShardedTransfer(**kwargs)
    if name == "hybrid":
        from swiftmpi_tpu_torch.transfer.hybrid import HybridTransfer
        return HybridTransfer(**kwargs)
    if name == "local":
        from swiftmpi_tpu_torch.transfer.local import LocalTransfer
        return LocalTransfer(**kwargs)
    raise ValueError(f"unknown transfer backend {name!r} "
                     "(expected xla|tpu|hybrid|local)")
