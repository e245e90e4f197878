"""The TrafficPlan compiler and the route tables of the transfer
interpreters (counterpart of ``swiftmpi_tpu/transfer/plan.py``).

Every window push compiles a :class:`TrafficPlan` (placement, dedup
stage, wire format, collective) from the live knobs, and one interpreter,
``Transfer.push_window`` (``transfer/api.py``), executes it over the
backends' primitives; the backends never ask the wire-format question.
:func:`compile_window_plan` and :func:`compile_hot_plan` cache each plan
under a key that holds every pricing input, the knobs still at their
defaults included, so a moved knob re-prices the next window with no
invalidation.  The pull family has its own: the pull routes are the
facts the pull interpreter (``Transfer.pull``) reads per backend, and an
armed pull (``pull_quant``, ``pull_cache``) compiles a :class:`PullPlan`
(:func:`compile_pull_plan`) in the same cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from swiftmpi_tpu_torch.transfer.sketch import OFFSET_BYTES, sketch_base_bytes

#: the wire-format ladder; every decision the pricer can return
WIRE_FORMATS = ("dense", "sparse", "bitmap", "sparse_q", "sparse_sketch")

#: the collectives a plan can name for the dense and hot reconciles
COLLECTIVES = ("psum", "psum_scatter", "sparse_allreduce")

#: legal values of ``[cluster] collective``
COLLECTIVE_MODES = ("psum", "auto", "sparse_allreduce")

#: the pull-wire ladder: ``full_f32`` ships rows at their stored dtype,
#: ``bf16`` halves the values, ``sparse_q`` ships int8 rows with a float32
#: scale a row and field (the delta codec's scheme, ``transfer/delta.py``)
PULL_FORMATS = ("full_f32", "bf16", "sparse_q")

#: legal values of ``[cluster] pull_quant``: ``bf16`` and ``int8`` arm the
#: encoded rung, which still has to clear the guard to be chosen
PULL_QUANT_MODES = ("off", "bf16", "int8")


@dataclass(frozen=True)
class WireFormatSpec:
    """One rung of the wire ladder: what the interpreter must do for a
    window that chose it.  ``dedup``: the window is deduplicated before
    the exchange.  ``ef``: error-feedback residuals around a lossy value
    encoding.  ``encoded``: the exchange is booked at the size
    :meth:`wire` gives rather than the executor's sparse row model."""

    name: str
    lossless: bool
    dedup: bool
    ef: bool
    encoded: bool

    def wire(self, grads, quant: str, capacity: int,
             with_counts: bool) -> Optional[Tuple[int, int]]:
        """``(row_bytes, base_bytes)`` the ledger books one exchange of
        this format at, or ``None`` for the executor's default model (the
        unencoded rungs).  Agrees with the pricer's byte models
        (``parameter.key_index.price_window_formats``): ``sparse_q`` the
        quantized row, ``bitmap`` the index-free row plus the ``capacity /
        8`` occupancy mask, ``sparse_sketch`` the index-free row plus a
        one-byte offset and the counting sketch."""
        from swiftmpi_tpu_torch.transfer.api import (grad_row_bytes,
                                                     quant_grad_row_bytes)
        if self.name == "sparse_q":
            return (quant_grad_row_bytes(grads, quant,
                                         with_counts=with_counts), 0)
        if self.name == "bitmap":
            return (grad_row_bytes(grads, with_index=False,
                                   with_counts=with_counts), capacity // 8)
        if self.name == "sparse_sketch":
            return (grad_row_bytes(grads, with_index=False,
                                   with_counts=with_counts) + OFFSET_BYTES,
                    sketch_base_bytes(capacity))
        return None


#: name -> spec: the table a new wire format is added to
FORMAT_TABLE: Dict[str, WireFormatSpec] = {
    "dense": WireFormatSpec("dense", lossless=True, dedup=False,
                            ef=False, encoded=False),
    "sparse": WireFormatSpec("sparse", lossless=True, dedup=False,
                             ef=False, encoded=False),
    "bitmap": WireFormatSpec("bitmap", lossless=True, dedup=True,
                             ef=False, encoded=True),
    "sparse_q": WireFormatSpec("sparse_q", lossless=False, dedup=True,
                               ef=True, encoded=True),
    "sparse_sketch": WireFormatSpec("sparse_sketch", lossless=True,
                                    dedup=True, ef=False, encoded=True),
}


@dataclass(frozen=True)
class WindowRoute:
    """Per-backend facts the interpreter composes a window plan from.

    ``eager``: the primitives are the host oracle's (numpy).
    ``always_decide``: every W > 1 window is priced even with every
    compression knob off (tpu, hybrid); unset, such windows take the
    flatten-and-delegate passthrough.  ``dedups_lossless``: a ``sparse``
    decision still runs the backend's dedup before the exchange.
    ``counts_follow_data``: the row-byte model counts the float32 counts
    column only when the family ships one; unset, the oracle routes
    always price and ship it.  ``placement``: ``flat`` or ``hot_split``
    (hybrid).  ``collective``: a label of the sparse exchange."""

    eager: bool = False
    always_decide: bool = False
    dedups_lossless: bool = False
    counts_follow_data: bool = False
    placement: str = "flat"
    collective: str = "gather_scatter"


#: backend name -> window route
WINDOW_ROUTES: Dict[str, WindowRoute] = {
    "local": WindowRoute(eager=True, collective="eager"),
    "xla": WindowRoute(collective="gather_scatter"),
    "tpu": WindowRoute(always_decide=True, dedups_lossless=True,
                       counts_follow_data=True, collective="all_to_all"),
    "hybrid": WindowRoute(always_decide=True, dedups_lossless=True,
                          counts_follow_data=True, placement="hot_split",
                          collective="psum+all_to_all"),
}


def window_route(backend: str) -> WindowRoute:
    try:
        return WINDOW_ROUTES[backend]
    except KeyError:
        raise KeyError(f"transfer.plan: backend {backend!r} has no "
                       "window route (add it to WINDOW_ROUTES)") from None


@dataclass(frozen=True)
class TrafficPlan:
    """One compiled window-push plan with its pricing evidence.  Frozen:
    re-pricing makes a new plan under a new cache key."""

    family: str
    backend: str
    placement: str
    dedup: str                    # none | backend | pre_deduped
    wire_format: str
    quant: str                    # off | int8 | bf16
    ef: bool
    collective: str
    taps: Tuple[str, ...]         # the interpreter's observation taps
    rows: int
    capacity: int
    row_bytes: int
    quant_row_bytes: Optional[int]
    priced: Tuple[Tuple[str, float], ...]

    @property
    def prices(self) -> Dict[str, float]:
        return dict(self.priced)

    @property
    def spec(self) -> WireFormatSpec:
        return FORMAT_TABLE[self.wire_format]


_PLAN_CACHE: Dict[tuple, TrafficPlan] = {}
_PLAN_CACHE_MAX = 4096


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


def _cache(key: tuple, plan: TrafficPlan) -> None:
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.clear()
    _PLAN_CACHE[key] = plan


def compile_window_plan(transfer, rows: int, capacity: int,
                        row_bytes: int,
                        quant_row_bytes: Optional[int],
                        with_counts: bool,
                        family: Optional[str] = "window",
                        ) -> Tuple[TrafficPlan, bool]:
    """Compile (or fetch) the :class:`TrafficPlan` of one window shape on
    ``transfer``: ``(plan, cache_hit)``.  The key holds every pricing
    input: the shape, ``wire_quant``, ``wire_sketch``, the family's dense
    ratio, ``window_expected_unique``, ``wire_quant_guard``, the
    collective mode, ``hot_touched_fraction`` and ``sparse_ar_ratio``."""
    from swiftmpi_tpu_torch.parameter.key_index import price_window_formats
    quant = transfer.wire_quant if quant_row_bytes is not None else "off"
    sketch = bool(transfer.wire_sketch)
    dense_ratio = transfer.wire_dense_ratio(family)
    expected_unique = transfer.window_expected_unique
    guard = transfer.wire_quant_guard
    mode = _collective_mode(transfer)
    key = (transfer.name, family, int(rows), int(capacity),
           int(row_bytes), quant_row_bytes, quant, sketch, dense_ratio,
           expected_unique, guard, bool(with_counts),
           mode, transfer.hot_touched_fraction, transfer.sparse_ar_ratio)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan, True
    decision, prices = price_window_formats(
        int(rows), int(capacity), int(row_bytes),
        dense_ratio=dense_ratio, expected_unique=expected_unique,
        quant=quant, quant_row_bytes=quant_row_bytes,
        quant_guard=guard, sketch=sketch)
    route = window_route(transfer.name)
    spec = FORMAT_TABLE[decision]
    dedup = ("backend" if spec.dedup
             or (route.dedups_lossless and decision == "sparse")
             else "none")
    taps = ("decision", "coalesce")
    if spec.dedup:
        taps += ("keys",)
    if spec.ef:
        taps += ("ef", "numerics")
    if decision == "dense":
        collective, coll_prices = _dense_rung_collective(
            transfer, mode, prices, int(capacity), int(row_bytes))
        prices = dict(prices, **coll_prices)
    else:
        collective = route.collective
    plan = TrafficPlan(
        family=family or "window", backend=transfer.name,
        placement=route.placement, dedup=dedup, wire_format=decision,
        quant=quant, ef=spec.ef, collective=collective, taps=taps,
        rows=int(rows), capacity=int(capacity), row_bytes=int(row_bytes),
        quant_row_bytes=quant_row_bytes,
        priced=tuple(sorted(prices.items())))
    _cache(key, plan)
    return plan, False


def _collective_mode(transfer) -> str:
    """The transfer's ``collective`` knob, checked against
    :data:`COLLECTIVE_MODES`."""
    mode = getattr(transfer, "collective_mode", "psum")
    if mode not in COLLECTIVE_MODES:
        raise ValueError(
            f"transfer.plan: unknown collective mode {mode!r} "
            f"(expected one of {COLLECTIVE_MODES})")
    return mode


def _dense_rung_collective(transfer, mode: str, prices, capacity: int,
                           row_bytes: int):
    """The collective of a window that densified: ``psum_scatter``, or
    ``sparse_allreduce`` when the knob pins it or (``auto``) the
    touched-fraction crossover, fed the pricer's own effective-unique
    estimate, prices it below the dense tiles.  Returns ``(collective,
    extra_prices)``."""
    if mode == "psum":
        return "psum_scatter", {}
    if mode == "sparse_allreduce":
        return "sparse_allreduce", {}
    from swiftmpi_tpu_torch.parameter.key_index import price_hot_collectives
    eff_fraction = prices["sparse"] / (4.0 + row_bytes) / max(capacity, 1)
    decision, coll_prices = price_hot_collectives(
        capacity, row_bytes, eff_fraction,
        sparse_ar_ratio=transfer.sparse_ar_ratio)
    return ("sparse_allreduce" if decision == "sparse_allreduce"
            else "psum_scatter"), coll_prices


def compile_hot_plan(transfer, n_hot: int, width_bytes: int,
                     ) -> Tuple[TrafficPlan, bool]:
    """Compile (or fetch) the hybrid hot plane's reconcile plan: one
    decision, ``psum`` or ``sparse_allreduce``, priced by the
    touched-fraction crossover from ``transfer.hot_touched_fraction``
    (the knob pins it unless ``auto``).  Returns ``(plan, cache_hit)``."""
    mode = _collective_mode(transfer)
    fraction = transfer.hot_touched_fraction
    ratio = transfer.sparse_ar_ratio
    key = (transfer.name, "hot", int(n_hot), int(width_bytes),
           mode, fraction, ratio)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan, True
    from swiftmpi_tpu_torch.parameter.key_index import price_hot_collectives
    decision, prices = price_hot_collectives(
        int(n_hot), int(width_bytes), fraction, sparse_ar_ratio=ratio)
    if mode != "auto":
        decision = mode
    plan = TrafficPlan(
        family="hot", backend=transfer.name, placement="hot",
        dedup="pre_deduped", wire_format="dense", quant="off", ef=False,
        collective=decision, taps=("decision",),
        rows=int(round((fraction or 0.0) * n_hot)), capacity=int(n_hot),
        row_bytes=int(width_bytes), quant_row_bytes=None,
        priced=tuple(sorted(prices.items())))
    _cache(key, plan)
    return plan, False


# -- the pull family ------------------------------------------------------------

@dataclass(frozen=True)
class PullRoute:
    """``eager``: the pull primitive is the host oracle's (numpy), so the
    interpreter counts rows on the host.  ``placement``: ``flat`` (one
    gather over the whole slot space) or ``hot_split`` (hybrid: hot hits
    read from the local hot plane at 0 wire bytes, tail rows re-based by
    ``-n_hot`` and pulled through the tail backend)."""

    eager: bool = False
    placement: str = "flat"


#: backend name -> pull route
PULL_ROUTES: Dict[str, PullRoute] = {
    "local": PullRoute(eager=True),
    "xla": PullRoute(),
    "tpu": PullRoute(),
    "hybrid": PullRoute(placement="hot_split"),
}


def pull_route(backend: str) -> PullRoute:
    try:
        return PULL_ROUTES[backend]
    except KeyError:
        raise KeyError(f"transfer.plan: backend {backend!r} has no pull "
                       "route (add it to PULL_ROUTES)") from None


@dataclass(frozen=True)
class PullPlan:
    """One compiled pull plan: the format the rows ship in, whether the
    versioned cache is consulted, and the pricing evidence.  Frozen, as
    :class:`TrafficPlan`."""

    backend: str
    placement: str
    wire_format: str
    quant: str                    # off | int8 | bf16
    cached: bool                  # the versioned PullCache is consulted
    rows: int
    capacity: int
    row_bytes: int                # full_f32 row bytes, the key included
    wire_row_bytes: int           # the chosen format's row bytes
    priced: Tuple[Tuple[str, float], ...]

    @property
    def prices(self) -> Dict[str, float]:
        return dict(self.priced)


def price_pull_formats(rows: int, row_bytes: int, quant: str = "off",
                       quant_row_bytes: Optional[int] = None,
                       quant_guard: float = 1.25):
    """``(decision, prices)`` over :data:`PULL_FORMATS`: ``full_f32`` at
    ``rows * row_bytes``, the armed encoded rung (``bf16`` or
    ``sparse_q``) at ``rows * quant_row_bytes``.  With ``quant`` off only
    ``full_f32`` is priced; an encoded rung wins only when ``q_vol *
    quant_guard <= full_vol``."""
    full_vol = float(rows) * float(row_bytes)
    prices = {"full_f32": full_vol}
    if quant == "off" or quant_row_bytes is None:
        return "full_f32", prices
    fmt = "bf16" if quant == "bf16" else "sparse_q"
    q_vol = float(rows) * float(quant_row_bytes)
    prices[fmt] = q_vol
    if q_vol * quant_guard <= full_vol:
        return fmt, prices
    return "full_f32", prices


def compile_pull_plan(transfer, rows: int, capacity: int, row_bytes: int,
                      quant_row_bytes: Optional[int],
                      ) -> Tuple[PullPlan, bool]:
    """Compile (or fetch) the :class:`PullPlan` of one pull shape on
    ``transfer``: ``(plan, cache_hit)``.  The key holds the shape and the
    live ``pull_quant``, ``pull_quant_guard`` and ``pull_cache`` knobs."""
    quant = transfer.pull_quant if quant_row_bytes is not None else "off"
    if quant not in PULL_QUANT_MODES:
        raise ValueError(
            f"transfer.plan: unknown pull_quant mode {quant!r} "
            f"(expected one of {PULL_QUANT_MODES})")
    guard = transfer.pull_quant_guard
    cached = bool(transfer.pull_cache)
    key = (transfer.name, "pull", int(rows), int(capacity),
           int(row_bytes), quant_row_bytes, quant, guard, cached)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan, True
    decision, prices = price_pull_formats(
        int(rows), int(row_bytes), quant=quant,
        quant_row_bytes=quant_row_bytes, quant_guard=guard)
    plan = PullPlan(
        backend=transfer.name, placement=pull_route(transfer.name).placement,
        wire_format=decision,
        quant=quant if decision != "full_f32" else "off", cached=cached,
        rows=int(rows), capacity=int(capacity), row_bytes=int(row_bytes),
        wire_row_bytes=(int(row_bytes) if decision == "full_f32"
                        else int(quant_row_bytes)),
        priced=tuple(sorted(prices.items())))
    _cache(key, plan)
    return plan, False
