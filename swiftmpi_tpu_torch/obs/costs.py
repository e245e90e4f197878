"""Compiled-program catalog: capture tracking and retrace accounting
(counterpart of ``swiftmpi_tpu/obs/costs.py``).

A compile in the port is a CUDA graph capture.  The port has no jit
cache: each model keeps its captured graphs by group length
(``utils/graphs.py``'s :class:`StepGraph` cache, filled by
``run_group``), and a capture is what a first call of a new jit shape
is in the JAX package.  Every graph capture the models do funnels
through :func:`track`, which wraps the capture callable of one handle in
a :class:`TrackedFn`.  Disarmed (the default), the wrapper is a single
attribute check around the call — the capture and the graph are
untouched, so a default-off run is bit-identical to one without this
module.  Armed (``[obs] costs: 1`` or ``SMTPU_COSTS=1``), every capture
— detected as growth of the handle's own capture count — is recorded
three ways:

* ``compile/compiles{fn=}`` / ``compile/compile_ms{fn=}`` /
  ``compile/retraces{fn=}`` counters in the telemetry registry;
* with ``[obs] costs_memory`` on a CUDA device, the peak of
  ``torch.cuda.max_memory_allocated`` around the capture as the
  ``compile/peak_bytes{fn=}`` gauge;
* a crash-safe ``runs/compile_catalog.json`` (schema ``smtpu-costs/1``,
  the JAX package's), rewritten atomically on every compile event, with
  the hand byte/FLOP models next to them
  (:meth:`CostCatalog.note_hand_model`).

There is no XLA cost analysis: ``flops`` and ``bytes_accessed`` stay
absent from every entry, as they do in the JAX package when its analysis
fails, and so do the drift percentages that need them.  Eager callables
(the port's single steps) have no capture probe and book nothing, as
plain callables book nothing in the JAX package.

Retrace semantics are **per handle**, as in the JAX package: one name
covers many handles (one a group length), each handle's FIRST capture is
expected, and only a handle capturing *again* books a retrace.  A model
drops its handles with its graphs when the graphs' key changes (the
table grew, a plan knob moved): fresh handles, so that books compiles,
never retraces.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import torch

#: catalog artifact schema tag (``runs/compile_catalog.json``).
COSTS_SCHEMA = "smtpu-costs/1"
COSTS_SCHEMA_PREFIX = "smtpu-costs/"

#: env override that arms the catalog without a config edit
ENV_COSTS = "SMTPU_COSTS"


class CostCatalog:
    """Per-process compile-event ledger.  Created disarmed; armed by
    :func:`configure_costs` (or programmatically by the bench child).
    Writers go through :func:`get_catalog` each call — the instance is
    swapped by :func:`reset_for_tests`, like the metrics registry."""

    def __init__(self, enabled: bool = False,
                 path: Optional[str] = None,
                 memory: bool = True, analyze_max: int = 1,
                 run: str = "run"):
        self.enabled = enabled
        self.path = path
        #: measure the device allocation peak around a capture (resets
        #: the device's peak statistics) — [obs] costs_memory
        self.memory = memory
        #: captures measured per fn name (the first handle is
        #: representative)
        self.analyze_max = analyze_max
        self.run = run
        self._lock = threading.Lock()
        self._fns: Dict[str, dict] = {}     # guarded-by: _lock
        self._analyzed: Dict[str, int] = {}  # guarded-by: _lock

    # -- the compile event -------------------------------------------------
    def on_compile(self, name: str, dt_ms: float, handle_compiles: int,
                   steps_per_call: int = 1,
                   peak_bytes: Optional[int] = None) -> None:
        """Book one capture under ``name``.  ``handle_compiles`` is the
        wrapping handle's own capture count — > 1 means this very handle
        captured again, which is the retrace signal.  ``dt_ms`` is the
        wall time of the capturing call.  ``peak_bytes``: the device's
        allocation peak around the capture (``costs_memory``), or None."""
        retrace = handle_compiles > 1
        with self._lock:
            e = self._fns.get(name)
            if e is None:
                e = self._fns[name] = {
                    "fn": name, "compiles": 0, "retraces": 0,
                    "compile_ms_total": 0.0, "last_compile_ms": 0.0,
                    "steps_per_call": steps_per_call,
                }
            e["compiles"] += 1
            e["compile_ms_total"] += dt_ms
            e["last_compile_ms"] = dt_ms
            e["steps_per_call"] = steps_per_call
            if retrace:
                e["retraces"] += 1
            n_analyzed = self._analyzed.get(name, 0)
            analyze = n_analyzed < self.analyze_max
            if analyze:
                self._analyzed[name] = n_analyzed + 1
        from swiftmpi_tpu_torch import obs
        reg = obs.get_registry()
        reg.counter("compile/compiles", fn=name).inc()
        reg.counter("compile/compile_ms", fn=name).inc(dt_ms)
        if retrace:
            reg.counter("compile/retraces", fn=name).inc()
        if analyze:
            a = {} if peak_bytes is None else {"peak_bytes": int(peak_bytes)}
            if a:
                with self._lock:
                    self._fns[name].update(a)
                if a.get("flops"):
                    reg.gauge("compile/flops", fn=name).set(a["flops"])
                if a.get("bytes_accessed"):
                    reg.gauge("compile/bytes",
                              fn=name).set(a["bytes_accessed"])
                if a.get("peak_bytes"):
                    reg.gauge("compile/peak_bytes",
                              fn=name).set(a["peak_bytes"])
        self._persist()

    # -- hand-model drift --------------------------------------------------
    def note_hand_model(self, name: str, flops: Optional[float] = None,
                        bytes_accessed: Optional[float] = None) -> None:
        """Record the hand byte/FLOP model's *per-call* prediction for
        ``name`` so reports can print measured-vs-model drift.  Callers
        with per-step models multiply by the fn's steps_per_call."""
        with self._lock:
            e = self._fns.setdefault(name, {
                "fn": name, "compiles": 0, "retraces": 0,
                "compile_ms_total": 0.0, "last_compile_ms": 0.0,
                "steps_per_call": 1,
            })
            if flops is not None:
                e["hand_flops"] = float(flops)
            if bytes_accessed is not None:
                e["hand_bytes"] = float(bytes_accessed)
        self._persist()

    # -- reads -------------------------------------------------------------
    def entry(self, name: str) -> Optional[dict]:
        with self._lock:
            e = self._fns.get(name)
            return dict(e) if e is not None else None

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._fns.items()}

    def snapshot(self) -> dict:
        """The ``smtpu-costs/1`` document: per-fn compile/retrace
        counts, measured flops/bytes, and drift percentages wherever a
        hand model was noted next to a measurement."""
        fns = self.entries()
        for e in fns.values():
            _add_drift(e)
        return {"schema": COSTS_SCHEMA, "run": self.run,
                "ts": time.time(), "fns": fns}

    # -- persistence ---------------------------------------------------
    def _persist(self) -> None:
        path = self.path
        if not path:
            return
        doc = self.snapshot()
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass    # artifact write must never take down training


def _add_drift(e: dict) -> None:
    """measured-vs-hand drift: positive = the hand model OVERestimates."""
    f, hf = e.get("flops"), e.get("hand_flops")
    if f and hf is not None:
        e["flops_drift_pct"] = round(100.0 * (hf - f) / f, 1)
    b, hb = e.get("bytes_accessed"), e.get("hand_bytes")
    if b and hb is not None:
        e["bytes_drift_pct"] = round(100.0 * (hb - b) / b, 1)


class TrackedFn:
    """The funnel wrapper around one capture handle.

    Call path invariant: the wrapped callable is ALWAYS the callee —
    armed or not — so arming cannot change what runs, only observe it.
    Compile detection is the handle's own ``_cache_size()`` (its count of
    captures) growing across a call; handles without that probe (plain
    callables) never book events.

    Unknown attributes forward to the wrapped fn."""

    __slots__ = ("_fn", "name", "steps_per_call", "_compiles",
                 "__weakref__")

    def __init__(self, name: str, fn, steps_per_call: int = 1):
        self._fn = fn
        self.name = name
        self.steps_per_call = max(int(steps_per_call), 1)
        self._compiles = 0

    def __call__(self, *args, **kwargs):
        cat = _CATALOG
        if not cat.enabled:
            return self._fn(*args, **kwargs)
        before = self._cache_size()
        dev = _cuda_device(args) if cat.memory else None
        if dev is not None:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if before >= 0 and self._cache_size() > before:
            peak = None
            if dev is not None:
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev)
            dt_ms = (time.perf_counter() - t0) * 1e3
            self._compiles += 1
            cat.on_compile(self.name, dt_ms, self._compiles,
                           self.steps_per_call, peak_bytes=peak)
        return out

    def _cache_size(self) -> int:
        cs = getattr(self._fn, "_cache_size", None)
        if cs is None:
            return -1
        try:
            return int(cs())
        except Exception:
            return -1

    def __getattr__(self, attr):
        return getattr(self._fn, attr)

    def __repr__(self) -> str:
        return f"TrackedFn({self.name!r}, {self._fn!r})"


def _cuda_device(args) -> Optional[torch.device]:
    """The CUDA device of the first tensor in ``args`` (a tensor or a
    sequence of tensors), or None."""
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor):
                return t.device if t.device.type == "cuda" else None
    return None


class Captures:
    """A capture callable with the probe :class:`TrackedFn` reads:
    ``make(fields)`` builds one graph (a capture); ``_cache_size()`` is
    the number of captures so far."""

    def __init__(self, make):
        self._make = make
        self._n = 0

    def __call__(self, *args, **kwargs):
        out = self._make(*args, **kwargs)
        self._n += 1
        return out

    def _cache_size(self) -> int:
        return self._n


def track(name: str, fn, steps_per_call: int = 1) -> TrackedFn:
    """Register ``fn`` (a capture handle, e.g. :class:`Captures`) in the
    catalog under ``name``.  Idempotent on an already-tracked fn (keeps
    the original name)."""
    if isinstance(fn, TrackedFn):
        return fn
    return TrackedFn(name, fn, steps_per_call)


# -- module globals (the registry pattern: swap via reset_for_tests) --------

_CATALOG = CostCatalog()


def get_catalog() -> CostCatalog:
    """The process-global catalog (disarmed unless configured)."""
    return _CATALOG


def reset_for_tests() -> CostCatalog:
    global _CATALOG
    _CATALOG = CostCatalog()
    return _CATALOG


def configure_costs(config, run: str = "run") -> Optional[CostCatalog]:
    """Arm the catalog from ``[obs]`` config (or ``SMTPU_COSTS=1``).

    Knobs: ``costs`` (master switch, default 0), ``costs_path`` (JSON
    artifact, default ``runs/compile_catalog.json``; empty = in-memory
    only) and ``costs_memory`` (the allocation peak around a capture,
    default 1).
    Returns the armed catalog, or None when the plane stays off."""
    g = config.get_or
    on = g("obs", "costs", 0).to_bool() or \
        os.environ.get(ENV_COSTS, "") not in ("", "0")
    if not on:
        return None
    cat = get_catalog()
    cat.enabled = True
    cat.run = run
    cat.path = g("obs", "costs_path",
                 os.path.join("runs", "compile_catalog.json")).to_string()
    cat.memory = g("obs", "costs_memory", 1).to_bool()
    return cat
