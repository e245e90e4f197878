"""Numerics health plane: gradient/EF/quantization telemetry with a
host-side anomaly detector (counterpart of ``swiftmpi_tpu/obs/numerics.py``).

Three pieces, as in the JAX package:

* **Bundle helpers** (:func:`push_stats`, :func:`state_stats`,
  :func:`spec_stats`, :func:`stage_step`) — torch reductions the model
  runs inside each dispatch when ``[obs] numerics`` is armed: gradient
  sum-of-squares split by hot/tail plane, nonfinite element counts,
  update-vs-param mass, and per-field EF residual mass.  Every input is
  upcast to float32 before it is reduced (bf16 tables included), and
  nonfinite elements are masked out of the norms.  With the plane off
  the model calls none of them: no extra op, and its CUDA graph key is
  unchanged.

* :class:`NumericsCollector` — the staging target.  The JAX package
  ships each dispatch's bundle through ``jax.debug.callback``; a CUDA
  graph cannot call the host, and a read in the step would stall every
  dispatch.  So the collector owns device buffers, written in place with
  torch ops (a graph replay books exactly what an eager dispatch books):
  a float32 vector with the latest bundle (``gsq``, ``gsq_hot``,
  ``upd_sq``, ``par_sq``, ``loss_sum``, ``loss_n``, then the ``@ef`` mass
  of each field) and float64 totals (nonfinite elements, bundles, the
  quantization error).  :meth:`NumericsCollector.sampler` reads them
  with one device-to-host copy when the StepRecorder records, mirrors
  them as the declared ``numerics/*`` series and lets the detector score
  them.  The quantization-error tap (:meth:`NumericsCollector.
  quant_tap`) is handed to ``transfer.api.set_numerics_tap``; it adds
  ``sqrt(max(err_sq, 0))`` a window, or 1 to the nonfinite total when
  ``err_sq`` is not finite, by ``torch.where``, not a host branch.

* :class:`AnomalyDetector` — rolling EWMA+MAD baselines per series
  (the JAX package's, line for line), emitting ``numerics/anomaly``
  events; its state rides checkpoints as ``extra__numerics`` in the JAX
  package's JSON bytes, so baselines cross between the two packages.
  With ``[control]`` on, the controller registers the demote hook
  (``Controller.attach_numerics``): a sustained EF runaway then demotes
  ``wire_quant`` and ``pull_quant`` at the next safe point
  (``Word2Vec._numerics_demote``); without it the detector observes.

A dispatch stages one bundle: one a step, one a group of ``inner_steps``
(graphed or not: the table at group entry is ``state0``), one a
window group.  The port updates its tables in place, so with numerics
armed the dispatch first copies the fields it updates (and their
``@hot`` planes) into buffers the collector owns (:meth:`NumericsCollector.
snapshot`): the JAX package gets ``state0`` free from its functional
state.

Cross-rank divergence is the fleet half: :func:`cross_rank_divergence`
scores per-rank ``numerics/grad_norm`` gauges, host-only.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch.parameter.sparse_table import hot_name, is_ef_field

#: anomaly event payload schema rides every ``numerics/anomaly`` event
SCHEMA = "smtpu-numerics/1"

#: anomaly kinds the detector emits (docs/ARCHITECTURE.md "Numerics
#: health" documents the triage story per kind)
ANOMALY_KINDS = ("loss_spike", "grad_norm_explosion",
                 "ef_residual_runaway", "nonfinite",
                 "cross_rank_divergence")

#: gauge-series -> anomaly kind scored by the rolling baseline (all
#: upward-only: a shrinking norm is convergence, not an anomaly)
_SERIES_KIND = {
    "numerics/loss": "loss_spike",
    "numerics/grad_norm": "grad_norm_explosion",
    "numerics/grad_norm_hot": "grad_norm_explosion",
    "numerics/grad_norm_tail": "grad_norm_explosion",
    "numerics/update_ratio": "grad_norm_explosion",
}


def enabled(config) -> bool:
    """The ``[obs] numerics`` master switch (default 0 = off)."""
    return config.get_or("obs", "numerics", 0).to_bool()


def detector_from_config(config) -> "AnomalyDetector":
    """Build a detector from the ``[obs] numerics_*`` knob family."""
    g = config.get_or
    return AnomalyDetector(
        alpha=g("obs", "numerics_alpha", 0.1).to_float(),
        k=g("obs", "numerics_mad_k", 6.0).to_float(),
        warmup=g("obs", "numerics_warmup", 8).to_int32(),
        patience=g("obs", "numerics_patience", 3).to_int32(),
    )



# -- bundle helpers ----------------------------------------------------------

def _parts(x) -> list:
    """A field as its tensors: a sharded field's shards, else itself."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _f32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(torch.float32)


def push_stats(slots, grads: dict, n_hot: int):
    """One push's gradient statistics: ``(sq_total, sq_hot, nonfinite)``,
    float32, float32 and int32 device scalars.  ``slots`` the per-row
    slots (``None`` for a dense push, all tail); nonfinite elements are
    counted and excluded from the norms."""
    sq_total = sq_hot = nonfin = None
    for g in grads.values():
        g32 = _f32(g)
        finite = torch.isfinite(g32)
        nf = (~finite).sum(dtype=torch.int32)
        row_sq = torch.where(finite, g32, 0.0).square().sum(dim=-1)
        s = row_sq.sum()
        sq_total = s if sq_total is None else sq_total + s
        nonfin = nf if nonfin is None else nonfin + nf
        if n_hot > 0 and slots is not None:
            sl = slots if isinstance(slots, torch.Tensor) else \
                torch.as_tensor(np.asarray(slots))
            sl = sl.to(row_sq.device)
            hot = ((sl >= 0) & (sl < n_hot)).to(torch.float32)
            h = (row_sq * hot.reshape(row_sq.shape)).sum()
            sq_hot = h if sq_hot is None else sq_hot + h
    dev = sq_total.device if sq_total is not None else None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return (zero if sq_total is None else sq_total,
            zero if sq_hot is None else sq_hot,
            torch.zeros((), dtype=torch.int32, device=dev)
            if nonfin is None else nonfin)


def spec_stats(pushes, n_hot: int):
    """:func:`push_stats` folded over one step's PushSpecs (a dense
    capacity-shaped spec has no slot identity: all tail)."""
    sq = hot = nf = None
    for spec in pushes:
        slots = None if getattr(spec, "dense", False) else spec.slots
        s, h, n = push_stats(slots, spec.grads, n_hot)
        sq = s if sq is None else sq + s
        hot = h if hot is None else hot + h
        nf = n if nf is None else nf + n
    return sq, hot, nf


def add_stats(acc, stats):
    """Element-wise sum of two ``(sq, sq_hot, nonfinite)`` triples (``acc``
    None: ``stats``)."""
    return stats if acc is None else tuple(a + b for a, b in zip(acc, stats))


def _updated_fields(state, grad_fields) -> list:
    keys = []
    for f in grad_fields:
        keys.append(f)
        if hot_name(f) in state:        # hybrid replicated hot overlay
            keys.append(hot_name(f))
    return keys


def state_stats(before: dict, after: dict, grad_fields):
    """Once-per-dispatch table statistics: ``(upd_sq, par_sq, ef_mass,
    nonfinite)`` — finite-masked update and parameter sum-of-squares over
    the updated fields (and their hot planes), the L1 mass of each
    ``@ef`` residual plane keyed by its base field, and the nonfinite
    element count over the updated fields and the residual planes.  A
    sharded field (a list of shard tensors) sums over its shards."""
    upd_sq = par_sq = nonfin = None
    for f in _updated_fields(after, grad_fields):
        for b, a in zip(_parts(before[f]), _parts(after[f])):
            a32, b32 = _f32(a), _f32(b)
            fin = torch.isfinite(a32)
            nf = (~fin).sum(dtype=torch.int32)
            a0 = torch.where(fin, a32, 0.0)
            b0 = torch.where(torch.isfinite(b32), b32, 0.0)
            u = (a0 - b0).square().sum()
            p = b0.square().sum()
            upd_sq = u if upd_sq is None else upd_sq + u
            par_sq = p if par_sq is None else par_sq + p
            nonfin = nf if nonfin is None else nonfin + nf
    ef_mass = {}
    for name in after:
        if not is_ef_field(name):
            continue
        m = None
        for r in _parts(after[name]):
            r32 = _f32(r)
            fin = torch.isfinite(r32)
            nf = (~fin).sum(dtype=torch.int32)
            nonfin = nf if nonfin is None else nonfin + nf
            s = torch.where(fin, r32, 0.0).abs().sum()
            m = s if m is None else m + s
        ef_mass[name[:name.rindex("@")]] = m
    return upd_sq, par_sq, ef_mass, nonfin


def stage_step(collector: "NumericsCollector", state0, state1,
               grad_acc, es, ec, grad_fields) -> None:
    """Assemble one dispatch's bundle and stage it on ``collector``'s
    device buffers: ``grad_acc`` the ``(sq, sq_hot, nonfinite)`` sum over
    the dispatch's pushes, ``state0``/``state1`` the table at dispatch
    entry and exit, ``es``/``ec`` the loss sum and example count."""
    gsq, gsq_hot, g_nf = grad_acc
    upd_sq, par_sq, ef_mass, s_nf = state_stats(state0, state1,
                                                grad_fields)

    def scalar(x):
        # a host number becomes a fill, not a host-to-device copy (which
        # a CUDA graph capture refuses)
        if isinstance(x, torch.Tensor):
            return x.to(torch.float32)
        return torch.full((), float(x), dtype=torch.float32,
                          device=gsq.device)
    bundle = {
        "gsq": gsq, "gsq_hot": gsq_hot,
        "upd_sq": upd_sq, "par_sq": par_sq,
        "nonfinite": g_nf.to(torch.int32) + s_nf.to(torch.int32),
        "loss_sum": scalar(es), "loss_n": scalar(ec),
    }
    collector.stage_traced(bundle, ef_mass)


# -- the collector -----------------------------------------------------------

#: the float32 bundle vector's leading entries, then one ``@ef`` mass a
#: field
BUNDLE_KEYS = ("gsq", "gsq_hot", "upd_sq", "par_sq", "loss_sum", "loss_n")
#: the float64 totals vector
_NONFINITE, _BUNDLES, _QUANT = 0, 1, 2


class NumericsCollector:
    """Device-side staging target + registry mirror (see the module
    docstring).  ``stage_traced`` and ``quant_tap`` write device buffers
    in place and read nothing back; ``sampler`` reads them once, on the
    StepRecorder's record path."""

    def __init__(self, detector: Optional["AnomalyDetector"] = None):
        self.detector = detector
        self._lock = threading.Lock()
        self._latest: Optional[torch.Tensor] = None   # float32 bundle
        self._totals: Dict[torch.device, torch.Tensor] = {}   # float64
        self._ef_fields: tuple = ()
        self._before: Dict[str, list] = {}
        # the local oracle's numpy path taps on the host
        self._host_nonfinite = 0.0                 # guarded-by: _lock
        self._host_quant = 0.0                     # guarded-by: _lock

    # .. device buffers ....................................................

    @staticmethod
    def _check_not_capturing(device: torch.device) -> None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the numerics buffers do not exist on "
                f"{device} yet: run a dispatch eagerly with numerics "
                "armed before capturing a CUDA graph")

    def _totals_on(self, device: torch.device) -> torch.Tensor:
        t = self._totals.get(device)
        if t is None:
            self._check_not_capturing(device)
            t = self._totals[device] = torch.zeros(
                3, dtype=torch.float64, device=device)
        return t

    def snapshot(self, state: dict, grad_fields) -> dict:
        """Copy the fields a dispatch updates (and their hot planes) into
        buffers this collector owns, in place (made on the first call,
        eagerly): the dispatch's ``state0``."""
        out = {}
        for f in _updated_fields(state, grad_fields):
            parts = _parts(state[f])
            buf = self._before.get(f)
            if buf is None or len(buf) != len(parts) or any(
                    b.shape != p.shape or b.device != p.device
                    or b.dtype != p.dtype for b, p in zip(buf, parts)):
                self._check_not_capturing(parts[0].device)
                buf = self._before[f] = [torch.empty_like(p)
                                         for p in parts]
            for b, p in zip(buf, parts):
                b.copy_(p)
            out[f] = buf if isinstance(state[f], (list, tuple)) else buf[0]
        return out

    def stage_traced(self, bundle: dict, ef_mass: dict) -> None:
        """Write one dispatch's bundle (device scalars) into the latest
        vector and bump the totals, in place: no host read."""
        fields = tuple(sorted(ef_mass))
        dev = bundle["gsq"].device
        if self._latest is None or fields != self._ef_fields \
                or self._latest.device != dev:
            self._check_not_capturing(dev)
            self._ef_fields = fields
            self._latest = torch.zeros(len(BUNDLE_KEYS) + len(fields),
                                       dtype=torch.float32, device=dev)
        vals = [bundle[k].to(torch.float32).reshape(())
                for k in BUNDLE_KEYS]
        vals += [ef_mass[f].to(torch.float32).reshape(()) for f in fields]
        self._latest.copy_(torch.stack(vals))
        tot = self._totals_on(dev)
        tot[_NONFINITE].add_(bundle["nonfinite"].to(torch.float64))
        tot[_BUNDLES].add_(1.0)

    def quant_tap(self, err_sq) -> None:
        """Accumulate one quantized window's pre-vs-post error: adds
        ``sqrt(max(err_sq, 0))`` to the quantization-error total, or 1 to
        the nonfinite total when ``err_sq`` is not finite (the JAX
        package's ``_on_quant``: the float32 value, summed in float64).
        A device scalar books in place; a host value (the local oracle)
        books on the host."""
        if isinstance(err_sq, torch.Tensor):
            v = err_sq.to(torch.float64).reshape(())
            fin = torch.isfinite(v)
            tot = self._totals_on(v.device)
            tot[_QUANT].add_(torch.where(
                fin, torch.sqrt(torch.clamp(torch.where(fin, v, 0.0),
                                            min=0.0)), 0.0))
            tot[_NONFINITE].add_((~fin).to(torch.float64))
            return
        v = float(np.asarray(err_sq))
        with self._lock:
            if not math.isfinite(v):
                self._host_nonfinite += 1.0
            else:
                self._host_quant += math.sqrt(max(v, 0.0))

    def read(self) -> dict:
        """The latest bundle and the totals, read to the host (one copy a
        device): ``{"latest": {key: v}, "ef_mass": {field: v},
        "nonfinite", "bundles", "quant_err"}``."""
        with self._lock:
            nonfinite, quant = self._host_nonfinite, self._host_quant
        bundles = 0.0
        for t in self._totals.values():
            nf, nb, q = t.cpu().tolist()
            nonfinite, bundles, quant = nonfinite + nf, bundles + nb, \
                quant + q
        latest, ef = {}, {}
        if self._latest is not None and bundles:
            vals = self._latest.cpu().tolist()
            latest = dict(zip(BUNDLE_KEYS, vals))
            ef = dict(zip(self._ef_fields, vals[len(BUNDLE_KEYS):]))
        return {"latest": latest, "ef_mass": ef, "nonfinite": nonfinite,
                "bundles": int(bundles), "quant_err": quant}

    @property
    def bundles(self) -> int:
        """Dispatch bundles staged so far (train_metrics surface)."""
        return self.read()["bundles"]

    # .. publishing ........................................................

    def sampler(self, reg) -> None:
        """StepRecorder sampler: mirror the latest bundle as declared
        series, then let the detector score the sample."""
        r = self.read()
        latest, ef_mass = r["latest"], r["ef_mass"]
        nonfinite, quant_err = r["nonfinite"], r["quant_err"]
        if not latest and not ef_mass and not nonfinite and not quant_err:
            return
        values: Dict[str, float] = {}
        gsq = latest.get("gsq", 0.0)
        gsq_hot = latest.get("gsq_hot", 0.0)
        values["numerics/grad_norm"] = math.sqrt(max(gsq, 0.0))
        values["numerics/grad_norm_hot"] = math.sqrt(max(gsq_hot, 0.0))
        values["numerics/grad_norm_tail"] = math.sqrt(
            max(gsq - gsq_hot, 0.0))
        par_sq = latest.get("par_sq", 0.0)
        if par_sq > 0.0:
            values["numerics/update_ratio"] = math.sqrt(
                max(latest.get("upd_sq", 0.0), 0.0) / par_sq)
        loss_n = latest.get("loss_n", 0.0)
        if loss_n > 0.0:
            values["numerics/loss"] = latest.get("loss_sum", 0.0) / loss_n
        for name, v in values.items():
            reg.gauge(name).set(v)
        for f, m in sorted(ef_mass.items()):
            reg.gauge("numerics/ef_mass", field=f).set(m)
        reg.counter("numerics/nonfinite").set_total(nonfinite)
        reg.counter("numerics/quant_err").set_total(quant_err)
        if self.detector is not None:
            for f, m in sorted(ef_mass.items()):
                values[f"numerics/ef_mass{{field={f}}}"] = m
            self.detector.on_sample(reg, values, nonfinite)


# -- rolling-baseline anomaly detector --------------------------------------

class AnomalyDetector:
    """EWMA+MAD baselines per series, anomaly events, demote hook.

    Per series the detector keeps ``(mean, dev, n)`` where ``dev`` is
    an EWMA of absolute deviation (a MAD proxy that needs no window
    buffer).  A sample scores anomalous when it exceeds the baseline by
    ``k`` deviations UPWARD after ``warmup`` samples; ``2k`` promotes
    the severity to ``critical``.  Anomalous samples update the
    baseline with their clamped value (``mean + k*dev``) so a genuine
    regime shift is absorbed over a few windows instead of either
    poisoning the baseline instantly or alarming forever.
    """

    def __init__(self, alpha: float = 0.1, k: float = 6.0,
                 warmup: int = 8, patience: int = 3):
        self.alpha = float(alpha)
        self.k = float(k)
        self.warmup = max(int(warmup), 1)
        self.patience = max(int(patience), 1)
        self._base: Dict[str, List[float]] = {}   # series -> [m, dev, n]
        self._streaks: Dict[str, int] = {}
        self._nonfinite_seen = 0.0
        self._hooks: List[Callable[[dict], None]] = []
        self._hook_fired = False
        self.anomalies_emitted = 0

    # .. hook contract (docs/ARCHITECTURE.md "Numerics health") ...........

    def add_demote_hook(self, fn: Callable[[dict], None]) -> None:
        """Register ``fn(anomaly)`` to fire ONCE on sustained EF-residual
        runaway (``patience`` consecutive anomalous windows on any
        ``numerics/ef_mass`` series).  Observe-only until someone calls
        this — the Controller's ``attach_numerics`` is the one caller."""
        self._hooks.append(fn)

    # .. scoring ..........................................................

    def observe(self, series: str, value: float) -> Optional[dict]:
        """Score one sample against the series' rolling baseline and
        update it.  Returns the anomaly dict (kind/severity/evidence)
        or None.  Also drives the sustained-runaway streaks and fires
        the demote hook when an ef_mass streak reaches ``patience``."""
        kind = _SERIES_KIND.get(series)
        if kind is None and series.startswith("numerics/ef_mass"):
            kind = "ef_residual_runaway"
        if kind is None:
            return None
        if not math.isfinite(value):
            return self._mk("nonfinite", series, value, None, None,
                            "critical")
        m, dev, n = self._base.get(series, (value, 0.0, 0.0))
        anomaly = None
        if n >= self.warmup:
            scale = max(dev, 1e-3 * max(abs(m), 1.0), 1e-12)
            z = (value - m) / scale
            if z > 2.0 * self.k:
                anomaly = self._mk(kind, series, value, m, dev,
                                   "critical", z=z)
            elif z > self.k:
                anomaly = self._mk(kind, series, value, m, dev,
                                   "warning", z=z)
        absorbed = value if anomaly is None else m + self.k * max(dev, 0.0)
        a = self.alpha
        m = m + a * (absorbed - m) if n else absorbed
        dev = dev + a * (abs(absorbed - m) - dev)
        self._base[series] = [m, dev, n + 1]
        if kind == "ef_residual_runaway":
            streak = self._streaks.get(series, 0) + 1 if anomaly else 0
            self._streaks[series] = streak
            if anomaly is not None and streak >= self.patience \
                    and not self._hook_fired:
                self._hook_fired = True
                anomaly["sustained"] = streak
                for h in list(self._hooks):
                    h(dict(anomaly))
        return anomaly

    def on_sample(self, reg, values: Dict[str, float],
                  nonfinite_total: float) -> List[dict]:
        """One recorded step's worth of scoring: every gauge in
        ``values`` plus the cumulative nonfinite counter (any forward
        motion is a critical anomaly — NaNs never self-heal)."""
        out = []
        if nonfinite_total > self._nonfinite_seen:
            out.append(self._mk(
                "nonfinite", "numerics/nonfinite",
                nonfinite_total - self._nonfinite_seen, None, None,
                "critical"))
            self._nonfinite_seen = nonfinite_total
        for series, v in values.items():
            a = self.observe(series, v)
            if a is not None:
                out.append(a)
        for a in out:
            self._emit(reg, a)
        return out

    def _mk(self, kind, series, value, mean, dev, severity, z=None):
        a = {"schema": SCHEMA, "anomaly": kind, "series": series,
             "severity": severity, "value": float(value)}
        if mean is not None:
            a["baseline"] = float(mean)
            a["mad"] = float(dev)
        if z is not None:
            a["z"] = float(z)
        return a

    def _emit(self, reg, anomaly: dict) -> None:
        from swiftmpi_tpu_torch import obs
        self.anomalies_emitted += 1
        reg.counter("numerics/anomalies",
                    severity=anomaly["severity"]).inc()
        rec = obs.get_recorder()
        if rec is not None:
            rec.event("numerics/anomaly", anomaly)
        if anomaly["severity"] == "critical":
            # triggered profiler window (ISSUE 14): a critical anomaly
            # captures the very steps that misbehaved — no-op unless
            # [obs] profile_on_anomaly armed a session
            from swiftmpi_tpu_torch.obs import profiler as obs_profiler
            from swiftmpi_tpu_torch.obs import trace as obs_trace
            obs_profiler.on_critical_anomaly(anomaly)
            # flight-recorder dump (ISSUE 15): preserve the last-N
            # window wire records surrounding the anomaly — no-op
            # unless a tracer is installed with [obs] trace_on_anomaly
            obs_trace.on_critical_anomaly(anomaly)

    # .. checkpoint carry ..................................................

    def state(self) -> dict:
        """JSON-able rolling state for ``save_checkpoint(extra=...)``."""
        return {"schema": SCHEMA, "alpha": self.alpha, "k": self.k,
                "warmup": self.warmup, "patience": self.patience,
                "series": {s: list(v) for s, v in self._base.items()},
                "streaks": dict(self._streaks),
                "nonfinite_seen": self._nonfinite_seen,
                "hook_fired": self._hook_fired}

    def load_state(self, state: dict) -> bool:
        """Restore baselines saved by :meth:`state`.  Unknown or
        foreign-schema payloads are ignored (False) — a detector must
        never crash a resume over its own bookkeeping."""
        if not isinstance(state, dict) or \
                state.get("schema") != SCHEMA:
            return False
        self._base = {str(s): [float(v[0]), float(v[1]), float(v[2])]
                      for s, v in (state.get("series") or {}).items()}
        self._streaks = {str(s): int(v)
                         for s, v in (state.get("streaks") or {}).items()}
        self._nonfinite_seen = float(state.get("nonfinite_seen", 0.0))
        self._hook_fired = bool(state.get("hook_fired", False))
        return True

    def state_bytes(self) -> np.ndarray:
        """:meth:`state` as a uint8 array (the checkpoint ``extra``
        vehicle — npz carries arrays, not dicts)."""
        raw = json.dumps(self.state()).encode("utf-8")
        return np.frombuffer(raw, dtype=np.uint8)

    def load_state_bytes(self, arr) -> bool:
        try:
            state = json.loads(np.asarray(arr, np.uint8)
                               .tobytes().decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return False
        return self.load_state(state)


# -- fleet half -------------------------------------------------------------

def cross_rank_divergence(per_step: Dict[int, Dict[str, float]],
                          factor: float = 4.0,
                          min_ranks: int = 2) -> List[dict]:
    """Score aligned per-rank grad norms for cross-rank divergence.

    ``per_step`` maps step -> {rank: grad_norm}.  A step where the
    max/min ratio across >= ``min_ranks`` live ranks exceeds ``factor``
    is a ``warning``; ``factor**2`` promotes to ``critical``.  Returns
    anomaly dicts (same shape the detector emits) sorted by step —
    the FleetCollector folds them into the merged timeline.
    """
    out = []
    for step in sorted(per_step):
        norms = {r: v for r, v in per_step[step].items()
                 if v is not None and math.isfinite(v)}
        if len(norms) < min_ranks:
            continue
        lo_rank = min(norms, key=lambda r: norms[r])
        hi_rank = max(norms, key=lambda r: norms[r])
        lo, hi = norms[lo_rank], norms[hi_rank]
        ratio = hi / max(lo, 1e-12)
        if ratio <= factor:
            continue
        severity = "critical" if ratio > factor * factor else "warning"
        out.append({"schema": SCHEMA, "anomaly": "cross_rank_divergence",
                    "series": "numerics/grad_norm", "severity": severity,
                    "step": int(step), "ratio": float(ratio),
                    "max_rank": str(hi_rank), "min_rank": str(lo_rank),
                    "value": float(hi), "baseline": float(lo)})
    return out
