"""Adaptive control plane: close the loop from the live traffic ledger
to the placement/wire knobs (counterpart of
``swiftmpi_tpu/control/controller.py``).

The repo's knobs — the hybrid hot-head size ``hot_k``, the push-window
width ``W``, the per-window sparse/dense wire-format crossover — are all
calibrated ONCE, from the build-time frequency histogram.  Under drift
(the hot set rotates, the batch mix changes) that calibration goes
stale and the static knobs quietly bleed wire bytes.  The
:class:`Controller` re-derives them online:

* **cadence** — the owner calls :meth:`Controller.on_steps` from the
  trainer thread at fused-group boundaries (the same safe points the
  serving plane publishes at); every ``[control] every`` consumed steps
  it runs one **evaluation**.
* **evidence** — an evaluation snapshots the transfer ledger delta
  since the previous one (:meth:`Transfer.traffic_delta`) and folds the
  :class:`~swiftmpi_tpu_torch.control.sketch.DecayedSketch` of observed ids,
  then asks each registered :class:`Knob` for a proposal.
* **hysteresis** — a proposal must win by ``[control] margin`` for
  ``[control] consecutive`` evaluations in a row before it is applied
  (the LATEST proposal is applied, not the first — under drift the
  target keeps moving while the streak builds).  A sub-margin
  evaluation resets the streak.
* **audit** — every evaluation emits a ``control/evaluation`` telemetry
  event and every decision (defer / apply / reject) a
  ``control/decision`` event with its evidence, via the installed
  :class:`~swiftmpi_tpu_torch.obs.recorder.StepRecorder` — so any knob change
  in a run is traceable to the ledger delta that triggered it.

The controller itself is knob-agnostic: appliers (which own the
re-partition / recompile machinery) live with the model that registers
the knobs (``models/word2vec.py``).  With no sketch and no knobs it
degrades to an observe-only traffic sampler.  The elastic fleet's
placement (``plan_placement``, host arithmetic) and its membership hook
(``Controller.on_membership_change``) live here too: the supervised
launcher (``launch.py``) places a dead rank's shards with them.

``[control] control: off`` (the default) pins everything: no controller
is constructed, no ids are observed, and every trajectory is
bit-identical to a build without this module.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from swiftmpi_tpu_torch import obs

#: traffic-ledger keys worth carrying into decision evidence (the full
#: delta is backend-dependent; these are the cross-backend core)
_EVIDENCE_KEYS = ("push_rows", "push_bytes", "pull_rows", "pull_bytes",
                  "pull_hot_rows", "hot_rows", "routed_rows", "psum_bytes",
                  "coalesced_rows", "dedup_saved_rows")


class ControlSettings:
    """``[control]`` section knobs.

    * ``control``     — master switch (default off = plane absent)
    * ``every``       — evaluation cadence in consumed train steps
    * ``margin``      — minimum win for a proposal to count
    * ``consecutive`` — evaluations in a row a win must persist
    * ``decay``       — sketch retention per evaluation
    """

    def __init__(self, enabled: bool = False, every: int = 64,
                 margin: float = 0.05, consecutive: int = 2,
                 decay: float = 0.5):
        if every < 1:
            raise ValueError(f"[control] every must be >= 1, got {every}")
        if margin < 0:
            raise ValueError(
                f"[control] margin must be >= 0, got {margin}")
        if consecutive < 1:
            raise ValueError(
                f"[control] consecutive must be >= 1, got {consecutive}")
        self.enabled = bool(enabled)
        self.every = int(every)
        self.margin = float(margin)
        self.consecutive = int(consecutive)
        self.decay = float(decay)

    @classmethod
    def from_config(cls, config) -> "ControlSettings":
        g = config.get_or
        return cls(
            enabled=g("control", "control", 0).to_bool(),
            every=g("control", "every", 64).to_int32(),
            margin=g("control", "margin", 0.05).to_float(),
            consecutive=g("control", "consecutive", 2).to_int32(),
            decay=g("control", "decay", 0.5).to_float())

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ControlSettings(enabled={self.enabled}, "
                f"every={self.every}, margin={self.margin}, "
                f"consecutive={self.consecutive}, decay={self.decay})")


class Proposal:
    """One knob change a proposer wants: the candidate ``value``, how
    much it ``win``s over the current setting (in the knob's own unit —
    token-mass points for ``hot_k``, relative wire-row savings for
    ``push_window``), and the evidence dict that justifies it."""

    __slots__ = ("value", "win", "evidence")

    def __init__(self, value, win: float, evidence: Optional[dict] = None):
        self.value = value
        self.win = float(win)
        self.evidence = dict(evidence or {})

    def __repr__(self) -> str:  # pragma: no cover
        return f"Proposal(value={self.value!r}, win={self.win:.4f})"


class Knob:
    """One tunable the controller closes the loop on.

    * ``current()`` — the live setting, as a JSON-able scalar (exported
      as the ``control/<name>`` gauge every evaluation).
    * ``propose(counts, traffic_delta)`` — returns a :class:`Proposal`
      or None (``counts`` is the folded sketch histogram, None when the
      controller has no sketch).
    * ``apply(value, evidence)`` — commits the change at the safe point
      the controller runs at; returns True on success, False to reject
      (e.g. a re-partition that trips ``CapacityError``).  The applier
      may add keys to ``evidence`` — they land in the decision event.
    * ``describe(value)`` — JSON-able rendering of a proposal value for
      the event stream (defaults to the value itself).
    """

    def __init__(self, name: str, current: Callable[[], object],
                 propose: Callable, apply: Optional[Callable] = None,
                 describe: Optional[Callable] = None):
        self.name = str(name)
        self.current = current
        self.propose = propose
        self.apply = apply
        self.describe = describe or (lambda v: v)


class Decision:
    """One hysteresis verdict on one knob at one evaluation."""

    __slots__ = ("knob", "action", "old", "new", "win", "streak",
                 "evaluation", "evidence")

    def __init__(self, knob: str, action: str, old, new, win: float,
                 streak: int, evaluation: int, evidence: dict):
        self.knob = knob
        self.action = action          # "defer" | "apply" | "reject"
        self.old = old
        self.new = new
        self.win = float(win)
        self.streak = int(streak)
        self.evaluation = int(evaluation)
        self.evidence = evidence

    def to_payload(self) -> dict:
        return {"knob": self.knob, "action": self.action,
                "old": self.old, "new": self.new, "win": self.win,
                "streak": self.streak, "evaluation": self.evaluation,
                "evidence": self.evidence}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Decision({self.knob}: {self.action} {self.old!r}"
                f"->{self.new!r}, win={self.win:.4f}, "
                f"streak={self.streak})")


class Controller:
    """The evaluation loop.  Owner calls :meth:`on_steps` from the
    trainer thread; everything else is internal.  ``decisions`` retains
    every :class:`Decision` (bounded only by run length — evaluations
    are ``every`` steps apart, so this is O(run/every))."""

    def __init__(self, settings: ControlSettings, transfer=None,
                 sketch=None, knobs: Sequence[Knob] = ()):
        self.settings = settings
        self.transfer = transfer
        self.sketch = sketch
        self.knobs: List[Knob] = list(knobs)
        self.decisions: List[Decision] = []
        self._since = 0
        self._evals = 0
        self._streak: Dict[str, int] = {}
        self._prev_traffic: Optional[dict] = None
        self._numerics_pending: Optional[dict] = None
        self._numerics_demote: Optional[Callable] = None

    # -- numerics health hook (obs/numerics.py) ----------------------------
    def attach_numerics(self, detector, demote: Callable) -> None:
        """Close the numerics loop: ``detector``'s sustained-EF-runaway
        hook parks its anomaly here (it fires on the recorder's flush
        path, potentially off the trainer thread); the NEXT
        :meth:`on_steps` call applies ``demote(anomaly)`` at the control
        plane's safe point and emits a ``control/decision`` event
        carrying the anomaly as evidence.  ``demote`` returns the
        previous setting (for the event) or None to decline."""
        self._numerics_demote = demote
        detector.add_demote_hook(self._on_numerics_anomaly)

    def _on_numerics_anomaly(self, anomaly: dict) -> None:
        # record only — applying here would recompile the step from
        # whatever thread flushed the recorder
        self._numerics_pending = dict(anomaly)

    def _apply_numerics(self) -> None:
        anomaly, self._numerics_pending = self._numerics_pending, None
        if self._numerics_demote is None or anomaly is None:
            return
        old = self._numerics_demote(anomaly)
        if old is None:
            return
        reg = obs.get_registry()
        d = Decision("wire_quant", "apply", old, "off", 0.0, 0,
                     self._evals, {"numerics": anomaly})
        self.decisions.append(d)
        reg.counter("control/decisions").inc()
        reg.counter("control/decisions_applied").inc()
        rec = obs.get_recorder()
        if rec is not None:
            rec.event("control/decision", d.to_payload())

    # -- elastic membership hook (cluster/membership.py) -------------------
    def on_membership_change(self, epoch: int, live: Sequence[int],
                             assign: Dict[int, int],
                             evidence: Optional[dict] = None
                             ) -> Decision:
        """Record a membership-change placement as a first-class
        control decision: the epoch bump rides the same
        ``control/decision`` event stream (and counters) as every knob
        change, so the fleet timeline shows WHO moved WHERE next to the
        supervisor's epoch event.  ``assign`` is the
        :func:`plan_placement` result the supervisor committed."""
        reg = obs.get_registry()
        d = Decision("placement", "apply", None,
                     {str(s): r for s, r in sorted(assign.items())},
                     0.0, 0, self._evals,
                     {"epoch": int(epoch), "live": list(live),
                      **(evidence or {})})
        self.decisions.append(d)
        reg.counter("control/decisions").inc()
        reg.counter("control/decisions_applied").inc()
        rec = obs.get_recorder()
        if rec is not None:
            rec.event("control/decision", d.to_payload())
        return d

    # -- cadence -----------------------------------------------------------
    def on_steps(self, n: int = 1) -> Optional[List[Decision]]:
        """Account ``n`` consumed steps; run an evaluation when the
        ``every`` cadence is due.  Returns that evaluation's decisions
        (possibly empty), or None when no evaluation ran.  A parked
        numerics demotion applies first — it must not wait out the
        evaluation cadence."""
        if self._numerics_pending is not None:
            self._apply_numerics()
        if not self.settings.enabled:
            return None
        self._since += n
        if self._since < self.settings.every:
            return None
        self._since = 0
        return self.evaluate()

    # -- one evaluation ----------------------------------------------------
    def evaluate(self) -> List[Decision]:
        reg = obs.get_registry()
        self._evals += 1
        reg.counter("control/evaluations").inc()
        delta: dict = {}
        if self.transfer is not None and hasattr(self.transfer,
                                                 "traffic_delta"):
            delta = self.transfer.traffic_delta(self._prev_traffic)
            # prev + delta == the ledger at this snapshot: one read, no
            # second traffic() racing the eager-count drain
            if self._prev_traffic is None:
                self._prev_traffic = dict(delta)
            else:
                for k, v in delta.items():
                    self._prev_traffic[k] = \
                        self._prev_traffic.get(k, 0) + v
        counts = self.sketch.fold() if self.sketch is not None else None
        decided: List[Decision] = []
        for knob in self.knobs:
            d = self._evaluate_knob(knob, counts, delta)
            if d is not None:
                decided.append(d)
            cur = knob.current()
            if isinstance(cur, (int, float)):
                reg.gauge(f"control/{knob.name}").set(float(cur))
        if self.sketch is not None:
            reg.gauge("control/sketch_observed").set(
                float(self.sketch.observed))
        rec = obs.get_recorder()
        if rec is not None:
            rec.event("control/evaluation", {
                "evaluation": self._evals,
                "decisions": len(decided),
                "traffic_delta": _evidence_traffic(delta)})
        for d in decided:
            self.decisions.append(d)
            reg.counter("control/decisions").inc()
            if d.action == "apply":
                reg.counter("control/decisions_applied").inc()
            if rec is not None:
                rec.event("control/decision",
                          {**d.to_payload(),
                           "margin": self.settings.margin,
                           "consecutive": self.settings.consecutive,
                           "traffic_delta": _evidence_traffic(delta)})
        return decided

    def _evaluate_knob(self, knob: Knob, counts,
                       delta: dict) -> Optional[Decision]:
        prop = knob.propose(counts, delta)
        name = knob.name
        if prop is None or prop.win < self.settings.margin:
            # steady state (or sub-margin noise): reset the streak, no
            # decision event — the evaluation event already records the
            # tick, and holds would otherwise dominate the stream
            self._streak[name] = 0
            return None
        streak = self._streak.get(name, 0) + 1
        old = knob.current()
        if streak < self.settings.consecutive:
            self._streak[name] = streak
            return Decision(name, "defer", old, knob.describe(prop.value),
                            prop.win, streak, self._evals, prop.evidence)
        # streak complete: commit the LATEST proposal (the target may
        # have moved while the streak built — applying the first one
        # would chase a stale optimum under exactly the drift that got
        # the streak started)
        self._streak[name] = 0
        ok = bool(knob.apply(prop.value, prop.evidence)) \
            if knob.apply is not None else False
        return Decision(name, "apply" if ok else "reject", old,
                        knob.describe(prop.value), prop.win, streak,
                        self._evals, prop.evidence)

    # -- read side ---------------------------------------------------------
    @property
    def evaluations(self) -> int:
        return self._evals

    def summary(self) -> dict:
        """Run-level rollup for ``train_metrics`` / bench detail."""
        by_action: Dict[str, int] = {}
        for d in self.decisions:
            by_action[d.action] = by_action.get(d.action, 0) + 1
        return {"evaluations": self._evals,
                "decisions": len(self.decisions),
                "applied": by_action.get("apply", 0),
                "rejected": by_action.get("reject", 0),
                "deferred": by_action.get("defer", 0),
                "knobs": {k.name: k.current() for k in self.knobs}}


def _evidence_traffic(delta: dict) -> dict:
    """The cross-backend core of a ledger delta, for event payloads."""
    return {k: delta[k] for k in _EVIDENCE_KEYS if k in delta}



# -- elastic membership placement (cluster/membership.py) --------------------

def shard_weights(shard_loads: Optional[Dict[int, Sequence[float]]],
                  n: int) -> List[float]:
    """Fleet-wide per-shard load of ``n`` shards: the sum over the ranks'
    published decayed touch loads (``shard_loads``, rank -> per-shard
    vector); a shard nobody reported weighs 1.0, so placement degrades
    to balance-by-count."""
    total = [0.0] * n
    for vec in (shard_loads or {}).values():
        for s, v in enumerate(vec):
            if s < n:
                total[s] += float(v)
    return [v if v > 0 else 1.0 for v in total]


def plan_placement(shards: Sequence[int], candidates: Sequence[int],
                   shard_loads: Optional[Dict[int, Sequence[float]]] = None,
                   current_owner: Optional[Sequence[int]] = None
                   ) -> Dict[int, int]:
    """Assign orphaned ``shards`` to ``candidates``, the Parallax
    placement rule (PAPERS.md): the per-parameter frequency statistics
    the control plane already folds decide where rows live when
    membership changes.

    ``shard_loads`` maps rank -> per-shard decayed touch loads (each
    rank's published :class:`~swiftmpi_tpu_torch.control.sketch.
    DecayedSketch` fold, :func:`~swiftmpi_tpu_torch.cluster.membership.
    read_loads`); the fleet-wide per-shard load is their sum.  Each
    candidate starts at the load of the shards it already owns
    (``current_owner``), then the orphans go heaviest-first to the
    least-loaded candidate (ties to the lower rank): the greedy LPT bound
    keeps the post-change wire imbalance low instead of piling a dead
    rank's hot shards onto one survivor.  With no load signal every shard
    weighs 1.0 and the rule degrades to balance-by-count."""
    candidates = list(candidates)
    if not candidates:
        raise ValueError("plan_placement: no candidate ranks")
    n = (len(current_owner) if current_owner is not None
         else (max(shards) + 1 if shards else 0))
    weight = shard_weights(shard_loads, n) or [1.0]
    busy = {r: 0.0 for r in candidates}
    if current_owner is not None:
        for s, r in enumerate(current_owner):
            if r in busy and s not in set(shards):
                busy[r] += weight[s] if s < len(weight) else 1.0
    assign: Dict[int, int] = {}
    for s in sorted(shards,
                    key=lambda s: -(weight[s] if s < len(weight)
                                    else 1.0)):
        dst = min(candidates, key=lambda r: (busy[r], r))
        assign[s] = dst
        busy[dst] += weight[s] if s < len(weight) else 1.0
    return assign
