"""Deterministic fault injection — chaos scenarios as reproducible tests
(the port's copy of ``swiftmpi_tpu/testing/faults.py``, which has no JAX
in it; the port imports nothing of the JAX package).

The reference ships "without Replication, Fault Tolerance and Repair"
(`/root/reference/src/cluster/hashfrag.h:13`); this framework claims the
opposite, so failures must be *injectable on purpose*: a recovery path
that is only exercised when real hardware dies is an untested path.

A :class:`FaultPlan` is an ordered set of fault specs (crash at step k,
hang for s seconds, corrupt the next checkpoint's bytes, kill rank r) that
training code triggers through the module-level **event bus**:

* ``step_event(step)`` — called by every training loop at the top of each
  step/iteration (``Word2Vec.train``);
* ``checkpoint_event(path)`` — called right after a checkpoint lands on
  disk.

The bus dispatches to the installed plan AND to registered observers —
``io.resilience.train_with_resume`` registers one as its hang-watchdog
heartbeat, so progress monitoring and fault injection share a single
thread-through point in the models.

Plans serialise to JSON and travel to launcher children via the
``SMTPU_FAULT_PLAN`` env var, so multi-process chaos runs (kill rank r
under the supervised launcher) need no code in the child.  Cross-process
once-only semantics use a marker file: a restarted world must not re-fire
the fault that killed it, or the restart budget just burns down.

Event dispatch with no plan installed and no observers is two attribute
loads and a truthiness check — models pay nothing in production.
"""

from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import asdict, dataclass
from typing import Callable, List, Optional

from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

ENV_FAULT_PLAN = "SMTPU_FAULT_PLAN"


def _obs_count(name: str, **labels) -> None:
    """Telemetry mirror for bus events (one branch when telemetry is
    off).  Deferred import: obs stays importable without the fault
    machinery and vice versa."""
    from swiftmpi_tpu_torch import obs
    reg = obs.get_registry()
    if reg.enabled:
        reg.counter(name, **labels).inc()


_KINDS = ("crash", "hang", "corrupt_checkpoint", "kill", "nan")


class InjectedFault(RuntimeError):
    """Raised by ``crash`` faults — distinguishable from organic failures
    in logs, caught by the same recovery machinery."""


@dataclass
class Fault:
    kind: str                       # one of _KINDS
    step: Optional[int] = None      # fire when global step == step
    rank: Optional[int] = None      # None = any process
    seconds: float = 0.0            # hang: how long to stall
    at_save: Optional[int] = None   # corrupt: nth checkpoint_event (1-based;
    #                                 None = the first one seen)
    nbytes: int = 16                # corrupt: bytes to flip
    offset: Optional[int] = None    # corrupt: file offset (None = mid-file)
    signum: int = int(signal.SIGKILL)   # kill: signal to self-deliver
    max_fires: int = 1              # in-process fire budget
    marker: Optional[str] = None    # cross-process once-only marker file
    fires: int = 0                  # in-memory count (not serialised intent)

    def _armed(self) -> bool:
        if self.fires >= self.max_fires:
            return False
        if self.rank is not None and _process_rank() != self.rank:
            return False
        if self.marker and os.path.exists(self.marker):
            return False
        return True

    def _record_fire(self) -> None:
        self.fires += 1
        if self.marker:
            try:
                with open(self.marker, "x"):
                    pass
            except FileExistsError:
                pass


def _process_rank() -> int:
    """This process's rank under the launcher/scheduler env contract
    (cluster/bootstrap.py); 0 for single-process runs.  Read from the
    environment, not jax.process_index(), so rank-filtered faults work
    before (or without) any backend initialisation."""
    return int(os.environ.get("SMTPU_PROCESS_ID", "0"))


def corrupt_file_bytes(path: str, nbytes: int = 16,
                       offset: Optional[int] = None) -> int:
    """Flip ``nbytes`` bytes of ``path`` in place (XOR 0xFF) at ``offset``
    (default: the middle of the file — past the zip directory headers, in
    actual array data).  Returns the offset used.  Deterministic: same
    file + same args = same damage."""
    size = os.path.getsize(path)
    if size == 0:
        return 0
    if offset is None:
        offset = size // 2
    offset = min(offset, max(size - 1, 0))
    n = min(nbytes, size - offset)
    with open(path, "r+b") as f:
        f.seek(offset)
        blob = f.read(n)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in blob))
        f.flush()
        os.fsync(f.fileno())
    return offset


class FaultPlan:
    """Builder + dispatcher for an injectable failure scenario.

    ::

        plan = (FaultPlan()
                .crash_at_step(3)
                .corrupt_checkpoint(at_save=3)
                .hang_at_step(5, seconds=30.0))
        train_with_resume(model, ..., fault_plan=plan)
    """

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults: List[Fault] = list(faults or [])
        self.saves_seen = 0

    # -- builders (chainable) ---------------------------------------------
    def crash_at_step(self, step: int, rank: Optional[int] = None,
                      times: int = 1, marker: Optional[str] = None
                      ) -> "FaultPlan":
        """Raise :class:`InjectedFault` at the top of global step ``step``
        — i.e. after ``step`` completed steps."""
        self.faults.append(Fault("crash", step=step, rank=rank,
                                 max_fires=times, marker=marker))
        return self

    def hang_at_step(self, step: int, seconds: float,
                     rank: Optional[int] = None,
                     marker: Optional[str] = None) -> "FaultPlan":
        """Stall ``seconds`` at the top of step ``step`` — the injectable
        stand-in for a hung device / stuck collective."""
        self.faults.append(Fault("hang", step=step, seconds=seconds,
                                 rank=rank, marker=marker))
        return self

    def corrupt_checkpoint(self, at_save: Optional[int] = None,
                           nbytes: int = 16, offset: Optional[int] = None,
                           rank: Optional[int] = None,
                           marker: Optional[str] = None) -> "FaultPlan":
        """Flip bytes in the checkpoint file written by the ``at_save``-th
        checkpoint event (1-based; None = first) — models a torn/bit-rotted
        write that the CRC validation must catch."""
        self.faults.append(Fault("corrupt_checkpoint", at_save=at_save,
                                 nbytes=nbytes, offset=offset, rank=rank,
                                 marker=marker))
        return self

    def kill_rank(self, rank: int, at_step: int,
                  signum: int = int(signal.SIGKILL),
                  marker: Optional[str] = None) -> "FaultPlan":
        """Self-deliver ``signum`` on rank ``rank`` at step ``at_step`` —
        the launcher-facing fault: no exception, no cleanup, the process
        is simply gone (pass a ``marker`` path so the supervised restart
        does not re-fire it)."""
        self.faults.append(Fault("kill", step=at_step, rank=rank,
                                 signum=int(signum), marker=marker))
        return self

    def nan_at_step(self, step: int, rank: Optional[int] = None,
                    marker: Optional[str] = None) -> "FaultPlan":
        """Arm a NaN poisoning at step ``step`` — the numerics-plane
        fault.  faults.py knows no model state, so the fault only raises
        the :func:`consume_nan` flag; the training loop that polls it
        (Word2Vec.train) overwrites one of its own parameter rows with
        NaN, and the numerics plane (obs/numerics.py) reports it."""
        self.faults.append(Fault("nan", step=step, rank=rank,
                                 marker=marker))
        return self

    # -- event dispatch ----------------------------------------------------
    def on_step(self, step: int) -> None:
        for f in self.faults:
            if f.kind not in ("crash", "hang", "kill", "nan"):
                continue
            if f.step is not None and step != f.step:
                continue
            if not f._armed():
                continue
            f._record_fire()
            _obs_count("faults/injected", kind=f.kind)
            if f.kind == "hang":
                log.warning("fault injection: hanging %.1fs at step %d",
                            f.seconds, step)
                time.sleep(f.seconds)
            elif f.kind == "kill":
                log.warning("fault injection: killing rank %d (signal %d) "
                            "at step %d", _process_rank(), f.signum, step)
                os.kill(os.getpid(), f.signum)
            elif f.kind == "nan":
                log.warning("fault injection: NaN poison armed at step %d",
                            step)
                _raise_nan_flag()
            else:
                log.warning("fault injection: crashing at step %d", step)
                raise InjectedFault(f"injected crash at step {step}")

    def on_checkpoint(self, path: str) -> None:
        self.saves_seen += 1
        for f in self.faults:
            if f.kind != "corrupt_checkpoint" or not f._armed():
                continue
            if f.at_save is not None and self.saves_seen != f.at_save:
                continue
            f._record_fire()
            _obs_count("faults/injected", kind=f.kind)
            off = corrupt_file_bytes(path, f.nbytes, f.offset)
            log.warning("fault injection: corrupted %d bytes of %s at "
                        "offset %d (save #%d)", f.nbytes, path, off,
                        self.saves_seen)

    # -- serialisation (launcher children read SMTPU_FAULT_PLAN) -----------
    def to_json(self) -> str:
        out = []
        for f in self.faults:
            d = asdict(f)
            d.pop("fires")      # runtime state, not intent
            out.append(d)
        return json.dumps(out)

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        return cls([Fault(**d) for d in json.loads(blob)])

    def install_env(self, env: Optional[dict] = None) -> dict:
        """Write the plan into ``env`` (default ``os.environ``) so
        subprocesses auto-activate it via :func:`active`."""
        if env is None:
            env = os.environ
        env[ENV_FAULT_PLAN] = self.to_json()
        return env


# -- module-level bus ------------------------------------------------------

_active: Optional[FaultPlan] = None
_env_checked = False
_observers: List[Callable[[str, object], None]] = []
_nan_pending = False


def _raise_nan_flag() -> None:
    global _nan_pending
    _nan_pending = True


def consume_nan() -> bool:
    """True exactly once per fired ``nan`` fault.  The training loop
    that sees True poisons one of its own parameter rows — the fault
    bus owns WHEN, the model owns WHAT (it knows its table layout)."""
    global _nan_pending
    if _nan_pending:
        _nan_pending = False
        return True
    return False


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Make ``plan`` the process-wide active plan (None clears)."""
    global _active, _env_checked
    _active = plan
    _env_checked = True       # explicit install beats env auto-activation
    return plan


def clear() -> None:
    global _active, _env_checked, _nan_pending
    _active = None
    _env_checked = False
    _nan_pending = False


def active() -> Optional[FaultPlan]:
    """The installed plan; lazily auto-activates from SMTPU_FAULT_PLAN the
    first time so launcher children need no code."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        blob = os.environ.get(ENV_FAULT_PLAN)
        if blob:
            try:
                _active = FaultPlan.from_json(blob)
                log.info("fault plan activated from %s (%d faults)",
                         ENV_FAULT_PLAN, len(_active.faults))
            except (ValueError, TypeError) as e:
                log.error("bad %s ignored: %r", ENV_FAULT_PLAN, e)
    return _active


def add_observer(fn: Callable[[str, object], None]) -> None:
    """Register a bus observer ``fn(event, payload)`` — called for every
    ``step``/``checkpoint`` event BEFORE fault dispatch (a heartbeat must
    be recorded even when the fault then crashes the step)."""
    _observers.append(fn)


def remove_observer(fn: Callable[[str, object], None]) -> None:
    try:
        _observers.remove(fn)
    except ValueError:
        pass


def step_event(step: int) -> None:
    """Training loops call this at the top of every step/iteration."""
    _obs_count("faults/step_events")
    if _observers:
        for fn in list(_observers):
            fn("step", step)
    plan = active()
    if plan is not None:
        plan.on_step(step)


def checkpoint_event(path: str) -> None:
    """Checkpoint writers call this right after a checkpoint lands."""
    _obs_count("faults/checkpoint_events")
    if _observers:
        for fn in list(_observers):
            fn("checkpoint", path)
    plan = active()
    if plan is not None:
        plan.on_checkpoint(path)
