"""Failure recovery: elastic checkpoint reshard and supervised
auto-resume (counterpart of ``swiftmpi_tpu/io/resilience.py``).

* ``load_checkpoint_elastic`` restores an npz checkpoint into a table of
  another shard count or capacity: every key is re-routed through the new
  table's ``KeyIndex`` and its row (AdaGrad sums included) moved to the
  new slot.  The strict ``load_checkpoint`` refuses a geometry change.
* ``train_with_resume`` wraps ``model.train`` with a checkpoint every k
  iterations and reload-and-retry after a failure (bounded restarts).  A
  resume takes the newest checkpoint that passes its CRCs (a corrupted
  latest falls back a generation); a failure can trigger a device health
  sweep (``utils/health.py``); and a hang watchdog bounds the time an
  attempt may go without step progress.

Chaos is injected through ``testing/faults.py``: pass a ``FaultPlan`` and
the crash, hang or corruption happens deterministically inside the run.

The watchdog runs the attempt on a worker thread and probes the card from
the watching thread only after the deadline passed.  The CUDA graphs
``Word2Vec.train`` captures use ``capture_error_mode="thread_local"``, so
a probe on another thread cannot invalidate a capture; a cancelled attempt
stops at its next step event (the top of an iteration), where its input
pipeline's producer and its side stream are already closed, and the
restarted attempt starts only after it acknowledged.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch.io.checkpoint import (find_latest_valid_checkpoint,
                                              npz_path, save_checkpoint,
                                              verify_checkpoint)
from swiftmpi_tpu_torch.parameter.sparse_table import SparseTable
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.utils.health import DeviceHangError, check_devices
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)


def load_checkpoint_elastic(table: SparseTable, path: str,
                            verify: bool = True) -> Dict[str, np.ndarray]:
    """Restore an npz checkpoint into a table whose shard geometry may
    differ from the checkpoint's: every key goes through the table's
    ``KeyIndex`` (its hashfrag, its slot ranges) and its row moves to the
    new slot, in place.  ``verify`` CRC-validates the file first.
    Returns the ``extra`` arrays; raises ``CapacityError`` if the new
    geometry cannot hold every row."""
    if verify:
        verify_checkpoint(path)
    with np.load(npz_path(path)) as z:
        keys, old_slots = z["keys"], z["slots"]
        new_slots = np.asarray(table.key_index.lookup(keys), np.int64)
        for name in table.access.fields:
            table.write_rows(name, new_slots, torch.from_numpy(
                z[f"field__{name}"][old_slots]))
        log.info("elastic restore: %d rows re-keyed from %d-shard "
                 "checkpoint into %d-shard table", len(keys),
                 int(z["num_shards"]), table.key_index.num_shards)
        return {k[len("extra__"):]: z[k] for k in z.files
                if k.startswith("extra__")}


class _AttemptAbandoned(Exception):
    """Raised inside an abandoned attempt's thread (through the fault
    bus observer) at its next step event, so a trainer the watchdog
    cancelled stops instead of racing the restarted one for the table."""


def _attempt(model, call_kwargs: dict, hang_timeout_s: Optional[float],
             probe_timeout_s: float):
    """One training attempt: ``model.train(**call_kwargs)``, or with a
    hang timeout, on a worker thread while this thread watches the fault
    bus heartbeat (every ``step_event`` beats it).  Silence longer than
    ``hang_timeout_s`` triggers a device health sweep and a
    ``DeviceHangError``; the stalled worker is cancelled cooperatively (its
    next step event raises) and must acknowledge within a grace period,
    else the error is marked non-recoverable (escalate to a process
    restart rather than race a zombie trainer)."""
    if not hang_timeout_s:
        return model.train(**call_kwargs)

    result: dict = {}
    beat = {"t": time.monotonic()}
    cancel = threading.Event()

    def obs(event, payload):
        beat["t"] = time.monotonic()
        if cancel.is_set():
            raise _AttemptAbandoned("attempt cancelled by hang watchdog")

    def worker():
        try:
            result["losses"] = model.train(**call_kwargs)
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            result["error"] = e

    faults.add_observer(obs)
    t = threading.Thread(target=worker, daemon=True, name="train-attempt")
    t.start()
    try:
        while t.is_alive():
            t.join(0.05)
            if not t.is_alive():
                break
            stalled = time.monotonic() - beat["t"]
            if stalled <= hang_timeout_s:
                continue
            report = check_devices(timeout_s=probe_timeout_s)
            bad = [(h.device, h.error) for h in report if not h.ok]
            cancel.set()
            grace = max(hang_timeout_s, 5.0)
            t.join(grace)
            recoverable = not t.is_alive()
            msg = (f"no training progress for {stalled:.1f}s "
                   f"(deadline {hang_timeout_s:.1f}s); "
                   + (f"unhealthy devices: {bad}" if bad
                      else "device probes healthy (stalled host loop)"))
            if not recoverable:
                msg += ("; attempt thread did not acknowledge "
                        f"cancellation within {grace:.0f}s — escalate to "
                        "process restart")
            err = DeviceHangError(msg)
            err.recoverable = recoverable
            raise err
    finally:
        faults.remove_observer(obs)
    if "error" in result:
        err = result["error"]
        if isinstance(err, _AttemptAbandoned):
            raise DeviceHangError("attempt cancelled by hang watchdog")
        raise err
    return result["losses"]


def train_with_resume(model, data=None, niters: int = 1,
                      checkpoint_path: str = "ckpt",
                      checkpoint_every: int = 1,
                      max_restarts: int = 2,
                      batcher=None,
                      retain: int = 2,
                      fault_plan: Optional[faults.FaultPlan] = None,
                      probe_devices: bool = False,
                      probe_timeout_s: float = 30.0,
                      hang_timeout_s: Optional[float] = None,
                      **train_kwargs):
    """Run ``model.train`` to ``niters`` total iterations with periodic
    checkpoints, resuming from the latest valid checkpoint after a
    failure (up to ``max_restarts`` times).  A checkpoint already at
    ``checkpoint_path`` is continued, so rerunning the same command after
    a crash picks up where it left off.

    The model provides ``train(..., checkpoint_path, checkpoint_every,
    checkpoint_retain, start_iter)`` and ``resume(path) -> start_iter``
    (``Word2Vec`` does).  Returns the per-iteration losses of the final
    successful ``train`` call (iterations ``start..niters``), ``[]`` when
    the checkpoint was already complete.

    ``retain``: generations kept on disk; ``fault_plan``: installed for
    the call; ``probe_devices``: sweep the devices after every failure;
    ``hang_timeout_s``: the watchdog's deadline on step progress."""
    installed_plan = None
    if fault_plan is not None:
        installed_plan = faults.install(fault_plan)
    try:
        start = 0
        best = find_latest_valid_checkpoint(checkpoint_path)
        if best is not None:
            start = int(model.resume(best))
            log.info("found valid checkpoint %s at iter %d; continuing",
                     best, start)
        elif getattr(model, "table", None) is not None:
            # the iter-0 snapshot: a crash before the first periodic
            # checkpoint rewinds to the initial state, not onto partly
            # updated rows
            save_checkpoint(model.table, checkpoint_path,
                            extra={"iter": np.int64(0)}, retain=retain)
        restarts = 0
        losses = []
        while True:
            remaining = niters - start
            if remaining <= 0:
                return losses
            call_kwargs = dict(
                data=data, niters=remaining,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every,
                checkpoint_retain=retain, start_iter=start,
                batcher=batcher, **train_kwargs)
            try:
                return _attempt(model, call_kwargs, hang_timeout_s,
                                probe_timeout_s)
            except Exception as e:  # noqa: BLE001 — retry any failure
                if isinstance(e, DeviceHangError) and \
                        not getattr(e, "recoverable", True):
                    log.error("unrecoverable hang — escalating to the "
                              "process supervisor: %s", e)
                    raise
                restarts += 1
                if restarts > max_restarts:
                    log.error("giving up after %d restarts: %s",
                              max_restarts, e)
                    raise
                if probe_devices and not isinstance(e, DeviceHangError):
                    report = check_devices(timeout_s=probe_timeout_s)
                    bad = [(h.device, h.error) for h in report if not h.ok]
                    if bad:
                        log.warning("post-failure probe: unhealthy "
                                    "devices %s", bad)
                best = find_latest_valid_checkpoint(checkpoint_path)
                if best is None:
                    log.error("no valid checkpoint to rewind to; "
                              "re-raising")
                    raise
                start = int(model.resume(best))
                log.warning("training failed (%s); restart %d/%d from "
                            "iter %d (%s)", e, restarts, max_restarts,
                            start, best)
    finally:
        if installed_plan is not None:
            faults.install(None)
