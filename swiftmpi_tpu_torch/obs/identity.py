"""Process/rank identity for log lines and telemetry records (the port's
copy of ``swiftmpi_tpu/obs/identity.py``).

A launcher gives every supervised child a rank through
``SMTPU_PROCESS_ID``.  Everything that emits an attributable line — the
logger, the StepRecorder, fault events — tags it with ``r<rank>`` when
launched, or ``p<pid>`` for a bare single process, so interleaved output
from a multi-process run stays attributable.

Read the environment *per call*, never cached at import: tests
monkeypatch ``SMTPU_PROCESS_ID`` and a supervisor re-execs children with
fresh ranks after a restart.
"""

from __future__ import annotations

import os
from typing import Optional

#: the launcher-assigned process rank (``cluster/bootstrap.py``'s
#: constant, repeated here so this module imports nothing of the cluster)
ENV_PROCESS_ID = "SMTPU_PROCESS_ID"
#: the shared fleet-telemetry directory a launcher hands every rank
ENV_FLEET_DIR = "SMTPU_FLEET_DIR"


def process_rank() -> Optional[int]:
    """The launcher-assigned process rank, or None for a bare process."""
    raw = os.environ.get(ENV_PROCESS_ID)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def process_ident() -> str:
    """``r<rank>`` under the launcher, ``p<pid>`` otherwise."""
    rank = process_rank()
    if rank is not None:
        return f"r{rank}"
    return f"p{os.getpid()}"
