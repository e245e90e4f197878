"""Logging setup (the port's counterpart of ``swiftmpi_tpu/utils/logger.py``).

A stdlib logger with a glog-like single-line format.  Each record carries
the process identity: ``r<rank>`` when ``SMTPU_PROCESS_ID`` names one,
``p<pid>`` otherwise.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "swiftmpi_tpu_torch"
_FORMAT = "%(levelname).1s%(asctime)s %(ident)s %(name)s] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

_configured = False


class _IdentFilter(logging.Filter):
    """Stamp each record with the process identity, resolved per record
    so a changed environment is honoured without reconfiguring."""

    def filter(self, record: logging.LogRecord) -> bool:
        from swiftmpi_tpu_torch.obs.identity import process_ident
        record.ident = process_ident()
        return True


def get_logger(name: str = _ROOT) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("SWIFTMPI_TPU_LOGLEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        handler.addFilter(_IdentFilter())
        root = logging.getLogger(_ROOT)
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    # names outside the package hierarchy are adopted under it so they get
    # the configured handler and level
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
