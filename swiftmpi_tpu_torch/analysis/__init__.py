"""smtpu-lint over the port: the repo's static invariant checker
(counterpart of ``swiftmpi_tpu/analysis/``).

The host-side invariants the port copied from the JAX package — serve
readers never launch device work, the pipeline producer owns no RNG and
places nothing implicitly, traffic ledgers never reset, telemetry series
match the declared catalog, lock-guarded fields mutate under their lock,
membership state moves only through epoch-guarded sites, config knobs
are documented, wire formats dispatch only in the plan interpreter —
are AST lint rules here, run over ``swiftmpi_tpu_torch/`` and
``chip_smoke.py``.  DONATE-ESCAPE has no torch counterpart: torch
donates no buffers.

Entry points:

* ``python -m swiftmpi_tpu_torch.analysis.lint`` — text or ``--format
  json``, rc 1 on new findings.
* :func:`run_lint` — programmatic API (tests, tooling).

Suppression: ``# smtpu-lint: disable=RULE[,RULE...]`` on the offending
line (on a ``def``/``class``/``with`` header it covers the whole
block); ``# smtpu-lint: disable-file=RULE`` anywhere covers the file.
Grandfathered findings live in the port's own baseline
(``swiftmpi_tpu_torch/analysis/lint_baseline.json``), each with its
justification.
"""

from swiftmpi_tpu_torch.analysis.core import (Finding, LintContext,
                                              LintFile, load_baseline,
                                              run_lint, write_baseline)
from swiftmpi_tpu_torch.analysis.rules import RULES

__all__ = ["Finding", "LintContext", "LintFile", "RULES", "run_lint",
           "load_baseline", "write_baseline"]
