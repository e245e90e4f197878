"""smtpu-lint over the port: ``python -m swiftmpi_tpu_torch.analysis.lint
[paths...]`` (counterpart of ``swiftmpi_tpu/analysis/lint.py``).  By
default it lints ``swiftmpi_tpu_torch/`` and ``chip_smoke.py`` against
the port's baseline (``swiftmpi_tpu_torch/analysis/lint_baseline.json``).

Exit codes: 0 clean (baselined-only counts as clean), 1 new findings,
2 usage error.  ``--write-baseline`` grandfathers the current NEW
findings into the baseline file (each entry still needs a human
``justification`` edit before review).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from swiftmpi_tpu_torch.analysis import core


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smtpu_lint_torch",
        description="the repo's static invariant checker over the port "
                    "(see docs/ARCHITECTURE.md 'Invariant catalog')")
    p.add_argument("paths", nargs="*",
                   help="files to lint (default: the port's lint scope — "
                        "swiftmpi_tpu_torch/ and chip_smoke.py)")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected from the "
                        "package location)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON path (default: "
                        f"<root>/{core.BASELINE_NAME}; 'none' disables)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current NEW findings into the baseline "
                        "file and exit 0")
    p.add_argument("--out", default=None,
                   help="also write the JSON report to this path "
                        "(for runs/ archiving)")
    return p


def report_json(new, old) -> dict:
    return {
        "schema": core.JSON_SCHEMA,
        "new": [f.to_dict() for f in new],
        "baselined": [f.to_dict() for f in old],
        "counts": {"new": len(new), "baselined": len(old)},
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    root = os.path.abspath(args.root) if args.root else core.repo_root()
    paths = [os.path.abspath(p) for p in args.paths] or None

    baseline = {}
    baseline_path = args.baseline
    if baseline_path != "none":
        if baseline_path is None:
            baseline_path = os.path.join(root, core.BASELINE_NAME)
        baseline = core.load_baseline(baseline_path)

    new, old = core.run_lint(paths=paths, root=root, baseline=baseline)

    if args.write_baseline:
        if baseline_path in (None, "none"):
            print("--write-baseline needs a baseline path",
                  file=sys.stderr)
            return 2
        n = core.write_baseline(baseline_path, old + new)
        print(f"wrote {n} finding(s) to {baseline_path} "
              "(edit each 'justification' before committing)")
        return 0

    payload = report_json(new, old)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")

    if args.format == "json":
        json.dump(payload, sys.stdout, indent=2)
        print()
    else:
        for f in new:
            print(f.render())
        if old:
            print(f"# {len(old)} baselined finding(s) suppressed "
                  f"(see {baseline_path})")
        if new:
            print(f"# {len(new)} new finding(s)")
        else:
            print("# lint clean")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
