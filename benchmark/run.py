"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Exits non-zero, and prints no result, where there is no CUDA device or
fewer than the cell needs, and where ``jax``, ``jaxlib``, ``flax`` or
the JAX package is loaded once the window has closed.  The last lines of
standard error, and the ``check`` key, last in the result line, give
each number the output check compared with its limit."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, first on the path: the harness's
# modules are ``benchmark.*`` and none of them shadows a standard one
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from benchmark import harness, spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 2
    # the configurations state float32 products with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.emit(harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), cell=cell))
    return 0


if __name__ == "__main__":
    sys.exit(main())
