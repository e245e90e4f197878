"""The readings the output check's limits are set from, on the card at a
cell's own size: for each seed, the compared numbers of the program's
checked steps (the lower readings), of the controls and of the planted
faults (the upper readings).  Training's readings need no window.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--variants program,bf16,...]

The variants are the model's (``models/<model>.py``'s ``VARIANTS`` and
``readings``; word2vec's: ``program``, ``tf32``, ``bf16``,
``half_batch``, ``token``).  One JSON line a seed and variant."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, first on the path: the harness's
# modules are ``benchmark.*`` and none of them shadows a standard one
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    import torch
    from benchmark import spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    model = spec.model_module(cell)
    variants = (args.variants.split(",") if args.variants
                else model.VARIANTS)
    for seed in (int(s) for s in args.seeds.split(",")):
        for k, v in model.readings(cell, seed, variants,
                                   args.device).items():
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "variant": k, **v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
