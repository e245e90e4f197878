"""The bounded-staleness envelope across N processes (counterpart of the
JAX package's ``scripts/async_envelope.py``).

The reference's headline deployment is 8 asynchronous workers pulling
and pushing against the parameter server (``mpirun -np 8``, its
``cluster_run.sh``).  This app runs the port's rendering of that shape:
``python -m swiftmpi_tpu_torch.launch -np N -- python -m
swiftmpi_tpu_torch.testing.mp_child async -sweep ...``, N processes
training one corpus with cross-process bounded staleness (the snapshot
mode, ``local_steps``) at each setting of the sweep, and reports the
loss and the throughput against sync (``local_steps`` 1)::

    python -m swiftmpi_tpu_torch.apps.async_envelope            # the card
    python -m swiftmpi_tpu_torch.apps.async_envelope -device cpu -np 8 \\
        -sweep 1,4,16 -epochs 2 -sents 200

Flags: ``-np`` (8), ``-sweep`` (``1,4,16``), ``-epochs`` (4), ``-sents``,
``-shape small|reference`` or a list of both (each shape's sweep in one
launch) and ``-data NPZ`` (as ``mp_child async`` takes them),
``-device`` (``cuda``; ``cpu`` runs the processes over gloo on the
host), ``-out`` (a JSON-lines file each shape's record is appended to,
default ``runs/async_envelope.jsonl``, which git ignores) and
``-timeout`` (seconds for the launch, 3600).

It prints, for each shape, one JSON line a setting: the final loss, its
gap to sync's in percent, the training wall seconds of the setting, the
global words/s (every process's words over the wall seconds), the
processes, ``os.cpu_count()`` and, on the card, the card's name and
power limit; then the markdown table.  The loss column is the algorithm's; the words/s
column is the host's and the card's together (each process is host-bound
at the reference shape), so it is read beside the core count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from swiftmpi_tpu_torch.apps.w2v_profile import card_line
from swiftmpi_tpu_torch.utils.cmdline import CMDLine

ROOT = Path(__file__).resolve().parents[2]


def run_sweeps(nprocs: int, child_args: List[str],
               timeout: float) -> List[dict]:
    """One launch of ``mp_child async`` over ``nprocs`` processes: rank
    0's ``MP_SWEEP_JSON`` records, one a shape, each with the launch's
    wall seconds.  A failed launch raises with the end of its output."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np",
         str(nprocs), "--", sys.executable, "-m",
         "swiftmpi_tpu_torch.testing.mp_child", "async", *child_args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, SMTPU_DIST_TIMEOUT=os.environ.get(
            "SMTPU_DIST_TIMEOUT", "300")))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"async_envelope: the launch failed with rc "
                           f"{res.returncode}:\n{res.stdout[-3000:]}\n"
                           f"{res.stderr[-3000:]}")
    recs = []
    for line in res.stdout.splitlines():
        # rank-prefixed by the launcher: "[rank 0] MP_SWEEP_JSON {...}"
        if "MP_SWEEP_JSON " in line:
            recs.append(dict(json.loads(line.split("MP_SWEEP_JSON ", 1)[1]),
                             launch_wall_s=wall))
    if not recs:
        raise RuntimeError("async_envelope: no MP_SWEEP_JSON line in the "
                           "launch's output:\n" + res.stdout[-3000:])
    return recs


def envelope_lines(rec: dict, card_name: Optional[str]) -> List[dict]:
    """One line a setting of a sweep record, in ``local_steps`` order."""
    sweep = rec["sweep"]
    sync = sweep.get("1")
    out = []
    for ls in sorted(sweep, key=int):
        r = sweep[ls]
        gap = (100.0 * (r["final_loss"] - sync["final_loss"])
               / sync["final_loss"] if sync else None)
        out.append({"local_steps": int(ls), "final_loss": r["final_loss"],
                    "first_loss": r["first_loss"], "losses": r["losses"],
                    "vs_sync_pct": gap, "wall_s": r["wall_s"],
                    "global_words_per_s": r["words_per_s"],
                    "words": r["words"], "steps": r["steps"],
                    "processes": rec["processes"],
                    "cpu_count": rec["cpu_count"], "epochs": rec["epochs"],
                    "shape": rec["shape"], "device": rec["device"],
                    "card": card_name})
    return out


def table(lines: List[dict]) -> str:
    """The markdown table of a sweep's lines."""
    head = ["| local_steps | final loss | vs sync | wall s | global words/s |",
            "|---|---|---|---|---|"]
    for ln in lines:
        gap = ("n/a" if ln["vs_sync_pct"] is None
               else f"{ln['vs_sync_pct']:+.2f}%")
        head.append(f"| {ln['local_steps']} | {ln['final_loss']:.5f} | "
                    f"{gap} | {ln['wall_s']:.3f} | "
                    f"{ln['global_words_per_s']:.1f} |")
    return "\n".join(head)


def main(argv=None) -> int:
    cmd = CMDLine(["async_envelope"] + list(
        sys.argv[1:] if argv is None else argv))
    nprocs = int(cmd.get_value("np", "8"))
    device = cmd.get_value("device", "cuda")
    child = ["-sweep", cmd.get_value("sweep", "1,4,16"),
             "-epochs", cmd.get_value("epochs", "4"),
             "-shape", cmd.get_value("shape", "small"),
             "-device", device]
    for flag in ("sents", "data", "vocab", "len"):
        if flag in cmd.keys():
            child += [f"-{flag}", cmd.get_value(flag)]
    card_name = None
    if device == "cuda":
        try:
            # the parent starts no CUDA context: its children hold the card
            card_name = card_line(0)
        except (OSError, subprocess.SubprocessError):
            print("async_envelope: no card answers nvidia-smi; pass "
                  "-device cpu", file=sys.stderr)
            return 2
    recs = run_sweeps(nprocs, child, float(cmd.get_value("timeout",
                                                         "3600")))
    out = Path(cmd.get_value("out", str(ROOT / "runs" /
                                        "async_envelope.jsonl")))
    out.parent.mkdir(parents=True, exist_ok=True)
    for rec in recs:
        lines = envelope_lines(rec, card_name)
        for ln in lines:
            print(json.dumps(ln), flush=True)
        if card_name:
            print(card_name)
        print(f"\n{nprocs}-process bounded-staleness envelope "
              f"({rec['epochs']} epochs, {rec['shape']} shape, {device}, "
              f"{rec['cpu_count']} cores):\n")
        print(table(lines), flush=True)
        rec.update(measured_at=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             time.gmtime()),
                   card=card_name, lines=lines)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
