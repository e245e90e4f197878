"""Restart-the-world's final loss against the unkilled job's, in the JAX
package and in the port, on the CPU, at ``chip_smoke.py`` phase 15 (a)'s
configuration: 2 processes of ``w2v_main -checkpoint`` on ``xla``, the
800-sentence prefix of the text8-shaped corpus, demo.conf's word2vec
settings at the reference width, 4 iterations, rank 1 SIGKILLed at the
top of iteration 2 under ``launch -max-restarts``.

    JAX_PLATFORMS=cpu python restart_witness.py [-out DIR]

(``-out`` defaults to ``build/restart_witness``.)

Both packages' resumed worlds restart the batcher's and the negatives'
streams, so iteration 2 after the restart replays the first epoch's
batches and draws; the final losses show what that does to each
package's reported loss.  Prints one JSON line a package: each run's
per-iteration losses of process 0 and the killed run's final loss
relative to the unkilled run's.  Not a test: it runs four 2-process
jobs of about half a minute each.
"""

import json
import os
import subprocess
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,  # noqa
                                                 TEXT8_CORPUS)
from swiftmpi_tpu_torch.data.text import (synthetic_corpus_bulk,  # noqa
                                          write_tokens_file)

#: chip_smoke.py's FLEET_SENTS, FLEET_ITERS, FLEET_KILL_ITER and PROCS
SENTS, ITERS, KILL_ITER, PROCS = 800, 4, 2, 2


def _conf() -> str:
    w = DEMO_CONF["word2vec"]
    return ("[cluster]\ntransfer: xla\nserver_num: 1\n"
            f"[worker]\nminibatch: {2 * w['window'] * (BATCH // PROCS)}\n"
            f"[server]\ninitial_learning_rate: "
            f"{DEMO_CONF['server']['initial_learning_rate']}\n"
            "[word2vec]\n" + "".join(f"{k}: {v}\n" for k, v in w.items()))


def _losses(stdout: str) -> list:
    return [float(ln.split(": error ")[1].split()[0])
            for ln in stdout.splitlines()
            if ln.startswith("[rank 0]") and "] iter " in ln
            and ": error " in ln]


def run(pkg: str, out: Path, data: Path, conf: Path, kill: bool) -> dict:
    d = out / f"{pkg}_{'killed' if kill else 'unkilled'}"
    d.mkdir(parents=True)
    jax = pkg == "swiftmpi_tpu"
    env = dict(os.environ, SMTPU_DIST_TIMEOUT="600")
    if kill:
        if jax:
            from swiftmpi_tpu.testing.faults import FaultPlan
        else:
            from swiftmpi_tpu_torch.testing.faults import FaultPlan
        env["SMTPU_FAULT_PLAN"] = FaultPlan().kill_rank(
            1, at_step=KILL_ITER, marker=str(d / "kill_marker")).to_json()
    res = subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch", "-np", str(PROCS),
         *(["-cpu", "1"] if jax else []), "-max-restarts", "1",
         "-backoff", "0.2", "-fleet-dir", str(d / "fleet"), "--",
         sys.executable, "-m", f"{pkg}.apps.w2v_main", "-config", str(conf),
         "-data", str(data), "-niters", str(ITERS), "-checkpoint",
         str(d / "ck"), *([] if jax else ["-device", "cpu"])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    (d / "launch.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise SystemExit(f"{pkg} {d.name}: rc {res.returncode}, see "
                         f"{d / 'launch.log'}")
    return {"losses": _losses(res.stdout),
            "restarts": res.stderr.count("world failed")}


def main(argv) -> int:
    out = Path(argv[argv.index("-out") + 1]) if "-out" in argv \
        else REPO / "build" / "restart_witness"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    data, conf = out / "corpus.txt", out / "w2v.conf"
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    write_tokens_file(np.ascontiguousarray(corpus[:SENTS]), str(data))
    conf.write_text(_conf())
    for pkg in ("swiftmpi_tpu", "swiftmpi_tpu_torch"):
        unkilled = run(pkg, out, data, conf, kill=False)
        killed = run(pkg, out, data, conf, kill=True)
        final, want = killed["losses"][-1], unkilled["losses"][-1]
        print(json.dumps({"package": pkg, "device": "cpu",
                          "unkilled": unkilled, "killed": killed,
                          "final_loss_vs_unkilled": final / want - 1.0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
