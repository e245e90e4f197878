"""Logistic-regression CLI of the port, flag-compatible with the JAX
package's ``apps/lr_main.py`` and the reference app (lr.cpp:413-509):
``-mode train|predict|eval -config <conf> -dataset <file> -niters N
-param <weights> -output <file>``, plus ``-device cuda|cpu`` (default:
the CUDA device; the CPU only when asked for).  The dataset is read by
the native C++ libSVM parser when its library builds, else by the Python
parser, as the JAX CLI does; the log names the parser.

    python -m swiftmpi_tpu_torch.apps.lr_main -mode train -config lr.conf \\
        -dataset a9a.txt -niters 3 -output weights.txt

Under the launcher (``python -m swiftmpi_tpu_torch.launch -np 2 --
python -m swiftmpi_tpu_torch.apps.lr_main ...``) every process reads the
whole dataset and trains its share of every minibatch; only process 0
writes the weights and the predictions.
"""

from __future__ import annotations

import sys

import numpy as np

from swiftmpi_tpu_torch.cluster.bootstrap import is_writer
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.utils import CMDLine, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger("apps.lr")


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("help", "this screen")
    cmd.registerParameter("mode", "train/predict/eval (eval = the "
                          "reference tools/evaluate.py flow in-process: "
                          "threshold-at-0.5 error rate on a labeled set)")
    cmd.registerParameter("config", "path of config file")
    cmd.registerParameter("dataset", "path of dataset (libSVM format)")
    cmd.registerParameter("niters", "number of training iterations")
    cmd.registerParameter("param", "path of parameter file (predict/warm start)")
    cmd.registerParameter("output", "output path (predictions or weights)")
    cmd.registerParameter("device", "cuda (default) | cpu")
    if cmd.hasParameter("help") or not cmd.hasParameter("mode"):
        cmd.print_help()
        return 0

    if cmd.hasParameter("config"):
        global_config().load_conf(cmd.getValue("config")).parse()
    mode = cmd.getValue("mode")
    model = LogisticRegression(device=cmd.getValue("device", "") or None)

    if mode == "train":
        niters = int(cmd.getValue("niters", "1"))
        losses = model.train(cmd.getValue("dataset"), niters=niters)
        log.info("libSVM parser: %s", model.parser)
        log.info("final train error: %.6f", losses[-1])
        if cmd.hasParameter("output"):
            n = model.save(cmd.getValue("output"))
            if is_writer():
                log.info("wrote %d weights -> %s", n, cmd.getValue("output"))
            else:
                log.info("computed %d weights; process 0 writes them", n)
        return 0

    if mode == "predict":
        if cmd.hasParameter("param"):
            model.load(cmd.getValue("param"))
        scores = model.predict(cmd.getValue("dataset"))
        log.info("libSVM parser: %s", model.parser)
        out = cmd.getValue("output", "predict.txt")
        if is_writer():
            np.savetxt(out, scores, fmt="%.6f")
            log.info("wrote %d predictions -> %s", len(scores), out)
        else:
            log.info("computed %d predictions; process 0 writes them",
                     len(scores))
        return 0

    if mode == "eval":
        # reference: predictions file + labels -> tools/evaluate.py
        # (26-line offline error-rate script); here one mode does the
        # predict + threshold-at-0.5 compare in-process
        if not cmd.hasParameter("param"):
            # unlike predict (whose all-0.5 output file is visibly
            # degenerate), an untrained model's error rate is a
            # plausible-looking wrong scalar — refuse instead
            log.error("-mode eval requires -param <weights>")
            return 1
        model.load(cmd.getValue("param"))
        err = model.error_rate(cmd.getValue("dataset"))
        log.info("libSVM parser: %s", model.parser)
        print(f"error rate: {err:.6f}")
        return 0

    log.error("unknown mode %r", mode)
    return 1


if __name__ == "__main__":
    sys.exit(main())
