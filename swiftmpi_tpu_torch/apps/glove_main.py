"""GloVe CLI of the port (counterpart of ``swiftmpi_tpu/apps/
glove_main.py``), the same flag surface as the other app mains.

Beyond the reference's app set; exists to show the parameter-server
worker API generalizes (models/glove.py).  Flags follow the reference
convention (w2v.cpp:8-17): ``-config <conf> -data <corpus> -niters N
-output <path>``, plus ``-device cuda|cpu`` (default: the CUDA device;
the CPU only when asked for).  The output is the standard w + wt
embedding sum in the single-vector dump layout
``swiftmpi_tpu_torch.apps.w2v_eval`` indexes directly; ``-output-full``
additionally writes both families (w, wt, b, bt) in the reference
checkpoint format.

    python -m swiftmpi_tpu_torch.apps.glove_main -config glove.conf \\
        -data corpus.txt -niters 3 -output glove.txt

Under the launcher (``python -m swiftmpi_tpu_torch.launch -np 2 --
python -m swiftmpi_tpu_torch.apps.glove_main ...``) every process reads
the whole corpus and trains its share of every minibatch; only process 0
writes the vectors.
"""

from __future__ import annotations

import sys

from swiftmpi_tpu_torch.cluster.bootstrap import is_writer
from swiftmpi_tpu_torch.data.text import load_corpus
from swiftmpi_tpu_torch.models.glove import GloVe
from swiftmpi_tpu_torch.utils import CMDLine, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger("apps.glove")


def main(argv=None) -> int:
    try:
        return _main(argv)
    finally:
        # a normal exit leaves no flight-recorder dump (obs/trace.py's
        # clean-teardown contract)
        from swiftmpi_tpu_torch import obs
        obs.uninstall_tracer()


def _main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("help", "this screen")
    cmd.registerParameter("config", "path of config file ([glove] "
                          "section: len_vec/window/x_max/alpha/"
                          "learning_rate/minibatch)")
    cmd.registerParameter("data", "path of corpus (one sentence per "
                          "line)")
    cmd.registerParameter("niters", "number of training iterations")
    cmd.registerParameter("output", "path for the w+wt embedding dump")
    cmd.registerParameter("output-full", "path for the full-field "
                          "dump (both families: w wt b bt)")
    cmd.registerParameter("device", "cuda (default) | cpu")
    if cmd.hasParameter("help") or not cmd.hasParameter("data"):
        cmd.print_help()
        return 0

    if cmd.hasParameter("config"):
        global_config().load_conf(cmd.getValue("config")).parse()
    model = GloVe(device=cmd.getValue("device", "") or None)
    corpus = load_corpus(cmd.getValue("data"))
    niters = int(cmd.getValue("niters", "1"))
    losses = model.train(corpus, niters=niters)
    log.info("final loss: %.6f", losses[-1])
    if not is_writer():
        # every process holds the same replica: process 0 writes
        if cmd.hasParameter("output") or cmd.hasParameter("output-full"):
            log.info("computed %d embeddings; process 0 writes them",
                     len(model.vocab))
        return 0
    if cmd.hasParameter("output"):
        n = model.save(cmd.getValue("output"))
        log.info("wrote %d embeddings -> %s", n, cmd.getValue("output"))
    if cmd.hasParameter("output-full"):
        n = model.save_full(cmd.getValue("output-full"))
        log.info("wrote %d full rows -> %s", n,
                 cmd.getValue("output-full"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
