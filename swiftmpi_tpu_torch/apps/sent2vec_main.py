"""sent2vec CLI of the port, flag-compatible with the JAX package's
``apps/sent2vec_main.py`` and the reference app
(``apps/sent2vec/sent2vec.cpp:198-257``): ``-config <conf> -data
<sentences> -niters N -output <vecs out> -wordvec <word2vec dump>``, plus
``-device cuda|cpu`` (default: the CUDA device; the CPU only when asked
for).  The word table is the dump (either package's ``save``), loaded
with the table grown to fit.

    python -m swiftmpi_tpu_torch.apps.sent2vec_main -config demo.conf \\
        -data sentences.txt -wordvec vectors.txt -niters 10 \\
        -output sent_vecs.txt

Under the launcher (``python -m swiftmpi_tpu_torch.launch -np 2 --
python -m swiftmpi_tpu_torch.apps.sent2vec_main ...``) every process
infers every sentence on its replica of the word table, as the JAX
package runs it; only process 0 writes the vectors.
"""

from __future__ import annotations

import sys

from swiftmpi_tpu_torch.cluster.bootstrap import is_writer
from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.utils import CMDLine, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger("apps.sent2vec")


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
    cmd.registerParameter("config", "path of config file")
    cmd.registerParameter("data", "path of dataset (one sentence per line)")
    cmd.registerParameter("niters", "gradient passes per sentence")
    cmd.registerParameter("output", "path to output sentence vectors")
    cmd.registerParameter("wordvec", "pre-trained word vectors (w2v dump)")
    cmd.registerParameter("device", "cuda (default) | cpu")
    if (cmd.hasParameter("help") or not cmd.hasParameter("data")
            or not cmd.hasParameter("wordvec")):
        cmd.print_help()
        return 0
    if cmd.hasParameter("config"):
        global_config().load_conf(cmd.getValue("config")).parse()
    word_model = build_word_model_from_dump(
        cmd.getValue("wordvec"), global_config(),
        device=cmd.getValue("device", "") or None)
    s2v = Sent2Vec(word_model)
    with open(cmd.getValue("data")) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    results = s2v.infer_sentences(lines,
                                  niters=int(cmd.getValue("niters", "10")))
    out = cmd.getValue("output", "sent_vecs.txt")
    if is_writer():
        s2v.write(results, out)
        log.info("wrote %d sentence vectors -> %s", len(results), out)
    else:
        log.info("computed %d sentence vectors; process 0 writes them",
                 len(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
