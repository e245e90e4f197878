"""word2vec CLI of the port, flag-compatible with the JAX package's
``apps/w2v_main.py`` and the reference mains (``-config <conf> -data
<corpus> -niters N -output <path>``), plus ``-device cuda|cpu`` (default:
the CUDA device; the CPU only when asked for).  Only the sync variant is
ported: ``-variant async|hogwild`` and ``-checkpoint`` raise.  The conf's
``[word2vec] stencil: 1`` and ``shared_negatives: 1`` pick the stencil,
shared and stencil_shared renderings, and ``[server] dtype: bfloat16``
bf16 tables, as in the JAX package.  The sharded
parameter server is the conf's ``[cluster] transfer: tpu`` with
``server_num: n``; ``-shards n`` sets ``server_num`` from the command
line.

    python -m swiftmpi_tpu_torch.apps.w2v_main -config demo.conf \\
        -data corpus.txt -niters 1 -output vectors.txt
"""

from __future__ import annotations

import sys

from swiftmpi_tpu_torch.data.text import load_corpus
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import CMDLine, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger("apps.w2v")


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("help", "this screen")
    cmd.registerParameter("config", "path of config file")
    cmd.registerParameter("data", "path of dataset")
    cmd.registerParameter("niters", "number of iterations")
    cmd.registerParameter("output", "path to output the embeddings")
    cmd.registerParameter("variant", "sync (int keys); async and hogwild "
                          "are not ported yet")
    cmd.registerParameter("device", "cuda (default) | cpu")
    cmd.registerParameter("shards", "table shards ([cluster] server_num; "
                          "needs [cluster] transfer: tpu when > 1)")
    if cmd.hasParameter("help") or not cmd.hasParameter("data"):
        cmd.print_help()
        return 0
    if cmd.hasParameter("config"):
        global_config().load_conf(cmd.getValue("config")).parse()
    variant = cmd.getValue("variant", "sync")
    if variant != "sync":
        raise NotImplementedError(
            f"-variant {variant} is not ported yet (ROADMAP A8); only sync")
    if cmd.hasParameter("checkpoint"):
        raise NotImplementedError(
            "-checkpoint is not ported yet (ROADMAP A9)")

    if cmd.hasParameter("shards"):
        global_config().set("cluster", "server_num",
                            int(cmd.getValue("shards")))
    device = cmd.getValue("device", "") or None
    model = Word2Vec(device=device)
    niters = int(cmd.getValue("niters", "1"))
    corpus = load_corpus(cmd.getValue("data"),
                         min_sentence_length=model.min_sentence_length)
    model.build(corpus)
    losses = model.train(corpus, niters=niters)
    log.info("final error: %.5f; push paths %s", losses[-1],
             model.train_metrics["push_paths"])
    if cmd.hasParameter("output"):
        n = model.save(cmd.getValue("output"))
        log.info("wrote %d embeddings -> %s", n, cmd.getValue("output"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
