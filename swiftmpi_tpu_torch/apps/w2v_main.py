"""word2vec CLI of the port, flag-compatible with the JAX package's
``apps/w2v_main.py`` and the reference mains (``-config <conf> -data
<corpus> -niters N -output <path>``), plus ``-device cuda|cpu`` (default:
the CUDA device; the CPU only when asked for).  ``-variant sync`` (the
default) keys words with ``int`` tokens; ``-variant async`` (``[word2vec]
local_steps: 4``, the snapshot mode) and ``-variant hogwild``
(``async_mode: hogwild``, one worker on each device of the model's
cluster) key them with the BKDR string hash, as the reference's
``w2v.cpp`` does; another variant logs an error and returns 1.
``-checkpoint <path>`` saves an npz checkpoint every iteration and
resumes from the newest valid one if present (``train_with_resume``), so
rerunning the same command after a crash continues the run; when the
checkpoint is already complete the command trains nothing and still
writes ``-output``.  The conf's ``[word2vec] stencil:
1``, ``shared_negatives: 1``, ``sg: 1`` and ``dense_logits: 1`` pick the
renderings, and ``[server] dtype: bfloat16`` bf16 tables, as in the JAX
package.  The sharded
parameter server is the conf's ``[cluster] transfer: tpu`` with
``server_num: n``; ``-shards n`` sets ``server_num`` from the command
line.  The corpus loads and batches through the native C++ loader
(``data/native.py``: ``load_corpus_native`` and the prefetching batcher)
when its library builds, as the JAX CLI picks it, else through the Python
loader; the log names the loader.  ``[worker] pipeline: K`` and
``inner_steps: N`` in the conf take effect through ``Word2Vec.train``.

Under the launcher (``python -m swiftmpi_tpu_torch.launch -np N -- python
-m swiftmpi_tpu_torch.apps.w2v_main ...``) every process joins the
process group through the model's ``Cluster.initialize()``, loads the
whole corpus through the Python loader (so every process builds the same
vocab) and trains on its own shard of the sentences, one data-parallel
job; process 0 writes ``-output``.  With ``-checkpoint`` under the
supervised launcher (``launch -max-restarts R``), a restarted world
resumes every process from the checkpoint process 0 wrote last.  The log
ends with the run's kernel launches and steps.

    python -m swiftmpi_tpu_torch.apps.w2v_main -config demo.conf \\
        -data corpus.txt -niters 1 -output vectors.txt
"""

from __future__ import annotations

import json
import sys

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.cluster.bootstrap import (is_writer,
                                                  shutdown_distributed)
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.data.text import load_corpus
from swiftmpi_tpu_torch.io.resilience import train_with_resume
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import CMDLine, global_config
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger("apps.w2v")


def main(argv=None) -> int:
    try:
        return _main(argv)
    finally:
        # a normal exit leaves no flight-recorder dump (obs/trace.py's
        # clean-teardown contract)
        from swiftmpi_tpu_torch import obs
        obs.uninstall_tracer()
        shutdown_distributed()


def _main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("help", "this screen")
    cmd.registerParameter("config", "path of config file")
    cmd.registerParameter("data", "path of dataset")
    cmd.registerParameter("niters", "number of iterations")
    cmd.registerParameter("output", "path to output the embeddings")
    cmd.registerParameter("variant", "sync (int keys) | async (hashed "
                          "keys, bounded staleness) | hogwild (hashed keys, "
                          "unsynchronized worker replicas)")
    cmd.registerParameter("checkpoint",
                          "checkpoint path: save every iteration and "
                          "auto-resume if present (re-run the same "
                          "command after a crash to continue)")
    cmd.registerParameter("device", "cuda (default) | cpu")
    cmd.registerParameter("shards", "table shards ([cluster] server_num; "
                          "needs [cluster] transfer: tpu when > 1)")
    if cmd.hasParameter("help") or not cmd.hasParameter("data"):
        cmd.print_help()
        return 0
    if cmd.hasParameter("config"):
        global_config().load_conf(cmd.getValue("config")).parse()
    variant = cmd.getValue("variant", "sync")
    if variant not in ("sync", "async", "hogwild"):
        log.error("unknown -variant %r (expected sync|async|hogwild)",
                  variant)
        return 1
    if variant == "async":
        global_config().set("word2vec", "local_steps", 4)
    elif variant == "hogwild":
        global_config().set("word2vec", "async_mode", "hogwild")
    mode = "int" if variant == "sync" else "bkdr"

    if cmd.hasParameter("shards"):
        global_config().set("cluster", "server_num",
                            int(cmd.getValue("shards")))
    device = cmd.getValue("device", "") or None
    model = Word2Vec(device=device)
    niters = int(cmd.getValue("niters", "1"))
    corpus, batcher = None, None
    if native.available() and model.cluster.dp == 1:
        # C++ end to end: vocab, corpus mapping and batch assembly never
        # touch the Python tokenizer
        vocab, tokens, offsets = native.load_corpus_native(
            cmd.getValue("data"), mode=mode,
            min_sentence_length=max(model.min_sentence_length, 1))
        batcher = native.PrefetchingCBOWBatcher(
            tokens, offsets, vocab, model.window, model.sample)
        log.info("using the native C++ loader (prefetching)")
        model.build_from_vocab(vocab)
    else:
        log.info("using the Python loader%s", " (process %d of %d: its "
                 "shard of the sentences)" % (model.cluster.dp_rank,
                                             model.cluster.dp)
                 if model.cluster.dp > 1 else "")
        corpus = load_corpus(cmd.getValue("data"), mode=mode,
                             min_sentence_length=model.min_sentence_length)
        model.build(corpus)
    if cmd.hasParameter("checkpoint"):
        losses = train_with_resume(
            model, corpus, niters=niters,
            checkpoint_path=cmd.getValue("checkpoint"),
            checkpoint_every=1, batcher=batcher)
    else:
        losses = model.train(corpus, niters=niters, batcher=batcher)
    if losses:
        log.info("final error: %.5f; push paths %s", losses[-1],
                 model.train_metrics["push_paths"])
        log.info("kernel launches %s over %d steps; ring wait timeouts %d",
                 json.dumps({**kernels.launch_counts(), "ring_process":
                             kernels.ring.process_launches}),
                 model.train_metrics["steps"], kernels.ring.timeouts())
    else:
        log.info("checkpoint already at %d iters; nothing to train", niters)
    if cmd.hasParameter("output"):
        n = model.save(cmd.getValue("output"))
        if is_writer():
            log.info("wrote %d embeddings -> %s", n, cmd.getValue("output"))
        else:
            log.info("computed %d embeddings; process 0 writes them", n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
