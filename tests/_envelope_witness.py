"""What staleness alone does to word2vec at the reference configuration,
in the JAX package and in the port, in one process on the CPU (not a
pytest file): sync against the snapshot mode at each ``local_steps`` of
the sweep.

    JAX_PLATFORMS=cpu python tests/_envelope_witness.py \\
        [-sents 1600] [-epochs 4] [-sweep 1,4,16] [-package jax,torch]

The configuration is the one ``chip_smoke.py`` phase 20 (c) sweeps over 8
processes: demo.conf's word2vec and server settings (len_vec 100, window
4, negative 20, sample 1e-5, lr 0.05, server lr 0.7, 5,000 centers a
step) on the first ``-sents`` sentences of the text8-shaped corpus
(``synthetic_corpus_bulk(**TEXT8_CORPUS)``), with the vocab of the whole
corpus (69,627 words, a table of 90,516 rows).  The port's half is
``mp_child async -sweep``'s own training (``_async_train``) in one
process; the JAX half builds JAX's model from the same vocab.  Each
package draws its own negatives, so the two trajectories are not the
same numbers; ``tests/test_torch_envelope.py`` holds the port's snapshot
mode to JAX's step by step at this width with JAX's draws.  Prints one
JSON line a package and setting: the losses, the steps, the final loss's
gap to sync's in percent and the seconds.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np                                             # noqa: E402

from swiftmpi_tpu_torch.apps.w2v_profile import BATCH, DEMO_CONF, \
    TEXT8_CORPUS                                               # noqa: E402
from swiftmpi_tpu_torch.data.text import build_vocab, \
    synthetic_corpus_bulk                                      # noqa: E402
from swiftmpi_tpu_torch.testing import mp_child                # noqa: E402
from swiftmpi_tpu_torch.utils.cmdline import CMDLine           # noqa: E402


def jax_losses(corpus: np.ndarray, vocab, epochs: int,
               local_steps: int) -> dict:
    """JAX's model at demo.conf's settings from ``vocab``, trained over
    ``corpus`` in one process: its losses."""
    from swiftmpi_tpu.data.text import Vocab
    from swiftmpi_tpu.models.word2vec import Word2Vec
    from swiftmpi_tpu.utils import ConfigParser
    conf = {**DEMO_CONF, "word2vec": {**DEMO_CONF["word2vec"],
                                      "local_steps": local_steps}}
    model = Word2Vec(config=ConfigParser().update(conf))
    keys = np.asarray(vocab.keys)
    model.build_from_vocab(Vocab(keys, np.asarray(vocab.counts),
                                 {int(k): i for i, k in enumerate(keys)}))
    losses = model.train(corpus.tolist(), niters=epochs, batch_size=BATCH)
    return {"losses": [float(x) for x in losses], "steps": None}


def torch_losses(corpus: np.ndarray, vocab, epochs: int,
                 local_steps: int) -> dict:
    """The port's ``mp_child async`` training at the reference shape in
    one process on the CPU: its losses and steps."""
    run = mp_child._async_train("reference", corpus, vocab, epochs,
                                local_steps, "xla", "cpu")
    return {"losses": run["losses"], "steps": run["steps"]}


def main(argv=None) -> list:
    cmd = CMDLine(["envelope_witness"] + list(
        sys.argv[1:] if argv is None else argv))
    sents = int(cmd.get_value("sents", "1600"))
    epochs = int(cmd.get_value("epochs", "4"))
    settings = [int(x) for x in cmd.get_value("sweep", "1,4,16").split(",")]
    packages = cmd.get_value("package", "jax,torch").split(",")
    full = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(full)
    corpus = np.ascontiguousarray(full[:sents])
    train = {"jax": jax_losses, "torch": torch_losses}
    lines = []
    for package in packages:
        sync = None
        for ls in settings:
            t0 = time.perf_counter()
            run = train[package](corpus, vocab, epochs, ls)
            final = run["losses"][-1]
            sync = final if ls == 1 else sync
            line = {"package": package, "local_steps": ls,
                    "sentences": sents, "epochs": epochs,
                    "vocab": len(vocab), **run,
                    "vs_sync_pct": (None if sync is None
                                    else 100 * (final - sync) / sync),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
    sys.exit(0)
