"""Embedding similarity / analogy queries over trained word2vec output
(the port's counterpart of ``swiftmpi_tpu/apps/w2v_eval.py``, the same
flags plus ``-device cuda|cpu``: the product and the top-k run on the CUDA
device unless ``-device cpu``).

The reference has no embedding eval at all — its word2vec README ends at
the text dump (the reference's `src/apps/word2vec/README.md`; row layout
word2vec.h:100-110), leaving nearest-neighbor checks to external
scripts.  This closes that loop: the entire similarity pass is ONE
normalized product ``(V, d) @ (d, Q)`` plus a top-k on the device
(``models/embedding.py``) — never a per-row host loop, so querying 1
word and 10K words cost the same launches.

CLI (reference-style single-dash flags, `utils/cmdline.py`):

    python -m swiftmpi_tpu_torch.apps.w2v_eval -embeddings out.txt \
        -query king,man [-topk 10] [-hash int|bkdr] [-words vocab.txt]
    python -m swiftmpi_tpu_torch.apps.w2v_eval -embeddings out.txt \
        -analogy king:man::woman [-topk 5]

``-hash`` mirrors the training key conventions (`data/text.py
tokenize`): ``int`` = tokens are integer ids (sync variant),
``bkdr`` = BKDR-hashed strings (async variant).  With ``bkdr``, pass
``-words`` (any text file; its whitespace tokens are hashed) so results
can be printed as words instead of raw keys.
"""

from __future__ import annotations

import sys
from typing import Dict

from swiftmpi_tpu_torch.data.text import tokenize
from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex  # noqa: F401  (re-export: CLI-facing name)
from swiftmpi_tpu_torch.utils import CMDLine
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger("apps.w2v_eval")


def _word_maps(cmd: CMDLine, mode: str):
    """word -> key (training convention) and key -> word (for output;
    only derivable when a -words file enumerates the vocabulary)."""
    to_key = lambda w: tokenize(w, mode)[0]     # noqa: E731
    key_to_word: Dict[int, str] = {}
    if cmd.hasParameter("words"):
        with open(cmd.getValue("words")) as f:
            words = f.read().split()
        for w, k in zip(words, tokenize(" ".join(words), mode)):
            key_to_word.setdefault(int(k), w)
    return to_key, key_to_word


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("help", "this screen")
    cmd.registerParameter("embeddings", "path of the trained embedding "
                          "dump (w2v -output / Word2Vec.save)")
    cmd.registerParameter("query", "comma-separated words: top-k "
                          "nearest neighbors each")
    cmd.registerParameter("analogy", "a:b::c — solve a-b+c")
    cmd.registerParameter("topk", "neighbors per query (default 10)")
    cmd.registerParameter("hash", "word->key convention: int | bkdr "
                          "(default int, the sync-variant keys)")
    cmd.registerParameter("field", "which vectors: v (input, default) "
                          "| h (output)")
    cmd.registerParameter("words", "vocabulary text file for printing "
                          "results as words (required to name bkdr "
                          "neighbors)")
    cmd.registerParameter("device", "cuda (default) | cpu")
    if cmd.hasParameter("help") or not cmd.hasParameter("embeddings") \
            or not (cmd.hasParameter("query")
                    or cmd.hasParameter("analogy")):
        cmd.print_help()
        return 0

    mode = cmd.getValue("hash", "int")
    if mode not in ("int", "bkdr"):
        log.error("unknown -hash %r (expected int|bkdr)", mode)
        return 1
    try:
        k = int(cmd.getValue("topk", "10"))
    except ValueError:
        log.error("-topk wants an integer, got %r",
                  cmd.getValue("topk"))
        return 1
    try:
        index = EmbeddingIndex.from_text(
            cmd.getValue("embeddings"), field=cmd.getValue("field", "v"),
            device=cmd.getValue("device", "") or None)
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 1
    log.info("loaded %d embeddings (d=%d)", len(index),
             index.vecs.shape[1])
    to_key, key_to_word = _word_maps(cmd, mode)
    name = lambda key: key_to_word.get(int(key), str(int(key)))  # noqa: E731

    try:
        if cmd.hasParameter("analogy"):
            spec = cmd.getValue("analogy")
            ab, _, c = spec.partition("::")
            a, _, b = ab.partition(":")
            if not (a and b and c):
                log.error("-analogy wants a:b::c, got %r", spec)
                return 1
            ks, ss = index.analogy(to_key(a), to_key(b), to_key(c), k)
            print(f"{a} - {b} + {c} =")
            for key, s in zip(ks, ss):
                print(f"  {name(key)}\t{s:.4f}")
        if cmd.hasParameter("query"):
            words = [w.strip() for w in cmd.getValue("query").split(",")
                     if w.strip()]
            all_ks, all_ss = index.neighbors_batch(
                [to_key(w) for w in words], k)      # ONE dispatch
            for w, ks, ss in zip(words, all_ks, all_ss):
                print(f"{w}:")
                for key, s in zip(ks, ss):
                    print(f"  {name(key)}\t{s:.4f}")
    except KeyError as e:
        log.error("%s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
