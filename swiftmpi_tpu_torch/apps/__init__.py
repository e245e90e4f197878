"""Command-line apps of the port: the mains (``w2v_main``, ``lr_main``,
``glove_main``, ``sent2vec_main``, ``w2v_eval``), flag-compatible with
the JAX package's, and the profiling and sweep tools."""

__all__ = ["glove_main", "lr_main", "sent2vec_main", "w2v_eval",
           "w2v_main"]
