"""Test support of the port: deterministic fault injection and the numpy
word2vec oracle (``w2v_oracle``)."""
