"""Models of the port."""

from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex
from swiftmpi_tpu_torch.models.glove import GloVe, cooccurrence, glove_access
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec

__all__ = ["EmbeddingIndex", "GloVe", "LogisticRegression", "Sent2Vec",
           "Word2Vec", "build_word_model_from_dump", "cooccurrence",
           "glove_access"]
