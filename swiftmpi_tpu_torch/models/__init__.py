"""Models of the port."""

from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec

__all__ = ["Sent2Vec", "Word2Vec", "build_word_model_from_dump"]
