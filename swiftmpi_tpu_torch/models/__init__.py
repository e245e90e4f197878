"""Models of the port."""

from swiftmpi_tpu_torch.models.word2vec import Word2Vec

__all__ = ["Word2Vec"]
