"""Models of the port: the reference's apps (logistic regression,
word2vec, sent2vec), GloVe and the embedding index, and the transformer
LM with its trainer."""

from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex
from swiftmpi_tpu_torch.models.glove import GloVe, cooccurrence, glove_access
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.models.trainer import (TrainState, Trainer,
                                               make_optimizer)
from swiftmpi_tpu_torch.models.transformer import (TransformerConfig,
                                                   forward,
                                                   forward_pipelined,
                                                   init_params, lm_loss,
                                                   param_shardings, sgd_step)
from swiftmpi_tpu_torch.models.word2vec import Word2Vec

__all__ = ["EmbeddingIndex", "GloVe", "LogisticRegression", "Sent2Vec",
           "Word2Vec", "build_word_model_from_dump", "cooccurrence",
           "glove_access", "TransformerConfig", "forward",
           "forward_pipelined", "init_params", "lm_loss", "param_shardings",
           "sgd_step", "TrainState", "Trainer", "make_optimizer"]
