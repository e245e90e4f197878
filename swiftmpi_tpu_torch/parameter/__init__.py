"""Parameter tables of the port: access methods, key index, table."""

from swiftmpi_tpu_torch.parameter.access import (AccessMethod, AdaGradAccess,
                                                 AdaGradRule, FieldSpec,
                                                 vec_rand_init, w2v_access,
                                                 zeros_init)
from swiftmpi_tpu_torch.parameter.key_index import CapacityError, KeyIndex
from swiftmpi_tpu_torch.parameter.sparse_table import SparseTable

__all__ = ["AccessMethod", "AdaGradAccess", "AdaGradRule", "CapacityError",
           "FieldSpec", "KeyIndex", "SparseTable", "vec_rand_init",
           "w2v_access", "zeros_init"]
