"""Transfer layer of the port: pull/push between workers and the table."""

from swiftmpi_tpu_torch.transfer.api import (PushSpec, Transfer,
                                             get_transfer)
from swiftmpi_tpu_torch.transfer.sharded import ShardedTransfer
from swiftmpi_tpu_torch.transfer.single import SingleTransfer

__all__ = ["PushSpec", "ShardedTransfer", "SingleTransfer", "Transfer",
           "get_transfer"]
