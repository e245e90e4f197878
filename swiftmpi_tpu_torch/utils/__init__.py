"""Host-side utilities of the port: config, command line, logging."""

from swiftmpi_tpu_torch.utils.cmdline import CMDLine
from swiftmpi_tpu_torch.utils.config import (ConfigError, ConfigParser, Item,
                                             global_config,
                                             reset_global_config)
from swiftmpi_tpu_torch.utils.logger import get_logger

__all__ = ["CMDLine", "ConfigError", "ConfigParser", "Item", "get_logger",
           "global_config", "reset_global_config"]
