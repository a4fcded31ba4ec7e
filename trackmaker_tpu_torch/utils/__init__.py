"""Host utilities (counterpart of ``trackmaker_tpu/utils``): logging setup."""

from trackmaker_tpu_torch.utils.logging import get_logger, init_logging

__all__ = ["init_logging", "get_logger"]
