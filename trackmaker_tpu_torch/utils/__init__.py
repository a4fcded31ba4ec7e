"""Host utilities (counterpart of ``trackmaker_tpu/utils``): logging setup,
progress bars and the text / bit-string converter (``utils.bintxt``)."""

from trackmaker_tpu_torch.utils.logging import get_logger, init_logging
from trackmaker_tpu_torch.utils.progress import ProgressBar

__all__ = ["init_logging", "get_logger", "ProgressBar"]
