"""trackmaker_tpu_torch — the PyTorch and CUDA port of trackmaker_tpu.

It mirrors the JAX package's layout, so each module's counterpart sits at
the same path under ``trackmaker_tpu/``.  The batch decode of the
Manchester and 4B5B line codes runs on an NVIDIA Hopper card through four
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use; on
CPU tensors every kernel wrapper runs its plain PyTorch version.  Importing the package touches no
device and builds nothing.

    trackmaker_tpu_torch.core   PhyConfig, bit ops, CRC8, frame codec
    trackmaker_tpu_torch.sync   correlation sync and the correlation kernel
    trackmaker_tpu_torch.phy    line code, encoder, exact and speculative decode
"""

__version__ = "0.1.0"

from trackmaker_tpu_torch.core.config import PhyConfig  # noqa: F401
