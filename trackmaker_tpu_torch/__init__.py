"""trackmaker_tpu_torch — the PyTorch and CUDA port of trackmaker_tpu.

It mirrors the JAX package's layout, so each module's counterpart sits at
the same path under ``trackmaker_tpu/``.  The batch decode of the
Manchester and 4B5B line codes, the MMSE equalizer in front of it and the
ASK/chirp modem's receiver run on an NVIDIA Hopper card through
hand-written CUDA kernel sources (``csrc/``, eleven with the tools'
two), built with ``nvcc`` at first use; on CPU tensors every kernel
wrapper runs its plain PyTorch version.  One long recording decodes in
blocks of time through ``decode_blocked_single_chip``.  Importing the
package touches no device and builds nothing.

    trackmaker_tpu_torch.core   PhyConfig, bit ops, CRC8, frame codec, block index
    trackmaker_tpu_torch.dsp    carrier and chirp synthesis, EMA power, the echo
                                channel, the preamble-trained MMSE equalizer
    trackmaker_tpu_torch.sync   correlation sync, the correlation, normalized-
                                correlation, row-stats and sliding-dot kernels
    trackmaker_tpu_torch.phy    line code, encoder, exact and speculative decode;
                                the ASK modem and its speculative receiver
    trackmaker_tpu_torch.parallel  the blocked decode of one long capture
    trackmaker_tpu_torch.tools  the window health probe, the flagship stage
                                profiler and the two-stream correlation
                                experiment; each runs on the card as
                                ``python -m trackmaker_tpu_torch.tools.<name>``
"""

__version__ = "0.1.0"

from trackmaker_tpu_torch.core.config import PhyConfig  # noqa: F401
from trackmaker_tpu_torch.parallel.stream import (  # noqa: F401
    decode_blocked_exact,
    decode_blocked_single_chip,
    decode_blocked_spec,
)
