"""Correlation-based preamble synchronization (counterpart of ``trackmaker_tpu/sync``)."""

import math

import numpy as np
import torch

from trackmaker_tpu_torch.sync.correlate import (  # noqa: F401
    normalized_xcorr,
    sliding_dot,
    sliding_energy,
)
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits


def auto_xcorr(samples: torch.Tensor, pattern_np: np.ndarray) -> torch.Tensor:
    """Dense normalized correlation of f32[T] or f32[B, T] captures: the
    dense output of the correlation kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    x = samples if samples.ndim == 2 else samples[None]
    corr, _ = xcorr_hits(x.contiguous(), pattern_np, threshold=math.inf,
                         emit_corr=True)
    return corr if samples.ndim == 2 else corr[0]
