"""Correlation-based preamble synchronization (counterpart of ``trackmaker_tpu/sync``)."""

import math

import numpy as np
import torch

from trackmaker_tpu_torch.sync.correlate import (  # noqa: F401
    normalized_xcorr,
    pattern_norm,
    preamble_energy,
    sliding_dot,
    sliding_energy,
)
from trackmaker_tpu_torch.sync.xcorr_hits import MAX_PATTERN as HITS_MAX_PATTERN
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense, xcorr_rowstats


def _batched(samples: torch.Tensor) -> torch.Tensor:
    return (samples if samples.ndim == 2 else samples[None]).contiguous()


def auto_xcorr(samples: torch.Tensor, pattern_np: np.ndarray,
               pattern_energy: float | None = None) -> torch.Tensor:
    """Dense normalized correlation f32[..., T-L+1] of f32[T] or f32[B, T]
    captures, divided by the norm `pattern_energy`, or by the pattern's norm
    summed in f32 (``correlate.pattern_norm``) where it is None, as the JAX
    package's CPU path divides.  On a CUDA tensor the correlation kernel's
    dense output (up to 128 pattern samples, where the norm rounds to the
    f32 of ``correlate.preamble_energy``, the one that kernel divides by) or
    the normalized-correlation kernel; on a CPU tensor their plain
    versions."""
    x = _batched(samples)
    pattern_np = np.asarray(pattern_np, np.float32)
    pe = pattern_norm(pattern_np) if pattern_energy is None else pattern_energy
    if (len(pattern_np) <= HITS_MAX_PATTERN
            and np.float32(pe) == np.float32(preamble_energy(pattern_np))):
        corr, _ = xcorr_hits(x, pattern_np, threshold=math.inf, emit_corr=True)
    else:
        corr = normalized_xcorr_dense(x, pattern_np, pe)
    return corr if samples.ndim == 2 else corr[0]


def auto_xcorr_row_stats(samples: torch.Tensor, pattern_np: np.ndarray):
    """(rowmax f32[..., R], rowpos int32[..., R]): the largest normalized
    correlation of each row of 128 lags and the absolute lag of its first
    maximum, R = ceil((T-L+1)/128), for f32[T] or f32[B, T] captures (the
    row-stats kernel on a CUDA tensor).  The equalizer's anchor search."""
    rowmax, rowpos = xcorr_rowstats(_batched(samples), pattern_np)
    if samples.ndim == 2:
        return rowmax, rowpos
    return rowmax[0], rowpos[0]
