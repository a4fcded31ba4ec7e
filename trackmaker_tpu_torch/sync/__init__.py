"""Correlation-based preamble synchronization (counterpart of ``trackmaker_tpu/sync``)."""

import math

import numpy as np
import torch

from trackmaker_tpu_torch.sync.correlate import (  # noqa: F401
    normalized_xcorr,
    sliding_dot,
    sliding_energy,
)
from trackmaker_tpu_torch.sync.xcorr_hits import MAX_PATTERN as HITS_MAX_PATTERN
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense, xcorr_rowstats


def _batched(samples: torch.Tensor) -> torch.Tensor:
    return (samples if samples.ndim == 2 else samples[None]).contiguous()


def auto_xcorr(samples: torch.Tensor, pattern_np: np.ndarray) -> torch.Tensor:
    """Dense normalized correlation f32[..., T-L+1] of f32[T] or f32[B, T]
    captures: on a CUDA tensor the correlation kernel's dense output (up to
    128 pattern samples) or the normalized-correlation kernel (longer
    patterns), on a CPU tensor their plain versions."""
    x = _batched(samples)
    if len(pattern_np) <= HITS_MAX_PATTERN:
        corr, _ = xcorr_hits(x, pattern_np, threshold=math.inf, emit_corr=True)
    else:
        corr = normalized_xcorr_dense(x, pattern_np)
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
