"""Correlation-based preamble synchronization (counterpart of ``trackmaker_tpu/sync``)."""

import math

import numpy as np
import torch

from trackmaker_tpu_torch.core import blockq
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


def walk_starts(corr: torch.Tensor, threshold: float, max_frames: int, width: int,
                sep: int) -> torch.Tensor:
    """int32[B, max_frames] pattern starts (-1 padded) from a correlation
    corr f32[B, N]: the walk of the JAX package's ``find_pattern_starts``
    and of its OFDM sync.

    From a cursor at 0, each of `max_frames` steps takes the first lag at or
    after the cursor whose corr reaches `threshold` (``blockq``'s next-set
    table), refines it to the first maximum of corr over the next `width`
    lags (zero past the last lag) and moves the cursor `sep` past that
    peak.  A step that finds no lag leaves the cursor, so every later step
    finds none: -1 from then on.  Tensor ops on corr's device, no read to
    the host."""
    b = corr.shape[0]
    dev = corr.device
    table = blockq.block_tables(corr >= threshold)
    corr_pad = torch.nn.functional.pad(corr, (0, width))
    lane = torch.arange(width, device=dev)
    cursor = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    out = []
    for _ in range(max_frames):
        first, has = blockq.first_set_from(table, cursor)
        first = torch.where(has, first.to(torch.int64), 0)
        peak = first + corr_pad.gather(1, first + lane).argmax(-1, keepdim=True)
        out.append(torch.where(has, peak, -1))
        cursor = torch.where(has, peak + sep, cursor)
    return torch.cat(out, dim=-1).to(torch.int32)


def find_pattern_starts(rx: torch.Tensor, pattern_np: np.ndarray, threshold: float,
                        max_frames: int = 64, min_sep: int | None = None) -> torch.Tensor:
    """int32[..., max_frames] starts (-1 padded) of the host pattern in
    f32[T] or f32[B, T] captures, in order, at least `min_sep` samples apart
    (default: the pattern's length): :func:`walk_starts` over
    :func:`auto_xcorr`'s correlation, refining over one pattern span.
    Callers decoding equal-length frames pass min_sep = the frame's
    samples, so threshold crossings inside a frame's body are passed over
    as a streaming decoder's cursor passes them."""
    pattern_np = np.asarray(pattern_np, np.float32)
    w = len(pattern_np)
    starts = walk_starts(auto_xcorr(_batched(rx), pattern_np), threshold, max_frames, w,
                         w if min_sep is None else int(min_sep))
    return starts if rx.ndim == 2 else starts[0]
