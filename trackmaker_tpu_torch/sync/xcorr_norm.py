"""Normalized sliding correlation at any pattern length up to 1024, dense or
reduced per row (counterpart of the normalized form of
``trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_kernel`` and of
``_xcorr_rowstats_kernel``).

``normalized_xcorr_dense`` and ``xcorr_rowstats`` launch the CUDA kernel
``csrc/xcorr_norm.cu`` on a CUDA tensor and run their plain versions on a
CPU tensor.  For captures x f32[B, T] and a host pattern p f32[L]:

* ``normalized_xcorr_dense`` returns corr f32[B, T-L+1],
  ``corr = energy < EPS ? 0 : dot / max(sqrt(energy) * ||p||, 1e-30)``
  with ``correlate.EPS`` = 1e-6 and ``||p||`` the caller's norm `pe`
  rounded to f32, by default the decoders' ``correlate.preamble_energy``
  (a division, as the JAX package's ``correlate.normalized_xcorr``);
* ``xcorr_rowstats`` returns (rowmax f32[B, R], rowpos int32[B, R]) over
  the R = ceil((T-L+1)/128) rows of 128 lags: each row's largest corr and
  the absolute lag of its first maximum.  Lags at or past T-L+1 count as
  -3.4e38.  This is the JAX package's CPU form of ``auto_xcorr_row_stats``
  (R counts the valid lags, not whole blocks of the capture), whose
  ``||p||`` is summed in f32 (``correlate.pattern_norm``).

The kernel runs the hit kernel's register tile (``csrc/xcorr_tile.cuh``):
each thread sums 8 consecutive lags from a window of samples in registers,
one fused multiply-add a tap for the dot and one for the energy, in tap
order, so at L <= 128 its corr equals ``xcorr_hits``' bit for bit.  A row
of 128 lags is 16 threads; each keeps the first maximum of its 8 lags and
the row's threads meet by warp shuffles, the smaller lag winning a tie.
The pattern goes to the kernel by value, 1024 floats (:func:`pack_taps`):
a call copies nothing to the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.sync import correlate

ROW_LAGS = 128
MAX_PATTERN = 1024   # longest pattern the kernel takes by value
MAX_BATCH = 65535    # captures a launch: the grid's second dimension
NO_ROW = -3.4e38     # the value of a lag past the valid ones


def pack_taps(taps) -> np.ndarray:
    """The pattern as the kernel's launch parameter: its f32 values, then
    zeros, MAX_PATTERN floats."""
    return correlate.pack_taps(taps, MAX_PATTERN)


def _shapes(x: torch.Tensor, pattern: np.ndarray) -> tuple[int, int, int]:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32[B, T], got {x.dtype}{list(x.shape)}")
    b, t = x.shape
    l = len(pattern)
    if not 1 <= l <= MAX_PATTERN or t < l:
        raise ValueError(f"pattern length {l} does not fit captures of {t} samples")
    return b, t, l


def normalized_xcorr_dense_plain(x: torch.Tensor, pattern: np.ndarray,
                                 pe: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`normalized_xcorr_dense`: the port's
    ``correlate.normalized_xcorr`` with ``||p|| = pe``, by default
    ``correlate.preamble_energy(pattern)``."""
    pattern = np.array(pattern, np.float32)      # a private, writable copy
    _shapes(x, pattern)
    pe = correlate.preamble_energy(pattern) if pe is None else pe
    return correlate.normalized_xcorr(x, torch.from_numpy(pattern).to(x.device), pe)


def xcorr_rowstats_plain(x: torch.Tensor, pattern: np.ndarray):
    """Plain PyTorch version of :func:`xcorr_rowstats`."""
    corr = normalized_xcorr_dense_plain(x, pattern, correlate.pattern_norm(pattern))
    b, n_lags = corr.shape
    r = -(-n_lags // ROW_LAGS)
    grid = torch.nn.functional.pad(corr, (0, r * ROW_LAGS - n_lags), value=NO_ROW)
    grid = grid.reshape(b, r, ROW_LAGS)
    lane = grid.argmax(-1)                    # the first maximum
    rowmax = grid.gather(-1, lane[..., None])[..., 0]
    base = torch.arange(0, r * ROW_LAGS, ROW_LAGS, device=x.device)
    return rowmax, (base + lane).to(torch.int32)


_DENSE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
_ROWSTATS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]


def _kernel_args(x: torch.Tensor, pattern: np.ndarray):
    """(b, t, l, the packed taps) for a launch, after the kernel's range
    checks."""
    b, t, l = _shapes(x, pattern)
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"the kernel takes 1..{MAX_BATCH} captures, got {b}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return b, t, l, pack_taps(pattern)


def normalized_xcorr_dense(x: torch.Tensor, pattern: np.ndarray,
                           pe: float | None = None) -> torch.Tensor:
    """corr f32[B, T-L+1] of the captures x f32[B, T] against the host
    constant `pattern` f32[L], L <= 1024, divided by the norm `pe`, by
    default ``correlate.preamble_energy(pattern)`` (see the module
    docstring)."""
    if not _build.on_cuda(x):
        return normalized_xcorr_dense_plain(x, pattern, pe)
    b, t, l, taps = _kernel_args(x, pattern)
    pe = correlate.preamble_energy(pattern) if pe is None else pe
    corr = torch.empty((b, t - l + 1), dtype=torch.float32, device=x.device)
    fn = _build.entry("xcorr_norm", "tm_normalized_xcorr", _DENSE_ARGTYPES)
    err = fn(x.data_ptr(), taps.ctypes.data, b, t, l, pe,
             corr.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "normalized_xcorr")
    normalized_xcorr_dense.launches += 1
    return corr


normalized_xcorr_dense.launches = 0


def xcorr_rowstats(x: torch.Tensor, pattern: np.ndarray):
    """(rowmax f32[B, R], rowpos int32[B, R]) of the captures x f32[B, T]
    against the host constant `pattern` f32[L], L <= 1024 (see the module
    docstring)."""
    if not _build.on_cuda(x):
        return xcorr_rowstats_plain(x, pattern)
    b, t, l, taps = _kernel_args(x, pattern)
    r = -(-(t - l + 1) // ROW_LAGS)
    rowmax = torch.empty((b, r), dtype=torch.float32, device=x.device)
    rowpos = torch.empty((b, r), dtype=torch.int32, device=x.device)
    fn = _build.entry("xcorr_norm", "tm_xcorr_rowstats", _ROWSTATS_ARGTYPES)
    err = fn(x.data_ptr(), taps.ctypes.data, b, t, l, correlate.pattern_norm(pattern), r,
             rowmax.data_ptr(), rowpos.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "xcorr_rowstats")
    xcorr_rowstats.launches += 1
    return rowmax, rowpos


xcorr_rowstats.launches = 0
