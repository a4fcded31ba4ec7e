"""Normalized preamble correlation with per-row hit extraction
(counterpart of ``trackmaker_tpu/sync/pallas_xcorr.py``).

``xcorr_hits`` launches the CUDA kernel ``csrc/xcorr_hits.cu`` on a CUDA
tensor and runs ``xcorr_hits_plain`` on a CPU tensor.  Both return
``(corr, rows)``:

* ``corr`` f32[B, T-L+1], the normalized correlation, when ``emit_corr``;
  else None;
* ``rows`` int32[B, ceil(T/128), 16], one row per 128 lags: columns 0..3
  the first four lags with ``corr >= threshold`` in ascending order
  (padded with 2^30), column 4 the row's true hit count, columns 5..8 the
  corr at those hits bit-cast to int32 (0 when absent), the rest 0.

Lags at or past T-L+1 are never hits.  The normalization, with
``correlate.EPS`` = 1e-6, is
``corr = energy < EPS ? 0 : dot * (1/sqrt(max(energy, 1e-30))) / ||p||``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.sync import correlate
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense_plain

BIGI = 2**30
ROW_LAGS = 128
ROW_COLS = 16
HIT_SLOTS = 4
MAX_PATTERN = 128   # longest pattern the kernel stages in shared memory


def _shapes(x: torch.Tensor, pattern: np.ndarray) -> tuple[int, int, int]:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32[B, T], got {x.dtype}{list(x.shape)}")
    b, t = x.shape
    l = len(pattern)
    if not 1 <= l <= MAX_PATTERN or t < l:
        raise ValueError(f"pattern length {l} does not fit captures of {t} samples")
    return b, t, l


def xcorr_hits_plain(x: torch.Tensor, pattern: np.ndarray, threshold: float,
                     emit_corr: bool = False):
    """Plain PyTorch version of :func:`xcorr_hits`."""
    pattern = np.asarray(pattern, np.float32)
    b, t, l = _shapes(x, pattern)
    n_lags = t - l + 1
    n_rows = -(-t // ROW_LAGS)
    dev = x.device
    corr = normalized_xcorr_dense_plain(x, pattern)

    grid = torch.nn.functional.pad(
        corr, (0, n_rows * ROW_LAGS - n_lags), value=-math.inf
    ).reshape(b, n_rows, ROW_LAGS)
    hit = grid >= threshold
    rank = hit.cumsum(-1) - 1
    slot = torch.where(hit & (rank < HIT_SLOTS), rank, HIT_SLOTS)  # 4 = sink
    lag = torch.arange(n_rows * ROW_LAGS, dtype=torch.int32, device=dev)
    lag = lag.reshape(n_rows, ROW_LAGS).expand(b, n_rows, ROW_LAGS)
    starts = torch.full((b, n_rows, HIT_SLOTS + 1), BIGI, dtype=torch.int32,
                        device=dev).scatter_(-1, slot, lag)[..., :HIT_SLOTS]
    vals = torch.zeros((b, n_rows, HIT_SLOTS + 1), dtype=torch.float32,
                       device=dev).scatter_(-1, slot, grid)[..., :HIT_SLOTS]
    rows = torch.cat([
        starts,
        hit.sum(-1, dtype=torch.int32)[..., None],
        vals.view(torch.int32),
        torch.zeros((b, n_rows, ROW_COLS - 2 * HIT_SLOTS - 1), dtype=torch.int32,
                    device=dev),
    ], dim=-1)
    return (corr if emit_corr else None), rows


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def xcorr_hits(x: torch.Tensor, pattern: np.ndarray, threshold: float,
               emit_corr: bool = False):
    """Correlation and hit rows of the captures x f32[B, T] against the host
    constant `pattern` f32[L] (see the module docstring)."""
    if not _build.on_cuda(x):
        return xcorr_hits_plain(x, pattern, threshold, emit_corr)
    pattern = np.asarray(pattern, np.float32)
    b, t, l = _shapes(x, pattern)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n_rows = -(-t // ROW_LAGS)
    p = torch.from_numpy(pattern).to(x.device)
    rows = torch.empty((b, n_rows, ROW_COLS), dtype=torch.int32, device=x.device)
    corr = (torch.empty((b, t - l + 1), dtype=torch.float32, device=x.device)
            if emit_corr else None)
    fn = _build.entry("xcorr_hits", "tm_xcorr_hits", _ARGTYPES)
    err = fn(x.data_ptr(), p.data_ptr(), b, t, l,
             1.0 / correlate.preamble_energy(pattern), threshold, n_rows,
             rows.data_ptr(), None if corr is None else corr.data_ptr(),
             _build.stream_ptr(x))
    _build.check(err, "xcorr_hits")
    xcorr_hits.launches += 1
    return corr, rows


xcorr_hits.launches = 0
