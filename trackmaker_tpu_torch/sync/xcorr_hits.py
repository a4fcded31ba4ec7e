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
``correlate.EPS`` = 1e-6 and ``||p|| = correlate.preamble_energy(p)``
rounded to f32, is the division of the JAX package's
``correlate.normalized_xcorr``:
``corr = energy < EPS ? 0 : dot / max(sqrt(energy) * ||p||, 1e-30)``.

Two more entry points of the same kernel give the same rows:
``xcorr_hits_batched`` folds `bc` captures into each block (the
counterpart of ``pallas_xcorr_hits_batched``), and ``xcorr_hits_refine``
(the counterpart of ``pallas_xcorr_hits_refine``) refines the frame start
of each row's first four hits against the sync word and writes it to
columns 9..12 as a delta from the hit (see :func:`refine_deltas_plain`).

The pattern and the sync word go to the kernel by value, as 128 floats
(:func:`pack_taps`): a call copies nothing to the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.sync import correlate
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense_plain
from trackmaker_tpu_torch.utils.trace import spanned

BIGI = 2**30
ROW_LAGS = 128
ROW_COLS = 16
HIT_SLOTS = 4
MAX_PATTERN = 128   # longest pattern (and sync word) the kernel takes by value

MAX_REFINE_POSITIONS = 32   # refine positions of a hit
MAX_REFINE_HALO = 256       # samples the kernel stages past a block's last lag
REFINE_EPS = 1e-6           # sync windows with no more energy correlate to 0


def pack_taps(taps) -> np.ndarray:
    """The pattern (or sync word) as the kernel's launch parameter: its f32
    values, then zeros, MAX_PATTERN floats."""
    return correlate.pack_taps(taps, MAX_PATTERN)


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
    _, t, _ = _shapes(x, pattern)
    corr = normalized_xcorr_dense_plain(x, pattern)
    return (corr if emit_corr else None), hit_rows_plain(corr, -(-t // ROW_LAGS), threshold)


def hit_rows_plain(corr: torch.Tensor, n_rows: int, threshold: float) -> torch.Tensor:
    """The hit rows int32[B, n_rows, 16] of the correlation corr f32[B, N]
    (see the module docstring); lags at or past N are never hits."""
    b, n_lags = corr.shape
    dev = corr.device
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
    return torch.cat([
        starts,
        hit.sum(-1, dtype=torch.int32)[..., None],
        vals.view(torch.int32),
        torch.zeros((b, n_rows, ROW_COLS - 2 * HIT_SLOTS - 1), dtype=torch.int32,
                    device=dev),
    ], dim=-1)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@spanned("tm.kernel.xcorr_hits")
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
    rows = torch.empty((b, n_rows, ROW_COLS), dtype=torch.int32, device=x.device)
    corr = (torch.empty((b, t - l + 1), dtype=torch.float32, device=x.device)
            if emit_corr else None)
    taps = pack_taps(pattern)
    fn = _build.entry("xcorr_hits", "tm_xcorr_hits", _ARGTYPES)
    err = fn(x.data_ptr(), taps.ctypes.data, b, t, l,
             correlate.preamble_energy(pattern), threshold, n_rows,
             rows.data_ptr(), None if corr is None else corr.data_ptr(),
             _build.stream_ptr(x))
    _build.check(err, "xcorr_hits")
    xcorr_hits.launches += 1
    return corr, rows


xcorr_hits.launches = 0


def xcorr_hits_batched_plain(x: torch.Tensor, pattern: np.ndarray, threshold: float,
                             bc: int = 8) -> torch.Tensor:
    """Plain PyTorch version of :func:`xcorr_hits_batched`."""
    return xcorr_hits_plain(x, pattern, threshold)[1]


_BATCHED_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def xcorr_hits_batched(x: torch.Tensor, pattern: np.ndarray, threshold: float,
                       bc: int = 8) -> torch.Tensor:
    """The hit rows of :func:`xcorr_hits`, with each block of the kernel
    covering `bc` captures."""
    if not _build.on_cuda(x):
        return xcorr_hits_batched_plain(x, pattern, threshold, bc)
    pattern = np.asarray(pattern, np.float32)
    b, t, l = _shapes(x, pattern)
    if not x.is_contiguous() or bc < 1:
        raise ValueError("x must be contiguous and bc positive")
    n_rows = -(-t // ROW_LAGS)
    rows = torch.empty((b, n_rows, ROW_COLS), dtype=torch.int32, device=x.device)
    taps = pack_taps(pattern)
    fn = _build.entry("xcorr_hits", "tm_xcorr_hits_batched", _BATCHED_ARGTYPES)
    err = fn(x.data_ptr(), taps.ctypes.data, b, min(bc, b), t, l,
             correlate.preamble_energy(pattern), threshold, n_rows,
             rows.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "xcorr_hits_batched")
    xcorr_hits_batched.launches += 1
    return rows


xcorr_hits_batched.launches = 0


def refine_deltas_plain(x: torch.Tensor, row: torch.Tensor, pos: torch.Tensor,
                        vlen: torch.Tensor, sync: np.ndarray, sync_e: float,
                        sync_off: int, n_pos: int, fall_off: int) -> torch.Tensor:
    """The sync refine of N positions: delta int32[N] of hit pos int32[N] in
    capture row[N] of x f32[B, T], whose valid length is vlen int32[N].

    The window of W = len(sync) samples at p_k = pos + sync_off + k, k <
    n_pos, correlates to ``cc_k = en > 1e-6 ? dot / (sqrt(en) * sync_e) : 0``
    with ``cc_k = -inf`` where p_k > vlen - W; the first maximum wins, and
    ``delta = max > -1 ? sync_off + best + W : fall_off``.  Samples at or
    past T read as zero.  The refine of the attempt kernels and of the
    correlation kernel's fused form, which add the same way."""
    dev = x.device
    t = x.shape[1]
    w = len(sync)
    base = pos.to(torch.int64) + sync_off
    k = torch.arange(n_pos, device=dev)
    idx = (base[:, None, None] + k[:, None] + torch.arange(w, device=dev)).clamp(max=t)
    xz = torch.nn.functional.pad(x, (0, 1))       # column t reads as zero
    win = xz[row.to(torch.int64)[:, None, None], idx]
    s = torch.from_numpy(np.asarray(sync, np.float32)).to(dev)
    # tap by tap, a rounded product then a rounded sum, as the kernels add
    # them: equal cc values keep a near-tie's first maximum the kernel's
    dot = torch.zeros(win.shape[:-1], dtype=torch.float32, device=dev)
    en = torch.zeros_like(dot)
    for j in range(w):
        v = win[..., j]
        dot = dot + v * s[j]
        en = en + v * v
    cc = torch.where(en > REFINE_EPS, dot / (torch.sqrt(en) * sync_e), 0.0)
    cc = torch.where(base[:, None] + k <= (vlen.to(torch.int64) - w)[:, None], cc, -torch.inf)
    best = cc.argmax(-1)
    return torch.where(cc.amax(-1) > -1.0, sync_off + best + w, fall_off).to(torch.int32)


def _check_refine(sync_pattern, sync_len: int, sync_off: int, n_pos: int, l: int) -> None:
    halo = max(l - 1, sync_off + n_pos + sync_len - 2)
    if (len(sync_pattern) != sync_len or not 1 <= sync_len <= MAX_PATTERN or sync_off < 0
            or not 1 <= n_pos <= MAX_REFINE_POSITIONS or halo > MAX_REFINE_HALO):
        raise ValueError(f"refine window (sync word {len(sync_pattern)} of {sync_len}, "
                         f"offset {sync_off}, {n_pos} positions) out of the kernel's range")


def xcorr_hits_refine_plain(x: torch.Tensor, vlens: torch.Tensor, pattern: np.ndarray,
                            sync_pattern: np.ndarray, threshold: float, *, sync_off: int,
                            n_pos: int, sync_len: int, fall_off: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`xcorr_hits_refine`."""
    pattern = np.asarray(pattern, np.float32)
    _check_refine(sync_pattern, sync_len, sync_off, n_pos, len(pattern))
    _, rows = xcorr_hits_plain(x, pattern, threshold)
    starts = rows[..., :HIT_SLOTS]
    live = starts < BIGI
    capture = torch.arange(x.shape[0], device=x.device)[:, None, None].expand_as(starts)[live]
    delta = torch.full_like(starts, fall_off)
    delta[live] = refine_deltas_plain(
        x, capture, starts[live], vlens[capture], sync_pattern,
        correlate.preamble_energy(sync_pattern), sync_off, n_pos, fall_off)
    rows[..., 2 * HIT_SLOTS + 1:3 * HIT_SLOTS + 1] = delta
    return rows


_REFINE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [
    ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


@spanned("tm.kernel.xcorr_hits_refine")
def xcorr_hits_refine(x: torch.Tensor, vlens: torch.Tensor, pattern: np.ndarray,
                      sync_pattern: np.ndarray, threshold: float, *, sync_off: int,
                      n_pos: int, sync_len: int, fall_off: int) -> torch.Tensor:
    """Hit rows int32[B, ceil(T/128), 16] of the captures x f32[B, T] with
    valid lengths vlens int32[B], each of the first four hits h of a row
    refined against the sync word `sync_pattern` f32[W]: columns 9..12
    hold the delta of its frame start h + delta (see
    :func:`refine_deltas_plain`; an absent hit holds `fall_off`)."""
    if not _build.on_cuda(x, vlens):
        return xcorr_hits_refine_plain(x, vlens, pattern, sync_pattern, threshold,
                                       sync_off=sync_off, n_pos=n_pos, sync_len=sync_len,
                                       fall_off=fall_off)
    pattern = np.asarray(pattern, np.float32)
    b, t, l = _shapes(x, pattern)
    _check_refine(sync_pattern, sync_len, sync_off, n_pos, l)
    if (not x.is_contiguous() or tuple(vlens.shape) != (b,) or vlens.dtype != torch.int32
            or not vlens.is_contiguous()):
        raise ValueError(f"x must be contiguous and vlens a contiguous int32[{b}]")
    n_rows = -(-t // ROW_LAGS)
    rows = torch.empty((b, n_rows, ROW_COLS), dtype=torch.int32, device=x.device)
    taps, sync_taps = pack_taps(pattern), pack_taps(sync_pattern)
    fn = _build.entry("xcorr_hits", "tm_xcorr_hits_refine", _REFINE_ARGTYPES)
    err = fn(x.data_ptr(), vlens.data_ptr(), taps.ctypes.data, sync_taps.ctypes.data,
             b, t, l, sync_len,
             correlate.preamble_energy(pattern), correlate.preamble_energy(sync_pattern),
             threshold, sync_off, n_pos, fall_off, n_rows, rows.data_ptr(),
             _build.stream_ptr(x))
    _build.check(err, "xcorr_hits_refine")
    xcorr_hits_refine.launches += 1
    return rows


xcorr_hits_refine.launches = 0
