"""The two-stream correlation experiment (counterpart of
``tools/exp_xcorr_streams.py``): kernel #1's hit rows with the operand
delivered as two streams, each staged in shared memory by its own
asynchronous copy, against kernel #1 itself.

``xcorr_hits_2s(x, pattern, threshold)`` launches ``csrc/xcorr_streams.cu``
on a CUDA tensor and runs ``xcorr_hits_2s_plain`` on a CPU tensor.  The
two streams are ``two_streams(x)``: the captures zero-padded to whole
tiles of 1,024 lags, and the same captures shifted left by 128 samples
and zero-padded at the end (the tool's ``xs_rows``).  It returns the hit
rows int32[B, ceil(T/128), 16] of :func:`trackmaker_tpu_torch.sync.
xcorr_hits.xcorr_hits`, bit for bit on the card (the same sums in the same
order); JAX's padded rows past T, all empty, are not kept.  With
``epilogue=False`` (the tool's ``noep``) row r holds, in column k < 16,
``int(corr[128 r + k])`` (truncated), 0 past the last lag.  Patterns of 2
to 129 samples, as the tool's two 128-lane chunks allow.

    python -m trackmaker_tpu_torch.tools.exp_xcorr_streams [iters]

runs the tool's three timings at its shapes (32 captures of 433,464
samples of unit noise from seed 0, the pattern ``sign(normal(96))`` from
seed 1, threshold 0.5): ``current`` (kernel #1), ``2stream`` and
``2stream_noep``, and the time to build the two streams, after checking
that the ``2stream`` rows equal ``current``'s.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.sync import correlate
from trackmaker_tpu_torch.sync.xcorr_hits import (
    ROW_COLS,
    ROW_LAGS,
    hit_rows_plain,
    xcorr_hits,
)
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense_plain
from trackmaker_tpu_torch.tools.health import card_line
from trackmaker_tpu_torch.tools.prof_fused import time_stage

B, T, L, THR = 32, 433_464, 96, 0.5
ITERS = 100
TILE = 8 * ROW_LAGS          # lags per block of the kernel
SHIFT = ROW_LAGS             # the second stream's offset
MIN_PATTERN, MAX_PATTERN = 2, ROW_LAGS + 1
NOEP_COLS = 16


def _shapes(x: torch.Tensor, pattern: np.ndarray) -> tuple[int, int, int]:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32[B, T], got {x.dtype}{list(x.shape)}")
    b, t = x.shape
    l = len(pattern)
    if not MIN_PATTERN <= l <= MAX_PATTERN or t < l:
        raise ValueError(f"pattern length {l} does not fit the two streams' two 128-lane "
                         f"chunks, or captures of {t} samples")
    return b, t, l


def two_streams(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x padded, x shifted by 128), each f32[B, P] with P the whole tiles
    covering ceil(T/128) rows, zero past the captures' ends."""
    t = x.shape[1]
    p = -(-t // TILE) * TILE
    xp = torch.nn.functional.pad(x, (0, p - t)).contiguous()
    xs = torch.nn.functional.pad(x[:, SHIFT:], (0, p - max(t - SHIFT, 0))).contiguous()
    return xp, xs


def noep_plain(corr: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32[B, n_rows, 16]: lanes 0..15 of each row of 128 lags of corr
    f32[B, N], truncated to int32, 0 past lag N."""
    b, n_lags = corr.shape
    grid = torch.nn.functional.pad(corr, (0, n_rows * ROW_LAGS - n_lags))
    return grid.reshape(b, n_rows, ROW_LAGS)[..., :NOEP_COLS].to(torch.int32).contiguous()


def xcorr_hits_2s_plain(x: torch.Tensor, pattern: np.ndarray, threshold: float,
                        epilogue: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`xcorr_hits_2s`."""
    pattern = np.asarray(pattern, np.float32)
    _, t, _ = _shapes(x, pattern)
    corr = normalized_xcorr_dense_plain(x, pattern)
    n_rows = -(-t // ROW_LAGS)
    return hit_rows_plain(corr, n_rows, threshold) if epilogue else noep_plain(corr, n_rows)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p] + [
    ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def xcorr_hits_2s(x: torch.Tensor, pattern: np.ndarray, threshold: float,
                  epilogue: bool = True, streams=None) -> torch.Tensor:
    """Hit rows of the captures x f32[B, T] against the host pattern f32[L]
    from the two streams (see the module docstring).  `streams`, the pair
    ``two_streams(x)`` built beforehand, saves building it in the call."""
    pattern = np.asarray(pattern, np.float32)
    b, t, l = _shapes(x, pattern)
    if not _build.on_cuda(x, *(streams or ())):
        return xcorr_hits_2s_plain(x, pattern, threshold, epilogue)
    xp, xs = two_streams(x) if streams is None else streams
    p_len = -(-t // TILE) * TILE
    for s in (xp, xs):
        if tuple(s.shape) != (b, p_len) or s.dtype != torch.float32 or not s.is_contiguous():
            raise ValueError(f"each stream must be a contiguous f32[{b}, {p_len}]")
    n_rows = -(-t // ROW_LAGS)
    p = torch.from_numpy(pattern).to(x.device)
    rows = torch.empty((b, n_rows, ROW_COLS), dtype=torch.int32, device=x.device)
    fn = _build.entry("xcorr_streams", "tm_xcorr_hits_2s", _ARGTYPES)
    err = fn(xp.data_ptr(), xs.data_ptr(), p_len, p.data_ptr(), b, t, l,
             1.0 / correlate.preamble_energy(pattern), threshold, n_rows, int(epilogue),
             rows.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "xcorr_hits_2s")
    xcorr_hits_2s.launches += 1
    return rows


xcorr_hits_2s.launches = 0


def tool_input(device, b: int = B, t: int = T, l: int = L):
    """The tool's captures f32[b, t] (unit noise, seed 0) on `device` and
    its pattern sign(normal(l)) (seed 1)."""
    pattern = np.sign(np.random.default_rng(1).normal(size=l)).astype(np.float32)
    x = np.random.default_rng(0).normal(0, 1, (b, t)).astype(np.float32)
    return torch.from_numpy(x).to(device), pattern


def check_streams(x: torch.Tensor, pattern: np.ndarray, threshold: float, streams=None):
    """The ``2stream`` rows, after checking that they equal kernel #1's
    (``current``) bit for bit; raises AssertionError if not."""
    _, current = xcorr_hits(x, pattern, threshold)
    two = xcorr_hits_2s(x, pattern, threshold, streams=streams)
    if not torch.equal(two, current):
        raise AssertionError("the 2stream rows differ from kernel #1's")
    return two


def experiment(x: torch.Tensor, pattern: np.ndarray, threshold: float, iters: int = ITERS):
    """The tool's timings, (min, median) ms a call each, after
    :func:`check_streams`: ``current``, ``2stream`` and ``2stream_noep``
    on streams built beforehand, and ``streams``, building them."""
    streams = two_streams(x)
    check_streams(x, pattern, threshold, streams)
    forms = {
        "current": lambda xx: xcorr_hits(xx, pattern, threshold)[1],
        "2stream": lambda xx: xcorr_hits_2s(xx, pattern, threshold, streams=streams),
        "2stream_noep": lambda xx: xcorr_hits_2s(xx, pattern, threshold, False, streams),
        "streams": two_streams,
    }
    return {name: time_stage(fn, x, iters) for name, fn in forms.items()}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if argv else ITERS
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    x, pattern = tool_input("cuda")
    print(f"B={B} T={T} L={L} THR={THR} iters={iters} [{card}]", flush=True)
    for name, (mn, med) in experiment(x, pattern, THR, iters).items():
        print(f"{name:14s} {mn:8.4f} ms  (med {med:.4f})  [{card}]", flush=True)


if __name__ == "__main__":
    main()
