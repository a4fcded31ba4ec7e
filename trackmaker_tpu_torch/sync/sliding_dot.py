"""Raw sliding dot product times a scale (counterpart of the raw form,
``normalize=False``, of ``trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_kernel``).

``sliding_dot_scaled`` launches the CUDA kernel ``csrc/sliding_dot.cu`` on
a CUDA tensor and runs ``sliding_dot_scaled_plain`` on a CPU tensor.  Both
compute, for x f32[B, T] and a host pattern p f32[L],

    out[b, i] = scale · Σ_k x[b, i-L+1+k] · p[k]      (x is 0 before sample 0)

so lag i is the dot of the L samples ending at sample i.  Both add the
taps in order, each product rounded and then each sum, and multiply by
`scale` last: the kernel and its plain version agree exactly.  That rules
out a fused multiply-add, so the kernel's floor is two f32 instructions a
tap (0.143 ms for the ASK sync, 16 captures of 339,453 samples at L=440,
on an H100).  Each kernel thread sums 8 consecutive lags from a window of
samples in registers (``csrc/xcorr_tile.cuh``), and the pattern goes to
the kernel by value, 512 floats (:func:`pack_taps`): a call copies nothing
to the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.sync import correlate

MAX_PATTERN = 512   # longest pattern the kernel takes by value
MAX_BATCH = 65535   # captures a launch: the grid's second dimension


def pack_taps(taps) -> np.ndarray:
    """The pattern as the kernel's launch parameter: its f32 values, then
    zeros, MAX_PATTERN floats."""
    return correlate.pack_taps(taps, MAX_PATTERN)


def _shapes(x: torch.Tensor, pattern: np.ndarray) -> tuple[int, int, int]:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32[B, T], got {x.dtype}{list(x.shape)}")
    b, t = x.shape
    l = len(pattern)
    if not 1 <= l <= MAX_PATTERN:
        raise ValueError(f"pattern length {l} is not in 1..{MAX_PATTERN}")
    return b, t, l


def sliding_dot_scaled_plain(x: torch.Tensor, pattern: np.ndarray,
                             scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`sliding_dot_scaled`."""
    pattern = np.asarray(pattern, np.float32)
    _, t, l = _shapes(x, pattern)
    xp = torch.nn.functional.pad(x, (l - 1, 0))
    acc = torch.zeros_like(x)
    for k, pk in enumerate(pattern.tolist()):
        acc = acc + xp[:, k:k + t] * pk
    return acc * scale


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _kernel_args(x: torch.Tensor, pattern: np.ndarray):
    """(b, t, l, the packed taps) for a launch, after the kernel's range
    checks."""
    b, t, l = _shapes(x, pattern)
    if not 1 <= b <= MAX_BATCH or t < 1:
        raise ValueError(f"the kernel takes 1..{MAX_BATCH} captures of at least one sample, "
                         f"got {b} x {t}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return b, t, l, pack_taps(pattern)


def sliding_dot_scaled(x: torch.Tensor, pattern: np.ndarray,
                       scale: float) -> torch.Tensor:
    """out f32[B, T] (see the module docstring) for x f32[B, T] and the host
    constant `pattern` f32[L], L <= 512."""
    if not _build.on_cuda(x):
        return sliding_dot_scaled_plain(x, pattern, scale)
    b, t, l, taps = _kernel_args(x, pattern)
    out = torch.empty_like(x)
    fn = _build.entry("sliding_dot", "tm_sliding_dot", _ARGTYPES)
    err = fn(x.data_ptr(), taps.ctypes.data, b, t, l, scale, out.data_ptr(),
             _build.stream_ptr(x))
    _build.check(err, "sliding_dot")
    sliding_dot_scaled.launches += 1
    return out


sliding_dot_scaled.launches = 0
