"""Plain sliding correlation (counterpart of ``trackmaker_tpu/sync/correlate.py``).

The reference path for the correlation kernel in
:mod:`trackmaker_tpu_torch.sync.xcorr_hits`.  Sliding sums are 1-D
convolutions; cuDNN would run a float32 convolution in TF32 by default,
which keeps about three decimal digits, so every convolution here turns
TF32 off for its own call.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6   # windows with less energy than this correlate to 0


def _conv_valid(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid-mode sliding correlation of x[..., T] with k[L] -> [..., T-L+1]."""
    lead = x.shape[:-1]
    xl = x.reshape(-1, 1, x.shape[-1])
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.nn.functional.conv1d(xl, k.reshape(1, 1, -1))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out.reshape(*lead, out.shape[-1])


def sliding_dot(samples: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """dot(samples[i:i+L], pattern) for every lag i (valid mode)."""
    return _conv_valid(samples, pattern.to(samples.dtype))


def sliding_energy(samples: torch.Tensor, window: int) -> torch.Tensor:
    """sum(samples[i:i+window]**2) for every lag i (valid mode)."""
    ones = torch.ones(window, dtype=samples.dtype, device=samples.device)
    return _conv_valid(samples * samples, ones)


def normalized_xcorr(samples: torch.Tensor, pattern: torch.Tensor,
                     pattern_energy: float | None = None) -> torch.Tensor:
    """corr[i] = dot(x[i:i+L], p) / max(||x[i:i+L]|| * ||p||, 1e-30); windows
    whose energy is below `EPS` give 0.  ``||p||`` is `pattern_energy`
    rounded to f32 where given, else summed in f32 (:func:`pattern_norm`),
    as in the JAX package's ``correlate.normalized_xcorr``.  The one formula
    of the port's normalization: every plain version and kernel divides so."""
    pattern = pattern.to(torch.float32)
    if pattern_energy is None:
        pe = torch.sqrt((pattern * pattern).sum())
    else:
        pe = torch.tensor(pattern_energy, dtype=torch.float32, device=samples.device)
    dot = sliding_dot(samples, pattern)
    energy = sliding_energy(samples, pattern.shape[-1])
    denom = torch.sqrt(energy.clamp(min=0.0)) * pe
    return torch.where(energy < EPS, 0.0, dot / denom.clamp(min=1e-30))


def pattern_norm(pattern: np.ndarray) -> float:
    """||p|| summed and rooted in f32: the norm the JAX package divides by
    where its caller passes no energy (``auto_xcorr_row_stats``)."""
    p = torch.from_numpy(np.array(pattern, np.float32))
    return float(torch.sqrt((p * p).sum()))


def preamble_energy(pattern: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.asarray(pattern, np.float64) ** 2)))


def pack_taps(taps, width: int) -> np.ndarray:
    """A pattern as a correlation kernel's launch parameter: its f32 values,
    then zeros, `width` floats."""
    taps = np.asarray(taps, np.float32)
    if not 1 <= len(taps) <= width:
        raise ValueError(f"{len(taps)} taps do not fit the kernel's {width}")
    out = np.zeros(width, np.float32)
    out[:len(taps)] = taps
    return out
