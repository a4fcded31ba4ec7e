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


def normalized_xcorr(samples: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """corr[i] = dot(x[i:i+L], p) / (||x[i:i+L]|| * ||p||); windows whose
    energy is below `EPS` give 0."""
    pattern = pattern.to(torch.float32)
    pattern_energy = torch.sqrt((pattern * pattern).sum())
    dot = sliding_dot(samples, pattern)
    energy = sliding_energy(samples, pattern.shape[-1])
    denom = torch.sqrt(energy.clamp(min=0.0)) * pattern_energy
    return torch.where(energy < EPS, 0.0, dot / denom.clamp(min=1e-30))


def preamble_energy(pattern: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.asarray(pattern, np.float64) ** 2)))
