"""Simulated acoustic channel (counterpart of ``trackmaker_tpu/dsp/channel.py``).

Only the echo channel is here so far: robustness runs build their captures
on the device beside the modem.
"""

from __future__ import annotations

import torch

from trackmaker_tpu_torch.sync.correlate import _conv_valid


def multipath(x: torch.Tensor, taps) -> torch.Tensor:
    """Convolve x[..., T] with a small echo impulse response,
    y[n] = Σ_k taps[k]·x[n-k], truncated to T samples: taps[0] is the direct
    path and taps[d] an echo at delay d.  A causal convolution in full
    float32 (TF32 off)."""
    k = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    xp = torch.nn.functional.pad(x.to(torch.float32), (k.shape[0] - 1, 0))
    return _conv_valid(xp, k.flip(0))
