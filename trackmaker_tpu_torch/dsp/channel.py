"""Simulated acoustic channel (counterpart of ``trackmaker_tpu/dsp/channel.py``).

The channel is explicit and parameterized, so that robustness sweeps
(noise, sample-clock mismatch, echoes) build their captures on the device
beside the modem.  Every model works on the last axis of x[..., T] and
keeps its device.
"""

from __future__ import annotations

import torch

from trackmaker_tpu_torch.sync.correlate import _conv_valid


def awgn(x: torch.Tensor, snr_db, generator: torch.Generator) -> torch.Tensor:
    """x plus white Gaussian noise at `snr_db` dB below the signal power of
    each row: sigma = sqrt(mean(x²) / 10^(snr_db/10)), all in float32, the
    draw from `generator` (on x's device; the JAX package takes a key
    there).  `snr_db` is a number or a tensor that broadcasts against
    x[..., :1]."""
    xf = x.to(torch.float32)
    power = (xf * xf).mean(-1, keepdim=True)
    snr = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32, device=x.device) / 10.0)
    sigma = torch.sqrt(power / snr.clamp(min=1e-12))
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return xf + sigma * noise


def gain(x: torch.Tensor, g) -> torch.Tensor:
    return x * torch.as_tensor(g, dtype=x.dtype, device=x.device)


def clock_offset(x: torch.Tensor, ppm) -> torch.Tensor:
    """Resample x[..., T] by (1 + ppm·1e-6) with linear interpolation: a
    sender's sample clock `ppm` parts per million fast.  `ppm` is a number,
    a 0-d tensor, or f32[B, 1] that resamples row b of x f32[T] or f32[B, T]
    at ppm[b].

    All in float32, as the JAX package computes it: pos = arange(T)·ratio,
    i0 = clip(floor(pos), 0, T-1), i1 = clip(i0+1, 0, T-1), frac = pos - i0,
    and x[i0]·(1 - frac) + x[i1]·frac as separate products and a sum (a
    fused multiply-add would round differently).  At T = 433,464 the
    float32 position is off by up to 0.03 samples; the reference's
    decisions include that."""
    t = x.shape[-1]
    dev = x.device
    ratio = 1.0 + torch.as_tensor(ppm, dtype=torch.float32, device=dev) * 1e-6
    pos = torch.arange(t, dtype=torch.float32, device=dev) * ratio
    i0 = torch.floor(pos).to(torch.int32).clamp(0, t - 1)
    i1 = (i0 + 1).clamp(0, t - 1)
    frac = pos - i0.to(torch.float32)
    if pos.ndim == 1:
        a, b = x[..., i0], x[..., i1]
    else:
        xe = x.expand(*pos.shape[:-1], t)
        a, b = xe.gather(-1, i0.to(torch.int64)), xe.gather(-1, i1.to(torch.int64))
    return a * (1.0 - frac) + b * frac


def delay(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """An integer-sample propagation delay: `num_samples` zeros in front,
    the same length T."""
    t = x.shape[-1]
    return torch.nn.functional.pad(x, (num_samples, 0))[..., :t]


def multipath(x: torch.Tensor, taps) -> torch.Tensor:
    """Convolve x[..., T] with a small echo impulse response,
    y[n] = Σ_k taps[k]·x[n-k], truncated to T samples: taps[0] is the direct
    path and taps[d] an echo at delay d.  A causal convolution in full
    float32 (TF32 off)."""
    k = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    xp = torch.nn.functional.pad(x.to(torch.float32), (k.shape[0] - 1, 0))
    return _conv_valid(xp, k.flip(0))


def mix(signals: torch.Tensor) -> torch.Tensor:
    """Superpose concurrent transmissions (a shared medium): the sum over
    the leading axis."""
    return signals.sum(0)
