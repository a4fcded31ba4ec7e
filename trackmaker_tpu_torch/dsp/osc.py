"""Carrier and chirp synthesis (counterpart of ``trackmaker_tpu/dsp/osc.py``).

Host (NumPy) functions only: the ASK modem bakes its carrier and chirp
preamble into constant tables.  The chirp accumulates its phase
sequentially in float32, as the reference receiver does, so it is
bit-identical to the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np


def carrier_np(num_samples: int, freq_hz: float, sample_rate: int) -> np.ndarray:
    """sin(2π f t) for t = i/fs, in float32."""
    t = np.arange(num_samples, dtype=np.float32) / np.float32(sample_rate)
    return np.sin(np.float32(2.0 * np.pi * freq_hz) * t).astype(np.float32)


def chirp_freq_profile(num_samples: int, f_lo: float, f_hi: float) -> np.ndarray:
    """Symmetric up-down linear sweep: first half f_lo -> f_hi, second half
    f_hi -> f_lo, each endpoint-inclusive with denominator (half-1)."""
    half = num_samples // 2
    i = np.arange(half, dtype=np.float32)
    up = f_lo + (f_hi - f_lo) * i / np.float32(half - 1)
    down = f_hi - (f_hi - f_lo) * i / np.float32(half - 1)
    return np.concatenate([up, down]).astype(np.float32)


def chirp_np(num_samples: int = 440, f_lo: float = 2000.0,
             f_hi: float = 10000.0, sample_rate: int = 48000) -> np.ndarray:
    """Chirp by cumulative trapezoidal phase integration:
    omega_i = omega_{i-1} + π (f_i + f_{i-1}) dt, sample_i = sin(omega_i),
    sample_0 = 0."""
    f = chirp_freq_profile(num_samples, f_lo, f_hi)
    dt = np.float32(1.0 / sample_rate)
    incr = (np.float32(np.pi) * (f[1:] + f[:-1]) * dt).astype(np.float32)
    omega = np.zeros(num_samples, dtype=np.float32)
    # sequential f32 accumulation (order matters for exactness)
    acc = np.float32(0.0)
    for i in range(1, num_samples):
        acc = np.float32(acc + incr[i - 1])
        omega[i] = acc
    out = np.sin(omega, dtype=np.float32)
    out[0] = np.float32(0.0)
    return out


@functools.lru_cache(maxsize=8)
def chirp_cached(num_samples: int = 440, f_lo: float = 2000.0,
                 f_hi: float = 10000.0, sample_rate: int = 48000) -> np.ndarray:
    out = chirp_np(num_samples, f_lo, f_hi, sample_rate)
    out.flags.writeable = False     # one array shared by every caller
    return out
