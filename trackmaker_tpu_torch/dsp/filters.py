"""FIR filtering, box smoothing, windowed-sinc taps and the EMA power
detector (counterpart of ``trackmaker_tpu/dsp/filters.py``).

``fir_filter`` follows XLA's convolution convention: the taps slide over
the samples unflipped (a cross-correlation), in `same`, `valid` or `full`
mode, one cuDNN convolution with TF32 off on the card.  The ASK receiver tracks ``p[i] = (1-α) p[i-1] + α x[i]²``.  As in the JAX
package, the recurrence is blocked: inside each 512-sample block it is
one product with a lower-triangular decay matrix, and only the block-end
values chain from block to block.  Decisions hang on this product
(``sync > 2·power``), so it runs in full float32 whatever the caller set.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmaker_tpu_torch.sync.correlate import _conv_valid

BLOCK = 512   # samples per block of the decay-matrix product


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32: TF32 is off for this product.  A TF32 product
    keeps about three decimal digits, and the ASK modem decides on the
    products it takes here."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ema_power(x: torch.Tensor, alpha: float = 1.0 / 64.0) -> torch.Tensor:
    """p[i] = (1-alpha) p[i-1] + alpha x[i]² with p[-1] = 0, over x[..., T].

    The block-end chain ``c[k] = decay·c[k-1] + e[k]``, decay =
    (1-alpha)^BLOCK (about 3e-4 at the defaults), runs as a doubling scan
    that stops once decay^s underflows to 0 in float32, after five rounds
    at the defaults: the rounds it skips would add exact zeros."""
    t = x.shape[-1]
    nb = -(-t // BLOCK)
    dev = x.device
    xf = x.to(torch.float32)
    y = torch.nn.functional.pad(xf * xf, (0, nb * BLOCK - t))
    y = y.reshape(*x.shape[:-1], nb, BLOCK)
    j = torch.arange(BLOCK, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(BLOCK, dtype=torch.float32, device=dev)[None, :]
    m = torch.where(j <= i, alpha * (1.0 - alpha) ** (i - j), 0.0)
    p_local = matmul_f32(y, m)                          # (..., nb, BLOCK)

    c = p_local[..., -1]                                # (..., nb)
    a = np.float32((1.0 - alpha) ** BLOCK)
    sh = 1
    while sh < nb and a != 0:
        c = torch.cat([c[..., :sh], c[..., sh:] + float(a) * c[..., :-sh]], dim=-1)
        a = np.float32(a * a)
        sh *= 2
    c_prev = torch.nn.functional.pad(c[..., :-1], (1, 0))
    tail = (1.0 - alpha) ** (torch.arange(BLOCK, dtype=torch.float32, device=dev) + 1.0)
    p = p_local + c_prev[..., None] * tail
    return p.reshape(*x.shape[:-1], nb * BLOCK)[..., :t]


def fir_filter(x: torch.Tensor, taps, mode: str = "same") -> torch.Tensor:
    """FIR filter along the last axis of x[..., T], the taps unflipped.
    mode: 'same' | 'valid' | 'full'."""
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    l = taps.shape[0]
    if mode == "same":
        lo = (l - 1) // 2
        xp = torch.nn.functional.pad(x, (lo, l - 1 - lo))
    elif mode == "full":
        xp = torch.nn.functional.pad(x, (l - 1, l - 1))
    elif mode == "valid":
        xp = x
    else:
        raise ValueError(mode)
    return _conv_valid(xp, taps)


def box_smooth_truncated(x: torch.Tensor, half: int = 5) -> torch.Tensor:
    """Edge-truncated centered moving average: out[j] = mean of
    x[max(0,j-half) : min(n, j+half+1)]."""
    n = x.shape[-1]
    w = 2 * half + 1
    sums = fir_filter(x, torch.ones(w, dtype=x.dtype, device=x.device), mode="same")
    idx = torch.arange(n, device=x.device)
    counts = (idx + half + 1).clamp(max=n) - (idx - half).clamp(min=0)
    return sums / counts.to(x.dtype)


def sinc_lowpass_taps(num_taps: int, cutoff_hz: float, sample_rate: int,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """Hamming-windowed sinc low-pass f32[num_taps], in float32 as the JAX
    package computes it, on `device`."""
    m = num_taps - 1
    k = torch.arange(num_taps, dtype=torch.float32, device=device)
    n = k - m / 2.0
    fc = 2.0 * cutoff_hz / sample_rate
    h = torch.where(n == 0, fc, fc * torch.sinc(fc * n))
    w = 0.54 - 0.46 * torch.cos(2.0 * np.pi * k / m)
    taps = h * w
    return taps / taps.sum()


def bandpass_taps(num_taps: int, lo_hz: float, hi_hz: float, sample_rate: int,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """Windowed-sinc band-pass: the difference of two low-passes."""
    lp_hi = sinc_lowpass_taps(num_taps, hi_hz, sample_rate, device)
    lp_lo = sinc_lowpass_taps(num_taps, lo_hz, sample_rate, device)
    return lp_hi - lp_lo
