"""EMA power detector (counterpart of ``trackmaker_tpu/dsp/filters.py:ema_power``).

The ASK receiver tracks ``p[i] = (1-α) p[i-1] + α x[i]²``.  As in the JAX
package, the recurrence is blocked: inside each 512-sample block it is
one product with a lower-triangular decay matrix, and only the block-end
values chain from block to block.  Decisions hang on this product
(``sync > 2·power``), so it runs in full float32 whatever the caller set.
"""

from __future__ import annotations

import numpy as np
import torch

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
