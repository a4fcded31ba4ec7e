"""Line codes on tensors (counterpart of ``trackmaker_tpu/phy/line_coding.py``).

Manchester: bit 0 -> [+1, -1], bit 1 -> [-1, +1], each level repeated
`samples_per_level` times; the decoder compares the means of the two
half-bits.  All functions take the bit or sample axis last and broadcast
over leading axes.  The 4B5B + NRZI code is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig

# Preamble bit pattern: (pattern_bytes-1) bytes of 0x33 (bits 00110011)
# followed by the sync byte 0x5A (bits 01011010).
SYNC_BYTE_BITS = (0, 1, 0, 1, 1, 0, 1, 0)
PATTERN_BYTE_BITS = (0, 0, 1, 1, 0, 0, 1, 1)


def _require_manchester(cfg: PhyConfig) -> None:
    if cfg.line_coding == FOUR_B_FIVE_B:
        raise NotImplementedError("the 4B5B line code is not ported yet")
    if cfg.line_coding != MANCHESTER:
        raise ValueError(cfg.line_coding)


def preamble_bits(pattern_bytes: int) -> np.ndarray:
    bits = PATTERN_BYTE_BITS * (pattern_bytes - 1) + SYNC_BYTE_BITS
    return np.asarray(bits, dtype=np.uint8)


def manchester_encode(bits: torch.Tensor, samples_per_level: int) -> torch.Tensor:
    """uint8[..., N] -> f32[..., N*2*spl]."""
    first = 1.0 - 2.0 * bits.to(torch.float32)
    levels = torch.stack([first, -first], dim=-1)
    flat = levels.reshape(*levels.shape[:-2], levels.shape[-2] * 2)
    return flat.repeat_interleave(samples_per_level, dim=-1)


def manchester_decode(samples: torch.Tensor, samples_per_level: int) -> torch.Tensor:
    """f32[..., N*2*spl] -> uint8[..., N]; first half > second half => 0."""
    spl = samples_per_level
    n = samples.shape[-1] // (2 * spl)
    x = samples[..., : n * 2 * spl].reshape(*samples.shape[:-1], n, 2, spl)
    halves = x.mean(dim=-1)
    return (halves[..., 0] <= halves[..., 1]).to(torch.uint8)


def encode(cfg: PhyConfig, bits: torch.Tensor) -> torch.Tensor:
    _require_manchester(cfg)
    return manchester_encode(bits, cfg.samples_per_level)


def decode(cfg: PhyConfig, samples: torch.Tensor) -> torch.Tensor:
    """Frame bits of a line-coded window (Manchester bits are always valid)."""
    _require_manchester(cfg)
    return manchester_decode(samples, cfg.samples_per_level)


@functools.lru_cache(maxsize=None)
def preamble_waveform(cfg: PhyConfig) -> np.ndarray:
    """Line-coded preamble samples, a small host constant (f32)."""
    _require_manchester(cfg)
    bits = preamble_bits(cfg.preamble_pattern_bytes).astype(np.int64)
    first = 1.0 - 2.0 * bits
    levels = np.stack([first, -first], axis=-1).reshape(-1)
    return np.repeat(levels, cfg.samples_per_level).astype(np.float32)
