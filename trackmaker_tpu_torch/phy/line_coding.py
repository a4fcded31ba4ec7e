"""Line codes on tensors (counterpart of ``trackmaker_tpu/phy/line_coding.py``).

* Manchester: bit 0 -> [+1, -1], bit 1 -> [-1, +1], each level repeated
  `samples_per_level` times; the decoder compares the means of the two
  half-bits.
* 4B5B + NRZI: each nibble maps through the 4B5B table to a 5-bit symbol,
  and NRZI turns every coded 1 into a level flip, starting from +1.  The
  decoder reads a transition where a level's mean has the other sign than
  the last level whose mean was not near zero (the receiver skips
  near-zero levels), and stops at the first symbol outside the table: a
  bit from there on is not valid.

All functions take the bit or sample axis last and broadcast over leading
axes.  ``decode`` returns ``(bits, bit_valid)`` for both codes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig

# 4B5B code table: nibble -> 5-bit symbol.
FOURB_FIVEB_ENCODE = np.array(
    [0b11110, 0b01001, 0b10100, 0b10101, 0b01010, 0b01011, 0b01110, 0b01111,
     0b10010, 0b10011, 0b10110, 0b10111, 0b11010, 0b11011, 0b11100, 0b11101],
    dtype=np.int32,
)

# Inverse table: 5-bit symbol -> nibble, -1 for invalid symbols.
FOURB_FIVEB_DECODE = np.full(32, -1, dtype=np.int32)
FOURB_FIVEB_DECODE[FOURB_FIVEB_ENCODE] = np.arange(16, dtype=np.int32)

NEAR_ZERO = 1e-6   # a level mean at most this far from 0 carries no sign
MIN_HEADER_BITS = 49   # a header parses from 7 whole or partial bytes

# Preamble bit pattern: (pattern_bytes-1) bytes of 0x33 (bits 00110011)
# followed by the sync byte 0x5A (bits 01011010).
SYNC_BYTE_BITS = (0, 1, 0, 1, 1, 0, 1, 0)
PATTERN_BYTE_BITS = (0, 0, 1, 1, 0, 0, 1, 1)


def preamble_bits(pattern_bytes: int) -> np.ndarray:
    bits = PATTERN_BYTE_BITS * (pattern_bytes - 1) + SYNC_BYTE_BITS
    return np.asarray(bits, dtype=np.uint8)


# --- Manchester -------------------------------------------------------------


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


# --- 4B5B + NRZI ------------------------------------------------------------


def fourb5b_code_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., N] frame bits -> uint8[..., ceil(N/4)*5] coded bits."""
    n = bits.shape[-1]
    n_nib = -(-n // 4)
    if n_nib * 4 > n:
        bits = torch.nn.functional.pad(bits, (0, n_nib * 4 - n))
    dev = bits.device
    nib_bits = bits.reshape(*bits.shape[:-1], n_nib, 4).to(torch.int64)
    nibbles = (nib_bits * torch.tensor([8, 4, 2, 1], device=dev)).sum(-1)
    symbols = torch.from_numpy(FOURB_FIVEB_ENCODE).to(dev)[nibbles]
    coded = (symbols[..., None] >> torch.arange(4, -1, -1, device=dev)) & 1
    return coded.reshape(*coded.shape[:-2], n_nib * 5).to(torch.uint8)


def nrzi_encode_levels(coded_bits: torch.Tensor) -> torch.Tensor:
    """Coded bits -> NRZI levels +-1 (f32), starting level +1."""
    flips = torch.cumsum(coded_bits.to(torch.int32), dim=-1)
    return torch.where(flips % 2 == 0, 1.0, -1.0).to(torch.float32)


def fourb5b_encode(bits: torch.Tensor, samples_per_level: int) -> torch.Tensor:
    """uint8[..., N] -> f32[..., ceil(N/4)*5*spl]."""
    levels = nrzi_encode_levels(fourb5b_code_bits(bits))
    return levels.repeat_interleave(samples_per_level, dim=-1)


def _last_valid_scan(avg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For each position i: the last avg[j] with j < i and valid[j], else
    +1.0 (the NRZI initial level).  The index of that level is a running
    maximum of the valid positions, so one cummax and one gather."""
    ones = torch.ones((*avg.shape[:-1], 1), dtype=avg.dtype, device=avg.device)
    vals = torch.cat([ones, avg[..., :-1]], dim=-1)
    ok = torch.cat([torch.ones_like(valid[..., :1]), valid[..., :-1]], dim=-1)
    idx = torch.arange(vals.shape[-1], device=avg.device).expand(vals.shape)
    last = torch.where(ok, idx, -1).cummax(dim=-1).values
    return vals.gather(-1, last)


def _level_means(samples: torch.Tensor, samples_per_level: int) -> torch.Tensor:
    """The mean of each level of the whole symbols in f32[..., M]:
    f32[..., n_sym*5], n_sym = (M // spl) // 5."""
    spl = samples_per_level
    n_lvl = samples.shape[-1] // spl // 5 * 5
    x = samples[..., : n_lvl * spl].reshape(*samples.shape[:-1], n_lvl, spl)
    return x.mean(dim=-1)


def _transitions_to_bits(coded: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits, bit_valid) of coded bits int64[..., n_sym*5] (1 = a
    transition), valid up to the first symbol outside the 4B5B table."""
    dev = coded.device
    n_sym = coded.shape[-1] // 5
    sym_bits = coded.reshape(*coded.shape[:-1], n_sym, 5)
    symbols = (sym_bits * torch.tensor([16, 8, 4, 2, 1], device=dev)).sum(-1)
    nibbles = torch.from_numpy(FOURB_FIVEB_DECODE).to(dev)[symbols]
    prefix_ok = torch.cumprod((nibbles >= 0).to(torch.int32), dim=-1).bool()
    nib = nibbles.clamp(min=0)
    bits = (nib[..., None] >> torch.arange(3, -1, -1, device=dev)) & 1
    bits = bits.reshape(*bits.shape[:-2], n_sym * 4).to(torch.uint8)
    return bits, prefix_ok.repeat_interleave(4, dim=-1)


def fourb5b_decode(samples: torch.Tensor,
                   samples_per_level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32[..., M] -> (bits uint8[..., n_sym*4], bit_valid bool[..., same]).

    n_sym = (M // spl) // 5 whole symbols.  `bit_valid` is True up to (and
    excluding) the first invalid 4B5B symbol.
    """
    avg = _level_means(samples, samples_per_level)
    prev = _last_valid_scan(avg, avg.abs() > NEAR_ZERO)
    return _transitions_to_bits((prev * avg < 0.0).to(torch.int64))   # transition -> 1


def fourb5b_decode_opt(samples: torch.Tensor, samples_per_level: int,
                       eps: float = NEAR_ZERO) -> tuple[torch.Tensor, ...]:
    """The optimistic 4B5B decode: each transition read against the level
    just before, as if no level mean were near zero, so no running scan.
    Returns ``(bits, bit_valid, near0)``, near0 bool[..., n_sym*5] marking
    the levels whose mean is at most `eps` from zero: where one lies inside
    a frame, the receiver (which skips it) may read other bits, and the
    caller must decode with :func:`fourb5b_decode`."""
    avg = _level_means(samples, samples_per_level)
    ones = torch.ones((*avg.shape[:-1], 1), dtype=avg.dtype, device=avg.device)
    prev = torch.cat([ones, avg[..., :-1]], dim=-1)
    bits, bit_ok = _transitions_to_bits((prev * avg < 0.0).to(torch.int64))
    return bits, bit_ok, avg.abs() <= eps


# --- dispatch and preamble ----------------------------------------------------


def encode(cfg: PhyConfig, bits: torch.Tensor) -> torch.Tensor:
    if cfg.line_coding == MANCHESTER:
        return manchester_encode(bits, cfg.samples_per_level)
    if cfg.line_coding == FOUR_B_FIVE_B:
        return fourb5b_encode(bits, cfg.samples_per_level)
    raise ValueError(cfg.line_coding)


def decode(cfg: PhyConfig, samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (bits, bit_valid) of a line-coded window.  Manchester bits are
    always valid."""
    if cfg.line_coding == MANCHESTER:
        bits = manchester_decode(samples, cfg.samples_per_level)
        return bits, torch.ones(bits.shape, dtype=torch.bool, device=bits.device)
    if cfg.line_coding == FOUR_B_FIVE_B:
        return fourb5b_decode(samples, cfg.samples_per_level)
    raise ValueError(cfg.line_coding)


@functools.lru_cache(maxsize=None)
def preamble_waveform(cfg: PhyConfig) -> np.ndarray:
    """Line-coded preamble samples, a small host constant (f32)."""
    bits = preamble_bits(cfg.preamble_pattern_bytes).astype(np.int64)
    spl = cfg.samples_per_level
    if cfg.line_coding == MANCHESTER:
        first = 1.0 - 2.0 * bits
        levels = np.stack([first, -first], axis=-1).reshape(-1)
        return np.repeat(levels, spl).astype(np.float32)
    if cfg.line_coding == FOUR_B_FIVE_B:
        nibbles = bits.reshape(-1, 4) @ np.asarray([8, 4, 2, 1])
        symbols = FOURB_FIVEB_ENCODE[nibbles]
        coded = ((symbols[:, None] >> np.arange(4, -1, -1)) & 1).reshape(-1)
        levels = np.where(np.cumsum(coded) % 2 == 0, 1.0, -1.0)
        return np.repeat(levels, spl).astype(np.float32)
    raise ValueError(cfg.line_coding)
