"""BPSK/QPSK single-carrier modem with pilot-aided coherent demodulation
(counterpart of ``trackmaker_tpu/phy/psk.py``).

Chirp-preamble sync (``ofdm.find_preambles``, the normalized correlation
kernel on the card), a known alternating pilot word for the carrier's
phase and amplitude, then coherent integrate-and-dump of each symbol
against the carrier quadratures, which are made on the host in float64
and rounded to f32, as the JAX package makes them.  Every receiver works
on f32[T] or f32[B, T] captures with int[F] or int[B, F] starts on their
device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy.ask import true_div
from trackmaker_tpu_torch.phy.fsk import body_window, frames_from_rows, sync_config
from trackmaker_tpu_torch.phy.ofdm import (
    _as_batch,
    _join,
    _preamble_and_guard,
    const,
    find_preambles,
)


@dataclasses.dataclass(frozen=True)
class PskConfig:
    sample_rate: int = 48_000
    carrier_hz: float = 8_000.0
    samples_per_symbol: int = 24    # 2 kbaud
    bits_per_symbol: int = 1        # 1=BPSK, 2=QPSK
    pilot_symbols: int = 16         # known alternating pilot word
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    guard_samples: int = 32
    sync_threshold: float = 0.5
    amplitude: float = 1.0

    @property
    def baud(self) -> float:
        return self.sample_rate / self.samples_per_symbol


def _pilot_bits(cfg: PskConfig) -> np.ndarray:
    return (np.arange(cfg.pilot_symbols * cfg.bits_per_symbol) % 2).astype(np.uint8)


def _symbols_from_bits(cfg: PskConfig, bits: torch.Tensor) -> torch.Tensor:
    """bits -> complex constellation points: 0 -> +1, 1 -> -1 on each axis,
    QPSK's over sqrt(2)."""
    if cfg.bits_per_symbol == 1:
        re = 1.0 - 2.0 * bits.to(torch.float32)
        return torch.complex(re, torch.zeros_like(re))
    pairs = bits.reshape(*bits.shape[:-1], -1, 2).to(torch.float32)
    s = float(np.float32(np.sqrt(2.0)))
    return torch.complex(true_div(1.0 - 2.0 * pairs[..., 0], s),
                         true_div(1.0 - 2.0 * pairs[..., 1], s))


def _bits_from_symbols(cfg: PskConfig, sym: torch.Tensor) -> torch.Tensor:
    if cfg.bits_per_symbol == 1:
        return (sym.real < 0).to(torch.uint8)
    b = torch.stack([sym.real < 0, sym.imag < 0], dim=-1).to(torch.uint8)
    return b.reshape(*sym.shape[:-1], -1)


@functools.lru_cache(maxsize=32)
def _quadratures(cfg: PskConfig, n_symbols: int) -> tuple[np.ndarray, np.ndarray]:
    """cos and sin of the carrier over n_symbols symbols, f32 from float64 on
    the host."""
    n = n_symbols * cfg.samples_per_symbol
    t = np.arange(n, dtype=np.float64) / cfg.sample_rate
    c = np.cos(2 * np.pi * cfg.carrier_hz * t).astype(np.float32)
    s = np.sin(2 * np.pi * cfg.carrier_hz * t).astype(np.float32)
    return c, s


def modulate_bits(cfg: PskConfig, bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """uint8[B, n_bits] -> f32[B, frame_samples] on bits' device: preamble ‖
    guard ‖ pilot word ‖ data."""
    b = bits.shape[0]
    dev = bits.device
    pilot = const(_pilot_bits(cfg), dev).expand(b, -1)
    sym = _symbols_from_bits(cfg, torch.cat([pilot, bits.to(torch.uint8)], dim=-1))
    cq, sq = (const(q, dev) for q in _quadratures(cfg, sym.shape[-1]))
    up = sym.repeat_interleave(cfg.samples_per_symbol, dim=-1)
    body = cfg.amplitude * (up.real * cq - up.imag * sq)
    return torch.cat([*_preamble_and_guard(cfg, b, dev), body.to(torch.float32)], dim=-1)


def demodulate_at(cfg: PskConfig, rx: torch.Tensor, n_bits: int, starts) -> torch.Tensor:
    """Coherent hard bits uint8[..., F, n_bits] of the frames whose preambles
    start at `starts` (int[F] in rx f32[T], or int[B, F] in rx f32[B, T]):
    each symbol's I/Q integrate-and-dump, derotated by the conjugate of the
    pilot word's mean channel estimate."""
    x, st, one = _as_batch(rx, starts)
    dev = x.device
    sps = cfg.samples_per_symbol
    n_sym = cfg.pilot_symbols + -(-n_bits // cfg.bits_per_symbol)
    seg = body_window(x.to(torch.float32), st, cfg.preamble_len + cfg.guard_samples,
                      n_sym * sps)
    cq, sq = (const(q, dev) for q in _quadratures(cfg, n_sym))
    i_arm = (seg * cq).reshape(*seg.shape[:-1], n_sym, sps).sum(-1)
    q_arm = (-seg * sq).reshape(*seg.shape[:-1], n_sym, sps).sum(-1)
    z = torch.complex(i_arm, q_arm)
    pilot = _symbols_from_bits(cfg, const(_pilot_bits(cfg), dev))
    h = (z[..., :cfg.pilot_symbols] * pilot.conj()).mean(-1)
    h = torch.where(h.abs() < 1e-12, torch.ones_like(h), h)
    eq = z[..., cfg.pilot_symbols:] * h.conj()[..., None]
    bits = _bits_from_symbols(cfg, eq)[..., :n_bits]
    return bits[0] if one else bits


class PskModem:
    """Frame facade matching ``OfdmModem`` and ``FskModem``, on `device`
    (the card unless the caller asks for another)."""

    def __init__(self, cfg: PskConfig = PskConfig(), device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        if not frames:
            raise ValueError("no frames to encode")
        if len({len(f.to_bytes()) for f in frames}) != 1:
            raise ValueError("group equal-length frames")
        bits = torch.from_numpy(np.stack([f.to_bits() for f in frames])).to(self.device)
        waves = modulate_bits(self.cfg, bits, bits.shape[-1]).cpu().numpy()
        return _join(list(waves), gap_samples)

    def decode(self, rx: np.ndarray, frame_bytes_len: int, max_frames: int = 64) -> list[Frame]:
        x = torch.from_numpy(np.asarray(rx, np.float32)).to(self.device)
        starts = find_preambles(sync_config(self.cfg), x, max_frames)
        starts = starts[starts >= 0]
        if starts.numel() == 0:
            return []
        return frames_from_rows(demodulate_at(self.cfg, x, frame_bytes_len * 8, starts))
