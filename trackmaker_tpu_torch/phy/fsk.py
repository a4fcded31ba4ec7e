"""Binary FSK modem (counterpart of ``trackmaker_tpu/phy/fsk.py``,
``BASELINE.json`` config 1's ASK/FSK family): phase-continuous synthesis
and noncoherent demodulation.

Synthesis integrates each sample's frequency: the phase is 2π·cumsum(f)/sr,
the cumulative sum taken in float64 and rounded to f32 (exact for integer
frequencies), so the card and the CPU give one waveform.  The JAX package
sums in f32 in another order, and the phase reaches about 10^5 rad on a
263-byte frame, where an f32 ulp is 0.008 rad: the waveforms agree within
a tolerance that grows with the frame (``tests/test_torch_fsk_psk.py``),
and each package decodes the other's.  Demodulation compares the I/Q
energy of each bit's window at the two tones: one product of the windows
with a (samples_per_bit, 4) quadrature basis in full float32
(``dsp.filters.matmul_f32``).  The preamble is the chirp, found by
``ofdm.find_preambles`` (the normalized correlation kernel on the card).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.phy.ask import true_div
from trackmaker_tpu_torch.phy.ofdm import (
    OfdmConfig,
    _as_batch,
    _gather_windows,
    _join,
    _preamble_and_guard,
    const,
    find_preambles,
)


@dataclasses.dataclass(frozen=True)
class FskConfig:
    sample_rate: int = 48_000
    f0_hz: float = 4_000.0      # bit 0 tone
    f1_hz: float = 8_000.0      # bit 1 tone
    samples_per_bit: int = 48   # 1 kbps
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    guard_samples: int = 32
    sync_threshold: float = 0.5
    amplitude: float = 1.0


def sync_config(cfg) -> OfdmConfig:
    """The OFDM sync's configuration for a single-carrier config's chirp."""
    return OfdmConfig(preamble_len=cfg.preamble_len, chirp_lo_hz=cfg.chirp_lo_hz,
                      chirp_hi_hz=cfg.chirp_hi_hz, sync_threshold=cfg.sync_threshold)


def body_window(rx: torch.Tensor, starts: torch.Tensor, off: int, total: int) -> torch.Tensor:
    """rx[b, s + off + i] for i < total at starts s int[B, F], f32[B, F,
    total], with rx zero-padded by total + off + 8 samples, each window's
    start taken as ``jax.lax.dynamic_slice`` takes it: a negative one counts
    from the padded capture's end, then it is moved to fit."""
    n = rx.shape[-1] + total + off + 8
    begin = starts.to(torch.int64) + off
    begin = torch.where(begin < 0, begin + n, begin).clamp(min=0, max=n - total)
    return _gather_windows(rx, begin, total, n - rx.shape[-1])


def modulate_bits(cfg: FskConfig, bits: torch.Tensor) -> torch.Tensor:
    """uint8[B, N] -> f32[B, preamble + guard + N·samples_per_bit] on bits'
    device, phase-continuous."""
    b = bits.shape[0]
    dev = bits.device
    freq = torch.where(bits > 0, cfg.f1_hz, cfg.f0_hz).to(torch.float64)
    freq = freq.repeat_interleave(cfg.samples_per_bit, dim=-1)
    cum = torch.cumsum(freq, dim=-1).to(torch.float32)
    phase = true_div(float(np.float32(2.0 * np.pi)) * cum, float(cfg.sample_rate))
    body = cfg.amplitude * torch.sin(phase)
    return torch.cat([*_preamble_and_guard(cfg, b, dev), body], dim=-1)


@functools.lru_cache(maxsize=16)
def _basis(cfg: FskConfig) -> np.ndarray:
    """The (samples_per_bit, 4) quadratures sin f0, cos f0, sin f1, cos f1 in
    f32, made on the host."""
    t = np.arange(cfg.samples_per_bit, dtype=np.float32) / np.float32(cfg.sample_rate)
    w0, w1 = np.float32(2 * np.pi * cfg.f0_hz), np.float32(2 * np.pi * cfg.f1_hz)
    return np.stack([np.sin(w0 * t), np.cos(w0 * t), np.sin(w1 * t), np.cos(w1 * t)],
                    axis=1).astype(np.float32)


def demodulate_at(cfg: FskConfig, rx: torch.Tensor, n_bits: int, starts) -> torch.Tensor:
    """Noncoherent hard bits uint8[..., F, n_bits] of the frames whose
    preambles start at `starts` (int[F] in rx f32[T], or int[B, F] in rx
    f32[B, T]): a bit is 1 where its window's energy at f1 exceeds f0's."""
    x, st, one = _as_batch(rx, starts)
    spb = cfg.samples_per_bit
    seg = body_window(x.to(torch.float32), st, cfg.preamble_len + cfg.guard_samples,
                      n_bits * spb)
    wins = seg.reshape(*seg.shape[:-1], n_bits, spb)
    iq = matmul_f32(wins, const(_basis(cfg).reshape(-1), x.device).reshape(spb, 4))
    e0 = iq[..., 0] ** 2 + iq[..., 1] ** 2
    e1 = iq[..., 2] ** 2 + iq[..., 3] ** 2
    bits = (e1 > e0).to(torch.uint8)
    return bits[0] if one else bits


def frames_from_rows(bits: torch.Tensor) -> list[Frame]:
    """The CRC-valid frames of the rows of bits uint8[F, n]."""
    out = []
    for row in bits.cpu().numpy():
        f = Frame.from_bits(row)
        if f is not None:
            out.append(f)
    return out


class FskModem:
    """Frame facade mirroring ``OfdmModem``'s, on `device` (the card unless
    the caller asks for another)."""

    def __init__(self, cfg: FskConfig = FskConfig(), device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        if not frames:
            raise ValueError("no frames to encode")
        if len({len(f.to_bytes()) for f in frames}) != 1:
            raise ValueError("group equal-length frames")
        bits = torch.from_numpy(np.stack([f.to_bits() for f in frames])).to(self.device)
        return _join(list(modulate_bits(self.cfg, bits).cpu().numpy()), gap_samples)

    def decode(self, rx: np.ndarray, frame_bytes_len: int, max_frames: int = 64) -> list[Frame]:
        x = torch.from_numpy(np.asarray(rx, np.float32)).to(self.device)
        starts = find_preambles(sync_config(self.cfg), x, max_frames)
        starts = starts[starts >= 0]
        if starts.numel() == 0:
            return []
        return frames_from_rows(demodulate_at(self.cfg, x, frame_bytes_len * 8, starts))
