"""Acoustic OFDM modem v1 (counterpart of ``trackmaker_tpu/phy/ofdm.py``,
``BASELINE.json`` config 2).

DMT-style real OFDM: QPSK (Gray) data on the FFT bins of an acoustic
passband (2-10 kHz at 48 kHz with a 512-point FFT), a cyclic prefix
against echo, the ASK modem's chirp as the preamble and one BPSK pilot
symbol for a one-tap channel estimate a bin.  The frame codec is the PHY's
(CRC8 and ``[Len|CRC|Type|Seq|Src|Dst]``), so the MAC and the network
layer run unchanged over it.

The FFTs are ``torch.fft.rfft`` / ``irfft`` (the JAX package computes them
outside any Pallas kernel).  The coarse sync, :func:`find_preambles`, is
the normalized correlation with the 440-sample chirp: on a CUDA tensor
``csrc/xcorr_norm.cu``'s kernel, on a CPU tensor its plain version, then
``sync.walk_starts``: ``max_frames`` steps over the hits as tensor ops.  Every receiver
works on f32[T] or a batch f32[B, T] of captures, on the device they lie on.

Windows: each symbol's FFT window is fetched at the 32-aligned position at
or before its nominal one (inside its cyclic prefix, as the JAX package's
fetch does) and the back-off's phase ramp removed, so callers see the
nominal window's spectrum; configurations with ``cp_len < 32`` or
``sym_len % 32 != 0`` take the nominal windows.  Under echo that back-off
is part of the decision (a window delta early tolerates echo up to
cp_len - delta), so it is kept exactly.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core import convcode, fec
from trackmaker_tpu_torch.core.config import PHY_HEADER_BYTES
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.dsp.osc import chirp_cached
from trackmaker_tpu_torch.sync import auto_xcorr, find_pattern_starts


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    sample_rate: int = 48_000
    n_fft: int = 512
    cp_len: int = 128
    bin_lo: int = 22            # ~2.06 kHz
    bin_hi: int = 107           # ~10.03 kHz (exclusive)
    bits_per_sym: int = 2       # QPSK
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    pilot_seed: int = 7
    amplitude: float = 0.5      # time-domain scaling headroom
    sync_threshold: float = 0.5  # normalized chirp correlation
    guard_samples: int = 64     # silence between preamble and first symbol

    @property
    def n_bins(self) -> int:
        return self.bin_hi - self.bin_lo

    @property
    def bits_per_symbol(self) -> int:
        return self.n_bins * self.bits_per_sym

    @property
    def sym_len(self) -> int:
        return self.n_fft + self.cp_len

    def n_symbols(self, n_bits: int) -> int:
        return -(-n_bits // self.bits_per_symbol)

    def frame_samples(self, n_bits: int) -> int:
        """preamble + guard + pilot + data symbols."""
        return (self.preamble_len + self.guard_samples
                + (1 + self.n_symbols(n_bits)) * self.sym_len)


def _pilot_symbols(cfg: OfdmConfig) -> np.ndarray:
    """Deterministic BPSK pilot per data bin (channel estimation)."""
    rng = np.random.default_rng(cfg.pilot_seed)
    return (2.0 * rng.integers(0, 2, cfg.n_bins) - 1.0).astype(np.complex64)


_QPSK = (np.asarray(  # Gray-coded: b1b0 -> constellation point / sqrt(2)
    [1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], dtype=np.complex64) / np.sqrt(2)).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _on(device: torch.device, table: bytes, dtype: str) -> torch.Tensor:
    """A host constant's copy on `device`, made once a process."""
    return torch.from_numpy(np.frombuffer(table, dtype=dtype).copy()).to(device)


def const(arr: np.ndarray, device) -> torch.Tensor:
    """The host constant `arr` (1-D) as a tensor on `device`: copied to the
    device once a process, then shared by every call."""
    arr = np.ascontiguousarray(arr)
    return _on(torch.device(device), arr.tobytes(), arr.dtype.str)


def cdiv(z: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """complex z / real d, each part divided by d."""
    return torch.complex(z.real / d, z.imag / d)


def _bits_to_qpsk(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., 2k] -> complex64[..., k] Gray-mapped QPSK."""
    pairs = bits.reshape(*bits.shape[:-1], -1, 2).to(torch.int64)
    idx = pairs[..., 0] * 2 + pairs[..., 1]
    return const(_QPSK, bits.device)[idx]


def _qpsk_to_bits(sym: torch.Tensor) -> torch.Tensor:
    """Hard decision, inverse of _bits_to_qpsk: the imaginary part's sign is
    the first bit of a pair, the real part's the second."""
    b0 = (sym.imag < 0).to(torch.uint8)
    b1 = (sym.real < 0).to(torch.uint8)
    return torch.stack([b0, b1], dim=-1).reshape(*sym.shape[:-1], -1)


def _spectrum_to_time(cfg: OfdmConfig, subcarriers: torch.Tensor) -> torch.Tensor:
    """complex[..., n_bins] -> real time symbols f32[..., sym_len] with CP."""
    shape = (*subcarriers.shape[:-1], cfg.n_fft // 2 + 1)
    spec = torch.zeros(shape, dtype=torch.complex64, device=subcarriers.device)
    spec[..., cfg.bin_lo:cfg.bin_hi] = subcarriers
    # the scale as the JAX package rounds it: the Python product, then f32
    scale = np.float32(cfg.amplitude * cfg.n_fft / max(cfg.n_bins, 1))
    time = torch.fft.irfft(spec, n=cfg.n_fft, dim=-1) * float(scale)
    return torch.cat([time[..., -cfg.cp_len:], time], dim=-1).to(torch.float32)


def _time_to_spectrum(cfg: OfdmConfig, symbols: torch.Tensor) -> torch.Tensor:
    """real[..., sym_len] -> complex[..., n_bins] (CP stripped)."""
    spec = torch.fft.rfft(symbols[..., cfg.cp_len:], n=cfg.n_fft, dim=-1)
    return spec[..., cfg.bin_lo:cfg.bin_hi]


def chirp(cfg: OfdmConfig) -> np.ndarray:
    """The preamble f32[preamble_len]: the ASK modem's chirp."""
    return chirp_cached(cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz, cfg.sample_rate)


def _preamble_and_guard(cfg: OfdmConfig, b: int, device) -> list[torch.Tensor]:
    pre = const(chirp(cfg), device)
    return [pre.expand(b, cfg.preamble_len),
            torch.zeros((b, cfg.guard_samples), dtype=torch.float32, device=device)]


def _padded_bits(cfg: OfdmConfig, bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    pad = cfg.n_symbols(n_bits) * cfg.bits_per_symbol - n_bits
    return torch.nn.functional.pad(bits, (0, pad)) if pad else bits


def modulate_bits(cfg: OfdmConfig, bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """uint8[B, n_bits] -> f32[B, frame_samples] on bits' device: chirp ‖
    guard ‖ pilot ‖ QPSK data symbols."""
    b = bits.shape[0]
    n_sym = cfg.n_symbols(n_bits)
    qpsk = _bits_to_qpsk(_padded_bits(cfg, bits, n_bits)).reshape(b, n_sym, cfg.n_bins)
    pilot = const(_pilot_symbols(cfg), bits.device).expand(b, 1, cfg.n_bins)
    t_syms = _spectrum_to_time(cfg, torch.cat([pilot, qpsk], dim=1))
    return torch.cat([*_preamble_and_guard(cfg, b, bits.device), t_syms.reshape(b, -1)], dim=-1)


def _gather_windows(rx: torch.Tensor, begin: torch.Tensor, width: int,
                    pad: int) -> torch.Tensor:
    """rx[b, begin[b, ...] + i] for i < width, f32[B, ..., width], with rx
    zero-padded by `pad` samples; a position past the padding, or before
    the capture, reads a padding zero."""
    b, t = rx.shape
    xp = torch.nn.functional.pad(rx.to(torch.float32), (0, pad + 1))
    last = t + pad                                      # a padding zero
    idx = begin.to(torch.int64)[..., None] + torch.arange(width, device=rx.device)
    idx = torch.where((idx < 0) | (idx > last), last, idx)
    out = xp.gather(1, idx.reshape(b, -1))
    return out.reshape(idx.shape)


def _windows_spectrum(cfg: OfdmConfig, rx: torch.Tensor, starts: torch.Tensor,
                      n_sym: int) -> torch.Tensor:
    """FFT spectra of the pilot and data symbol bodies of the frames whose
    preambles start at `starts`: f32[B, T], int[B, F] ->
    complex64[B, F, 1+n_sym, n_bins] (see the module docstring: each window
    backed off to a 32-aligned position and de-ramped, or the nominal
    windows where the configuration has no such alignment)."""
    body_off = cfg.preamble_len + cfg.guard_samples
    nst = 1 + n_sym
    dev = rx.device
    t = rx.shape[-1]
    o = starts.to(torch.int64) + body_off                              # [B, F]
    if not (cfg.cp_len >= 32 and cfg.sym_len % 32 == 0):
        # the nominal windows, as one slice a frame; the slice is moved back
        # to fit the padded capture, as a dynamic slice is
        total = nst * cfg.sym_len
        pad = body_off + total + cfg.n_fft + 8
        begin = o.clamp(min=0).clamp(max=t + pad - total)
        seg = _gather_windows(rx, begin, total, pad)
        body = seg.reshape(*seg.shape[:-1], nst, cfg.sym_len)[..., cfg.cp_len:]
        spec = torch.fft.rfft(body, n=cfg.n_fft, dim=-1)
        return spec[..., cfg.bin_lo:cfg.bin_hi]
    wpos = (o[..., None] + torch.arange(nst, device=dev) * cfg.sym_len
            + cfg.cp_len)                                              # [B, F, nst]
    aligned = torch.div(wpos, 32, rounding_mode="floor") * 32         # back-off into CP
    body = _gather_windows(rx, aligned, cfg.n_fft, body_off + nst * cfg.sym_len + 1024)
    spec = torch.fft.rfft(body, n=cfg.n_fft, dim=-1)[..., cfg.bin_lo:cfg.bin_hi]
    # the back-off scales bin k by exp(-2i pi k delta / n_fft): multiply by
    # the conjugate ramp, in f32 as the JAX package forms it
    delta = (wpos - aligned).to(torch.float32)                        # in [0, 32)
    k_abs = torch.arange(cfg.bin_lo, cfg.bin_hi, dtype=torch.float32, device=dev)
    phase = (float(np.float32(2.0 * np.pi / cfg.n_fft)) * delta[..., None]) * k_abs
    return spec * torch.polar(torch.ones_like(phase), phase)


def _as_batch(rx: torch.Tensor, starts) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(rx f32[B, T], starts int[B, F], whether the caller's rx was 1-D)."""
    starts = torch.as_tensor(starts, device=rx.device)
    if rx.ndim == 1:
        return rx[None], starts.reshape(1, -1), True
    return rx, starts.reshape(rx.shape[0], -1), False


def _pilot_channel(cfg: OfdmConfig, spec: torch.Tensor):
    """(h, |h|) of the one-tap estimate from the pilot symbol spec[..., 0, :],
    with bins of |h| < 1e-12 set to 1."""
    h = spec[..., 0, :] * const(_pilot_symbols(cfg), spec.device).conj()
    h = torch.where(h.abs() < 1e-12, torch.ones_like(h), h)
    return h, h.abs()


def _equalize_v1(cfg: OfdmConfig, spec: torch.Tensor):
    """(data symbols over h, one tap a bin, [..., n_sym, n_bins]; |h|)."""
    h, mag = _pilot_channel(cfg, spec)
    eq = cdiv(spec[..., 1:, :] * h.conj()[..., None, :], mag.clamp(min=1e-12)[..., None, :])
    return eq, mag


def demodulate_at(cfg: OfdmConfig, rx: torch.Tensor, n_bits: int, starts) -> torch.Tensor:
    """Hard bits uint8[..., F, n_bits] of the frames whose preambles start
    at `starts` (int[F] in rx f32[T], or int[B, F] in rx f32[B, T]), each bin
    equalized by its pilot estimate."""
    x, st, one = _as_batch(rx, starts)
    eq, _ = _equalize_v1(cfg, _windows_spectrum(cfg, x, st, cfg.n_symbols(n_bits)))
    bits = _qpsk_to_bits(eq.reshape(*eq.shape[:-2], -1))[..., :n_bits]
    return bits[0] if one else bits


def demodulate_soft_at(cfg: OfdmConfig, rx: torch.Tensor, n_bits: int,
                       starts) -> torch.Tensor:
    """Soft bit metrics f32[..., F, n_bits] in [-1, 1] (positive = bit 1)
    of the frames at `starts`, as :func:`demodulate_at` takes them."""
    x, st, one = _as_batch(rx, starts)
    eq, mag = _equalize_v1(cfg, _windows_spectrum(cfg, x, st, cfg.n_symbols(n_bits)))
    scale = mag.mean(-1).clamp(min=1e-12)
    eqf = cdiv(eq.reshape(*eq.shape[:-2], -1), scale[..., None])
    # bit pair per symbol: b0 from -imag, b1 from -real (see _QPSK)
    soft = torch.stack([-eqf.imag, -eqf.real], dim=-1).reshape(*eqf.shape[:-1], -1)
    out = (soft * float(np.float32(np.sqrt(2.0)))).clamp(-1.0, 1.0)[..., :n_bits]
    return out[0] if one else out


def preamble_corr(cfg: OfdmConfig, x: torch.Tensor) -> torch.Tensor:
    """The chirp's normalized correlation f32[B, T-L+1] of captures x
    f32[B, T], divided by the chirp's norm summed in f32 as the JAX package
    divides where its OFDM sync passes none: on a CUDA tensor
    ``csrc/xcorr_norm.cu``'s kernel, on a CPU tensor its plain version."""
    return auto_xcorr(x, chirp(cfg))


def find_preambles(cfg: OfdmConfig, rx: torch.Tensor, max_frames: int = 64) -> torch.Tensor:
    """Coarse chirp sync: int32[..., max_frames] preamble starts (-1 padded)
    of f32[T] or f32[B, T] captures.

    ``sync.find_pattern_starts`` with the chirp at ``sync_threshold``: each
    step takes the first lag at or after the cursor whose normalized
    correlation (:func:`preamble_corr`) reaches the threshold, refines it to
    the first maximum over the next ``preamble_len`` lags (zero past the
    last lag) and moves the cursor one preamble past that peak.  The steps
    run as tensor ops on rx's device, with no read to the host."""
    return find_pattern_starts(rx, chirp(cfg), cfg.sync_threshold, max_frames)


def _demod_symbols_at(cfg: OfdmConfig, max_syms: int, rx: torch.Tensor,
                      start: torch.Tensor) -> torch.Tensor:
    """Hard bits uint8[max_syms * bits_per_symbol] of the pilot and up to
    max_syms data symbols after the preamble at `start` (a 0-d or 1-element
    tensor) in rx f32[T], at the nominal windows (no back-off)."""
    total = (1 + max_syms) * cfg.sym_len
    body_off = cfg.preamble_len + cfg.guard_samples
    pad = total + body_off + 8
    begin = (start.reshape(1, 1).to(torch.int64).clamp(min=0) + body_off).clamp(
        max=rx.shape[-1] + pad - total)
    seg = _gather_windows(rx[None], begin, total, pad)[0, 0]
    spec = _time_to_spectrum(cfg, seg.reshape(1 + max_syms, cfg.sym_len))
    eq, _ = _equalize_v1(cfg, spec)
    return _qpsk_to_bits(eq.reshape(-1))


def _bucket(n: int) -> int:
    """The power-of-two length, at least 4,096, a stream buffer is padded to."""
    bucket = 4096
    while bucket < n:
        bucket *= 2
    return bucket


def _join(parts: list[np.ndarray], gap_samples: int) -> np.ndarray:
    out = []
    for i, w in enumerate(parts):
        out.append(w)
        if i < len(parts) - 1:
            out.append(np.zeros(gap_samples, np.float32))
    return np.concatenate(out) if out else np.zeros(0, np.float32)


class OfdmStreamPhy:
    """Variable-length OFDM PHY with the line-coded PHY's duck type
    (``encode_frames`` / ``process_samples`` / ``reset``), so the MAC and
    everything above it run unchanged over OFDM.

    The buffer lives on the host.  Each ``process_samples`` call that holds
    more than a preamble copies the buffer, zero-padded to a power-of-two
    bucket, to `device` once (the card unless the caller asks for another),
    finds the preambles there and reads their starts back.  For each start
    it demodulates the pilot and every symbol of the largest frame, parses
    the length from the leading bits and keeps exactly (7 + len) * 8 bits.
    ``decode_calls`` counts the buckets decoded.
    """

    def __init__(self, cfg: OfdmConfig = OfdmConfig(),
                 max_frame_bytes: int = 263, local_addr: int | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.max_syms = cfg.n_symbols(max_frame_bytes * 8)
        self.device = torch.device(device)
        self._buf = np.zeros(0, np.float32)
        self.preamble_len = cfg.preamble_len
        self.decode_calls = 0

    # -- encoder side ------------------------------------------------------

    def encode_frame(self, frame: Frame) -> np.ndarray:
        bits = torch.from_numpy(frame.to_bits()).to(self.device)
        return modulate_bits(self.cfg, bits[None], bits.shape[-1])[0].cpu().numpy()

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        return _join([self.encode_frame(f) for f in frames], gap_samples)

    # -- streaming decoder side ---------------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def frame_samples(self, n_payload: int) -> int:
        return self.cfg.frame_samples((PHY_HEADER_BYTES + n_payload) * 8)

    def _starts(self, pj: torch.Tensor) -> torch.Tensor:
        """The preamble starts int32[16] (-1 padded) of a padded bucket on
        the device."""
        self.decode_calls += 1
        return find_preambles(self.cfg, pj, 16)

    def _header(self, pj: torch.Tensor, start: torch.Tensor):
        """(the bits demodulated at `start`, the payload length their header
        gives): v1 demodulates every symbol of the largest frame at once."""
        bits = _demod_symbols_at(self.cfg, self.max_syms, pj, start).cpu().numpy()
        hdr = np.packbits(bits[:56])
        return bits, (int(hdr[0]) << 8) | int(hdr[1])

    def _frame_bits(self, pj: torch.Tensor, start: torch.Tensor, total_bits: int,
                    header_bits: np.ndarray) -> np.ndarray:
        """The frame's bits once its length is known (v1: the header pass's)."""
        return header_bits

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        cfg = self.cfg
        if len(self._buf) < cfg.preamble_len + 1:
            return []
        out: list[Frame] = []
        consumed = 0
        padded = np.zeros(_bucket(len(self._buf)), np.float32)
        padded[: len(self._buf)] = self._buf
        pj = torch.from_numpy(padded).to(self.device)
        starts_dev = self._starts(pj)
        starts = starts_dev.cpu().numpy()
        for i in np.flatnonzero(starts >= 0):
            s = int(starts[i])
            if s < consumed:
                continue
            if s + cfg.frame_samples(1) > len(self._buf):   # header needs 1st symbol
                break  # frame still arriving
            start = starts_dev[i:i + 1]
            bits, data_len = self._header(pj, start)
            if data_len > self.max_frame_bytes - 7:
                consumed = s + cfg.preamble_len
                continue
            total_bits = (7 + data_len) * 8
            frame_end = s + cfg.frame_samples(total_bits)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            bits = self._frame_bits(pj, start, total_bits, bits)
            f = Frame.from_bits(bits[:total_bits])
            consumed = frame_end
            if f is None:
                continue
            if self.local_addr is not None and f.dst != self.local_addr:
                continue
            out.append(f)
        if consumed:
            keep = max(consumed - (cfg.preamble_len - 1), 0)
            self._buf = self._buf[keep:]
        elif len(self._buf) > 10 * cfg.sample_rate:
            self._buf = self._buf[-cfg.preamble_len:]
        return out


class OfdmModem:
    """Frame-level facade: equal-length PHY frames <-> OFDM waveform, on
    `device` (the card unless the caller asks for another).

    With ``fec=True`` or ``"hamming"`` the frame bits pass through
    Hamming(7,4) and a block interleaver that spreads each codeword across
    subcarriers.  With ``fec="conv"`` they pass through the rate-1/2 K=7
    convolutional code (``core/convcode.py``), and ``decode`` runs the soft
    demodulation and one Viterbi call (``csrc/viterbi.cu`` on the card) for
    all the frames it found.
    """

    def __init__(self, cfg: OfdmConfig = OfdmConfig(), fec: bool | str = False,
                 interleave_depth: int = 16, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.fec = "hamming" if fec is True else (fec or None)
        if self.fec not in (None, "hamming", "conv"):
            raise ValueError(f"unknown fec {fec!r}")
        self.depth = interleave_depth
        self.device = torch.device(device)

    def frame_bits(self, frame: Frame) -> np.ndarray:
        return frame.to_bits()

    def _tx_len(self, n_bits: int) -> int:
        if self.fec is None:
            return n_bits
        if self.fec == "conv":
            return 2 * (n_bits + convcode.K - 1)
        c = fec.coded_len(n_bits)
        return -(-c // self.depth) * self.depth  # interleaver pad

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        if not frames:
            raise ValueError("no frames to encode")
        n_bits = {len(f.to_bytes()) * 8 for f in frames}
        if len(n_bits) != 1:
            raise ValueError("group equal-length frames")
        bits = torch.from_numpy(np.stack([self.frame_bits(f) for f in frames])).to(self.device)
        if self.fec == "hamming":
            bits = fec.interleave(fec.hamming74_encode(bits), self.depth)
        elif self.fec == "conv":
            bits = convcode.conv_encode(bits)
        waves = modulate_bits(self.cfg, bits, self._tx_len(n_bits.pop())).cpu().numpy()
        return _join(list(waves), gap_samples)

    def decode(self, rx: np.ndarray, frame_bytes_len: int,
               max_frames: int = 64) -> list[Frame]:
        """Decode equal-length frames (frame_bytes_len = 7 + payload)."""
        n_bits = frame_bytes_len * 8
        x = torch.from_numpy(np.asarray(rx, np.float32)).to(self.device)
        starts = find_preambles(self.cfg, x, max_frames)
        starts = starts[starts >= 0]
        if starts.numel() == 0:
            return []
        if self.fec == "conv":
            soft = demodulate_soft_at(self.cfg, x, self._tx_len(n_bits), starts)
            bits = convcode.viterbi_decode(soft, n_bits, soft=True)
        else:
            bits = demodulate_at(self.cfg, x, self._tx_len(n_bits), starts)
            if self.fec == "hamming":
                coded = fec.deinterleave(bits, self.depth, fec.coded_len(n_bits))
                bits = fec.hamming74_decode(coded)[..., :n_bits]
        out = []
        for row in bits.cpu().numpy():
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
