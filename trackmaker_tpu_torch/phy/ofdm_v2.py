"""OFDM receiver v2 (counterpart of ``trackmaker_tpu/phy/ofdm_v2.py``):
Schmidl-Cox fine timing, a smoothed channel estimate and per-symbol
pilot-tone phase tracking over the v1 waveform's chirp sync.

* Repeated-halves pilot symbol: pilot energy on even bins only, so its
  time body is two equal halves.  The Schmidl-Cox metric
  M(d) = P(d)^2 / R(d)^2, P(d) = sum_k r[d+k] r[d+k+N/2] and
  R(d) = sum_k r[d+k+N/2]^2, over +-``sc_search`` lags around the chirp's
  estimate, refines the symbol timing to its first maximum.
* Smoothed channel estimate: a 9-bin complex moving average over the
  pilot's per-bin estimates (odd bins interpolated from their neighbours).
* Pilot tones: every ``pilot_spacing``-th data bin carries a known BPSK
  pilot in every symbol.  Each frame's common phase error and phase slope
  across the band are fitted as lines in the symbol index over the frame's
  real symbols (`vsyms`) and removed before the QPSK decision.

Frame format: chirp ‖ guard ‖ SC pilot symbol ‖ data symbols (pilot tones
embedded).  Every receiver works on f32[T] or f32[B, T] captures with
int[F] or int[B, F] starts, on their device; the coarse sync is
:func:`trackmaker_tpu_torch.phy.ofdm.find_preambles`.

The P(d) and R(d) sums are windows of elementwise products summed along
their last axis (no matmul, so TF32 never enters), and the smoother is a
9-tap correlation with ones/9 through ``correlate._conv_valid`` (TF32
off), the sums the JAX package's ``jnp.convolve`` forms under its vmap.
Within the search, M(d) is often flat to a few parts in a million, below
the effect of another summation order, so on a clean capture the refined
start may be another lag of that plateau than the JAX package's; the
decisions after it are the same.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy.ofdm import (
    OfdmConfig,
    OfdmStreamPhy,
    _as_batch,
    _bits_to_qpsk,
    _gather_windows,
    _join,
    _padded_bits,
    _preamble_and_guard,
    _qpsk_to_bits,
    _spectrum_to_time,
    _windows_spectrum,
    cdiv,
    const,
    find_preambles,
)
from trackmaker_tpu_torch.phy.ask import true_div
from trackmaker_tpu_torch.sync.correlate import _conv_valid


@dataclasses.dataclass(frozen=True)
class OfdmV2Config(OfdmConfig):
    pilot_spacing: int = 8      # every Nth data bin is a pilot tone
    sc_search: int = 32         # +- timing search around the chirp peak
    smooth_bins: int = 9        # channel-estimate moving-average window
    track_cpe: bool = True      # per-symbol common-phase-error correction
    track_slope: bool = True    # per-symbol phase-slope (timing drift)
    use_sc: bool = True         # Schmidl-Cox fine timing

    @property
    def pilot_bin_idx(self) -> np.ndarray:
        return np.arange(0, self.n_bins, self.pilot_spacing)

    @property
    def data_bin_idx(self) -> np.ndarray:
        mask = np.ones(self.n_bins, bool)
        mask[self.pilot_bin_idx] = False
        return np.nonzero(mask)[0]

    @property
    def bits_per_symbol(self) -> int:  # type: ignore[override]
        return len(self.data_bin_idx) * self.bits_per_sym


@functools.lru_cache(maxsize=16)
def _sc_pilot(cfg: OfdmV2Config) -> np.ndarray:
    """BPSK pilot on even bins only -> repeated-halves time body."""
    rng = np.random.default_rng(cfg.pilot_seed)
    p = (2.0 * rng.integers(0, 2, cfg.n_bins) - 1.0).astype(np.complex64)
    even = ((np.arange(cfg.n_bins) + cfg.bin_lo) % 2 == 0)
    # doubled amplitude keeps the pilot symbol's power comparable
    return np.where(even, p * np.sqrt(2.0), 0.0).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _tone_pilots(cfg: OfdmV2Config) -> np.ndarray:
    rng = np.random.default_rng(cfg.pilot_seed + 1)
    n = len(cfg.pilot_bin_idx)
    return (2.0 * rng.integers(0, 2, n) - 1.0).astype(np.complex64)


def modulate_bits_v2(cfg: OfdmV2Config, bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """uint8[B, n_bits] -> f32[B, frame_samples] on bits' device."""
    b = bits.shape[0]
    dev = bits.device
    n_sym = cfg.n_symbols(n_bits)
    qpsk = _bits_to_qpsk(_padded_bits(cfg, bits, n_bits)).reshape(
        b, n_sym, len(cfg.data_bin_idx))
    subs = torch.zeros((b, n_sym, cfg.n_bins), dtype=torch.complex64, device=dev)
    subs[..., const(cfg.data_bin_idx, dev)] = qpsk
    subs[..., const(cfg.pilot_bin_idx, dev)] = const(_tone_pilots(cfg), dev)
    pilot = const(_sc_pilot(cfg), dev).expand(b, 1, cfg.n_bins)
    t_syms = _spectrum_to_time(cfg, torch.cat([pilot, subs], dim=1))
    return torch.cat([*_preamble_and_guard(cfg, b, dev), t_syms.reshape(b, -1)], dim=-1)


def _smooth_complex(h: torch.Tensor, win: int) -> torch.Tensor:
    """Complex moving average along the last axis (edge-clamped): each
    output the sum of `win` taps of f32(1/win) times the clamped input."""
    n = h.shape[-1]
    pad = win // 2
    hp = torch.cat([h[..., :1].expand(*h.shape[:-1], pad), h,
                    h[..., -1:].expand(*h.shape[:-1], pad)], dim=-1)
    k = const(np.full(win, np.float32(1.0) / np.float32(win), np.float32), h.device)
    return torch.complex(_conv_valid(hp.real.contiguous(), k),
                         _conv_valid(hp.imag.contiguous(), k))[..., :n]


def sc_metric(cfg: OfdmV2Config, rx: torch.Tensor, starts: torch.Tensor):
    """(M f32[B, F, 2·sc_search], base int64[B, F]): the Schmidl-Cox metric
    M(d) at positions base + d around each frame's pilot body, for rx
    f32[B, T] and chirp starts int[B, F]."""
    half = cfg.n_fft // 2
    n_lag = 2 * cfg.sc_search
    body_off = cfg.preamble_len + cfg.guard_samples
    base = (starts.to(torch.int64) + body_off + cfg.cp_len - cfg.sc_search).clamp(min=0)
    width = n_lag + cfg.n_fft - 1
    seg = _gather_windows(rx, base, width, body_off + cfg.cp_len + width + 8)
    a = seg[..., :n_lag + half - 1]
    b = seg[..., half:half + n_lag + half - 1]
    p = (a * b).unfold(-1, half, 1).sum(-1)
    r2 = (b * b).unfold(-1, half, 1).sum(-1)
    return (p * p) / (r2 * r2).clamp(min=1e-12), base


def _sc_refine(cfg: OfdmV2Config, rx: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Schmidl-Cox fine timing: chirp-start estimates int[B, F] -> refined
    starts int64[B, F], the first maximum of M over the search."""
    m, base = sc_metric(cfg, rx, starts)
    return base + m.argmax(-1) - cfg.cp_len - cfg.preamble_len - cfg.guard_samples


def _f32_mean(v: np.ndarray) -> np.float32:
    """The mean of integers as the JAX package takes it: the f32 sum over the
    f32 count."""
    return np.float32(np.float32(v.sum()) / np.float32(len(v)))


def _angle(z: torch.Tensor) -> torch.Tensor:
    return torch.atan2(z.imag, z.real)


def _expj(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def smoothed_channel(cfg: OfdmV2Config, pilot_spec: torch.Tensor) -> torch.Tensor:
    """The smoothed channel estimate complex64[..., n_bins] from the SC
    pilot symbol's spectrum: the even bins' estimates, each odd bin the mean
    of its neighbours, the moving average, and bins of |h| < 1e-9 set to 1."""
    dev = pilot_spec.device
    sc_tx = const(_sc_pilot(cfg), dev)
    h_raw = cdiv(pilot_spec * sc_tx.conj(), (sc_tx.abs() ** 2).clamp(min=1e-12))
    idx = torch.arange(cfg.n_bins, device=dev)
    even = (idx + cfg.bin_lo) % 2 == 0
    left = (idx - 1).clamp(0, cfg.n_bins - 1)
    right = (idx + 1).clamp(0, cfg.n_bins - 1)
    h_f = torch.where(even, h_raw, 0.5 * (h_raw[..., left] + h_raw[..., right]))
    h = _smooth_complex(h_f, cfg.smooth_bins)
    return torch.where(h.abs() < 1e-9, torch.ones_like(h), h)


def equalize_one_tap(data_spec: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Data symbols complex[..., n_sym, n_bins] times conj(h) over |h|², a
    tap a bin, for h complex[..., n_bins]."""
    return cdiv(data_spec * h.conj()[..., None, :], (h.abs() ** 2).clamp(min=1e-12)[..., None, :])


def symbols_v2(cfg: OfdmV2Config, rx: torch.Tensor, n_sym: int, starts,
               vsyms=None) -> torch.Tensor:
    """The equalized, de-rotated data symbols complex64[..., F, n_sym,
    n_data] of v2 frames whose chirps start at `starts` (int[F] in rx f32[T],
    or int[B, F] in rx f32[B, T]): what :func:`demodulate_at_v2` decides.
    `vsyms` (int, or int[..., F]) counts each frame's real data symbols:
    the phase fits weight only those."""
    x, st, one = _as_batch(rx, starts)
    fine = _sc_refine(cfg, x, st) if cfg.use_sc else st
    out = equalize_track(cfg, _windows_spectrum(cfg, x, fine, n_sym), vsyms)
    return out[0] if one else out


def equalize_track(cfg: OfdmV2Config, spec: torch.Tensor, vsyms=None) -> torch.Tensor:
    """The data symbols complex64[..., n_sym, n_data] of the frames whose
    pilot and data symbol spectra are spec complex64[..., 1 + n_sym,
    n_bins]: equalized by the smoothed pilot estimate, then de-rotated by
    the fitted common phase and phase slope (`vsyms` as in
    :func:`symbols_v2`)."""
    dev = spec.device
    n_sym = spec.shape[-2] - 1
    pbins = const(cfg.pilot_bin_idx, dev)
    dbins = const(cfg.data_bin_idx, dev)
    h = smoothed_channel(cfg, spec[..., 0, :])
    eq = equalize_one_tap(spec[..., 1:, :], h)                # [..., n_sym, n_bins]

    # pilot tones, MRC-weighted by |H|^2: a line in the symbol index for the
    # common phase and for the phase slope across the band
    wmrc = h[..., pbins].abs() ** 2
    pt = eq[..., pbins] * const(_tone_pilots(cfg), dev).conj() * wmrc[..., None, :]
    cpe = pt.sum(-1)                                          # [..., n_sym]
    srange = torch.arange(n_sym, dtype=torch.float32, device=dev)
    if vsyms is None or isinstance(vsyms, int):       # a host number: no copy
        w = srange < float(n_sym if vsyms is None else vsyms)
    else:
        vs = torch.as_tensor(vsyms, device=dev)
        w = srange < vs.reshape(*vs.shape, 1).to(torch.float32)
    w = w.to(torch.float32).expand(*cpe.shape)
    nw = w.sum(-1).clamp(min=1.0)
    if cfg.track_cpe and n_sym > 1:
        # the increment a symbol from consecutive ratios (pairs inside the
        # valid prefix only), then the offset
        binc = _angle((w[..., 1:] * cpe[..., 1:] * cpe[..., :-1].conj()).sum(-1))
        a0 = _angle((w * cpe * _expj(-(binc[..., None] * srange))).sum(-1))
        theta = a0[..., None] + binc[..., None] * srange
    elif cfg.track_cpe:
        theta = _angle(cpe)
    else:
        theta = torch.zeros(cpe.shape, dtype=torch.float32, device=dev)
    npil = pt.shape[-1]
    lo = pt[..., : npil // 2].sum(-1)
    hi = pt[..., npil - npil // 2:].sum(-1)
    dphi = _angle(hi * lo.conj())                             # over about half the band
    span = _f32_mean(cfg.pilot_bin_idx[npil - npil // 2:]) - _f32_mean(
        cfg.pilot_bin_idx[: npil // 2])
    slope_raw = true_div(dphi, float(max(span, np.float32(1.0))))
    if cfg.track_slope and n_sym > 1:
        # weighted least-squares line over the valid symbols
        sm = (w * srange).sum(-1) / nw
        dev_s = srange - sm[..., None]
        den = (w * dev_s ** 2).sum(-1)
        d1 = (w * dev_s * slope_raw).sum(-1) / den.clamp(min=1.0)
        c0 = (w * slope_raw).sum(-1) / nw - d1 * sm
        slope = c0[..., None] + d1[..., None] * srange
    elif cfg.track_slope:
        slope = slope_raw
    else:
        slope = torch.zeros(cpe.shape, dtype=torch.float32, device=dev)
    binr = torch.arange(cfg.n_bins, dtype=torch.float32, device=dev)
    centred = binr - float(np.float32((cfg.n_bins - 1) / 2))
    rot = _expj(-(theta[..., None] + slope[..., None] * centred))
    return (eq * rot)[..., dbins]


def demodulate_at_v2(cfg: OfdmV2Config, rx: torch.Tensor, n_bits: int, starts,
                     vsyms=None) -> torch.Tensor:
    """Hard bits uint8[..., F, n_bits] of v2 frames whose chirps start at
    `starts`, as :func:`symbols_v2` takes them."""
    sym = symbols_v2(cfg, rx, cfg.n_symbols(n_bits), starts, vsyms)
    return _qpsk_to_bits(sym.reshape(*sym.shape[:-2], -1))[..., :n_bits]


class OfdmStreamPhyV2(OfdmStreamPhy):
    """Variable-length v2 OFDM PHY with the line-coded PHY's duck type
    (``encode_frames`` / ``process_samples`` / ``reset``), as
    :class:`trackmaker_tpu_torch.phy.ofdm.OfdmStreamPhy` is for v1, with
    the same host buffer, one copy of its bucket to `device` a call (the card
    unless the caller asks for another) and the same consumed / keep rules.

    Each detection takes two fixed-shape passes: a header pass (one data
    symbol covers the 56-bit header) gives the length, then the full pass
    demodulates at the largest frame's size with `vsyms` restricting the
    phase fits to the frame's real symbols."""

    def __init__(self, cfg: OfdmV2Config = OfdmV2Config(), max_frame_bytes: int = 263,
                 local_addr: int | None = None, device: torch.device | str = "cuda"):
        if cfg.bits_per_symbol < 56:
            raise ValueError("the first data symbol must cover the frame header")
        super().__init__(cfg, max_frame_bytes, local_addr, device)

    def encode_frame(self, frame: Frame) -> np.ndarray:
        bits = torch.from_numpy(frame.to_bits()).to(self.device)
        return modulate_bits_v2(self.cfg, bits[None], bits.shape[-1])[0].cpu().numpy()

    def frame_samples(self, n_payload: int) -> int:
        return self.cfg.frame_samples((7 + n_payload) * 8)

    def _header(self, pj: torch.Tensor, start: torch.Tensor):
        bits = demodulate_at_v2(self.cfg, pj, 56, start).cpu().numpy()
        hdr = np.packbits(bits[:56])
        return bits, (int(hdr[0]) << 8) | int(hdr[1])

    def _frame_bits(self, pj: torch.Tensor, start: torch.Tensor, total_bits: int,
                    header_bits: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        return demodulate_at_v2(cfg, pj, self.max_syms * cfg.bits_per_symbol, start,
                                cfg.n_symbols(total_bits))[0].cpu().numpy()


class OfdmModemV2:
    """Frame-level facade over the v2 waveform (equal-length frames), on
    `device` (the card unless the caller asks for another)."""

    def __init__(self, cfg: OfdmV2Config = OfdmV2Config(),
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        if not frames:
            raise ValueError("no frames to encode")
        nb = {len(f.to_bytes()) * 8 for f in frames}
        if len(nb) != 1:
            raise ValueError("group equal-length frames")
        bits = torch.from_numpy(np.stack([f.to_bits() for f in frames])).to(self.device)
        waves = modulate_bits_v2(self.cfg, bits, nb.pop()).cpu().numpy()
        return _join(list(waves), gap_samples)

    def decode(self, rx: np.ndarray, frame_bytes_len: int,
               max_frames: int = 64) -> list[Frame]:
        x = torch.from_numpy(np.asarray(rx, np.float32)).to(self.device)
        starts = find_preambles(self.cfg, x, max_frames)
        starts = starts[starts >= 0]
        if starts.numel() == 0:
            return []
        bits = demodulate_at_v2(self.cfg, x, frame_bytes_len * 8, starts)
        out = []
        for row in bits.cpu().numpy():
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
