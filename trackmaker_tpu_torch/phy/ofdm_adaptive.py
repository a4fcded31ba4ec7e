"""Adaptive per-bin bit-loading on the OFDM v2 waveform (counterpart of
``trackmaker_tpu/phy/ofdm_adaptive.py``).

The acoustic channel is strongly frequency-selective, so a uniform
constellation wastes the good bins and drowns the bad ones.  DMT
bit-loading (ADSL's scheme) probes the channel once, estimates each bin's
SNR and gives each data bin the largest constellation it supports: 64- or
16-QAM on strong bins, QPSK or BPSK on middling ones, nothing on dead ones,
with per-bin amplitude gains (water-filling) on top.

* ``probe_waveform`` / ``estimate_bin_snr``: a probe frame (chirp ‖ SC
  pilot ‖ ``probe_symbols`` known uniform-QPSK symbols, NumPy bits from
  ``probe_seed``), equalized as data and measured bin by bin.
* ``choose_loading`` / ``choose_gains``: SNR-gap thresholds to bits a bin
  in {0, 1, 2, 4, 6}, and margin-balancing gains on the handshake's
  0.25 dB grid (host code, the JAX package's line for line).
* ``OfdmAdaptiveStreamPhy``: the MAC's stream PHY, every frame a flushed
  rate-1/2 K=7 header block and payload block, soft-decision Viterbi
  decoded; ``OfdmAdaptiveModem``: the uncoded frame facade.

A loading is a tuple on a frozen config: the classes' bins are a cached
split of the data bins (``_class_idx``), each class one gather.  Every
receiver works on f32[T] or f32[B, T] captures with int[F] or int[B, F]
starts on their device.  The coarse sync is ``ofdm.find_preambles``
(``csrc/xcorr_norm.cu``'s kernel on the card); the receiver's windows are
the nominal ones (the chirp's timing, no Schmidl-Cox refine), each start
clamped as ``jax.lax.dynamic_slice`` clamps it; the channel estimate is
v2's smoothed one; each symbol's common phase is removed with the pilot
tones weighted by |H|².

The soft values weigh each bin by (|H|·g)² and feed the Viterbi kernel
(``csrc/viterbi.cu``): ``batched_decode_fn`` demaps every frame of every
capture at once, deinterleaves by an index gather with the inverse
permutation and launches the decoder once for all headers and once for all
payloads.  The FFTs are ``torch.fft``'s, so soft values equal the JAX
package's within rounding, not bit for bit (``tests/test_torch_ofdm_adaptive.py``
states the tolerance).  Divisions by host constants divide on the device
(``ask.true_div``), as the JAX package divides.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.convcode import block_interleaver, conv_encode, viterbi_decode
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy.ask import true_div
from trackmaker_tpu_torch.phy.ofdm import (
    _as_batch,
    _bits_to_qpsk,
    _bucket,
    _gather_windows,
    _join,
    _preamble_and_guard,
    _qpsk_to_bits,
    _spectrum_to_time,
    _time_to_spectrum,
    cdiv,
    const,
    find_preambles,
)
from trackmaker_tpu_torch.phy.ofdm_v2 import (
    OfdmV2Config,
    _angle,
    _expj,
    _sc_pilot,
    _tone_pilots,
    equalize_one_tap,
    smoothed_channel,
)

LOADING_BITS = (0, 1, 2, 4, 6)


@dataclasses.dataclass(frozen=True)
class OfdmAdaptiveConfig(OfdmV2Config):
    # bits per data bin (aligned with data_bin_idx), in {0, 1, 2, 4, 6};
    # () is uniform QPSK
    loading: tuple = ()
    # per-data-bin amplitude gains (choose_gains), quantize_gain outputs so
    # both ends agree exactly; () is unit power everywhere
    gains: tuple = ()
    probe_symbols: int = 8
    probe_seed: int = 99

    def resolved_loading(self) -> np.ndarray:
        n = len(self.data_bin_idx)
        if not self.loading:
            return np.full(n, 2, np.int32)
        if len(self.loading) != n:
            raise ValueError(f"loading has {len(self.loading)} bins, the config {n}")
        lv = np.asarray(self.loading, np.int32)
        if not set(np.unique(lv)).issubset(LOADING_BITS):
            raise ValueError(f"loading bits must lie in {LOADING_BITS}")
        return lv

    def resolved_gains(self) -> np.ndarray:
        n = len(self.data_bin_idx)
        if not self.gains:
            return np.ones(n, np.float32)
        if len(self.gains) != n:
            raise ValueError(f"gains has {len(self.gains)} bins, the config {n}")
        return np.asarray(self.gains, np.float32)

    @property
    def bits_per_symbol(self) -> int:  # type: ignore[override]
        return int(self.resolved_loading().sum())


# Gray-coded 16-QAM: 2 bits -> amplitude level (00,01,11,10 -> -3,-1,1,3)
_QAM16_LEVELS = np.asarray([-3.0, -1.0, 1.0, 3.0], np.float32)
_GRAY2 = np.asarray([0, 1, 3, 2], np.int32)        # bits -> level index (self-inverse)
_QAM16_SCALE = 1.0 / np.sqrt(10.0)
# Gray-coded 64-QAM: 3 bits per axis.  Level index l (amplitude
# (2l-7)/sqrt(42)) carries Gray code l^(l>>1); _GRAY3 is the inverse (bit
# triple -> level index), so adjacent amplitudes differ in one bit.
_QAM64_LEVELS = np.asarray([-7., -5., -3., -1., 1., 3., 5., 7.], np.float32)
_GRAY3 = np.asarray([0, 1, 3, 2, 7, 6, 4, 5], np.int32)
_GRAY3_ENC = np.asarray([lv ^ (lv >> 1) for lv in range(8)], np.int32)
_QAM64_SCALE = 1.0 / np.sqrt(42.0)
# the scales and the 16-QAM inner/outer threshold as f32, as the JAX package
# rounds its float64 constants
_S16 = float(np.float32(_QAM16_SCALE))
_S64 = float(np.float32(_QAM64_SCALE))
_THR16 = float(np.float32(2.0 * _QAM16_SCALE))
_MID64 = float(np.float32(4 * _QAM64_SCALE))
_IN64 = float(np.float32(2 * _QAM64_SCALE))


@functools.lru_cache(maxsize=16)
def _class_idx(cfg: OfdmAdaptiveConfig):
    """((BPSK, QPSK, 16-QAM, 64-QAM bins), (their gains)), each a tuple in
    ascending bin order.  A symbol's bits are [every BPSK bin's bit ‖ every
    QPSK bin's pair ‖ every 16-QAM bin's quad ‖ every 64-QAM bin's six], a
    fixed permutation both ends derive from the shared loading.  The bins
    are bin-relative (0..n_bins), as v2's."""
    lv = cfg.resolved_loading()
    g = cfg.resolved_gains()
    dbins = cfg.data_bin_idx
    return (tuple(tuple(dbins[lv == k].tolist()) for k in (1, 2, 4, 6)),
            tuple(tuple(g[lv == k].tolist()) for k in (1, 2, 4, 6)))


def _classes(cfg: OfdmAdaptiveConfig, dev):
    """[(bits a bin, bins int64[n] on dev, gains f32[n] on dev)] of the
    non-empty classes, in the bit layout's order."""
    bins, gains = _class_idx(cfg)
    return [(k, const(np.asarray(b, np.int64), dev), const(np.asarray(g, np.float32), dev))
            for k, b, g in zip((1, 2, 4, 6), bins, gains) if b]


def cscale(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """complex z times real g, each part multiplied by g."""
    return torch.complex(z.real * g, z.imag * g)


def _bits_to_qam16(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., 4k] -> complex64[..., k]."""
    quads = bits.reshape(*bits.shape[:-1], -1, 4).to(torch.int64)
    gray, lv = const(_GRAY2.astype(np.int64), bits.device), const(_QAM16_LEVELS, bits.device)
    gi = gray[quads[..., 0] * 2 + quads[..., 1]]
    gq = gray[quads[..., 2] * 2 + quads[..., 3]]
    return torch.complex(lv[gi] * _S16, lv[gq] * _S16)


def _pam_levels(v: torch.Tensor, scale: float, half: float, top: int) -> torch.Tensor:
    """The nearest level index of amplitudes v: round((v / scale + half) /
    2), clipped to [0, top], the division on v's device."""
    return torch.round((true_div(v, scale) + half) / 2.0).clamp(0, top).to(torch.int64)


def _qam16_to_bits(sym: torch.Tensor) -> torch.Tensor:
    """Hard decision, inverse of _bits_to_qam16."""
    gray = const(_GRAY2.astype(np.int64), sym.device)

    def axis_bits(v):
        g = gray[_pam_levels(v, _S16, 3.0, 3)]
        return torch.stack([g // 2, g % 2], dim=-1)

    out = torch.cat([axis_bits(sym.real), axis_bits(sym.imag)], dim=-1)
    return out.reshape(*sym.shape[:-1], -1).to(torch.uint8)


def _bits_to_qam64(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., 6k] -> complex64[..., k] (I bits first, MSB first)."""
    six = bits.reshape(*bits.shape[:-1], -1, 6).to(torch.int64)
    vi = six[..., 0] * 4 + six[..., 1] * 2 + six[..., 2]
    vq = six[..., 3] * 4 + six[..., 4] * 2 + six[..., 5]
    gray, lv = const(_GRAY3.astype(np.int64), bits.device), const(_QAM64_LEVELS, bits.device)
    return torch.complex(lv[gray[vi]] * _S64, lv[gray[vq]] * _S64)


def _qam64_to_bits(sym: torch.Tensor) -> torch.Tensor:
    """Hard decision, inverse of _bits_to_qam64."""
    enc = const(_GRAY3_ENC.astype(np.int64), sym.device)

    def axis_bits(v):
        g = enc[_pam_levels(v, _S64, 7.0, 7)]
        return torch.stack([g >> 2 & 1, g >> 1 & 1, g & 1], dim=-1)

    out = torch.cat([axis_bits(sym.real), axis_bits(sym.imag)], dim=-1)
    return out.reshape(*sym.shape[:-1], -1).to(torch.uint8)


def modulate_bits_adaptive(cfg: OfdmAdaptiveConfig, bits: torch.Tensor,
                           n_bits: int) -> torch.Tensor:
    """uint8[B, n_bits] -> f32[B, frame_samples] on bits' device, with the
    per-bin loading and gains and v2's tone pilots and SC pilot."""
    dev = bits.device
    bps = cfg.bits_per_symbol
    b = bits.shape[0]
    n_sym = cfg.n_symbols(n_bits)
    pad = n_sym * bps - n_bits
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    sym_bits = bits.reshape(b, n_sym, bps)
    subs = torch.zeros((b, n_sym, cfg.n_bins), dtype=torch.complex64, device=dev)
    maps = {2: _bits_to_qpsk, 4: _bits_to_qam16, 6: _bits_to_qam64}
    off = 0
    for k, bins, g in _classes(cfg, dev):
        chunk = sym_bits[..., off:off + k * bins.numel()]
        if k == 1:
            s = torch.complex(2.0 * chunk.to(torch.float32) - 1.0,
                              torch.zeros(chunk.shape, dtype=torch.float32, device=dev))
        else:
            s = maps[k](chunk)
        subs[..., bins] = cscale(s, g)
        off += k * bins.numel()
    subs[..., const(cfg.pilot_bin_idx, dev)] = const(_tone_pilots(cfg), dev)
    pilot = const(_sc_pilot(cfg), dev).expand(b, 1, cfg.n_bins)
    t_syms = _spectrum_to_time(cfg, torch.cat([pilot, subs], dim=1))
    return torch.cat([*_preamble_and_guard(cfg, b, dev), t_syms.reshape(b, -1)], dim=-1)


def _equalized_symbols(cfg: OfdmAdaptiveConfig, rx: torch.Tensor, starts: torch.Tensor,
                       n_sym: int):
    """(eq complex64[B, F, n_sym, n_bins], h complex64[B, F, n_bins]) of the
    frames whose chirps start at starts int[B, F] in rx f32[B, T]: the
    nominal windows after the chirp's timing (a start below 0 read as 0, the
    window moved back to fit the capture padded as the JAX package pads it),
    v2's smoothed estimate, the one-tap EQ, and each symbol's common phase
    from the tone pilots weighted by |H|²."""
    dev = rx.device
    total = (1 + n_sym) * cfg.sym_len
    body_off = cfg.preamble_len + cfg.guard_samples
    pad = total + body_off + cfg.n_fft + 8
    begin = (starts.to(torch.int64).clamp(min=0) + body_off).clamp(max=rx.shape[-1] + pad - total)
    seg = _gather_windows(rx, begin, total, pad)
    spec = _time_to_spectrum(cfg, seg.reshape(*seg.shape[:-1], 1 + n_sym, cfg.sym_len))
    h = smoothed_channel(cfg, spec[..., 0, :])
    eq = equalize_one_tap(spec[..., 1:, :], h)
    pbins = const(cfg.pilot_bin_idx, dev)
    wmrc = h[..., pbins].abs() ** 2
    pt = eq[..., pbins] * const(_tone_pilots(cfg), dev).conj()
    cpe = (pt * wmrc[..., None, :]).sum(-1)
    cpe = torch.where(cpe.abs() < 1e-12, torch.ones_like(cpe), cpe)
    return eq * _expj(-_angle(cpe))[..., None], h


def _per_symbol(parts: list[torch.Tensor], n_bits: int) -> torch.Tensor:
    """Each class's [..., n_sym, n_c, k] values -> [..., n_bits]: per symbol
    the classes in order, then the symbols in order."""
    per_sym = torch.cat([p.reshape(*p.shape[:-2], -1) for p in parts], dim=-1)
    return per_sym.reshape(*per_sym.shape[:-2], -1)[..., :n_bits]


def soft_demodulate_at_adaptive(cfg: OfdmAdaptiveConfig, rx: torch.Tensor, n_bits: int,
                                starts) -> torch.Tensor:
    """Max-log soft values f32[..., F, n_bits] (positive = bit 1) of the
    frames whose chirps start at `starts` (int[F] in rx f32[T], or int[B, F]
    in rx f32[B, T]), in :func:`demodulate_at_adaptive`'s bit layout.

    BPSK: re(s).  QPSK (b0 = im < 0, b1 = re < 0): (-im, -re).  Gray 16-QAM
    per axis: the sign bit's value is the amplitude, the inner/outer bit's
    2/sqrt(10) - |v|.  Gray 64-QAM per axis (s = 1/sqrt(42)): v, 4s - |v|,
    2s - ||v| - 4s|.  Every bin's values are weighted by (|H|·g)², the
    inverse of its post-EQ noise variance up to a common scale: the one-tap
    EQ divides by H and the gain normalization by g."""
    x, st, one = _as_batch(rx, starts)
    eqc, h = _equalized_symbols(cfg, x, st, cfg.n_symbols(n_bits))
    w = h.abs() ** 2
    w = w / w.amax(-1, keepdim=True).clamp(min=1e-12)          # a common scale only
    parts = []
    for k, bins, g in _classes(cfg, x.device):
        s = cdiv(eqc[..., bins], g)                            # [..., n_sym, n_c]
        wc = (w[..., bins] * (g * g))[..., None, :, None]
        re, im = s.real, s.imag
        if k == 1:
            vals = [re]
        elif k == 2:
            vals = [-im, -re]
        elif k == 4:
            vals = [re, _THR16 - re.abs(), im, _THR16 - im.abs()]
        else:
            vals = [re, _MID64 - re.abs(), _IN64 - (re.abs() - _MID64).abs(),
                    im, _MID64 - im.abs(), _IN64 - (im.abs() - _MID64).abs()]
        parts.append(torch.stack(vals, dim=-1) * wc)
    out = _per_symbol(parts, n_bits)
    return out[0] if one else out


def demodulate_at_adaptive(cfg: OfdmAdaptiveConfig, rx: torch.Tensor, n_bits: int,
                           starts) -> torch.Tensor:
    """Hard bits uint8[..., F, n_bits] of loaded frames at `starts`, as
    :func:`soft_demodulate_at_adaptive` takes them."""
    x, st, one = _as_batch(rx, starts)
    eqc, _ = _equalized_symbols(cfg, x, st, cfg.n_symbols(n_bits))
    maps = {2: _qpsk_to_bits, 4: _qam16_to_bits, 6: _qam64_to_bits}
    parts = []
    for k, bins, g in _classes(cfg, x.device):
        s = cdiv(eqc[..., bins], g)
        bits = (s.real > 0).to(torch.uint8) if k == 1 else maps[k](s)
        parts.append(bits.reshape(*s.shape, k))
    out = _per_symbol(parts, n_bits)
    return out[0] if one else out


# --- channel probing and loading selection -----------------------------------------


@functools.lru_cache(maxsize=16)
def _probe_syms(cfg: OfdmAdaptiveConfig) -> np.ndarray:
    """Known uniform-QPSK probe bits on every data bin, from NumPy's
    default_rng(probe_seed) as the JAX package draws them."""
    rng = np.random.default_rng(cfg.probe_seed)
    n = cfg.probe_symbols * len(cfg.data_bin_idx) * 2
    return rng.integers(0, 2, n).astype(np.uint8)


def _probe_cfg(cfg: OfdmAdaptiveConfig) -> OfdmAdaptiveConfig:
    return dataclasses.replace(cfg, loading=(), gains=())      # uniform QPSK


def probe_waveform(cfg: OfdmAdaptiveConfig, device: torch.device | str = "cuda") -> np.ndarray:
    """chirp ‖ SC pilot ‖ probe_symbols of known QPSK on every data bin, as
    f32 NumPy samples, modulated on `device`."""
    bits = torch.from_numpy(_probe_syms(cfg)[None]).to(device)
    return modulate_bits_adaptive(_probe_cfg(cfg), bits, bits.shape[-1])[0].cpu().numpy()


def estimate_bin_snr(cfg: OfdmAdaptiveConfig, rx, start,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """Per-data-bin SNR (linear) f32[n_data] from the probe frame whose chirp
    starts at `start` in rx f32[T] (a tensor on its device, or NumPy samples
    copied to `device`).

    The deterministic equalizer bias a = H/H_est - 1 (fixed across symbols,
    scaling with the transmitted amplitude) is separated from the additive
    noise and counted at the 16-QAM corner amplitude (1.8 times the probe's
    QPSK power)."""
    if not isinstance(rx, torch.Tensor):
        rx = torch.from_numpy(np.asarray(rx, np.float32)).to(device)
    pcfg = _probe_cfg(cfg)
    n_sym = cfg.probe_symbols
    st = torch.as_tensor(start, device=rx.device).reshape(1, 1)
    eqc, _ = _equalized_symbols(pcfg, rx.to(torch.float32)[None], st, n_sym)
    got = eqc[0, 0][:, const(pcfg.data_bin_idx, rx.device)]          # [n_sym, n_data]
    bits = torch.from_numpy(_probe_syms(cfg)).to(rx.device)
    want = _bits_to_qpsk(bits.reshape(n_sym, -1))
    err = got - want
    p_want = want.abs() ** 2
    sig = true_div(p_want.sum(0), float(n_sym))
    a = cdiv((err * want.conj()).sum(0), p_want.sum(0).clamp(min=1e-12))
    resid = (err - a[None, :] * want).abs() ** 2
    noise = true_div(resid.sum(0), float(n_sym)).clamp(min=1e-12)
    eff_err = 1.8 * a.abs() ** 2 * sig + noise
    return sig / eff_err


def choose_loading(snr_linear, thresholds_db: tuple = (8.5, 14.0, 23.0, 29.5),
                   guard_bins: int = 2) -> tuple:
    """SNR-gap loading: bits a bin in {0, 1, 2, 4, 6}.

    Each bin is thresholded on the minimum SNR over a +-guard_bins window:
    the probe's estimate carries 1-2 dB of noise a bin, and in a steep
    roll-off the smoothed estimate biases it up by 2-6 dB, so the windowed
    minimum derates where the SNR curve is steep.  The 64-QAM tier is the
    16-QAM threshold + 6.5 dB; a 3-tuple caps the loading at 16-QAM."""
    snr = np.asarray(snr_linear)
    n = len(snr)
    robust = snr.copy()
    for d in range(1, guard_bins + 1):
        left = np.concatenate([snr[:d], snr[:-d]])
        right = np.concatenate([snr[d:], snr[-d:]])
        robust = np.minimum(robust, np.minimum(left, right))
    snr_db = 10.0 * np.log10(np.maximum(robust, 1e-12))
    tiers = (1, 2, 4, 6)[: len(thresholds_db)]
    lv = np.zeros(n, np.int32)
    for t_db, bits in zip(thresholds_db, tiers):
        lv[snr_db >= t_db] = bits
    return tuple(lv.tolist())


def _gain_code(g: float) -> int:
    return int(np.clip(np.round(80.0 * np.log10(max(g, 1e-12))), -127, 127))


def quantize_gain(g: float) -> float:
    """Snap an amplitude gain to the handshake's wire grid (0.25 dB steps,
    +-31.75 dB), so that both ends use the same value; pack_gains and
    unpack_gains round-trip these values exactly."""
    return float(10.0 ** (_gain_code(g) / 80.0))


def choose_gains(snr_linear, loading: tuple, thresholds_db: tuple = (8.5, 14.0, 23.0, 29.5),
                 max_gain_db: float = 6.0) -> tuple:
    """Water-filling (margin-balancing) per-bin transmit power on top of the
    discrete loading: each active bin gets power proportional to
    req(bits) / SNR, so that every active bin sits at its constellation's
    threshold plus the same margin; the active bins' total power stays
    n_active, each bin's power is clipped to +-max_gain_db (the water level
    re-found by bisection), and the gains are quantized to the handshake's
    grid.  Inactive bins get 1.0."""
    snr = np.maximum(np.asarray(snr_linear, np.float64), 1e-12)
    lv = np.asarray(loading, np.int64)
    if len(lv) != len(snr):
        raise ValueError(f"loading has {len(lv)} bins, the SNR {len(snr)}")
    active = lv > 0
    n_act = int(active.sum())
    if n_act == 0:
        return tuple([1.0] * len(lv))
    t1, t2, t4 = thresholds_db[:3]
    t6 = thresholds_db[3] if len(thresholds_db) > 3 else t4 + 6.5
    req_db = np.where(lv == 1, t1, np.where(lv == 2, t2, np.where(lv == 4, t4, t6)))
    req = 10.0 ** (req_db / 10.0)
    p_des = np.where(active, req / snr, 0.0)
    p_lo = 10.0 ** (-max_gain_db / 10.0)
    p_hi = 10.0 ** (max_gain_db / 10.0)

    def total(s: float) -> float:
        return float(np.clip(s * p_des[active], p_lo, p_hi).sum())

    lo, hi = 1e-9, 1e9
    for _ in range(60):                    # bisect the water level
        mid = np.sqrt(lo * hi)
        if total(mid) < n_act:
            lo = mid
        else:
            hi = mid
    p = np.where(active, np.clip(lo * p_des, p_lo, p_hi), 1.0)
    return tuple(quantize_gain(float(np.sqrt(v))) for v in p)


def pack_gains(gains: tuple) -> bytes:
    """Gains -> one signed byte a data bin (0.25 dB steps)."""
    return bytes(_gain_code(float(g)) & 0xFF for g in gains)


def unpack_gains(data: bytes, n_bins: int) -> tuple:
    qs = [(b - 256 if b >= 128 else b) for b in data[:n_bins]]
    return tuple(float(10.0 ** (q / 80.0)) for q in qs)


_LOADING_CODE = {0: 0, 1: 1, 2: 2, 4: 3, 6: 4}
_CODE_LOADING = {v: k for k, v in _LOADING_CODE.items()}


def pack_loading(loading: tuple) -> bytes:
    """Loading -> the handshake's bytes: a nibble code a data bin (0, 1, 2,
    4, 6 bits -> codes 0..4), 2 bins a byte, high nibble first."""
    lv = [_LOADING_CODE[int(v)] for v in loading]
    if len(lv) % 2:
        lv.append(0)
    return bytes((lv[i] << 4) | lv[i + 1] for i in range(0, len(lv), 2))


def unpack_loading(data: bytes, n_bins: int) -> tuple:
    lv = []
    for byte in data:
        lv.append(_CODE_LOADING[byte >> 4])
        lv.append(_CODE_LOADING[byte & 0xF])
    return tuple(lv[:n_bins])


# --- the coded stream PHY ------------------------------------------------------------


def _replace(cfg: OfdmAdaptiveConfig, loading, gains) -> OfdmAdaptiveConfig:
    if loading is not None:
        cfg = dataclasses.replace(cfg, loading=tuple(loading))
    if gains is not None:
        cfg = dataclasses.replace(cfg, gains=tuple(gains))
    if cfg.bits_per_symbol < 1:
        raise ValueError("the loading disables every bin")
    return cfg


class OfdmAdaptiveStreamPhy:
    """The MAC's adaptive-loading coded PHY, the duck type of
    :class:`trackmaker_tpu_torch.phy.ofdm_v2.OfdmStreamPhyV2`
    (``encode_frames`` / ``process_samples`` / ``reset`` /
    ``frame_samples``), on `device` (the card unless the caller asks for
    another).

    Both ends construct it with the same loading (ADSL's fixed-loading
    handshake): the receiver probes, chooses a loading, packs it into a data
    frame sent over :meth:`handshake_mode`, and both sides switch.  Every
    frame is two flushed rate-1/2 K=7 code blocks, the header (56 bits ->
    124 coded) and the payload (8L -> 16L + 12), each interleaved
    (``block_interleaver``), so the length decodes from a short prefix.

    ``process_samples`` keeps its buffer on the host; each call copies it,
    zero-padded to a power-of-two bucket, to the device once, finds the
    chirps there (``decode_calls`` counts the buckets) and, for each start,
    decodes the header, then the payload.  Each decode attempt appends its
    pre-FEC bit error rate to ``frame_prefec``: the re-encoded decisions
    against the signs of the soft values, the live re-probe trigger
    (:meth:`link_degraded`)."""

    HDR_BITS = 56
    HDR_CODED = 2 * (56 + 6)          # 124

    def __init__(self, cfg: OfdmAdaptiveConfig = OfdmAdaptiveConfig(),
                 loading: tuple | None = None, max_frame_bytes: int = 263,
                 local_addr: int | None = None, gains: tuple | None = None,
                 device: torch.device | str = "cuda"):
        cfg = _replace(cfg, loading, gains)
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.max_syms = cfg.n_symbols(self._coded_bits(max_frame_bytes - 7))
        self.device = torch.device(device)
        self._buf = np.zeros(0, np.float32)
        self.preamble_len = cfg.preamble_len
        self.frame_prefec: list[float] = []
        self.decode_calls = 0

    @staticmethod
    def _perm(m: int) -> np.ndarray:
        """The coded block's interleaver: contiguous roll-off bins would hand
        the decoder bursts longer than its memory."""
        return block_interleaver(m)

    @staticmethod
    def _coded_bits(n_payload_bytes: int) -> int:
        return OfdmAdaptiveStreamPhy.HDR_CODED + 2 * (8 * n_payload_bytes + 6)

    @property
    def net_bits_per_symbol(self) -> float:
        """Information bits an OFDM symbol after the rate-1/2 code."""
        return self.cfg.bits_per_symbol / 2.0

    @classmethod
    def handshake_mode(cls, cfg: OfdmAdaptiveConfig = OfdmAdaptiveConfig(),
                       local_addr: int | None = None,
                       device: torch.device | str = "cuda") -> "OfdmAdaptiveStreamPhy":
        """The a-priori negotiation mode: coded BPSK on the lowest quarter of
        the data bins only, the sub-band roll-off rarely kills, so that the
        handshake survives a channel nobody has probed yet."""
        n = len(cfg.data_bin_idx)
        lv = tuple([1] * (n // 4) + [0] * (n - n // 4))
        return cls(cfg, loading=lv, local_addr=local_addr, device=device)

    def _deinterleave(self, soft: torch.Tensor) -> torch.Tensor:
        """soft f32[..., m] in wire order -> coded order: a gather by the
        inverse permutation (the transmitter sent wire[i] = coded[perm[i]])."""
        inv = np.argsort(self._perm(soft.shape[-1]))
        return soft[..., const(inv, soft.device)]

    # -- encoder side --------------------------------------------------------------

    def _encode_block(self, bits: np.ndarray) -> torch.Tensor:
        coded = conv_encode(torch.from_numpy(bits).to(self.device))
        return coded[const(self._perm(coded.shape[-1]), self.device)]

    def encode_frame(self, frame: Frame) -> np.ndarray:
        fb = frame.to_bytes()
        hdr = bitops.bytes_to_bits_host(fb[:7])
        pay = bitops.bytes_to_bits_host(fb[7:]) if len(fb) > 7 else np.zeros(0, np.uint8)
        coded = torch.cat([self._encode_block(hdr), self._encode_block(pay)])
        return modulate_bits_adaptive(self.cfg, coded[None], coded.shape[-1])[0].cpu().numpy()

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        return _join([self.encode_frame(f) for f in frames], gap_samples)

    # -- streaming decoder side ----------------------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def frame_samples(self, n_payload: int) -> int:
        return self.cfg.frame_samples(self._coded_bits(n_payload))

    @staticmethod
    def _prefec(soft_coded: np.ndarray, decoded_bits: np.ndarray) -> float:
        """Pre-FEC BER: the re-encoded decisions against the hard decisions
        of the soft values (inside the code's correction radius the
        re-encoded stream is the transmitted one)."""
        ref = conv_encode(torch.from_numpy(np.asarray(decoded_bits, np.uint8))).numpy()
        hard = (soft_coded > 0).astype(np.uint8)
        return float(np.mean(hard != ref[: len(hard)]))

    def prefec_ber(self, window: int = 8) -> float:
        """Mean pre-FEC BER over the last `window` decode attempts (0.0 until
        anything was decoded)."""
        h = self.frame_prefec[-window:]
        return float(np.mean(h)) if h else 0.0

    def link_degraded(self, threshold: float = 0.04, window: int = 8) -> bool:
        """True when the recent pre-FEC BER says the loading no longer fits
        the channel: rate-1/2 K=7 soft Viterbi corrects about 4-5% channel
        BER, so 4% is the retrain's trip point."""
        return len(self.frame_prefec) >= window and self.prefec_ber(window) >= threshold

    def _decode_block(self, soft: torch.Tensor, n_bits: int) -> tuple[np.ndarray, np.ndarray]:
        """(soft values in coded order, decoded bits), both on the host, of
        one block's wire-order soft values."""
        deint = self._deinterleave(soft)
        bits = viterbi_decode(deint, n_bits, soft=True)
        return deint.cpu().numpy(), bits.cpu().numpy()

    def _starts(self, pj: torch.Tensor) -> torch.Tensor:
        """The chirp starts int32[16] (-1 padded) of a padded bucket on the
        device."""
        self.decode_calls += 1
        return find_preambles(self.cfg, pj, 16)

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
            if s + cfg.frame_samples(self.HDR_CODED) > len(self._buf):
                break  # header symbols still arriving
            start = starts_dev[i:i + 1]
            soft_h = soft_demodulate_at_adaptive(cfg, pj, self.HDR_CODED, start)[0]
            deint, hdr_bits = self._decode_block(soft_h, self.HDR_BITS)
            hdr = np.packbits(hdr_bits)
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - 7:
                self.frame_prefec.append(self._prefec(deint, hdr_bits))
                consumed = s + cfg.preamble_len
                continue
            total_coded = self._coded_bits(data_len)
            frame_end = s + cfg.frame_samples(total_coded)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            prefec = self._prefec(deint, hdr_bits)
            if data_len:
                soft = soft_demodulate_at_adaptive(cfg, pj,
                                                   self.max_syms * cfg.bits_per_symbol,
                                                   start)[0]
                pdeint, pay_bits = self._decode_block(soft[self.HDR_CODED:total_coded],
                                                      8 * data_len)
                prefec = 0.5 * (prefec + self._prefec(pdeint, pay_bits))
            else:
                pay_bits = np.zeros(0, np.uint8)
            f = Frame.from_bits(np.concatenate([hdr_bits, pay_bits]))
            self.frame_prefec.append(prefec)
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

    # -- the batched decode (equal-length frames) -----------------------------------

    def soft_blocks(self, x: torch.Tensor, starts: torch.Tensor, payload_len: int):
        """(headers f32[B, F, 124], payloads f32[B, F, 2·(8·payload_len + 6)]):
        the Viterbi decoder's inputs, in coded order, for the frames whose
        chirps start at starts int[B, F] (-1 read as 0) in captures x f32[B,
        T]."""
        total_coded = self._coded_bits(payload_len)
        soft = soft_demodulate_at_adaptive(self.cfg, x.to(torch.float32), total_coded,
                                           starts.clamp(min=0))
        return (self._deinterleave(soft[..., :self.HDR_CODED]),
                self._deinterleave(soft[..., self.HDR_CODED:total_coded]))

    def batched_decode_fn(self, n_frames: int, payload_len: int):
        """The batch decoder ``x f32[B, T] -> (starts int32[B, n_frames], bits
        uint8[B, n_frames, 56 + 8·payload_len])`` of captures holding
        equal-length adaptive coded frames, on x's device: the chirp sync
        (one launch of the normalized correlation), the loading-aware soft
        demap of every frame, the deinterleave, and one Viterbi launch for all
        headers and one for all payloads."""
        def decode(x: torch.Tensor):
            starts = find_preambles(self.cfg, x.to(torch.float32), n_frames)
            hdr, pay = self.soft_blocks(x, starts, payload_len)
            return starts, torch.cat([viterbi_decode(hdr, self.HDR_BITS, soft=True),
                                      viterbi_decode(pay, 8 * payload_len, soft=True)], dim=-1)

        return decode

    def decode_equal_frames(self, caps, n_frames: int, payload_len: int) -> list[list[Frame]]:
        """The CRC-valid frames (addressed to this PHY, where it has an
        address) of each capture of caps f32[B, T], each holding up to
        `n_frames` frames of `payload_len` bytes: a tensor decodes on its own
        device, a NumPy array on the PHY's."""
        if not isinstance(caps, torch.Tensor):
            caps = torch.from_numpy(np.asarray(caps, np.float32)).to(self.device)
        starts, bits = self.batched_decode_fn(n_frames, payload_len)(caps)
        starts, bits = starts.cpu().numpy(), bits.cpu().numpy()
        out: list[list[Frame]] = []
        for b in range(bits.shape[0]):
            row = []
            for k in range(bits.shape[1]):
                if starts[b, k] < 0:
                    continue
                f = Frame.from_bits(bits[b, k])
                if f is None or (self.local_addr is not None and f.dst != self.local_addr):
                    continue
                row.append(f)
            out.append(row)
        return out


# --- the live retrain protocol -------------------------------------------------------
#
# When link_degraded() fires, the receiver retrains without tearing the link
# down: a REPROBE request over the handshake mode, the transmitter's probe,
# estimate_bin_snr -> choose_loading (-> choose_gains) -> a LOADING frame
# over the handshake mode, and both ends switch.  Control frames are data
# frames whose payload starts with a 2-byte magic.

CTRL_REPROBE = b"\xa5R"
CTRL_LOADING = b"\xa5L"


def make_reprobe_frame(seq: int, src: int, dst: int) -> Frame:
    return Frame.new_data(seq, src, dst, CTRL_REPROBE)


def make_loading_frame(seq: int, src: int, dst: int, loading: tuple,
                       gains: tuple | None = None) -> Frame:
    """LOADING update: the loading codes, then, where given, a byte a bin of
    water-filling gains (pack_gains)."""
    body = CTRL_LOADING + pack_loading(loading)
    if gains is not None:
        body += pack_gains(gains)
    return Frame.new_data(seq, src, dst, body)


def parse_control(frame: Frame, n_bins: int):
    """("reprobe", None, None) | ("loading", loading, gains or None) | None;
    gains is None when the frame carries no gain bytes."""
    if frame.data[:2] == CTRL_REPROBE and len(frame.data) == 2:
        return ("reprobe", None, None)
    if frame.data[:2] == CTRL_LOADING:
        rest = frame.data[2:]
        n_lb = -(-n_bins // 2)            # loading bytes, 2 bins a byte
        loading = unpack_loading(rest[:n_lb], n_bins)
        gains = unpack_gains(rest[n_lb:], n_bins) if len(rest) >= n_lb + n_bins else None
        return ("loading", loading, gains)
    return None


class OfdmAdaptiveModem:
    """Frame-level facade over a loading (uncoded): equal-length PHY frames
    <-> the loaded waveform, on `device` (the card unless the caller asks
    for another).  Both ends share the loading: the receiver probes
    (:func:`probe_waveform`, :func:`estimate_bin_snr`) and chooses it
    (:func:`choose_loading`)."""

    def __init__(self, cfg: OfdmAdaptiveConfig = OfdmAdaptiveConfig(),
                 loading: tuple | None = None, gains: tuple | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = _replace(cfg, loading, gains)
        self.device = torch.device(device)

    @property
    def bits_per_symbol(self) -> int:
        return self.cfg.bits_per_symbol

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        if not frames:
            raise ValueError("no frames to encode")
        nb = {len(f.to_bytes()) * 8 for f in frames}
        if len(nb) != 1:
            raise ValueError("group equal-length frames")
        bits = torch.from_numpy(np.stack([f.to_bits() for f in frames])).to(self.device)
        waves = modulate_bits_adaptive(self.cfg, bits, nb.pop()).cpu().numpy()
        return _join(list(waves), gap_samples)

    def decode(self, rx: np.ndarray, frame_bytes_len: int, max_frames: int = 64) -> list[Frame]:
        x = torch.from_numpy(np.asarray(rx, np.float32)).to(self.device)
        starts = find_preambles(self.cfg, x, max_frames)
        starts = starts[starts >= 0]
        if starts.numel() == 0:
            return []
        bits = demodulate_at_adaptive(self.cfg, x, frame_bytes_len * 8, starts)
        out = []
        for row in bits.cpu().numpy():
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
