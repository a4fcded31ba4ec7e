"""ASK/chirp modem (counterpart of ``trackmaker_tpu/phy/ask.py``).

10 kHz carrier ASK at 44 samples per bit, a 440-sample 2→10→2 kHz chirp
preamble, an EMA power detector, a sliding 440-tap chirp correlator with
local-maximum peak picking, and coherent demodulation (multiply by the
carrier, 11-tap smoothing, integration over samples 10..30 of each bit).

The receiver has two phases:

* the dense phase (``dense_arrays``): the EMA power, the sync correlation
  (the sliding-dot kernel, ``sync/sliding_dot.py``) and the update
  predicate ``sync > max(2·power, 0.05)`` over the whole capture;
* the consumption phase: frame after frame, the record chain of the
  reference's peak state machine from the cursor (``run_chain``, with the
  exact warm-up correlations after each frame, ``warmup_sync_at``), then
  the cursor moves past the frame.

``demodulate`` is the exact scan: a host loop over frame slots with one
host sync per slot, then one batched demodulation of every fired slot
(the 4752 x 108 weight product).  It is the fallback of the speculative
receiver (``phy/ask_spec.py``), which ``demodulate_fast`` runs first.
The record-chain kernel ``ask_chain`` (``csrc/ask_chain.cu``) serves both.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.core import blockq
from trackmaker_tpu_torch.dsp.filters import ema_power, matmul_f32
from trackmaker_tpu_torch.dsp.osc import carrier_np, chirp_cached
from trackmaker_tpu_torch.sync.sliding_dot import sliding_dot_scaled

BIG = 2**30
NEGB = -(2**30)       # "no update yet" in the record chain
CHAIN_WINDOW = 4096   # samples of the exact scan's record chain from its first update


@dataclasses.dataclass(frozen=True)
class AskConfig:
    """A field-for-field copy of the JAX package's ``AskConfig``."""

    sample_rate: int = 48_000
    carrier_hz: float = 10_000.0
    samples_per_bit: int = 44
    frame_bits: int = 100          # 8-bit id + 92 payload bits
    crc_bits: int = 8              # placeholder zeros
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    power_alpha: float = 1.0 / 64.0
    sync_divisor: float = 200.0
    sync_power_factor: float = 2.0    # sync > 2*power
    sync_abs_threshold: float = 0.05  # sync > 0.05
    peak_guard: int = 200             # fire 200 quiet samples after peak
    smooth_half: int = 5              # 11-tap box smoother
    bit_lo: int = 10                  # integrate smooth[10..30] per bit
    bit_hi: int = 30
    id_min: int = 1
    id_max: int = 100
    max_gap: int = 100                # random inter-frame gap upper bound

    @property
    def coded_bits(self) -> int:
        return self.frame_bits + self.crc_bits  # 108

    @property
    def frame_samples(self) -> int:
        return self.coded_bits * self.samples_per_bit  # 4752

    @property
    def payload_bits(self) -> int:
        return self.frame_bits - 8  # 92


class AskDecoded(NamedTuple):
    valid: torch.Tensor     # bool[..., K]
    frame_id: torch.Tensor  # int32[..., K]
    bits: torch.Tensor      # uint8[..., K, payload_bits]
    start: torch.Tensor     # int32[..., K] fired peak index (-1 if empty)

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


def build_frames(text: bytes, cfg: AskConfig = AskConfig(),
                 num_frames: int = 100) -> np.ndarray:
    """Pack text into id+payload bit frames uint8[num_frames, frame_bits],
    with the reference's wrap quirk (reset the cursor, then consume bit 0)."""
    text_bits = np.unpackbits(np.frombuffer(text, dtype=np.uint8))
    n_text = len(text_bits)
    payload = cfg.payload_bits
    frames = np.zeros((num_frames, cfg.frame_bits), dtype=np.uint8)
    ids = np.arange(1, num_frames + 1, dtype=np.uint32)
    frames[:, :8] = (ids[:, None] >> np.arange(7, -1, -1)) & 1
    idx = np.arange(num_frames * payload) % n_text
    frames[:, 8:] = text_bits[idx].reshape(num_frames, payload)
    return frames


def _chirp_np(cfg: AskConfig) -> np.ndarray:
    return chirp_cached(cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz,
                        cfg.sample_rate)


def modulate_frames(cfg: AskConfig, frames: torch.Tensor) -> torch.Tensor:
    """uint8[B, frame_bits] -> f32[B, preamble_len + frame_samples], on the
    frames' device."""
    b = frames.shape[0]
    dev = frames.device
    bits = torch.cat([frames.to(torch.float32),
                      torch.zeros((b, cfg.crc_bits), device=dev)], dim=-1)
    amp = (2.0 * bits - 1.0).repeat_interleave(cfg.samples_per_bit, dim=-1)
    car = torch.from_numpy(carrier_np(cfg.frame_samples, cfg.carrier_hz,
                                      cfg.sample_rate)).to(dev)
    pre = torch.from_numpy(_chirp_np(cfg).copy()).to(dev)
    return torch.cat([pre.expand(b, -1), amp * car], dim=-1)


def build_track(cfg: AskConfig, frames: np.ndarray,
                gaps: np.ndarray | None = None, seed: int = 1) -> np.ndarray:
    """Serialize modulated frames with random 0..max_gap silence before and
    after each frame; host f32[T]."""
    if gaps is None:
        rng = np.random.default_rng(seed)
        gaps = rng.integers(0, cfg.max_gap, size=(len(frames), 2))
    waves = modulate_frames(cfg, torch.from_numpy(np.asarray(frames))).numpy()
    parts = []
    for i in range(len(frames)):
        parts.append(np.zeros(gaps[i, 0], np.float32))
        parts.append(waves[i])
        parts.append(np.zeros(gaps[i, 1], np.float32))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# Receiver building blocks, shared by the exact scan below and the
# speculative receiver (phy/ask_spec.py).
# ---------------------------------------------------------------------------


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, as the JAX package divides.  On a CUDA tensor
    PyTorch turns a division by a host scalar into a product with its
    float32 reciprocal, which rounds differently; a divisor on the
    tensor's own device keeps the true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def dense_arrays(cfg: AskConfig, rx: torch.Tensor):
    """(power, sync, upd_ok), each [B, T], over captures rx f32[B, T].

    `sync` is FIFO-aligned: lag i is the dot of the newest 440 samples
    ending at sample i against the chirp, times f32(1/200) (zero history
    at the start, as the reference's zeroed FIFO)."""
    power = ema_power(rx, cfg.power_alpha)
    sync = sliding_dot_scaled(rx, _chirp_np(cfg), 1.0 / cfg.sync_divisor)
    upd_ok = (sync > cfg.sync_power_factor * power) & (sync > cfg.sync_abs_threshold)
    return power, sync, upd_ok


@functools.lru_cache(maxsize=4)
def _warmup_band_np(cfg: AskConfig) -> np.ndarray:
    """Banded Toeplitz operator of the warm-up correlations: the FIFO holds
    the newest p+1 samples at its tail, so
    out[p] = Σ_{k<=p} slab[k]·pre[k + L-1-p], i.e. slab @ W with
    W[k, p] = pre[k + L-1-p] for k <= p."""
    pre_host = _chirp_np(cfg)
    l_pre = cfg.preamble_len
    w_np = np.zeros((l_pre, l_pre), np.float32)
    for p in range(l_pre):
        w_np[: p + 1, p] = pre_host[l_pre - 1 - p:]
    w_np.flags.writeable = False
    return w_np


def warmup_sync_at(cfg: AskConfig, rx_pad: torch.Tensor, power_pad: torch.Tensor,
                   w_band: torch.Tensor, cursor: int, t: int):
    """Exact partial correlations for the L positions after a decode: the
    reference zeroes its sync FIFO when a frame fires, so sync at cursor+p
    sees only the p+1 samples received since.  Returns (sync_w[L], ok_w[L]).
    The divisor divides, as in the JAX package (the dense sync multiplies
    by the rounded reciprocal instead)."""
    l_pre = cfg.preamble_len
    slab = rx_pad[cursor:cursor + l_pre]
    out = true_div(matmul_f32(slab, w_band), cfg.sync_divisor)
    pw = power_pad[cursor:cursor + l_pre]
    okw = (out > cfg.sync_power_factor * pw) & (out > cfg.sync_abs_threshold)
    pos_valid = torch.arange(cursor, cursor + l_pre, device=rx_pad.device) < t
    return out, okw & pos_valid


# --- the record chain: kernel csrc/ask_chain.cu ------------------------------


def ask_chain_plain(vals: torch.Tensor, base: torch.Tensor, guard: int):
    """Plain PyTorch version of :func:`ask_chain`."""
    n, win = vals.shape
    dev = vals.device
    idx = base[:, None] + torch.arange(win, dtype=torch.int32, device=dev)
    m_incl = vals.cummax(-1).values
    m_excl = torch.nn.functional.pad(m_incl[:, :-1], (1, 0), value=-math.inf)
    upd = vals > m_excl            # strict: the earlier index wins a tie
    ridx = torch.where(upd, idx, NEGB)
    rec = ridx.cummax(-1).values
    rec_excl = torch.nn.functional.pad(rec[:, :-1], (1, 0), value=NEGB)
    fire = ~upd & (idx > rec_excl + guard) & (m_excl > -math.inf)
    lane = torch.arange(win, device=dev)
    j1 = torch.where(fire, lane, win).amin(-1)
    fired = j1 < win
    peak_f = rec_excl.gather(1, j1.clamp(max=win - 1)[:, None])[:, 0]
    return fired, torch.where(fired, peak_f, ridx.amax(-1))


_CHAIN_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def ask_chain(vals: torch.Tensor, base: torch.Tensor, guard: int):
    """Record-chain fire resolution of each row of vals f32[N, W] (masked
    sync values, -inf where no update may happen), whose column j is
    sample base[n] + j, base int32[N].  Along the row:

    * m = the exclusive running max; upd = v > m (strict, so the earlier
      index wins a tie); rec = the last update index before each column
      (-2^30 before the first);
    * fire = !upd & idx > rec + guard & m > -inf; the row fires at its
      first fire, with peak = rec there;
    * a row that never fires gives fired False and peak = its last
      update index (-2^30 if none).

    Returns (fired bool[N], peak int32[N]).  Integers and max only, so the
    kernel and its plain version agree exactly (see ``csrc/ask_chain.cu``).
    """
    if not _build.on_cuda(vals, base):
        return ask_chain_plain(vals, base, guard)
    n, win = vals.shape
    if vals.dtype != torch.float32 or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous f32[N, W]")
    if tuple(base.shape) != (n,) or base.dtype != torch.int32 or not base.is_contiguous():
        raise ValueError(f"base must be a contiguous int32[{n}]")
    fired = torch.empty(n, dtype=torch.bool, device=vals.device)
    peak = torch.empty(n, dtype=torch.int32, device=vals.device)
    fn = _build.entry("ask_chain", "tm_ask_chain", _CHAIN_ARGTYPES)
    err = fn(vals.data_ptr(), base.data_ptr(), n, win, guard, fired.data_ptr(),
             peak.data_ptr(), _build.stream_ptr(vals))
    _build.check(err, "ask_chain")
    ask_chain.launches += 1
    return fired, peak


ask_chain.launches = 0


def run_chain(cfg: AskConfig, sync_pad: torch.Tensor, upd_pad: torch.Tensor,
              i0: torch.Tensor, cursor: int, sync_w: torch.Tensor, ok_w: torch.Tensor):
    """The local-max record chain and its 200-sample fire guard over the
    CHAIN_WINDOW samples from i0 (a 0-dim tensor), with the
    values of the warm-up region [cursor, cursor+L) taken from
    (sync_w, ok_w).  The warm-up region is a prefix of the window (i0 >=
    cursor).  Returns (peak, fired) as 0-dim tensors."""
    l_pre = cfg.preamble_len
    dev = sync_pad.device
    off = torch.arange(CHAIN_WINDOW, device=dev)
    idx = i0 + off
    woff0 = (i0 - cursor).clamp(0, l_pre)
    sw = torch.nn.functional.pad(sync_w, (0, CHAIN_WINDOW + 8), value=-math.inf)[woff0 + off]
    okw = torch.nn.functional.pad(ok_w, (0, CHAIN_WINDOW + 8))[woff0 + off]
    in_warm = off < (l_pre - woff0)
    sp = torch.where(in_warm, sw, sync_pad[idx])
    ok = torch.where(in_warm, okw, upd_pad[idx])
    vals = torch.where(ok, sp, -math.inf)
    fired, peak = ask_chain(vals[None], idx[:1].to(torch.int32), cfg.peak_guard)
    return peak[0], fired[0]


# "first update at or after the cursor": a next-set table over the mask
upd_block_tables = blockq.block_tables
first_upd_from = blockq.first_set_from


# --- demodulation ---------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _demod_weights_np(cfg: AskConfig) -> np.ndarray:
    """f32[frame_samples, coded_bits]: the edge-truncated box smooth and the
    per-bit integration over smooth[bit_lo..bit_hi) folded into one linear
    operator on the carrier product, sums = prod @ W."""
    n = cfg.frame_samples
    h = cfg.smooth_half
    w = np.zeros((n, cfg.coded_bits), np.float32)
    for i in range(cfg.coded_bits):
        for p in range(cfg.bit_lo + i * cfg.samples_per_bit,
                       cfg.bit_hi + i * cfg.samples_per_bit):
            j0, j1 = max(0, p - h), min(n, p + h + 1)
            w[j0:j1, i] += np.float32(1.0) / np.float32(j1 - j0)
    w.flags.writeable = False
    return w


def demod_tables(cfg: AskConfig, device):
    """(carrier f32[frame_samples], smooth+integrate weights
    f32[frame_samples, coded_bits]) on `device`."""
    car = carrier_np(cfg.frame_samples, cfg.carrier_hz, cfg.sample_rate)
    return (torch.from_numpy(car).to(device),
            torch.from_numpy(_demod_weights_np(cfg).copy()).to(device))


def _demod_decisions(cfg: AskConfig, bits: torch.Tensor, peak: torch.Tensor,
                     ok: torch.Tensor) -> dict:
    """The frame-id filter (1..100) and the output fields, from the coded
    bits bool[..., coded_bits] of each slot."""
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    fid = (bits[..., :8].to(torch.int32) * weights).sum(-1, dtype=torch.int32)
    valid = ok & (fid >= cfg.id_min) & (fid <= cfg.id_max)
    return dict(
        valid=valid,
        frame_id=torch.where(valid, fid, 0),
        bits=torch.where(valid[..., None], bits[..., 8:cfg.frame_bits], False).to(torch.uint8),
        start=torch.where(valid, peak.to(torch.int32), -1),
    )


def slot_bit_sums(cfg: AskConfig, rx_pad: torch.Tensor, car: torch.Tensor,
                  weights: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """The bit sums f32[K, coded_bits] of the 4752-sample window after each
    peak int[K] of one capture: the window times the carrier, through the
    fused smooth+integrate product."""
    start = (peak.to(torch.int64) + 1).clamp(0, rx_pad.shape[0] - cfg.frame_samples)
    win = rx_pad[start[:, None] + torch.arange(cfg.frame_samples, device=rx_pad.device)]
    return matmul_f32(win * car, weights)


def demod_slot(cfg: AskConfig, rx_pad: torch.Tensor, car: torch.Tensor,
               weights: torch.Tensor, peak: torch.Tensor, ok: torch.Tensor) -> dict:
    """Coherent demodulation of the window after each fired peak int[K] of
    one capture: the slot bit sums, then the frame-id filter."""
    sums = slot_bit_sums(cfg, rx_pad, car, weights, peak)
    return _demod_decisions(cfg, sums > 0.0, peak, ok)


@functools.lru_cache(maxsize=4)
def _demod_dense_tables_np(cfg: AskConfig):
    """(k f32[30], sin f32[P], cos f32[P]) of the dense demodulation, or None
    where the configuration's geometry does not admit it.

    The carrier is periodic (10 kHz at 48 kHz: P = 24 samples), so a
    window product splits over the window start p0:
    win[i]·car[i] = cos(w p0)·rx[j]sin(wj) - sin(w p0)·rx[j]cos(wj), j = p0+i.
    Where the 11-tap smooth never truncates (bit_lo >= h and
    bit_hi + h <= samples_per_bit), each bit's smooth+integrate column is
    one shared 30-tap kernel k placed at bit_lo - h + c·spb.  The whole
    post-pass becomes two 30-tap sliding dots and a strided pick."""
    fhz = cfg.carrier_hz
    if abs(fhz - round(fhz)) > 1e-9:
        return None
    if cfg.bit_lo < cfg.smooth_half or cfg.bit_hi + cfg.smooth_half > cfg.samples_per_bit:
        return None                      # edge truncation would fire
    g = math.gcd(int(round(fhz)), cfg.sample_rate)
    period = cfg.sample_rate // g
    if period > 4096:
        return None
    nsm = 2 * cfg.smooth_half + 1
    k = np.convolve(np.ones(cfg.bit_hi - cfg.bit_lo, np.float64),
                    np.ones(nsm, np.float64) / nsm).astype(np.float32)
    ph = (2.0 * np.pi * (int(round(fhz)) // g)
          * np.arange(period, dtype=np.float64) / period)
    return k, np.sin(ph).astype(np.float32), np.cos(ph).astype(np.float32)


def demod_dense_input(cfg: AskConfig, rx: torch.Tensor) -> torch.Tensor:
    """f32[2B, T + frame_samples + 30]: the captures rx f32[B, T] times the
    periodic sin, then times the cos, each followed by zeros; the input of
    the two 30-tap dots of `demod_dense`."""
    k, s_per, c_per = _demod_dense_tables_np(cfg)
    t = rx.shape[1]
    dev = rx.device
    reps = -(-t // len(s_per))
    sw = torch.from_numpy(s_per).to(dev).repeat(reps)[:t]
    cw = torch.from_numpy(c_per).to(dev).repeat(reps)[:t]
    return torch.nn.functional.pad(torch.cat([rx * sw, rx * cw]),
                                   (0, cfg.frame_samples + len(k)))


def demod_dense(cfg: AskConfig, rx: torch.Tensor):
    """Dense demodulation arrays (ds, dc), each f32[B, T + frame_samples + 1],
    of captures rx f32[B, T]: the bit sums of a window starting at p0 are

        sums[c] = cos[p0 % P]·ds[q] - sin[p0 % P]·dc[q],
        q = p0 + bit_lo - smooth_half + c·samples_per_bit.

    Both 30-tap dots go through one launch of the sliding-dot kernel."""
    k = _demod_dense_tables_np(cfg)[0]
    d = sliding_dot_scaled(demod_dense_input(cfg, rx), k, 1.0)[:, len(k) - 1:]
    return d[:rx.shape[0]], d[rx.shape[0]:]


def dense_bit_sums(cfg: AskConfig, ds: torch.Tensor, dc: torch.Tensor,
                   peaks: torch.Tensor) -> torch.Tensor:
    """The bit sums f32[B, K, coded_bits] of every slot peaks int[B, K] from
    the dense arrays ds, dc [B, N]: the strided pick ds[b, q0 + spb·c] and
    the 2-term carrier-phase combination.  The same sums as
    `slot_bit_sums` in real arithmetic."""
    _, s_per, c_per = _demod_dense_tables_np(cfg)
    dev = ds.device
    b, k = peaks.shape
    p0 = (peaks.to(torch.int64) + 1).clamp(min=0)
    m = p0 % len(s_per)
    q0 = p0 + cfg.bit_lo - cfg.smooth_half
    idx = q0[..., None] + cfg.samples_per_bit * torch.arange(cfg.coded_bits, device=dev)
    idx = idx.clamp(max=ds.shape[1] - 1).reshape(b, -1)   # only empty slots clamp
    pick_s = ds.gather(1, idx).reshape(b, k, cfg.coded_bits)
    pick_c = dc.gather(1, idx).reshape(b, k, cfg.coded_bits)
    s = torch.from_numpy(s_per).to(dev)[m][..., None]
    c = torch.from_numpy(c_per).to(dev)[m][..., None]
    return c * pick_s - s * pick_c


def demod_slots_dense(cfg: AskConfig, ds: torch.Tensor, dc: torch.Tensor,
                      peaks: torch.Tensor, oks: torch.Tensor) -> dict:
    """Every slot of every capture from the dense arrays: the dense bit
    sums, then the frame-id filter.  peaks, oks [B, K].  Decision-equivalent
    to `demod_slot`."""
    return _demod_decisions(cfg, dense_bit_sums(cfg, ds, dc, peaks) > 0.0, peaks, oks)


def demod_slot_dense(cfg: AskConfig, ds: torch.Tensor, dc: torch.Tensor,
                     peak: torch.Tensor, ok: torch.Tensor) -> dict:
    """`demod_slots_dense` for the slots peak int[K] of one capture."""
    res = demod_slots_dense(cfg, ds[None], dc[None], peak[None], ok[None])
    return {name: value[0] for name, value in res.items()}


# --- receivers --------------------------------------------------------------------


def demodulate(cfg: AskConfig, rx: torch.Tensor, max_frames: int = 128) -> AskDecoded:
    """The exact scan of one capture rx f32[T], replaying the reference
    receiver decision for decision: AskDecoded over `max_frames` slots.

    Each slot takes the first update from the cursor (exact warm-up
    correlations inside [cursor, cursor+L), the dense ones beyond), runs
    the record chain over CHAIN_WINDOW samples from there, and either
    fires a complete frame (the cursor moves past it) or ends the scan.
    One host sync per slot; the fired windows are demodulated together
    afterwards."""
    if rx.ndim != 1:
        raise ValueError("rx must be f32[T]")
    x = rx.to(torch.float32).contiguous()
    dev = x.device
    t = x.shape[0]
    power, sync, upd_ok = (a[0] for a in dense_arrays(cfg, x[None]))
    tables = upd_block_tables(upd_ok[None])

    l_pre = cfg.preamble_len
    rx_pad = torch.nn.functional.pad(x, (0, cfg.frame_samples + CHAIN_WINDOW + 8))
    sync_pad = torch.nn.functional.pad(sync, (0, CHAIN_WINDOW + 8), value=-math.inf)
    upd_pad = torch.nn.functional.pad(upd_ok, (0, CHAIN_WINDOW + 8))
    power_pad = torch.nn.functional.pad(power, (0, l_pre + 8))
    w_band = torch.from_numpy(_warmup_band_np(cfg).copy()).to(dev)

    cursor = 0
    peaks, fire_ok = [], []
    for _ in range(max_frames):
        sync_w, ok_w = warmup_sync_at(cfg, rx_pad, power_pad, w_band, cursor, t)
        warm_idx = torch.arange(cursor, cursor + l_pre, device=dev)
        first_warm = torch.where(ok_w, warm_idx, BIG).amin()
        dense_from = torch.full((1, 1), cursor + l_pre, dtype=torch.int64, device=dev)
        first_dense, has_dense = first_upd_from(tables, dense_from)
        first = torch.minimum(first_warm, torch.where(has_dense, first_dense, BIG)[0, 0])
        peak, fired = run_chain(cfg, sync_pad, upd_pad, first.clamp(0, t - 1), cursor,
                                sync_w, ok_w)
        has, fired, peak = torch.stack([(first < BIG).to(torch.int64), fired.to(torch.int64),
                                        peak.to(torch.int64)]).tolist()  # the slot's one host sync
        # a fired frame counts only when its window fits in the capture;
        # anything else ends the scan
        emit = bool(has and fired) and peak + cfg.frame_samples < t
        peaks.append(peak)
        fire_ok.append(emit)
        if not emit:
            break
        cursor = peak + cfg.frame_samples + 1
    pad = max_frames - len(peaks)
    peak_t = torch.tensor(peaks + [0] * pad, dtype=torch.int32, device=dev)
    ok_t = torch.tensor(fire_ok + [False] * pad, device=dev)
    car, wts = demod_tables(cfg, dev)
    return AskDecoded(**demod_slot(cfg, rx_pad, car, wts, peak_t, ok_t))


def demodulate_fast(cfg: AskConfig, rx: torch.Tensor, max_frames: int = 128) -> AskDecoded:
    """Batch receive of f32[T] or f32[B, T] captures through the speculative
    receiver where the configuration admits it.

    The speculative receiver (kernels on a CUDA tensor, their plain
    versions on a CPU tensor) runs first; each row it flags not ``ok`` (a
    candidate table that overflowed, a fired peak outside the table, or a
    chain unresolved inside its window) is decoded again by the exact
    scan and takes its result.  Every row equals :func:`demodulate` slot
    for slot."""
    from trackmaker_tpu_torch.phy import ask_spec

    x = rx.to(torch.float32)
    batched = x.ndim == 2
    xb = x if batched else x[None]
    if ask_spec.spec_supported_cfg(cfg):
        res, ok = ask_spec.demodulate_spec(cfg, xb, max_frames=max_frames)
        for r in torch.nonzero(~ok).flatten().tolist():
            exact = demodulate(cfg, xb[r], max_frames=max_frames)
            for field, fix in zip(res, exact):
                field[r] = fix
    else:
        rows = [demodulate(cfg, xb[r], max_frames=max_frames) for r in range(xb.shape[0])]
        res = AskDecoded(*(torch.stack(col) for col in zip(*rows)))
    return res if batched else AskDecoded(*(f[0] for f in res))


def assemble_text(decoded: AskDecoded) -> bytes:
    """The payload bits of the valid frames, in arrival order, packed to
    bytes."""
    valid = decoded.valid.cpu().numpy()
    bits = decoded.bits.cpu().numpy()[valid].reshape(-1)
    n = (len(bits) // 8) * 8
    return np.packbits(bits[:n]).tobytes()
