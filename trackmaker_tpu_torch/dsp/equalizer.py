"""Preamble-trained MMSE equalizer, a multipath front-end for the line-coded
PHY (counterpart of ``trackmaker_tpu/dsp/equalizer.py``).

Batched over captures f32[B, T] (or one f32[T]):

1. *Anchors*: the per-128-lag-row maxima of the normalized preamble
   correlation (``sync.auto_xcorr_row_stats``, the row-stats kernel on the
   card), peeled ``n_anchors`` times: take the largest, then drop every row
   whose maximum lies within a preamble length of it.
2. *Channel estimate* at each anchor: an LS fit of ``N_CH`` taps (``K0``
   of them acausal) against the known preamble and the silence before it,
   ``h = M @ window`` with ``M`` a host constant, and the fit's
   residual-to-signal ratio ``lam``.  Of the anchors whose correlation
   reaches ``min_quality``, the one with the smallest ``lam`` trains.
3. *MMSE inversion*: ``G = conj(H) / (|H|² + lam)`` on 1024 FFT bins,
   truncated to a two-sided FIR over lags [-L_HALF, L_HALF].
4. *Apply*: the FIR as a banded product of 128-sample rows (four
   [nblk, 128] @ [128, 128] products per capture), grouped as the JAX
   package groups it.
5. *Gate*: a capture whose training correlation is below ``min_quality``
   passes through bit for bit.

``decode_capture_dd`` is the decision-directed decode for captures with no
clean preamble to train on (a burst whose head was cut): it refits the
channel on the interiors of the frames already decoded (host float64, as
in the JAX package), applies the refit taps with the same banded product
and decodes again while the frame count grows.

The output feeds the unmodified decoder.  The LS and FIR products decide
which anchor wins and what the decoder sees, so they run in full float32
(``filters.matmul_f32``) whatever the caller set for TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy.decoder import (
    DecodedFrames,
    as_capture,
    decode_capture,
    decode_capture_fast,
)
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync import auto_xcorr_row_stats

N_CH = 48          # estimated channel taps
K0 = 16            # acausal taps (echo arriving before the anchor path)
N_FFT = 1024       # inversion FFT size
L_HALF = 192       # equalizer FIR: lags in [-L_HALF, L_HALF]
BAND = 128         # row width of the FIR's banded product


@functools.lru_cache(maxsize=8)
def _ls_solver_np(cfg: PhyConfig) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(M, A, i0, rows): h = M @ rx[anchor+i0 : anchor+i0+rows].

    Model: rx[anchor + i] = Σ_k h[k]·s[i + K0 - k], where s is the transmit
    waveform aligned so s[0] = preamble[0] at the anchor, and the N_CH
    samples before the preamble are silence.  The silent lead-in adds rows
    (the 4B5B preamble alone has fewer samples than there are taps) and
    pins the direct path's delay.  M folds the ridge-regularized normal
    equations into one [N_CH, rows] constant; A reproduces the fit for the
    residual.  Host float64, returned as float32."""
    pre = np.asarray(line_coding.preamble_waveform(cfg), np.float64)
    p = len(pre)
    s_ext = np.concatenate([np.zeros(N_CH), pre])   # s[j] = s_ext[j+N_CH]
    i_min = -K0 - 1
    i_max = p - K0 - 1
    rows = i_max - i_min + 1
    a = np.zeros((rows, N_CH), np.float64)
    for r in range(rows):
        for k in range(N_CH):
            a[r, k] = s_ext[i_min + r + K0 - k + N_CH]
    ata = a.T @ a + 1e-4 * np.eye(N_CH)
    m = np.linalg.solve(ata, a.T)
    return m.astype(np.float32), a.astype(np.float32), i_min, rows


@functools.lru_cache(maxsize=8)
def _ls_mats(cfg: PhyConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Mᵀ, Aᵀ) of :func:`_ls_solver_np` on `device`, copied once: a copy
    from the host waits for every kernel queued before it."""
    m, a, _, _ = _ls_solver_np(cfg)
    return (torch.from_numpy(m.T.copy()).to(device),
            torch.from_numpy(a.T.copy()).to(device))


def estimate_channel(cfg: PhyConfig, rx: torch.Tensor, anchors: torch.Tensor):
    """(h f32[B, A, N_CH], lam f32[B, A]): the LS channel taps at each
    anchor int32[B, A] of the captures rx f32[B, T], and the fit's
    residual-to-signal ratio clipped to [1e-4, 1], the MMSE noise loading.

    The capture is front-padded with K0+1 zeros, so that an anchor within
    K0+1 samples of its start still aligns its window: those zeros are the
    silence at the capture's boundary.  The window is one index gather of
    `rows` samples from max(anchor + i0 + K0+1, 0) of the padded capture,
    reading 0 past its end."""
    _, _, i0, rows = _ls_solver_np(cfg)
    m_t, a_t = _ls_mats(cfg, rx.device)
    b, t = rx.shape
    pad0 = K0 + 1                                       # -i0
    xp = torch.nn.functional.pad(rx, (pad0, 0))
    start = (anchors.to(torch.int64) + (i0 + pad0)).clamp(min=0)
    idx = start[..., None] + torch.arange(rows, device=rx.device)
    win = torch.gather(xp, 1, idx.clamp(max=t + pad0 - 1).reshape(b, -1))
    win = torch.where(idx < t + pad0, win.reshape(idx.shape), 0.0)
    h = matmul_f32(win, m_t)                            # [B, A, N_CH]
    fit = matmul_f32(h, a_t)                            # [B, A, rows]
    res = ((fit - win) ** 2).mean(-1)
    sig = (win ** 2).mean(-1).clamp(min=1e-12)
    return h, (res / sig).clamp(1e-4, 1.0)


def _mmse_taps(h: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Two-sided equalizer FIR g_t f32[..., 2·L_HALF+1] over lags
    [-L_HALF, L_HALF] from the frequency-domain MMSE inverse of h[..., N_CH]."""
    hf = torch.fft.rfft(h, n=N_FFT)
    g = hf.conj() / (hf.abs() ** 2 + lam[..., None])
    g_full = torch.fft.irfft(g, n=N_FFT)
    lags = torch.arange(-L_HALF, L_HALF + 1, device=h.device) % N_FFT
    return g_full[..., lags]


def _apply_fir(rx: torch.Tensor, g_t: torch.Tensor) -> torch.Tensor:
    """eq[b, n] = Σ_lag g_t[b, lag + L_HALF]·rx[b, n - K0 - lag] for rx
    f32[B, T] and per-capture taps g_t f32[B, 2·L_HALF+1].

    A banded product over 128-sample rows, grouped as the JAX package
    groups it: with xs = rx after L_HALF + K0 zeros and p = g_t reversed,
    eq[128i + c] = Σ_d p[d]·xs[128i + c + d], d < 385, spans rows i..i+3,
    so eq's row i is Σ_s xs_row[i+s] @ band_s with
    band_s[u, c] = p[128s + u - c] inside the band, 0 outside."""
    b, t = rx.shape
    dev = rx.device
    l_gt = 2 * L_HALF + 1
    nblk = -(-t // BAND)
    nrows = nblk + 4
    pad_l = L_HALF + K0
    xs = torch.nn.functional.pad(rx, (pad_l, nrows * BAND - t - pad_l))
    xs = xs.reshape(b, nrows, BAND)
    u = torch.arange(BAND, device=dev)
    d = (BAND * torch.arange(4, device=dev))[:, None, None] + u[:, None] - u   # [4, u, c]
    p = g_t.flip(-1)
    band = torch.where((d >= 0) & (d < l_gt), p[:, d.clamp(0, l_gt - 1)], 0.0)
    eq = matmul_f32(xs[:, :nblk], band[:, 0])
    for s in range(1, 4):
        eq = eq + matmul_f32(xs[:, s:s + nblk], band[:, s])
    return eq.reshape(b, nblk * BAND)[:, :t]


def equalize_capture(cfg: PhyConfig, rx: torch.Tensor, min_quality: float = 0.5,
                     n_anchors: int = 4):
    """(rx_eq, info): the MMSE-equalized captures rx f32[T] or f32[B, T] on
    their device, a capture passing through unchanged when no anchor's
    correlation reaches `min_quality`.  info holds, per capture, the
    training anchor's `quality` (its correlation), `lam`, the taps `h`,
    whether the FIR was `applied`, and the `anchor` sample (int32).

    The peel is row-granular: a row is dropped when its maximum lies within
    a preamble length of a chosen anchor, as in the JAX package.  Of the
    `n_anchors` candidates, the one with the smallest fit residual trains:
    a mid-burst preamble's "silence" holds the previous frame's tail, which
    the fit cannot explain, so a candidate after a real gap wins."""
    x = rx.to(torch.float32)
    batched = x.ndim == 2
    xb = (x if batched else x[None]).contiguous()
    pre = line_coding.preamble_waveform(cfg)
    rowmax, rowpos = auto_xcorr_row_stats(xb, pre)
    rm = rowmax
    cands, quals = [], []
    for _ in range(n_anchors):
        j = rm.argmax(-1, keepdim=True)                 # the first maximum
        a = rowpos.gather(-1, j)
        cands.append(a)
        quals.append(rm.gather(-1, j))
        rm = torch.where((rowpos - a).abs() < len(pre), -torch.inf, rm)
    anchors = torch.cat(cands, -1)
    quals = torch.cat(quals, -1)
    hs, lams = estimate_channel(cfg, xb, anchors)
    lam_eff = torch.where(quals >= min_quality, lams, torch.inf)
    j = lam_eff.argmin(-1, keepdim=True)                # the first minimum
    h = hs.gather(1, j[..., None].expand(-1, -1, N_CH))[:, 0]
    lam, anchor, quality = (v.gather(1, j)[:, 0] for v in (lams, anchors, quals))
    eq = _apply_fir(xb, _mmse_taps(h, lam))
    use = quality >= min_quality
    out = torch.where(use[:, None], eq, xb)
    info = dict(quality=quality, lam=lam, h=h, applied=use, anchor=anchor)
    if batched:
        return out, info
    return out[0], {k: v[0] for k, v in info.items()}


def decode_capture_eq(cfg: PhyConfig, samples, local_addr: int, max_frames: int = 64,
                      device: torch.device | str | None = None) -> DecodedFrames:
    """Equalize, then decode through ``decode_capture_fast`` (the
    speculative decode, the exact scan for the rows it flags).  `samples`
    f32[T] or f32[B, T] is a tensor, which stays on its device, or a NumPy
    array, which goes to the card; `device` moves either."""
    eq, _ = equalize_capture(cfg, as_capture(samples, device))
    return decode_capture_fast(cfg, eq, local_addr, max_frames=max_frames)


# --- decision-directed refinement (captures with no clean leading preamble) ---------


def refit_channel(cfg: PhyConfig, rx: np.ndarray, frames, starts) -> tuple[np.ndarray, float]:
    """(h f32[N_CH], lam): an LS channel estimate trained on decoded frames
    instead of the preamble and the silence before it.

    Each frame is encoded again (``PhyEncoder`` on the host) and only its
    interior rows enter the fit: sample i of the frame's window counts when
    every regressor s[i + K0 - k] lies inside the known waveform, so
    nothing is assumed about what surrounds the frame.  A frame with fewer
    than 4·N_CH such rows is skipped; with none left, ValueError.  Host
    float64 NumPy, as in the JAX package; lam is the fit's
    residual-to-signal ratio clipped to [1e-4, 1]."""
    enc = PhyEncoder(cfg, device="cpu")
    a_rows, b_rows = [], []
    t = len(rx)
    rx64 = np.asarray(rx, np.float64)
    for f, p in zip(frames, starts):
        s = enc.encode_frame(f).numpy().astype(np.float64)
        n = len(s)
        i_lo = N_CH - 1 - K0            # j = i + K0 - k stays in [0, n)
        i_hi = min(n - 1 - K0, t - 1 - int(p))
        if i_hi - i_lo + 1 < 4 * N_CH:
            continue
        idx = np.arange(i_lo, i_hi + 1)
        a_rows.append(s[idx[:, None] + K0 - np.arange(N_CH)[None, :]])
        b_rows.append(rx64[int(p) + idx])
    if not a_rows:
        raise ValueError("no frame long enough to train on")
    a = np.concatenate(a_rows)
    b = np.concatenate(b_rows)
    ata = a.T @ a + 1e-4 * np.eye(N_CH)
    h = np.linalg.solve(ata, a.T @ b)
    res = float(np.mean((a @ h - b) ** 2))
    sig = max(float(np.mean(b ** 2)), 1e-12)
    lam = float(np.clip(res / sig, 1e-4, 1.0))
    return h.astype(np.float32), lam


def _mmse_taps_np(h: np.ndarray, lam: float) -> np.ndarray:
    """NumPy twin of :func:`_mmse_taps` for host-refit taps (float64 FFTs,
    returned as float32)."""
    hf = np.fft.rfft(h, n=N_FFT)
    g = np.conj(hf) / (np.abs(hf) ** 2 + lam)
    g_full = np.fft.irfft(g, n=N_FFT)
    lags = np.arange(-L_HALF, L_HALF + 1) % N_FFT
    return g_full[lags].astype(np.float32)


def _apply_taps_decode(cfg: PhyConfig, rx: torch.Tensor, g_t: torch.Tensor, local_addr: int,
                       max_frames: int) -> DecodedFrames:
    """The capture rx f32[T] through the FIR g_t f32[2·L_HALF+1]
    (:func:`_apply_fir`), then ``decode_capture_fast``."""
    eq = _apply_fir(rx[None], g_t[None])[0]
    return decode_capture_fast(cfg, eq, local_addr, max_frames=max_frames)


def decode_capture_dd(cfg: PhyConfig, samples, local_addr: int, max_frames: int = 8,
                      max_iters: int = 3,
                      device: torch.device | str | None = None) -> DecodedFrames:
    """The decision-directed equalized decode of one capture f32[T] (a
    tensor stays on its device, a NumPy array goes to the card; `device`
    moves either).

    Bootstrap: the preamble-trained decode (``decode_capture_eq``), or the
    stock exact scan (``decode_capture``) when it finds strictly more frames
    (training mid-burst can make the equalized capture worse than the raw
    one).  Then up to `max_iters` times: refit the channel on every decoded
    frame's interior (:func:`refit_channel`), equalize with the refit taps,
    decode again, and keep the result only if it finds strictly more
    frames; stop at the first that does not.  Returns the best decode.

    The starts of either bootstrap are valid refit anchors: the stock
    decode's are the direct path's arrival in the raw capture, the
    equalized decode's are aligned to the transmission; both lie within the
    fit's K0 acausal taps."""
    x = as_capture(samples, device)
    rx = x.cpu().numpy()
    best = decode_capture_eq(cfg, x, local_addr, max_frames=max_frames)
    stock = decode_capture(cfg, x, local_addr, max_frames=max_frames)
    if int(stock.count) > int(best.count):
        best = stock
    for _ in range(max_iters):
        valid = best.valid.cpu().numpy()
        if not valid.any():
            break
        frames = best.to_frames()
        starts = best.start.cpu().numpy()[valid]
        try:
            h, lam = refit_channel(cfg, rx, frames, starts)
        except ValueError:
            break
        g_t = torch.from_numpy(_mmse_taps_np(h, lam)).to(x.device)
        res = _apply_taps_decode(cfg, x, g_t, local_addr, max_frames)
        if int(res.count) <= int(best.count):
            break
        best = res
    return best
