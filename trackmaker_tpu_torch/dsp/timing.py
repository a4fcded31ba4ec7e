"""Sample-clock offset recovery (counterpart of ``trackmaker_tpu/dsp/timing.py``).

Cheap sound cards disagree by tens to thousands of ppm, and the line-coded
PHY tolerates about 100 ppm over a frame of the largest size (it does not
track timing inside a frame, as the reference does not).  Two decodes
recover what a skewed clock loses:

* :func:`decode_with_clock_search`: the capture resampled at a grid of
  ratios, all of them decoded as one batch by ``decode_capture_fast``, and
  the ratio with the most CRC-valid frames kept;
* :func:`decode_with_timing_gate`: the exact decode, then every correlation
  hit it could not turn into a frame retried in its own window, resampled
  at that window's own drift estimate (:func:`estimate_frame_ppm`), the
  windows decoded as one batch: frames from senders with different skews
  in one capture.

:func:`estimate_clock_ppm` reads the ppm off the starts of a regular frame
train.  Captures given as tensors stay on their device; NumPy captures go
to the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import PHY_HEADER_BYTES, PhyConfig
from trackmaker_tpu_torch.dsp.channel import clock_offset
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy.decoder import DecodedFrames, as_capture, decode_capture_fast
from trackmaker_tpu_torch.phy.spec_decode import extract_candidates
from trackmaker_tpu_torch.sync import auto_xcorr
from trackmaker_tpu_torch.sync.correlate import preamble_energy

PPM_GRID = (-2000.0, -1000.0, -500.0, 0.0, 500.0, 1000.0, 2000.0)


def decode_with_clock_search(cfg: PhyConfig, samples, local_addr: int, ppm_grid=PPM_GRID,
                             max_frames: int = 64,
                             device: torch.device | str | None = None
                             ) -> tuple[DecodedFrames, float]:
    """(the best decode, its ppm) of one capture f32[T]: the capture
    resampled by -ppm for every ppm of the grid (undoing a sender clock
    that fast) into one [len(grid), T] batch, decoded by
    ``decode_capture_fast``; the first row with the most valid frames
    wins, as ``np.argmax`` picks it."""
    x = as_capture(samples, device)
    grid = torch.tensor(ppm_grid, dtype=torch.float32, device=x.device)
    res = decode_capture_fast(cfg, clock_offset(x, -grid[:, None]), local_addr,
                              max_frames=max_frames)
    best = int(np.argmax(res.count.cpu().numpy()))
    return DecodedFrames(*(f[best] for f in res)), float(ppm_grid[best])


def estimate_frame_ppm(cfg: PhyConfig, window: torch.Tensor, n_levels: int,
                       max_shift: int = 8, segments: int = 8):
    """(ppm f32[...], weight f32[...]): the early-late timing estimate of
    frame windows f32[W] or f32[B, W], each starting at a frame body (the
    preamble stripped) laid out as `n_levels` levels of samples_per_level
    (spb) samples.

    For a level boundary j and a shift s, |mean(level j-1) - mean(level j)|
    at s peaks where s matches the local timing offset, but the level
    grating makes it periodic in spb, so the offset is seen only modulo
    spb.  The metric is summed over `segments` equal spans of boundaries,
    collapsed modulo spb (a product with the residue classes, full
    float32), and each segment's phase is the circular centroid of its spb
    residues (complex64); the phases unwrap along the frame into a
    trajectory whose weighted least-squares slope, in samples a level, is
    the drift.  All float32, every mean a true division, as in the JAX
    package.  Callers gate on the weight (the sum of the centroids'
    magnitudes) to reject windows without line-coded content."""
    spb = cfg.samples_per_level
    x = window.to(torch.float32)
    xb = x if x.ndim == 2 else x[None]
    dev = x.device
    n_s = 2 * max_shift + 1
    span = n_levels * spb
    xp = torch.nn.functional.pad(xb, (max_shift, max_shift + spb))
    # a level's mean at every sample offset j of xp: (x[j] + x[j+1] + ...) / spb
    sums = xp[:, :xp.shape[1] - spb + 1]
    for k in range(1, spb):
        sums = sums + xp[:, k:xp.shape[1] - spb + 1 + k]
    # shift s reads its levels from offset s + max_shift of xp, clamped so
    # that the `span` samples lie inside xp
    first = torch.arange(n_s, device=dev).clamp(max=xp.shape[1] - span)
    idx = first[:, None] + spb * torch.arange(n_levels, device=dev)
    lm = sums[:, idx] / spb                                     # [B, S, n_levels]
    m = (lm[..., :-1] - lm[..., 1:]).abs()                      # boundaries 1..n-1
    per_seg = -(-(n_levels - 1) // segments)
    pad = per_seg * segments - (n_levels - 1)
    mseg = torch.nn.functional.pad(m, (0, pad)).reshape(
        xb.shape[0], n_s, segments, per_seg).sum(-1)            # [B, S, segments]

    shifts = torch.arange(-max_shift, max_shift + 1, device=dev)
    onehot = (shifts.remainder(spb)[:, None] == torch.arange(spb, device=dev)).to(torch.float32)
    cnt = onehot.sum(0).clamp(min=1.0)
    mp = matmul_f32(mseg.transpose(-1, -2), onehot) / cnt      # [B, segments, spb]
    ang = 2.0 * math.pi * torch.arange(spb, dtype=torch.float32, device=dev) / spb
    z = (mp * torch.exp(1j * ang)).sum(-1)                      # complex64 [B, segments]
    phase = torch.angle(z) * spb / (2.0 * math.pi)
    w = z.abs()

    d = phase[:, 1:] - phase[:, :-1]
    d = d - spb * torch.round(d / spb)
    traj = torch.cat([phase[:, :1], phase[:, :1] + d.cumsum(-1)], -1)
    traj = traj - spb * torch.round(traj[:, :1] / spb)

    centers = (torch.arange(segments, dtype=torch.float32, device=dev) + 0.5) * per_seg
    wsum = w.sum(-1, keepdim=True).clamp(min=1e-9)
    cm = (w * centers).sum(-1, keepdim=True) / wsum
    den = (w * (centers - cm) ** 2).sum(-1).clamp(min=1e-9)
    slope = (w * (centers - cm) * traj).sum(-1) / den          # samples a level
    ppm, weight = slope / spb * 1e6, w.sum(-1)
    if x.ndim == 2:
        return ppm, weight
    return ppm[0], weight[0]


def decode_with_timing_gate(cfg: PhyConfig, samples, local_addr: int, max_frames: int = 64,
                            max_retry: int = 16, max_shift: int = 8,
                            device: torch.device | str | None = None
                            ) -> tuple[DecodedFrames, DecodedFrames]:
    """(exact, recovered) for one capture f32[T]: its decode by
    ``decode_capture_fast`` and the frames recovered by a per-frame
    early-late retry of the correlation hits that decode left.

    The hits (``auto_xcorr``'s dense correlation at the threshold) outside
    every valid frame's extent give up to `max_retry` candidates
    (``extract_candidates``: 4 a 512-sample block).  Each candidate's window
    of preamble + largest frame + 4·max_shift + 16 samples (a start past
    the zero-padded capture's end clamped, as ``jax.lax.dynamic_slice``
    clamps it) is resampled at its body's drift estimate
    (:func:`estimate_frame_ppm`), and all windows decode as one batch at
    max_frames=1.  A retry counts when its frame is valid and starts within
    2·max_shift of the window's start; of retries within 2·sync_margin of
    one already kept, the first stays.  `recovered` holds one slot a
    candidate, starts absolute.  Frames from senders with different skews
    in one capture defeat :func:`decode_with_clock_search`'s one ratio;
    here each frame gets its own.  A retried candidate inside a failed
    region decodes on its own, without the exact walk's consumption
    (CRC-gated)."""
    x = as_capture(samples, device)
    dev = x.device
    res = decode_capture_fast(cfg, x, local_addr, max_frames=max_frames)
    cand, nv, batch = _retry_batch(cfg, x, res, max_retry, max_shift)
    rec = decode_capture_fast(cfg, batch, local_addr, max_frames=1)
    rec = DecodedFrames(*(f[:, 0] for f in rec))
    ok = (rec.valid & (torch.arange(max_retry, device=dev) < nv)
          & (rec.start <= 2 * max_shift)).cpu().numpy()
    abs_start = np.where(ok, cand.cpu().numpy() + rec.start.cpu().numpy(), -1)
    # dedupe: nearby hits (within the sync margin) recover the same frame;
    # keep the first
    okh = ok.copy()
    seen: list[int] = []
    for i in range(len(okh)):
        if not okh[i]:
            continue
        if any(abs(int(abs_start[i]) - p) <= 2 * cfg.sync_margin for p in seen):
            okh[i] = False
        else:
            seen.append(int(abs_start[i]))
    recovered = rec._replace(
        valid=torch.from_numpy(okh).to(dev),
        start=torch.from_numpy(np.where(okh, abs_start, -1).astype(np.int32)).to(dev))
    return res, recovered


def _retry_batch(cfg: PhyConfig, x: torch.Tensor, res: DecodedFrames, max_retry: int,
                 max_shift: int) -> tuple[torch.Tensor, int, torch.Tensor]:
    """(candidates int32[max_retry], how many are real, the retry windows
    f32[max_retry, wlen]) of :func:`decode_with_timing_gate`: the hits of
    capture x outside `res`'s frames, each window resampled at its body's
    drift estimate."""
    dev = x.device
    pre = line_coding.preamble_waveform(cfg)
    corr = auto_xcorr(x, pre, preamble_energy(pre))
    n = corr.shape[0]
    # the extent of every valid frame, as +1/-1 steps summed along the lags
    starts = res.start[res.valid].to(torch.int64)
    ext = cfg.preamble_len + torch.tensor(
        [cfg.samples_for_bits((PHY_HEADER_BYTES + ln) * 8)
         for ln in res.length[res.valid].tolist()], dtype=torch.int64, device=dev)
    steps = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    ones = torch.ones_like(starts, dtype=torch.int32)
    steps.index_add_(0, starts.clamp(0, n), ones)
    steps.index_add_(0, (starts + ext).clamp(0, n), -ones)
    covered = steps[:n].cumsum(0) > 0
    hits = (corr >= cfg.correlation_threshold) & ~covered
    cand, n_valid, _ = extract_candidates(hits[None], max_retry)
    cand, nv = cand[0], int(n_valid[0])

    max_window = cfg.samples_for_bits((PHY_HEADER_BYTES + cfg.max_frame_bytes) * 8)
    wlen = cfg.preamble_len + max_window + 4 * max_shift + 16
    xp = torch.nn.functional.pad(x, (0, wlen + 8))
    first = cand.to(torch.int64).clamp(0, xp.shape[0] - wlen)
    win = xp[first[:, None] + torch.arange(wlen, device=dev)]          # [max_retry, wlen]
    ppm, _ = estimate_frame_ppm(cfg, win[:, cfg.preamble_len:],
                                max_window // cfg.samples_per_level, max_shift=max_shift)
    return cand, nv, clock_offset(win, ppm[:, None])


def estimate_clock_ppm(starts: np.ndarray, nominal_pitch: float) -> float:
    """The ppm of a regular frame train from its detected preamble starts:
    the median observed pitch over `nominal_pitch`, minus 1, in ppm."""
    starts = np.asarray(starts, np.float64)
    starts = starts[starts >= 0]
    if len(starts) < 2:
        return 0.0
    observed = np.median(np.diff(starts))
    return (observed / nominal_pitch - 1.0) * 1e6
