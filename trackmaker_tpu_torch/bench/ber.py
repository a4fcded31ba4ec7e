"""AWGN and clock-offset robustness sweeps (counterpart of ``trackmaker_tpu/bench/ber.py``).

Each sweep encodes one capture of frames with seeded random payloads,
corrupts it once for every point of the sweep, decodes all the corrupted
captures as one batch (``decode_capture_fast``) and scores each against
the payloads sent.  Lost frames, not bit errors, are what the CRC lets
through, so frame loss is the metric that counts.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import PHY_HEADER_BYTES, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.dsp import channel
from trackmaker_tpu_torch.phy.coded import CodedFourB5BPhy, CodedManchesterPhy
from trackmaker_tpu_torch.phy.decoder import DecodedFrames, decode_capture_fast
from trackmaker_tpu_torch.phy.encoder import PhyEncoder


def _build_capture(cfg: PhyConfig, n_frames: int, payload_len: int, seed: int,
                   device: torch.device | str):
    """(payloads uint8[n_frames, payload_len], the capture f32[T] on
    `device`): frames with sequence numbers 0.. from 1 to 2, 240 samples of
    silence between them."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, payload_len), dtype=np.uint8)
    frames = [Frame.new_data(i & 0xFF, 1, 2, payloads[i].tobytes()) for i in range(n_frames)]
    wave = PhyEncoder(cfg, device=device).encode_frames(frames, gap_samples=240)
    return payloads, wave


def _score(res: DecodedFrames, payloads: np.ndarray) -> tuple[int, int, int]:
    """(bit errors, decoded frames, compared bits) of one capture's decode:
    each valid frame is matched to the frame sent by its sequence number."""
    n_frames, payload_len = payloads.shape
    valid = res.valid.cpu().numpy()
    seqs = res.sequence.cpu().numpy()
    fb = res.frame_bytes.cpu().numpy()
    bit_err = 0
    decoded = 0
    for k in np.nonzero(valid)[0]:
        s = seqs[k]
        if s >= n_frames:
            continue
        got = fb[k, PHY_HEADER_BYTES:PHY_HEADER_BYTES + payload_len]
        bit_err += int(np.unpackbits(got ^ payloads[s]).sum())
        decoded += 1
    return bit_err, decoded, decoded * payload_len * 8


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _decode_rows(cfg: PhyConfig, noisy: torch.Tensor, n_frames: int) -> list[DecodedFrames]:
    res = decode_capture_fast(cfg, noisy, 2, max_frames=n_frames + 8)
    return [DecodedFrames(*(f[r] for f in res)) for r in range(noisy.shape[0])]


def _ber_batch(cfg: PhyConfig, snr_dbs, n_frames: int, payload_len: int, seed: int,
               device: torch.device | str):
    """(payloads, the noisy captures f32[len(snr_dbs), T]) of :func:`ber_sweep`."""
    payloads, wave = _build_capture(cfg, n_frames, payload_len, seed, device)
    return payloads, torch.stack([
        channel.awgn(wave, float(snr), _generator(seed * 1000 + i, wave.device))
        for i, snr in enumerate(snr_dbs)])


def _clock_batch(cfg: PhyConfig, ppms, n_frames: int, payload_len: int, snr_db: float,
                 seed: int, device: torch.device | str):
    """(payloads, the skewed noisy captures f32[len(ppms), T]) of
    :func:`clock_offset_sweep`."""
    payloads, wave = _build_capture(cfg, n_frames, payload_len, seed, device)
    return payloads, torch.stack([
        channel.awgn(channel.clock_offset(wave, float(ppm)), snr_db, _generator(seed, wave.device))
        for ppm in ppms])


def ber_sweep(cfg: PhyConfig | None = None, snr_dbs=(-2, 0, 2, 4, 6, 8, 10, 15),
              n_frames: int = 32, payload_len: int = 64, seed: int = 0,
              device: torch.device | str = "cuda") -> list[dict]:
    """Frame loss and bit error rate against SNR on the line-coded PHY.  The
    noise of point i comes from a ``torch.Generator`` seeded seed·1000 + i."""
    cfg = cfg or PhyConfig()
    payloads, noisy = _ber_batch(cfg, snr_dbs, n_frames, payload_len, seed, device)
    results = []
    for snr, res in zip(snr_dbs, _decode_rows(cfg, noisy, n_frames)):
        bit_err, decoded, bits = _score(res, payloads)
        results.append({
            "snr_db": float(snr),
            "frames_sent": n_frames,
            "frames_decoded": decoded,
            "frame_loss_pct": 100.0 * (n_frames - decoded) / n_frames,
            "payload_bit_errors": bit_err,
            "ber": bit_err / bits if bits else None,
        })
    return results


def coded_ber_sweep(snr_dbs=(-8, -6, -4, -2, 0, 2, 4, 6), n_frames: int = 16,
                    payload_len: int = 64, seed: int = 0, line_coding: str = "manchester",
                    rate34: bool = False, device: torch.device | str = "cuda") -> list[dict]:
    """Frame loss against SNR of the Viterbi-coded PHY (``phy/coded.py``) and
    of the uncoded decoder at the same detection threshold, 0.45 for both,
    so that the sweep measures the code and not the correlator.
    `line_coding` picks the waveform (manchester or 4b5b), `rate34`
    punctures to rate 3/4.

    Point i draws from ``np.random.default_rng(seed·1000 + i)`` the uncoded
    capture's noise, then the coded one's (its waveform and 4,000 samples of
    silence), as the JAX package does; the signal power is the mean square
    of the uncoded waveform's nonzero samples.  The uncoded captures decode
    as one batch (``decode_capture_fast``, frame for frame the exact scan's
    ``decode_capture``), each coded one in one ``process_samples`` call of a
    new stream."""
    cfg = PhyConfig(line_coding=line_coding, correlation_threshold=0.45)
    phy_cls = CodedManchesterPhy if line_coding == "manchester" else CodedFourB5BPhy
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, payload_len), dtype=np.uint8)
    frames = [Frame.new_data(i & 0xFF, 1, 2, payloads[i].tobytes()) for i in range(n_frames)]
    wave_u = PhyEncoder(cfg, device=device).encode_frames(frames, gap_samples=240).cpu().numpy()
    phy = phy_cls(cfg, local_addr=2, rate34=rate34, device=device)
    wave_c = phy.encode_frames(frames, gap_samples=240)
    sig_pow = float(np.mean(np.square(wave_u[np.abs(wave_u) > 0])))
    noisy_u, noisy_c = [], []
    for i, snr in enumerate(snr_dbs):
        sigma = float(np.sqrt(sig_pow / (10.0 ** (snr / 10.0))))
        r = np.random.default_rng(seed * 1000 + i)
        noisy_u.append(wave_u + r.normal(0, sigma, len(wave_u)).astype(np.float32))
        cap = np.concatenate([wave_c, np.zeros(4000, np.float32)])
        noisy_c.append(cap + r.normal(0, sigma, len(cap)).astype(np.float32))
    x = torch.from_numpy(np.stack(noisy_u)).to(phy.device)
    results = []
    for snr, res, cap in zip(snr_dbs, _decode_rows(cfg, x, n_frames), noisy_c):
        _, dec_u, _ = _score(res, payloads)
        phy.reset()
        dec_c = sum(1 for f in phy.process_samples(cap)
                    if f.sequence < n_frames and f.data == payloads[f.sequence].tobytes())
        results.append({
            "snr_db": float(snr),
            "frames_sent": n_frames,
            "uncoded_loss_pct": 100.0 * (n_frames - dec_u) / n_frames,
            "coded_loss_pct": 100.0 * (n_frames - dec_c) / n_frames,
        })
    return results


def clock_offset_sweep(cfg: PhyConfig | None = None,
                       ppms=(0, 50, 100, 200, 500, 1000, 2000, 5000),
                       n_frames: int = 32, payload_len: int = 64, snr_db: float = 20.0,
                       seed: int = 0, device: torch.device | str = "cuda") -> list[dict]:
    """Frame loss against the sample-clock mismatch of sender and receiver,
    at `snr_db`; every point's noise comes from a ``torch.Generator`` seeded
    `seed`."""
    cfg = cfg or PhyConfig()
    payloads, noisy = _clock_batch(cfg, ppms, n_frames, payload_len, snr_db, seed, device)
    results = []
    for ppm, res in zip(ppms, _decode_rows(cfg, noisy, n_frames)):
        _, decoded, _ = _score(res, payloads)
        results.append({
            "clock_ppm": float(ppm),
            "frames_sent": n_frames,
            "frames_decoded": decoded,
            "frame_loss_pct": 100.0 * (n_frames - decoded) / n_frames,
        })
    return results
