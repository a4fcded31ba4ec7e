"""Offline signal inspection (counterpart of ``trackmaker_tpu/bench/viz.py``):
waveform / FFT / spectrogram dashboards of captures and JSON dumps, drawn
with matplotlib, which the functions import when they run."""

from __future__ import annotations

import pathlib

import numpy as np


def _load(source) -> tuple[np.ndarray, int]:
    if isinstance(source, (str, pathlib.Path)):
        p = pathlib.Path(source)
        if p.suffix == ".json":
            from trackmaker_tpu_torch.io import load_json
            a = load_json(p)
            return a.audio_data, a.sample_rate
        from trackmaker_tpu_torch.io import load_audio
        return load_audio(p)
    samples, sr = source
    return np.asarray(samples, np.float32), sr


def spectrogram(samples: np.ndarray, sample_rate: int, nfft: int = 512,
                hop: int = 256) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Simple STFT magnitude (dB): -> (freqs, times, S[db])."""
    n = (len(samples) - nfft) // hop + 1
    win = np.hanning(nfft).astype(np.float32)
    frames = np.stack([samples[i * hop: i * hop + nfft] * win
                       for i in range(max(n, 0))])
    spec = np.abs(np.fft.rfft(frames, axis=-1))
    sdb = 20.0 * np.log10(np.maximum(spec, 1e-9)).T
    freqs = np.fft.rfftfreq(nfft, 1.0 / sample_rate)
    times = (np.arange(max(n, 0)) * hop + nfft / 2) / sample_rate
    return freqs, times, sdb


def plot_dashboard(source, out_png: str | pathlib.Path,
                   title: str = "capture") -> pathlib.Path:
    """Waveform + FFT + spectrogram panel -> PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples, sr = _load(source)
    t = np.arange(len(samples)) / sr

    fig, axes = plt.subplots(3, 1, figsize=(12, 9))
    axes[0].plot(t, samples, lw=0.3)
    axes[0].set_title(f"{title} — waveform ({len(samples)} samples @ {sr} Hz)")
    axes[0].set_xlabel("s")

    spec = np.abs(np.fft.rfft(samples))
    freqs = np.fft.rfftfreq(len(samples), 1.0 / sr)
    axes[1].semilogy(freqs, np.maximum(spec, 1e-9), lw=0.4)
    axes[1].set_title("spectrum")
    axes[1].set_xlabel("Hz")

    f, tt, sdb = spectrogram(samples, sr)
    if sdb.size:
        axes[2].pcolormesh(tt, f, sdb, shading="auto")
    axes[2].set_title("spectrogram (dB)")
    axes[2].set_xlabel("s")
    axes[2].set_ylabel("Hz")

    fig.tight_layout()
    out = pathlib.Path(out_png)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def plot_ber_curves(ber_results: list[dict], out_png) -> pathlib.Path:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    snr = [r["snr_db"] for r in ber_results]
    loss = [r["frame_loss_pct"] for r in ber_results]
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(snr, loss, marker="o")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("frame loss (%)")
    ax.set_title("AWGN robustness (frame loss vs SNR)")
    ax.grid(True, alpha=0.3)
    out = pathlib.Path(out_png)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
