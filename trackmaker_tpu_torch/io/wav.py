"""WAV read/write, 16-bit PCM, stdlib only (counterpart of ``trackmaker_tpu/io/wav.py``).

Floats in [-1, 1] are clamped and scaled by 32767 on write; samples read
back divide by 32768 (16-bit), 128 around 128 (8-bit) or 2^31 (32-bit).
"""

from __future__ import annotations

import pathlib
import wave

import numpy as np


def write_wav(path: str | pathlib.Path, samples: np.ndarray,
              sample_rate: int = 48_000) -> None:
    """f32 [-1,1] (1-D mono or [C, N]) -> 16-bit PCM WAV."""
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[None, :]
    ch, _n = samples.shape
    clipped = np.clip(samples, -1.0, 1.0)
    ints = (clipped * 32767.0).astype("<i2")
    inter = ints.T.reshape(-1)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(p), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(inter.tobytes())


def read_wav(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """-> (f32[C, N] in [-1,1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        ch = w.getnchannels()
        sw = w.getsampwidth()
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2**31
    else:
        raise ValueError(f"unsupported sample width {sw}")
    return data.reshape(-1, ch).T, sr
