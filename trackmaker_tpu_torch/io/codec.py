"""Audio file loading: WAV (stdlib) and FLAC (the port's native runtime
decoder; counterpart of ``trackmaker_tpu/io/codec.py``).

A FLAC file needs the runtime's shared library (``runtime/``, built with
g++ at first use); a failed build raises, there is no NumPy stand-in.
"""

from __future__ import annotations

import pathlib

import numpy as np

from trackmaker_tpu_torch.io.wav import read_wav


def decode_flac_to_f32(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """-> (f32[C, N] in [-1,1], sample_rate) via the C++ decoder."""
    from trackmaker_tpu_torch import runtime
    data = pathlib.Path(path).read_bytes()
    return runtime.flac_decode(data)


def load_audio(path: str | pathlib.Path,
               mono: bool = True) -> tuple[np.ndarray, int]:
    """Load WAV or FLAC; optionally average down to mono f32[N]."""
    p = pathlib.Path(path)
    if p.suffix.lower() == ".flac":
        samples, sr = decode_flac_to_f32(p)
    else:
        samples, sr = read_wav(p)
    if mono and samples.ndim == 2:
        samples = samples.mean(axis=0)
    return samples.astype(np.float32), sr
