"""Debug dumps: AudioData -> JSON / WAV (counterpart of ``trackmaker_tpu/io/dump.py``)."""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field

import numpy as np

from trackmaker_tpu_torch.io.wav import write_wav


@dataclass
class AudioData:
    sample_rate: int
    audio_data: np.ndarray
    channels: int = 1
    duration: float = field(default=0.0)

    def __post_init__(self):
        self.audio_data = np.asarray(self.audio_data, np.float32)
        if not self.duration:
            self.duration = len(self.audio_data) / self.sample_rate


def dump_to_json(path: str | pathlib.Path, audio: AudioData) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({
        "sample_rate": audio.sample_rate,
        "audio_data": audio.audio_data.tolist(),
        "duration": audio.duration,
        "channels": audio.channels,
    }))


def load_json(path: str | pathlib.Path) -> AudioData:
    d = json.loads(pathlib.Path(path).read_text())
    return AudioData(d["sample_rate"], np.asarray(d["audio_data"],
                                                  np.float32),
                     d.get("channels", 1), d.get("duration", 0.0))


def dump_to_wav(path: str | pathlib.Path, audio: AudioData) -> None:
    write_wav(path, audio.audio_data, audio.sample_rate)
