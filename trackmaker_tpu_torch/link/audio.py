"""Half-duplex audio endpoint (counterpart of ``trackmaker_tpu/link/audio.py``).

A host NumPy copy of the JAX package's module: the simulated shared audio
state of a node and its process callback's 4-state machine:
``Recording`` captures the medium into ``record_buffer``; ``Playing``
drains ``playback_buffer`` to the medium and flips to ``Idle`` when empty;
``RecordingAndPlaying`` does both; ``Idle`` does neither.  Only
``set_playback`` differs: it also takes a tensor, the port's encoder's.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class AppState(enum.Enum):
    IDLE = 0
    RECORDING = 1
    PLAYING = 2
    RECORDING_AND_PLAYING = 3


class AudioEndpoint:
    def __init__(self, name: str = ""):
        self.name = name
        self.state = AppState.IDLE
        self.record_buffer: list[np.ndarray] = []
        self._record_len = 0
        self._playback = np.zeros(0, np.float32)
        self._play_pos = 0
        self.samples_played = 0
        self.samples_recorded = 0

    # -- control surface (what the MAC manipulates) ------------------------

    def set_state(self, state: AppState) -> None:
        self.state = state

    def clear_record(self) -> None:
        self.record_buffer.clear()
        self._record_len = 0

    def record_len(self) -> int:
        return self._record_len

    def take_record(self) -> np.ndarray:
        """Drain the record buffer (receiver loop, csma.rs:456-462)."""
        if not self.record_buffer:
            return np.zeros(0, np.float32)
        out = np.concatenate(self.record_buffer)
        self.clear_record()
        return out

    def peek_record(self) -> np.ndarray:
        if not self.record_buffer:
            return np.zeros(0, np.float32)
        return np.concatenate(self.record_buffer)

    def set_playback(self, samples) -> None:
        """playback.clear() + extend (csma.rs:265-272).  `samples` is a
        NumPy waveform or a tensor, the port's encoder's on its device,
        which comes to the host in one copy."""
        if isinstance(samples, torch.Tensor):
            samples = samples.cpu().numpy()
        self._playback = np.asarray(samples, np.float32)
        self._play_pos = 0

    @property
    def playing_remaining(self) -> int:
        return len(self._playback) - self._play_pos

    # -- process callback (what the bus calls every chunk) -----------------

    def pull_playback(self, chunk: int) -> np.ndarray:
        """Next `chunk` output samples. In a playing state, drains the
        playback buffer and flips to IDLE when it runs dry (the callback's
        end-of-playback transition)."""
        if self.state not in (AppState.PLAYING,
                              AppState.RECORDING_AND_PLAYING):
            return np.zeros(chunk, np.float32)
        avail = self.playing_remaining
        n = min(chunk, avail)
        out = np.zeros(chunk, np.float32)
        out[:n] = self._playback[self._play_pos: self._play_pos + n]
        self._play_pos += n
        self.samples_played += n
        if self.playing_remaining == 0:
            self.state = (AppState.RECORDING
                          if self.state == AppState.RECORDING_AND_PLAYING
                          else AppState.IDLE)
        return out

    def push_record(self, samples: np.ndarray) -> None:
        if self.state in (AppState.RECORDING,
                          AppState.RECORDING_AND_PLAYING):
            self.record_buffer.append(np.asarray(samples, np.float32))
            self._record_len += len(samples)
            self.samples_recorded += len(samples)
