"""PHY encoder: frames -> 48 kHz waveforms (counterpart of ``trackmaker_tpu/phy/encoder.py``).

A waveform is the preamble followed by the line-coded frame bits; frames
in a track are joined with silence gaps.  Equal-length frames encode as
one batch.  ``PhyEncoder`` makes its waveforms on the device it is given,
the card unless the caller asks for another.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import line_coding


def encode_frame_bytes(cfg: PhyConfig, frame_bytes: torch.Tensor) -> torch.Tensor:
    """uint8[B, NB] serialized frames -> f32[B, preamble + samples(NB*8)].

    Every frame of the batch has the same byte length NB (header + payload).
    """
    body = line_coding.encode(cfg, bitops.unpack_bits(frame_bytes))
    pre = torch.from_numpy(line_coding.preamble_waveform(cfg)).to(body.device)
    return torch.cat([pre.expand(*body.shape[:-1], pre.shape[-1]), body], dim=-1)


class PhyEncoder:
    """Host facade: frames in, f32 waveform tensors on `device` out."""

    def __init__(self, cfg: PhyConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.preamble = line_coding.preamble_waveform(cfg)

    @property
    def preamble_len(self) -> int:
        return len(self.preamble)

    def _check(self, frame: Frame) -> None:
        # The decoder accepts bodies up to max_frame_bytes (twice the
        # nominal payload size); a longer payload would encode but never
        # decode, so refuse it here.
        if len(frame.data) > self.cfg.max_frame_bytes:
            raise ValueError(
                f"frame payload {len(frame.data)} B exceeds the decoder "
                f"body cap max_frame_bytes={self.cfg.max_frame_bytes}")

    def encode_frame(self, frame: Frame) -> torch.Tensor:
        self._check(frame)
        raw = torch.frombuffer(bytearray(frame.to_bytes()), dtype=torch.uint8)
        return encode_frame_bytes(self.cfg, raw[None].to(self.device))[0]

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int | None = None) -> torch.Tensor:
        """Serialize frames with `gap_samples` of silence between them."""
        gap = (self.cfg.inter_frame_gap_samples
               if gap_samples is None else gap_samples)
        if not frames:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        for f in frames:
            self._check(f)
        raws = [np.frombuffer(f.to_bytes(), dtype=np.uint8) for f in frames]
        by_len: dict[int, list[int]] = {}
        for i, r in enumerate(raws):
            by_len.setdefault(len(r), []).append(i)
        waves: dict[int, torch.Tensor] = {}
        for idxs in by_len.values():
            batch = torch.from_numpy(np.stack([raws[i] for i in idxs])).to(self.device)
            out = encode_frame_bytes(self.cfg, batch)
            for row, i in enumerate(idxs):
                waves[i] = out[row]
        silence = torch.zeros(gap, dtype=torch.float32, device=self.device)
        parts = []
        for i in range(len(frames)):
            parts.append(waves[i])
            if i < len(frames) - 1:
                parts.append(silence)
        return torch.cat(parts)
