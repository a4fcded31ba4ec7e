"""Streaming decode pipeline (counterpart of ``trackmaker_tpu/link/stream.py``).

Live capture arrives in chunks; an energy-gated segmenter on the host finds
the bursts that have closed, and only those, zero-padded to power-of-two
buckets, go to the card's batch decoder.  Sparse channels (the common case:
under CSMA the medium is mostly silent) ship a small share of their samples.

A segment makes one host-to-device copy (its padded samples, with the true
length in one more slot: float32 holds every bucket length exactly) and one
device-to-host copy (a uint8 pack of every slot's frame bytes, valid flag,
length and the decode's ``ok``).  A segment whose pack is not ``ok`` is
decoded again through ``decode_capture_fast``.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import PHY_HEADER_BYTES, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import spec_decode
from trackmaker_tpu_torch.phy.decoder import PhyDecoder, decode_capture_fast


def active_regions(x: np.ndarray, threshold: float, hang: int,
                   halo: int) -> np.ndarray:
    """int64[k, 2] (start, end) regions of x where |x| > threshold.

    Hot samples more than `hang` apart split a burst; each burst is widened
    by `halo` samples on both sides (clipped to x), and regions that then
    overlap or touch merge."""
    idx = np.nonzero(np.abs(x) > threshold)[0]
    if len(idx) == 0:
        return np.zeros((0, 2), np.int64)
    splits = np.nonzero(np.diff(idx) > hang)[0]
    starts = np.concatenate([[idx[0]], idx[splits + 1]])
    ends = np.concatenate([idx[splits], [idx[-1]]]) + 1
    out = np.stack([np.maximum(starts - halo, 0),
                    np.minimum(ends + halo, len(x))], axis=1)
    merged = [out[0].tolist()]
    for s, e in out[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    return np.asarray(merged, np.int64)


def padded_segment(seg: np.ndarray) -> np.ndarray:
    """f32[b + 1]: `seg` zero-padded to its power-of-two bucket b of at
    least 4,096 samples, with its length in the last slot."""
    b = PhyDecoder._bucket(len(seg))
    xn = np.zeros(b + 1, np.float32)
    xn[:len(seg)] = seg
    xn[b] = len(seg)
    return xn


def packed_decode(cfg: PhyConfig, xn: torch.Tensor, local_addr: int,
                  max_frames: int) -> torch.Tensor:
    """The speculative decode of one padded segment xn f32[b + 1] (samples
    in [:b], the true length in [b]), packed for one readback.

    Returns uint8[max_frames, 263 + 4], a row a slot: the frame bytes
    (header and payload, zero-padded), the valid flag, the payload length's
    low and high bytes, and the decode's ``ok`` flag (the same in every
    row)."""
    x, vlen = xn[None, :-1], xn[-1:].to(torch.int32)
    res, ok = spec_decode.decode_capture_spec(cfg, x, local_addr, max_frames=max_frames,
                                              valid_len=vlen)
    k = res.frame_bytes.shape[1]
    ln = res.length[0]
    cols = [res.valid[0], ln & 0xFF, (ln >> 8) & 0xFF, ok.expand(k)]
    return torch.cat([res.frame_bytes[0]]
                     + [c.to(torch.uint8)[:, None] for c in cols], dim=1)


def parse_packed(arr: np.ndarray) -> tuple[bool, list[Frame]]:
    """(ok, frames) of a :func:`packed_decode` result read back to the host."""
    cap = arr.shape[1] - 4
    if not arr[0, cap + 3]:
        return False, []
    out = []
    for row in arr:
        if not row[cap]:
            continue
        ln = int(row[cap + 1]) | (int(row[cap + 2]) << 8)
        f = Frame.from_bytes(row[: PHY_HEADER_BYTES + ln].tobytes())
        assert f is not None
        out.append(f)
    return True, out


class StreamingDecodePipeline:
    """Chunks in, frames of closed bursts out, decoded on `device` (the
    card unless the caller asks for another)."""

    def __init__(self, cfg: PhyConfig, local_addr: int,
                 energy_threshold: float = 0.05,
                 max_frames_per_segment: int = 32,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.local_addr = local_addr
        self.threshold = energy_threshold
        self.max_frames = max_frames_per_segment
        self.device = torch.device(device)
        # hang: how much quiet ends a burst; halo: context kept around it
        self.hang = cfg.preamble_len + cfg.inter_frame_gap_samples + 256
        self.halo = cfg.preamble_len + cfg.sync_margin + 8
        self._buf = np.zeros(0, np.float32)
        self.segments_decoded = 0
        self.samples_shipped = 0
        self.samples_seen = 0

    def _regions(self, x: np.ndarray) -> np.ndarray:
        return active_regions(x, self.threshold, self.hang, self.halo)

    def push(self, samples) -> list[Frame]:
        """Feed a chunk; returns frames from bursts that have *closed*
        (quiet for at least `hang` samples before the buffer tail)."""
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        self.samples_seen += len(samples)
        regions = self._regions(self._buf)
        out: list[Frame] = []
        consumed = 0
        for s, e in regions:
            if e >= len(self._buf) - self.hang:
                break  # the burst may still be growing; wait for more input
            out.extend(self._decode_segment(self._buf[s:e]))
            consumed = e
        if consumed:
            self._buf = self._buf[consumed:]
        elif len(regions) == 0 and len(self._buf) > self.hang:
            self._buf = self._buf[-self.hang:]  # drop old silence
        return out

    def flush(self) -> list[Frame]:
        """Decode whatever is buffered (end of stream)."""
        out: list[Frame] = []
        for s, e in self._regions(self._buf):
            out.extend(self._decode_segment(self._buf[s:e]))
        self._buf = np.zeros(0, np.float32)
        return out

    def _decode_segment(self, seg: np.ndarray) -> list[Frame]:
        # Segments are closed bursts (a quiet tail of at least `hang`), so
        # the halo keeps every frame inside the padded bucket and no cursor
        # is needed.
        n = len(seg)
        xn = torch.from_numpy(padded_segment(seg)).to(self.device)
        b = xn.shape[0] - 1
        self.segments_decoded += 1
        self.samples_shipped += b
        if spec_decode.spec_supported_cfg(self.cfg):
            arr = packed_decode(self.cfg, xn, self.local_addr, self.max_frames).cpu().numpy()
            ok, frames = parse_packed(arr)
            if ok:
                return frames
        res = decode_capture_fast(self.cfg, xn[:b], self.local_addr,
                                  max_frames=self.max_frames, valid_len=n)
        return res.to_frames()
