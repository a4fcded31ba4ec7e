"""PHY frame codec (counterpart of ``trackmaker_tpu/core/framing.py``).

Byte layout: big-endian 2-byte payload length, CRC8 over the payload only,
then type/seq/src/dst, then data: ``[Len:2][CRC8:1][Type:1][Seq:1][Src:1]
[Dst:1][Data:N]``.  ``Frame`` is the host class; the batched codec works on
zero-padded ``uint8[B, 7+max_len]`` tensors with explicit per-frame lengths:
``build_frame_bytes`` serializes a batch, ``parse_header`` reads the header
fields and ``verify_frames`` adds the CRC check.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.config import (
    FRAME_TYPE_ACK,
    FRAME_TYPE_DATA,
    PHY_HEADER_BYTES,
)

__all__ = [
    "Frame",
    "build_frame_bytes",
    "parse_header",
    "verify_frames",
    "FRAME_TYPE_DATA",
    "FRAME_TYPE_ACK",
    "PHY_HEADER_BYTES",
]


@dataclass
class Frame:
    """Host-side PHY frame."""

    frame_type: int
    sequence: int
    src: int
    dst: int
    data: bytes = field(default=b"")

    @classmethod
    def new_data(cls, sequence: int, src: int, dst: int, data: bytes) -> "Frame":
        return cls(FRAME_TYPE_DATA, sequence, src, dst, bytes(data))

    @classmethod
    def new_ack(cls, sequence: int, src: int, dst: int, data: bytes = b"") -> "Frame":
        return cls(FRAME_TYPE_ACK, sequence, src, dst, bytes(data))

    def to_bytes(self) -> bytes:
        n = len(self.data)
        hdr = bytes([
            (n >> 8) & 0xFF,
            n & 0xFF,
            bitops.crc8_host(self.data),
            self.frame_type & 0xFF,
            self.sequence & 0xFF,
            self.src & 0xFF,
            self.dst & 0xFF,
        ])
        return hdr + self.data

    def to_bits(self) -> np.ndarray:
        """The frame's bytes as uint8 bits, MSB first."""
        return bitops.bytes_to_bits_host(self.to_bytes())

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Frame | None":
        """Parse and validate; None on a bad type, short buffer or CRC."""
        if len(raw) < PHY_HEADER_BYTES:
            return None
        n = (raw[0] << 8) | raw[1]
        crc, ftype, seq, src, dst = raw[2], raw[3], raw[4], raw[5], raw[6]
        if ftype not in (FRAME_TYPE_DATA, FRAME_TYPE_ACK):
            return None
        if len(raw) < PHY_HEADER_BYTES + n:
            return None
        data = raw[PHY_HEADER_BYTES:PHY_HEADER_BYTES + n]
        if bitops.crc8_host(data) != crc:
            return None
        return cls(ftype, seq, src, dst, data)

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "Frame | None":
        """Parse uint8 bits, MSB first (a trailing partial byte is
        zero-padded); None where :meth:`from_bytes` gives None."""
        return cls.from_bytes(bitops.bits_to_bytes_host(bits).tobytes())


def parse_header(frame_bytes: torch.Tensor) -> dict[str, torch.Tensor]:
    """Header fields of uint8[..., >=7] frame byte tensors, as int32.

    `type_valid` is True for the DATA and ACK frame types.
    """
    fb = frame_bytes[..., :PHY_HEADER_BYTES].to(torch.int32)
    ftype = fb[..., 3]
    return {
        "length": fb[..., 0] * 256 + fb[..., 1],
        "crc": fb[..., 2],
        "frame_type": ftype,
        "sequence": fb[..., 4],
        "src": fb[..., 5],
        "dst": fb[..., 6],
        "type_valid": (ftype == FRAME_TYPE_DATA) | (ftype == FRAME_TYPE_ACK),
    }


def build_frame_bytes(
    payload: torch.Tensor,      # uint8[B, max_len] zero-padded payloads
    length: torch.Tensor,       # int[B] true payload lengths
    frame_type: torch.Tensor,   # int[B]
    sequence: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Serialize a batch of frames -> uint8[B, 7+max_len] (zero-padded).

    Bytes past 7+length are zero; callers carry `length` alongside.  The
    header holds each field's low byte (the length's low 16 bits); a length
    past max_len takes the CRC of the whole row.
    """
    payload = payload.to(torch.uint8)
    max_len = payload.shape[-1]
    length = length.to(torch.int32)
    crc = bitops.crc8(payload, length.clamp(0, max_len))
    col = torch.arange(max_len, dtype=torch.int32, device=payload.device)
    masked = torch.where(col[None, :] < length[:, None], payload, 0)
    hdr = torch.stack([
        (length >> 8).to(torch.uint8),
        (length & 0xFF).to(torch.uint8),
        crc,
        frame_type.to(torch.uint8),
        sequence.to(torch.uint8),
        src.to(torch.uint8),
        dst.to(torch.uint8),
    ], dim=-1)
    return torch.cat([hdr, masked], dim=-1)


def verify_frames(frame_bytes: torch.Tensor) -> dict[str, torch.Tensor]:
    """Header parse and CRC check of a batch of frame byte tensors
    uint8[B, 7+max_len].

    `crc_ok` holds where the CRC8 of payload[0:length] (the length clipped to
    max_len) equals the header's and the type is valid; callers combine it
    with their own length and destination checks.
    """
    hdr = parse_header(frame_bytes)
    payload = frame_bytes[..., PHY_HEADER_BYTES:]
    length = hdr["length"].clamp(0, payload.shape[-1])
    crc = bitops.crc8(payload, length)
    hdr["crc_ok"] = (crc.to(torch.int32) == hdr["crc"]) & hdr["type_valid"]
    return hdr
