"""PHY frame codec (counterpart of ``trackmaker_tpu/core/framing.py``).

Byte layout: big-endian 2-byte payload length, CRC8 over the payload only,
then type/seq/src/dst, then data: ``[Len:2][CRC8:1][Type:1][Seq:1][Src:1]
[Dst:1][Data:N]``.  ``Frame`` is the host class; ``parse_header`` reads the
header fields of a batch of decoded frame byte tensors.
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
