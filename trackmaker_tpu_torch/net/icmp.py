"""ICMP echo codec (reference src/net/icmp.rs; counterpart of
``trackmaker_tpu/net/icmp.py``)."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from trackmaker_tpu_torch.net.ip import checksum

ICMP_ECHO_REPLY = 0
ICMP_ECHO_REQUEST = 8
ICMP_HEADER_BYTES = 8


@dataclass
class IcmpPacket:
    icmp_type: int
    code: int = 0
    checksum: int = 0
    identifier: int = 0
    sequence_number: int = 0
    payload: bytes = field(default=b"")

    @classmethod
    def new(cls, icmp_type: int, code: int, identifier: int,
            sequence_number: int, payload: bytes = b"") -> "IcmpPacket":
        p = cls(icmp_type, code, 0, identifier, sequence_number,
                bytes(payload))
        p.checksum = p.calculate_checksum()
        return p

    @classmethod
    def echo_request(cls, identifier: int, sequence: int,
                     payload: bytes = b"") -> "IcmpPacket":
        return cls.new(ICMP_ECHO_REQUEST, 0, identifier, sequence, payload)

    @classmethod
    def echo_reply(cls, identifier: int, sequence: int,
                   payload: bytes = b"") -> "IcmpPacket":
        return cls.new(ICMP_ECHO_REPLY, 0, identifier, sequence, payload)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "IcmpPacket":
        if len(raw) < ICMP_HEADER_BYTES:
            raise ValueError("ICMP packet too short")
        t, c, ck, ident, seq = struct.unpack(">BBHHH", raw[:8])
        return cls(t, c, ck, ident, seq, bytes(raw[8:]))

    def to_bytes(self) -> bytes:
        return struct.pack(">BBHHH", self.icmp_type, self.code,
                           self.checksum, self.identifier,
                           self.sequence_number) + self.payload

    def calculate_checksum(self) -> int:
        raw = struct.pack(">BBHHH", self.icmp_type, self.code, 0,
                          self.identifier, self.sequence_number) + self.payload
        return checksum(raw)

    def verify_checksum(self) -> bool:
        return self.calculate_checksum() == self.checksum
