"""IPv4 header codec (reference src/net/ip.rs; counterpart of
``trackmaker_tpu/net/ip.py``)."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

IP_HEADER_BYTES = 20
_FMT = ">BBHHHBBH4s4s"


def ones_complement_sum(data: bytes) -> int:
    """16-bit ones-complement sum with end-around carry (RFC 1071).
    Odd-length data is padded with a trailing zero byte (big-endian)."""
    if len(data) % 2:
        data = data + b"\x00"
    total = 0
    for i in range(0, len(data), 2):
        total += (data[i] << 8) | data[i + 1]
    while total >> 16:
        total = (total & 0xFFFF) + (total >> 16)
    return total


def checksum(data: bytes) -> int:
    return (~ones_complement_sum(data)) & 0xFFFF


@dataclass
class Ipv4Header:
    version_ihl: int = 0x45
    tos: int = 0
    total_length: int = IP_HEADER_BYTES
    identification: int = 0
    flags_fragment_offset: int = 0
    ttl: int = 64
    protocol: int = 0
    checksum: int = 0
    source_ip: bytes = field(default=b"\x00" * 4)
    dest_ip: bytes = field(default=b"\x00" * 4)

    @classmethod
    def new(cls, total_length: int, identification: int, ttl: int,
            protocol: int, source_ip: bytes, dest_ip: bytes) -> "Ipv4Header":
        h = cls(0x45, 0, total_length, identification, 0, ttl, protocol, 0,
                bytes(source_ip), bytes(dest_ip))
        h.checksum = h.calculate_checksum()
        return h

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Ipv4Header":
        if len(raw) < IP_HEADER_BYTES:
            raise ValueError("IPv4 header too short")
        f = struct.unpack(_FMT, raw[:IP_HEADER_BYTES])
        return cls(*f)

    def to_bytes(self) -> bytes:
        return struct.pack(
            _FMT, self.version_ihl, self.tos, self.total_length,
            self.identification, self.flags_fragment_offset, self.ttl,
            self.protocol, self.checksum, bytes(self.source_ip),
            bytes(self.dest_ip))

    def calculate_checksum(self) -> int:
        tmp = Ipv4Header(**{**self.__dict__, "checksum": 0})
        return checksum(tmp.to_bytes())

    @property
    def ihl_bytes(self) -> int:
        return (self.version_ihl & 0x0F) * 4


def build_ipv4_packet(protocol: int, source_ip: bytes, dest_ip: bytes,
                      payload: bytes, identification: int = 0,
                      ttl: int = 64) -> bytes:
    hdr = Ipv4Header.new(IP_HEADER_BYTES + len(payload), identification,
                         ttl, protocol, source_ip, dest_ip)
    return hdr.to_bytes() + payload


def recompute_header_checksum(packet: bytes) -> bytes:
    """Zero + recompute the IPv4 header checksum in place (the TUN inbound
    path's fix-up, src/net/tun.rs:227-241)."""
    ihl = (packet[0] & 0x0F) * 4
    buf = bytearray(packet)
    buf[10:12] = b"\x00\x00"
    buf[10:12] = checksum(bytes(buf[:ihl])).to_bytes(2, "big")
    return bytes(buf)
