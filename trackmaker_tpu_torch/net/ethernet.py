"""Ethernet II + ARP packet codecs (for the router's pcap-style ports;
the reference uses etherparse — src/net/router.rs:623-722; counterpart of
``trackmaker_tpu/net/ethernet.py``)."""

from __future__ import annotations

import struct
from dataclasses import dataclass

ETHERTYPE_IPV4 = 0x0800
ETHERTYPE_ARP = 0x0806
BROADCAST_MAC = b"\xff" * 6

ARP_REQUEST = 1
ARP_REPLY = 2


@dataclass
class EthernetFrame:
    dst_mac: bytes
    src_mac: bytes
    ethertype: int
    payload: bytes

    @classmethod
    def from_bytes(cls, raw: bytes) -> "EthernetFrame":
        if len(raw) < 14:
            raise ValueError("ethernet frame too short")
        dst, src = raw[0:6], raw[6:12]
        et = int.from_bytes(raw[12:14], "big")
        return cls(bytes(dst), bytes(src), et, bytes(raw[14:]))

    def to_bytes(self) -> bytes:
        return (bytes(self.dst_mac) + bytes(self.src_mac)
                + self.ethertype.to_bytes(2, "big") + self.payload)


@dataclass
class ArpPacket:
    opcode: int
    sender_mac: bytes
    sender_ip: bytes
    target_mac: bytes
    target_ip: bytes

    @classmethod
    def request(cls, sender_mac: bytes, sender_ip: bytes,
                target_ip: bytes) -> "ArpPacket":
        return cls(ARP_REQUEST, sender_mac, sender_ip, b"\x00" * 6,
                   target_ip)

    @classmethod
    def reply(cls, sender_mac: bytes, sender_ip: bytes,
              target_mac: bytes, target_ip: bytes) -> "ArpPacket":
        return cls(ARP_REPLY, sender_mac, sender_ip, target_mac, target_ip)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ArpPacket":
        if len(raw) < 28:
            raise ValueError("arp packet too short")
        htype, ptype, hlen, plen, op = struct.unpack(">HHBBH", raw[:8])
        if htype != 1 or ptype != ETHERTYPE_IPV4 or hlen != 6 or plen != 4:
            raise ValueError("unsupported arp packet")
        return cls(op, bytes(raw[8:14]), bytes(raw[14:18]),
                   bytes(raw[18:24]), bytes(raw[24:28]))

    def to_bytes(self) -> bytes:
        return (struct.pack(">HHBBH", 1, ETHERTYPE_IPV4, 6, 4, self.opcode)
                + bytes(self.sender_mac) + bytes(self.sender_ip)
                + bytes(self.target_mac) + bytes(self.target_ip))

    def to_ethernet(self, dst_mac: bytes | None = None) -> bytes:
        dst = dst_mac if dst_mac is not None else (
            BROADCAST_MAC if self.opcode == ARP_REQUEST else self.target_mac)
        return EthernetFrame(dst, self.sender_mac, ETHERTYPE_ARP,
                             self.to_bytes()).to_bytes()
