"""RFC-791-style IP fragmentation/reassembly for the acoustic MTU
(reference src/net/fragmentation.rs; counterpart of
``trackmaker_tpu/net/fragmentation.py``).

Fragments are cut on 8-byte boundaries; reassembly is keyed by
(identification, source IP), gap-checked against offsets, and splices the
stored first-seen header back on (clearing the frag fields and fixing
total_length), matching the reference behavior including its quirks
(e.g. the fragment checksum is copied from the original header —
fragmentation.rs:179-182 — and recomputed by senders downstream).
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass(frozen=True)
class FragmentationInfo:
    identification: int
    more_fragments: bool
    fragment_offset: int  # in 8-byte units

    def to_u16(self) -> int:
        value = 0x2000 if self.more_fragments else 0
        return value | (self.fragment_offset & 0x1FFF)

    @classmethod
    def from_u16(cls, value: int) -> "FragmentationInfo":
        return cls(0, bool(value & 0x2000), value & 0x1FFF)


class IpFragmenter:
    def __init__(self, mtu: int):
        self.mtu = mtu
        self._next_id = 0

    def next_identification(self) -> int:
        nid = self._next_id
        self._next_id = (self._next_id + 1) & 0xFFFF
        return nid

    def fragment_packet(self, packet: bytes) -> list[bytes]:
        if len(packet) <= self.mtu:
            return [bytes(packet)]
        if len(packet) < 20:
            raise ValueError("Invalid IP packet: too small for header")
        ihl = (packet[0] & 0x0F) * 4
        if ihl < 20 or ihl > len(packet):
            raise ValueError("Invalid IP header length")
        ip_header = packet[:20]
        options = packet[20:ihl]
        data = packet[20:]  # reference fragments from byte 20 (frag.rs:117)

        max_data = ((self.mtu - ihl) // 8) * 8
        if max_data == 0:
            raise ValueError("MTU too small for fragmentation")

        ident = self.next_identification()
        fragments: list[bytes] = []
        offset = 0
        while offset < len(data):
            chunk = data[offset: offset + max_data]
            more = offset + len(chunk) < len(data)
            frag = bytearray(ip_header)
            fo = FragmentationInfo(ident, more, offset // 8).to_u16()
            frag[6:8] = fo.to_bytes(2, "big")
            frag[2:4] = (ihl + len(chunk)).to_bytes(2, "big")
            frag[4:6] = ident.to_bytes(2, "big")
            # checksum copied from original; recomputed by the sender
            frag[10:12] = ip_header[10:12]
            if ihl > 20:
                frag.extend(options)
            frag.extend(chunk)
            fragments.append(bytes(frag))
            offset += len(chunk)
        return fragments


class IpReassembler:
    """Reassembly keyed by (identification, src IP) like the reference
    (fragmentation.rs:234-401), hardened against two leaks the reference
    shares: duplicate fragments are idempotent (first copy wins — a
    retransmitted fragment no longer wedges the gap check forever), and
    partial reassemblies expire after `timeout_s` (RFC 791's reassembly
    timer), so loss cannot grow the tables without bound."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        # key -> {offset_units: payload}
        self._fragments: dict[tuple[int, bytes], dict[int, bytes]] = {}
        self._last_seen: dict[tuple[int, bytes], bool] = {}
        self._headers: dict[tuple[int, bytes], bytes] = {}
        self._born: dict[tuple[int, bytes], float] = {}

    def _expire(self, now: float) -> None:
        dead = [k for k, t0 in self._born.items()
                if now - t0 > self.timeout_s]
        for k in dead:
            self._fragments.pop(k, None)
            self._last_seen.pop(k, None)
            self._headers.pop(k, None)
            self._born.pop(k, None)

    def process_fragment(self, packet: bytes) -> bytes | None:
        now = time.monotonic()
        self._expire(now)

        if len(packet) < 20:
            raise ValueError("fragment too small for header")
        ihl = (packet[0] & 0x0F) * 4
        if ihl < 20 or ihl > len(packet):
            raise ValueError("invalid header length in fragment")
        info = FragmentationInfo.from_u16(
            int.from_bytes(packet[6:8], "big"))
        ident = int.from_bytes(packet[4:6], "big")
        key = (ident, bytes(packet[12:16]))

        if not info.more_fragments and info.fragment_offset == 0:
            return bytes(packet)  # unfragmented

        self._headers.setdefault(key, bytes(packet[:ihl]))
        self._born.setdefault(key, now)
        self._fragments.setdefault(key, {}).setdefault(
            info.fragment_offset, bytes(packet[ihl:]))
        if not info.more_fragments:
            self._last_seen[key] = True

        if not self._last_seen.get(key, False):
            return None

        frags = sorted(self._fragments[key].items())
        expected = 0
        for off, payload in frags:
            if off != expected:
                return None  # gap
            expected = off + (len(payload) + 7) // 8

        out = bytearray(self._headers[key])
        for _, payload in frags:
            out.extend(payload)
        out[2:4] = len(out).to_bytes(2, "big")
        out[6:8] = b"\x00\x00"
        del self._fragments[key]
        del self._last_seen[key]
        del self._headers[key]
        del self._born[key]
        return bytes(out)
