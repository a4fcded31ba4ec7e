"""Minimal DNS A-record service (reference src/net/router.rs:870-980:
a UDP:53 responder answering from a static table; counterpart of
``trackmaker_tpu/net/dns.py``)."""

from __future__ import annotations

import struct


def parse_query(payload: bytes) -> tuple[int, str] | None:
    """-> (transaction_id, qname) for a standard A/IN query, else None."""
    if len(payload) < 12:
        return None
    tid, flags, qdcount = struct.unpack(">HHH", payload[:6])
    if flags & 0x8000 or qdcount < 1:  # response or no question
        return None
    pos = 12
    labels = []
    while pos < len(payload):
        n = payload[pos]
        pos += 1
        if n == 0:
            break
        if n > 63 or pos + n > len(payload):
            return None
        labels.append(payload[pos:pos + n].decode("ascii", "replace"))
        pos += n
    if pos + 4 > len(payload):
        return None
    qtype, qclass = struct.unpack(">HH", payload[pos:pos + 4])
    if qtype != 1 or qclass != 1:  # A, IN
        return None
    return tid, ".".join(labels)


def build_response(query_payload: bytes, ip: bytes,
                   ttl: int = 300) -> bytes | None:
    """Answer a parsed A query with one A record (echoes the question)."""
    q = parse_query(query_payload)
    if q is None:
        return None
    tid, _name = q
    # find end of question section
    pos = 12
    while pos < len(query_payload) and query_payload[pos] != 0:
        pos += query_payload[pos] + 1
    question = query_payload[12:pos + 5]
    header = struct.pack(">HHHHHH", tid, 0x8180, 1, 1, 0, 0)
    answer = (b"\xc0\x0c"                      # pointer to qname
              + struct.pack(">HHIH", 1, 1, ttl, 4) + bytes(ip))
    return header + question + answer


def build_query(tid: int, name: str) -> bytes:
    q = struct.pack(">HHHHHH", tid, 0x0100, 1, 0, 0, 0)
    for label in name.split("."):
        q += bytes([len(label)]) + label.encode()
    q += b"\x00" + struct.pack(">HH", 1, 1)
    return q


def parse_response_ip(payload: bytes) -> bytes | None:
    """Extract the first A record from a response (for tests/clients)."""
    if len(payload) < 12:
        return None
    ancount = struct.unpack(">H", payload[6:8])[0]
    if ancount < 1:
        return None
    # last 4 bytes of the first answer (fixed layout from build_response)
    return payload[-4:]
