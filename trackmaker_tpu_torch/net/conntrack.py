"""5-tuple connection tracking for NAT (counterpart of
``trackmaker_tpu/net/conntrack.py``) — the production upgrade over
the reference's port-keyed 1:1 maps (src/net/router.rs:1944-2139 keeps
``port -> inside ip`` with no collision handling and no expiry; two
inside hosts reusing a source port silently steal each other's
sessions, and mappings leak forever).

Design: a forward map keyed by the full inside 5-tuple and a reverse
map keyed by the external (port, remote) pair.  External ports prefer
the inside port when free (port preservation) and otherwise allocate
from the ephemeral range.  Entries expire on idle timeout — TCP gets a
long timeout that collapses once FIN/RST is seen, UDP and ICMP short
ones.  ICMP "ports" are echo identifiers (RFC 5508 style).

Host-side code by design (SURVEY: MAC/NET stay a thin host layer);
time is the simulation's sample clock so expiry is deterministic in
tests and real-time at 48 kHz in deployment.
"""

from __future__ import annotations

from dataclasses import dataclass

PROTO_ICMP = 1
PROTO_TCP = 6
PROTO_UDP = 17

TCP_FIN = 0x01
TCP_RST = 0x04


@dataclass
class CtEntry:
    proto: int
    inside_ip: bytes
    inside_port: int           # L4 port, or ICMP echo identifier
    remote_ip: bytes
    remote_port: int           # 0 for ICMP
    ext_port: int
    last_seen: int             # sample-clock ticks
    closing: bool = False      # TCP FIN/RST seen -> short timeout


class ConntrackTable:
    def __init__(self, sample_rate: int = 48_000,
                 ephemeral_base: int = 49_152,
                 ephemeral_size: int = 16_384,
                 tcp_timeout_s: float = 300.0,
                 tcp_closing_timeout_s: float = 10.0,
                 udp_timeout_s: float = 60.0,
                 icmp_timeout_s: float = 30.0):
        self.rate = sample_rate
        self.base = ephemeral_base
        self.size = ephemeral_size
        self._timeouts = {
            PROTO_TCP: int(tcp_timeout_s * sample_rate),
            PROTO_UDP: int(udp_timeout_s * sample_rate),
            PROTO_ICMP: int(icmp_timeout_s * sample_rate),
        }
        self._tcp_closing = int(tcp_closing_timeout_s * sample_rate)
        # forward: (proto, inside_ip, inside_port, remote_ip, remote_port)
        self._fwd: dict[tuple, CtEntry] = {}
        # reverse: (proto, ext_port, remote_ip, remote_port)
        self._rev: dict[tuple, CtEntry] = {}
        self._next_port = ephemeral_base

    def __len__(self) -> int:
        return len(self._fwd)

    def _timeout(self, e: CtEntry) -> int:
        if e.proto == PROTO_TCP and e.closing:
            return self._tcp_closing
        return self._timeouts[e.proto]

    def expire(self, now: int) -> None:
        dead = [k for k, e in self._fwd.items()
                if now - e.last_seen > self._timeout(e)]
        for k in dead:
            e = self._fwd.pop(k)
            self._rev.pop((e.proto, e.ext_port, e.remote_ip,
                           e.remote_port), None)

    def _alloc_port(self, proto: int, want: int, remote_ip: bytes,
                    remote_port: int) -> int:
        """Prefer the inside port; otherwise walk the ephemeral range.
        A port is usable if no live entry shares (proto, port, remote)."""
        if (proto, want, remote_ip, remote_port) not in self._rev:
            return want
        for _ in range(self.size):
            p = self._next_port
            self._next_port = (self.base
                               + (self._next_port + 1 - self.base)
                               % self.size)
            if (proto, p, remote_ip, remote_port) not in self._rev:
                return p
        raise RuntimeError("conntrack: ephemeral port range exhausted")

    def snat(self, proto: int, inside_ip: bytes, inside_port: int,
             remote_ip: bytes, remote_port: int, now: int) -> int:
        """Outbound packet: return the external port (== echo ident for
        ICMP) to rewrite to, creating the session if new."""
        key = (proto, inside_ip, inside_port, remote_ip, remote_port)
        e = self._fwd.get(key)
        if e is None:
            ext = self._alloc_port(proto, inside_port, remote_ip,
                                   remote_port)
            e = CtEntry(proto, inside_ip, inside_port, remote_ip,
                        remote_port, ext, now)
            self._fwd[key] = e
            self._rev[(proto, ext, remote_ip, remote_port)] = e
        e.last_seen = now
        return e.ext_port

    def dnat(self, proto: int, ext_port: int, remote_ip: bytes,
             remote_port: int, now: int) -> tuple[bytes, int] | None:
        """Inbound packet from (remote_ip, remote_port) to ext_port:
        return (inside_ip, inside_port) or None if no session."""
        e = self._rev.get((proto, ext_port, remote_ip, remote_port))
        if e is None or now - e.last_seen > self._timeout(e):
            return None
        e.last_seen = now
        return e.inside_ip, e.inside_port

    def note_tcp_flags(self, proto: int, ext_port: int, remote_ip: bytes,
                       remote_port: int, flags: int) -> None:
        """FIN/RST collapses the session to the short closing timeout."""
        if proto != PROTO_TCP or not (flags & (TCP_FIN | TCP_RST)):
            return
        e = self._rev.get((proto, ext_port, remote_ip, remote_port))
        if e is not None:
            e.closing = True
