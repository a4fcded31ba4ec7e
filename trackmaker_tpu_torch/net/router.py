"""Multi-interface IPv4 router: acoustic / WiFi / Ethernet / TUN
(reference src/net/router.rs — its largest component; counterpart of
``trackmaker_tpu/net/router.py``).

Behavior ported: static prefix routing with default gateway
(router.rs:97-149), per-interface ARP with learning + pending-packet
queue + request broadcast (:152-206, :2150-2238), ICMP-identifier and
TCP/UDP-port SNAT masquerade with L4 pseudo-header checksum recompute
(:1944-2139, :542-621), inbound DNAT (:724-860), the ICMP "traversal"
DNAT on payload magic bytes 0xaa/0xbb (:1706-1779), a DNS A-record
service on UDP:53 (:1819-1857), TTL decrement with checksum fix
(:476-516), and acoustic egress fragmentation at the acoustic MTU
(:2257-2342).

Architecturally it differs from the reference on purpose: instead of 8
OS threads wired by channels (:982-1397) the router is a synchronous,
deterministic `poll()` pipeline over pluggable ports — tickable inside
the simulated audio bus, or driven by real TUN/raw-socket ports.
"""

from __future__ import annotations

import enum
import ipaddress
from dataclasses import dataclass

from trackmaker_tpu_torch.net import dns as dns_mod
from trackmaker_tpu_torch.net.ethernet import (
    ARP_REPLY, ARP_REQUEST, BROADCAST_MAC, ETHERTYPE_ARP, ETHERTYPE_IPV4,
    ArpPacket, EthernetFrame)
from trackmaker_tpu_torch.net.fragmentation import IpFragmenter
from trackmaker_tpu_torch.net.ip import checksum as ip_checksum
from trackmaker_tpu_torch.utils.logging import get_logger

log = get_logger("router")

PROTO_ICMP, PROTO_TCP, PROTO_UDP = 1, 6, 17
TRAVERSAL_TO_NODE3 = 0xAA
TRAVERSAL_TO_NODE1 = 0xBB


class InterfaceType(enum.Enum):
    ACOUSTIC = "acoustic"
    WIFI = "wifi"
    ETHERNET = "ethernet"
    TUN = "tun"


def _ip(s) -> bytes:
    return ipaddress.IPv4Address(s).packed


def _ips(b) -> str:
    return str(ipaddress.IPv4Address(bytes(b)))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@dataclass
class RouteEntry:
    network: ipaddress.IPv4Network
    interface: InterfaceType
    next_hop: bytes | None = None


class RoutingTable:
    def __init__(self):
        self.routes: list[RouteEntry] = []

    def add_direct_network(self, network: str, mask: str,
                           interface: InterfaceType) -> None:
        self.routes.append(RouteEntry(
            ipaddress.IPv4Network(f"{network}/{mask}"), interface))

    def add_network(self, network: str, mask: str,
                    interface: InterfaceType, next_hop: str) -> None:
        self.routes.append(RouteEntry(
            ipaddress.IPv4Network(f"{network}/{mask}"), interface,
            _ip(next_hop)))

    def lookup(self, dest_ip: bytes):
        addr = ipaddress.IPv4Address(bytes(dest_ip))
        for r in self.routes:
            if addr in r.network:
                return r.next_hop, r.interface
        return None


class RouterArpTable:
    """Per-interface IP->MAC(6) with learning; acoustic side pre-seeded
    like the reference (router.rs:158-168)."""

    def __init__(self):
        self.table: dict[InterfaceType, dict[bytes, bytes]] = {
            InterfaceType.ACOUSTIC: {
                _ip(f"192.168.1.{i}"): bytes([0, 0, 0, 0, 0, i])
                for i in (1, 2, 3)
            }
        }

    def get_mac(self, ip: bytes, iface: InterfaceType) -> bytes | None:
        return self.table.get(iface, {}).get(bytes(ip))

    def update(self, ip: bytes, mac: bytes, iface: InterfaceType) -> None:
        self.table.setdefault(iface, {})[bytes(ip)] = bytes(mac)


class DnsTable:
    def __init__(self):
        self._entries: dict[str, bytes] = {}

    def add_entry(self, domain: str, ip: str) -> None:
        self._entries[domain.lower()] = _ip(ip)

    def lookup(self, domain: str) -> bytes | None:
        return self._entries.get(domain.lower())


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass
class RouterConfig:
    """Mirrors the reference defaults (router.rs:273-308)."""

    acoustic_ip: str = "192.168.1.1"
    acoustic_mac: int = 2
    acoustic_network: str = "192.168.1.0"
    acoustic_netmask: str = "255.255.255.0"
    acoustic_mtu: int = 140

    wifi_ip: str = "192.168.2.1"
    wifi_mac: bytes = bytes([0, 0, 0, 0, 0, 2])
    wifi_network: str = "192.168.2.0"
    wifi_netmask: str = "255.255.255.0"

    eth_ip: str = "10.20.0.1"
    eth_netmask: str = "255.255.255.0"
    eth_mac: bytes = bytes([0x9C, 0x29, 0x76, 0x0C, 0x49, 0x00])
    gateway_ip: str = "192.168.2.254"

    tun_ip: str = "10.0.0.1"
    tun_netmask: str = "255.255.255.0"

    node1_ip: str = "192.168.1.2"
    node3_ip: str = "192.168.2.2"

    # 5-tuple connection tracking for the NAT instead of the
    # reference's port-keyed 1:1 maps (collision-safe, expiring) —
    # opt-in so the default router stays quirk-for-quirk with
    # router.rs; see net/conntrack.py
    conntrack: bool = False


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------


def decrement_ttl(packet: bytearray) -> bool:
    """TTL-1 + header checksum fix; False when expired (router.rs:476)."""
    if len(packet) < 20 or packet[8] <= 1:
        return False
    packet[8] -= 1
    recompute_ip_checksum(packet)
    return True


def recompute_ip_checksum(packet: bytearray) -> None:
    ihl = (packet[0] & 0x0F) * 4
    packet[10:12] = b"\x00\x00"
    packet[10:12] = ip_checksum(bytes(packet[:ihl])).to_bytes(2, "big")


def recompute_l4_checksum(packet: bytearray) -> None:
    """TCP/UDP/ICMP checksum refresh after address rewrites
    (router.rs:542-621; ICMP has no pseudo header)."""
    ihl = (packet[0] & 0x0F) * 4
    proto = packet[9]
    l4 = packet[ihl:]
    if proto == PROTO_ICMP:
        if len(l4) < 4:
            return
        l4[2:4] = b"\x00\x00"
        c = ip_checksum(bytes(l4))
        packet[ihl + 2: ihl + 4] = c.to_bytes(2, "big")
        return
    if proto == PROTO_TCP:
        if len(l4) < 18:
            return
        off = 16
    elif proto == PROTO_UDP:
        if len(l4) < 8:
            return
        off = 6
    else:
        return
    l4[off:off + 2] = b"\x00\x00"
    pseudo = (bytes(packet[12:20]) + b"\x00" + bytes([proto])
              + len(l4).to_bytes(2, "big"))
    c = ip_checksum(pseudo + bytes(l4))
    packet[ihl + off: ihl + off + 2] = c.to_bytes(2, "big")


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


@dataclass
class PendingPacket:
    packet: bytes
    interface: InterfaceType


class Router:
    def __init__(self, config: RouterConfig | None = None):
        self.cfg = config or RouterConfig()
        self.routing_table = RoutingTable()
        self.arp_table = RouterArpTable()
        self.dns_table = DnsTable()
        self.nat_icmp: dict[int, bytes] = {}       # icmp id -> original ip
        self.nat_sessions: dict[int, bytes] = {}   # l4 port -> original ip
        self.dnat_map: dict[int, bytes] = {}       # traversal id -> origin
        self.ct = None                             # ConntrackTable | None
        self._now = 0                              # sample-clock ticks
        self._ct_last_expire = 0
        if self.cfg.conntrack:
            from trackmaker_tpu_torch.net.conntrack import ConntrackTable
            self.ct = ConntrackTable()
        self.pending: dict[bytes, list[PendingPacket]] = {}
        self.ports: dict[InterfaceType, object] = {}
        self.dropped = 0
        self.forwarded = 0

        c = self.cfg
        rt = self.routing_table
        rt.add_direct_network(c.acoustic_network, c.acoustic_netmask,
                              InterfaceType.ACOUSTIC)
        rt.add_direct_network(c.wifi_network, c.wifi_netmask,
                              InterfaceType.WIFI)
        net = ipaddress.IPv4Network(f"{c.tun_ip}/{c.tun_netmask}",
                                    strict=False)
        rt.add_direct_network(str(net.network_address), c.tun_netmask,
                              InterfaceType.TUN)
        eth_net = ipaddress.IPv4Network(f"{c.eth_ip}/{c.eth_netmask}",
                                        strict=False)
        rt.add_direct_network(str(eth_net.network_address), c.eth_netmask,
                              InterfaceType.ETHERNET)
        # default route via gateway over ethernet (router.rs:1904-1925)
        rt.add_network("0.0.0.0", "0.0.0.0", InterfaceType.ETHERNET,
                       c.gateway_ip)

        self._local_ips = {
            _ip(c.acoustic_ip), _ip(c.wifi_ip), _ip(c.eth_ip), _ip(c.tun_ip)}
        self._iface_ip = {
            InterfaceType.ACOUSTIC: _ip(c.acoustic_ip),
            InterfaceType.WIFI: _ip(c.wifi_ip),
            InterfaceType.ETHERNET: _ip(c.eth_ip),
            InterfaceType.TUN: _ip(c.tun_ip),
        }
        self._iface_mac = {
            InterfaceType.WIFI: c.wifi_mac,
            InterfaceType.ETHERNET: c.eth_mac,
        }
        self._fragmenter = IpFragmenter(c.acoustic_mtu)

    # -- wiring -------------------------------------------------------------

    def register_port(self, itype: InterfaceType, port) -> None:
        self.ports[itype] = port

    # -- main pipeline --------------------------------------------------

    def poll(self) -> int:
        """Drain all ports once; returns number of packets handled."""
        n = 0
        for itype, port in self.ports.items():
            while True:
                item = port.recv()
                if item is None:
                    break
                n += 1
                if itype in (InterfaceType.WIFI, InterfaceType.ETHERNET):
                    self._ingress_eth(itype, item)
                else:
                    self._ingress_ip(itype, item)
        return n

    def on_tick(self, now: int) -> None:  # bus-compatible
        self._now = now
        # expire at most ~once per second of sim time: the table scan is
        # O(sessions) and on_tick fires every bus chunk (128 samples)
        if self.ct is not None and now - self._ct_last_expire >= 48_000:
            self._ct_last_expire = now
            self.ct.expire(now)
        self.poll()

    # -- ingress ----------------------------------------------------------

    def _ingress_eth(self, itype: InterfaceType, raw: bytes) -> None:
        try:
            frame = EthernetFrame.from_bytes(raw)
        except ValueError:
            self.dropped += 1
            return
        if frame.ethertype == ETHERTYPE_ARP:
            self._handle_arp(itype, frame)
        elif frame.ethertype == ETHERTYPE_IPV4:
            # opportunistic ARP learning from traffic
            if len(frame.payload) >= 20:
                self.arp_table.update(frame.payload[12:16], frame.src_mac,
                                      itype)
            self._handle_ip(bytearray(frame.payload), itype)
        else:
            self.dropped += 1

    def _ingress_ip(self, itype: InterfaceType, item) -> None:
        packet = item[0] if isinstance(item, tuple) else item
        self._handle_ip(bytearray(packet), itype)

    def _handle_arp(self, itype: InterfaceType, frame: EthernetFrame) -> None:
        """Learn + reply + flush pending (router.rs:1555-1668)."""
        try:
            arp = ArpPacket.from_bytes(frame.payload)
        except ValueError:
            self.dropped += 1
            return
        self.arp_table.update(arp.sender_ip, arp.sender_mac, itype)
        self._flush_pending(arp.sender_ip)
        if (arp.opcode == ARP_REQUEST
                and bytes(arp.target_ip) == self._iface_ip[itype]):
            my_mac = self._iface_mac[itype]
            reply = ArpPacket.reply(my_mac, self._iface_ip[itype],
                                    arp.sender_mac, arp.sender_ip)
            self.ports[itype].send(EthernetFrame(
                arp.sender_mac, my_mac, ETHERTYPE_ARP,
                reply.to_bytes()).to_bytes())

    def _handle_ip(self, packet: bytearray, in_iface: InterfaceType) -> None:
        if len(packet) < 20 or (packet[0] >> 4) != 4:
            self.dropped += 1
            return
        dst = bytes(packet[16:20])
        if dst in self._local_ips or dst == b"\xff\xff\xff\xff":
            self._local_process(packet, in_iface)
        else:
            self._route(packet)

    # -- local processing ---------------------------------------------------

    def _local_process(self, packet: bytearray,
                       in_iface: InterfaceType) -> None:
        proto = packet[9]
        ihl = (packet[0] & 0x0F) * 4
        l4 = packet[ihl:]
        if proto == PROTO_ICMP and len(l4) >= 8:
            self._local_icmp(packet, l4, in_iface)
        elif proto == PROTO_UDP and len(l4) >= 8:
            dport = int.from_bytes(l4[2:4], "big")
            if dport == 53:
                self._serve_dns(packet, l4)
            elif self.ct is not None:
                if not self._dnat_conntrack(packet, proto, ihl):
                    self.dropped += 1
            elif dport in self.nat_sessions:
                self._dnat_l4(packet, dport)
            else:
                self.dropped += 1
        elif proto == PROTO_TCP and len(l4) >= 20:
            dport = int.from_bytes(l4[2:4], "big")
            if self.ct is not None:
                if not self._dnat_conntrack(packet, proto, ihl):
                    self.dropped += 1
            elif dport in self.nat_sessions:
                self._dnat_l4(packet, dport)
            else:
                self.dropped += 1
        else:
            self.dropped += 1

    def _local_icmp(self, packet: bytearray, l4: bytearray,
                    in_iface: InterfaceType) -> None:
        icmp_type = l4[0]
        ident = int.from_bytes(l4[4:6], "big")
        payload = bytes(l4[8:])
        cfg = self.cfg

        if icmp_type == 8:  # echo request
            # traversal magic (router.rs:1706-1779)
            if payload[:1] == bytes([TRAVERSAL_TO_NODE3]):
                self._traverse(packet, _ip(cfg.node3_ip), ident)
                return
            if payload[:1] == bytes([TRAVERSAL_TO_NODE1]):
                self._traverse(packet, _ip(cfg.node1_ip), ident)
                return
            # plain ping to the router: reply
            src, dst = bytes(packet[12:16]), bytes(packet[16:20])
            packet[12:16], packet[16:20] = dst, src
            ihl = (packet[0] & 0x0F) * 4
            packet[ihl] = 0  # echo reply (l4 slice above is a copy)
            recompute_l4_checksum(packet)
            packet[8] = 64
            recompute_ip_checksum(packet)
            self._route(packet, decrement=False)
            return

        if icmp_type == 0:  # echo reply
            if ident in self.dnat_map:  # traversal return leg
                orig = self.dnat_map.pop(ident)
                packet[16:20] = orig
                recompute_l4_checksum(packet)
                recompute_ip_checksum(packet)
                self._route(packet, decrement=False)
                return
            if self.ct is not None:
                ihl = (packet[0] & 0x0F) * 4
                if self._dnat_conntrack(packet, PROTO_ICMP, ihl):
                    return
            elif ident in self.nat_icmp:  # inbound NAT (router.rs:724-860)
                orig = self.nat_icmp[ident]
                packet[16:20] = orig
                recompute_l4_checksum(packet)
                recompute_ip_checksum(packet)
                self._route(packet, decrement=False)
                return
        self.dropped += 1

    def _traverse(self, packet: bytearray, new_dst: bytes,
                  ident: int) -> None:
        """ICMP traversal DNAT: redirect the echo to the far node and
        remember who asked."""
        self.dnat_map[ident] = bytes(packet[12:16])
        packet[16:20] = new_dst
        # masquerade source as the router on the egress segment
        route = self.routing_table.lookup(new_dst)
        if route is None:
            self.dropped += 1
            return
        _nh, out_iface = route
        packet[12:16] = self._iface_ip[out_iface]
        recompute_l4_checksum(packet)
        recompute_ip_checksum(packet)
        self._route(packet, decrement=False)

    def _serve_dns(self, packet: bytearray, l4: bytearray) -> None:
        """UDP:53 A-record service (router.rs:1819-1857)."""
        query = bytes(l4[8:])
        parsed = dns_mod.parse_query(query)
        if parsed is None:
            self.dropped += 1
            return
        _tid, name = parsed
        ip = self.dns_table.lookup(name)
        if ip is None:
            self.dropped += 1
            return
        resp = dns_mod.build_response(query, ip)
        src_ip, dst_ip = bytes(packet[12:16]), bytes(packet[16:20])
        sport, dport = bytes(l4[0:2]), bytes(l4[2:4])
        udp = (dport + sport + (8 + len(resp)).to_bytes(2, "big")
               + b"\x00\x00" + resp)
        out = bytearray(packet[:20])
        out[12:16], out[16:20] = dst_ip, src_ip
        out[2:4] = (20 + len(udp)).to_bytes(2, "big")
        out[8] = 64
        out += udp
        recompute_l4_checksum(out)
        recompute_ip_checksum(out)
        self._route(out, decrement=False)

    def _dnat_l4(self, packet: bytearray, dport: int) -> None:
        """Inbound TCP/UDP session DNAT (router.rs:724-860)."""
        packet[16:20] = self.nat_sessions[dport]
        recompute_l4_checksum(packet)
        recompute_ip_checksum(packet)
        self._route(packet, decrement=False)

    # -- conntrack NAT (opt-in; net/conntrack.py) -------------------------

    def _snat_conntrack(self, packet: bytearray, proto: int, ihl: int,
                        src: bytes) -> None:
        """Egress rewrite via the 5-tuple table: unlike the reference's
        maps this also rewrites the source port/ident when two inside
        hosts collide, and tracks TCP FIN/RST for expiry."""
        remote = bytes(packet[16:20])
        if proto == PROTO_ICMP:
            ident = int.from_bytes(packet[ihl + 4: ihl + 6], "big")
            ext = self.ct.snat(proto, src, ident, remote, 0, self._now)
            packet[ihl + 4: ihl + 6] = ext.to_bytes(2, "big")
        elif proto in (PROTO_TCP, PROTO_UDP):
            sport = int.from_bytes(packet[ihl: ihl + 2], "big")
            dport = int.from_bytes(packet[ihl + 2: ihl + 4], "big")
            ext = self.ct.snat(proto, src, sport, remote, dport,
                               self._now)
            packet[ihl: ihl + 2] = ext.to_bytes(2, "big")
            if proto == PROTO_TCP and len(packet) >= ihl + 14:
                self.ct.note_tcp_flags(proto, ext, remote, dport,
                                       packet[ihl + 13])

    def _dnat_conntrack(self, packet: bytearray, proto: int,
                        ihl: int) -> bool:
        """Inbound lookup; True when the packet matched a session and
        was forwarded to the inside host."""
        remote = bytes(packet[12:16])
        if proto == PROTO_ICMP:
            ident = int.from_bytes(packet[ihl + 4: ihl + 6], "big")
            hit = self.ct.dnat(proto, ident, remote, 0, self._now)
            if hit is None:
                return False
            inside_ip, inside_ident = hit
            packet[ihl + 4: ihl + 6] = inside_ident.to_bytes(2, "big")
        elif proto in (PROTO_TCP, PROTO_UDP):
            sport = int.from_bytes(packet[ihl: ihl + 2], "big")
            dport = int.from_bytes(packet[ihl + 2: ihl + 4], "big")
            hit = self.ct.dnat(proto, dport, remote, sport, self._now)
            if hit is None:
                return False
            inside_ip, inside_port = hit
            packet[ihl + 2: ihl + 4] = inside_port.to_bytes(2, "big")
            if proto == PROTO_TCP and len(packet) >= ihl + 14:
                self.ct.note_tcp_flags(proto, dport, remote, sport,
                                       packet[ihl + 13])
        else:
            return False
        packet[16:20] = inside_ip
        recompute_l4_checksum(packet)
        recompute_ip_checksum(packet)
        self._route(packet, decrement=False)
        return True

    # -- routing + egress -----------------------------------------------

    def _route(self, packet: bytearray, decrement: bool = True) -> None:
        if decrement and not decrement_ttl(packet):
            self.dropped += 1
            return
        dst = bytes(packet[16:20])
        route = self.routing_table.lookup(dst)
        if route is None:
            self.dropped += 1
            return
        next_hop, out_iface = route

        # SNAT masquerade when leaving through the ethernet uplink with a
        # private source (router.rs:1944-2139)
        if out_iface == InterfaceType.ETHERNET:
            src = bytes(packet[12:16])
            eth_net = ipaddress.IPv4Network(
                f"{self.cfg.eth_ip}/{self.cfg.eth_netmask}", strict=False)
            if (ipaddress.IPv4Address(src) not in eth_net
                    and src not in self._local_ips):
                proto = packet[9]
                ihl = (packet[0] & 0x0F) * 4
                if self.ct is not None:
                    self._snat_conntrack(packet, proto, ihl, src)
                elif proto == PROTO_ICMP:
                    ident = int.from_bytes(packet[ihl + 4: ihl + 6], "big")
                    self.nat_icmp[ident] = src
                elif proto in (PROTO_TCP, PROTO_UDP):
                    sport = int.from_bytes(packet[ihl: ihl + 2], "big")
                    self.nat_sessions[sport] = src
                packet[12:16] = self._iface_ip[InterfaceType.ETHERNET]
                recompute_l4_checksum(packet)
                recompute_ip_checksum(packet)

        self._send(bytes(packet), out_iface, next_hop or dst)

    def _send(self, packet: bytes, out_iface: InterfaceType,
              gateway_ip: bytes) -> None:
        port = self.ports.get(out_iface)
        if port is None:
            self.dropped += 1
            return
        if out_iface == InterfaceType.ACOUSTIC:
            # fragment at the acoustic MTU; 1-byte MAC = last IP octet
            for frag in self._fragmenter.fragment_packet(packet):
                port.send(frag, dst_mac=gateway_ip[3])
            self.forwarded += 1
            return
        if out_iface == InterfaceType.TUN:
            port.send(packet)
            self.forwarded += 1
            return
        # ethernet-like: need a MAC
        mac = self.arp_table.get_mac(gateway_ip, out_iface)
        if mac is None:
            # buffer + broadcast ARP request (router.rs:2150-2238)
            self.pending.setdefault(gateway_ip, []).append(
                PendingPacket(packet, out_iface))
            req = ArpPacket.request(self._iface_mac[out_iface],
                                    self._iface_ip[out_iface], gateway_ip)
            port.send(EthernetFrame(BROADCAST_MAC,
                                    self._iface_mac[out_iface],
                                    ETHERTYPE_ARP,
                                    req.to_bytes()).to_bytes())
            return
        port.send(EthernetFrame(mac, self._iface_mac[out_iface],
                                ETHERTYPE_IPV4, packet).to_bytes())
        self.forwarded += 1

    def _flush_pending(self, ip: bytes) -> None:
        for p in self.pending.pop(bytes(ip), []):
            self._send(p.packet, p.interface, bytes(ip))
