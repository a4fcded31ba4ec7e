"""The multi-segment router demo (the scenario of
``tests/test_router_acoustic.py``, carried in the package for the CLI's
``router`` subcommand).

An acoustic node pings a host on the router's WiFi segment: the packet
crosses the simulated audio bus, the router's ARP and forwarding
machinery, and comes back over sound.
"""

from __future__ import annotations

import ipaddress

import torch

from trackmaker_tpu_torch.core.config import FRAME_TYPE_DATA, MacConfig, NetConfig, PhyConfig
from trackmaker_tpu_torch.link.audio import AudioEndpoint
from trackmaker_tpu_torch.link.bus import SimulatedBus
from trackmaker_tpu_torch.link.interface import AcousticInterface
from trackmaker_tpu_torch.net.ethernet import (
    ETHERTYPE_ARP, ETHERTYPE_IPV4, ArpPacket, EthernetFrame)
from trackmaker_tpu_torch.net.icmp import IcmpPacket
from trackmaker_tpu_torch.net.ip import Ipv4Header, build_ipv4_packet
from trackmaker_tpu_torch.net.ports import AcousticRouterPort, LoopbackPort
from trackmaker_tpu_torch.net.router import InterfaceType, Router, RouterConfig

PAYLOAD = b"crossing segments"


class WifiHost:
    """A node on the WiFi loopback: answers ARP and echoes ICMP."""

    def __init__(self, port: LoopbackPort, ip: str, mac: bytes):
        self.port = port
        self.ip = ipaddress.IPv4Address(ip).packed
        self.mac = mac
        self.pings_seen = 0

    def poll(self):
        while (raw := self.port.recv()) is not None:
            frame = EthernetFrame.from_bytes(raw)
            if frame.ethertype == ETHERTYPE_ARP:
                arp = ArpPacket.from_bytes(frame.payload)
                if arp.opcode == 1 and bytes(arp.target_ip) == self.ip:
                    reply = ArpPacket.reply(self.mac, self.ip,
                                            arp.sender_mac, arp.sender_ip)
                    self.port.send(reply.to_ethernet())
            elif frame.ethertype == ETHERTYPE_IPV4:
                pkt = frame.payload
                hdr = Ipv4Header.from_bytes(pkt)
                if hdr.protocol != 1:
                    continue
                icmp = IcmpPacket.from_bytes(pkt[hdr.ihl_bytes:])
                if icmp.icmp_type != 8:
                    continue
                self.pings_seen += 1
                reply = IcmpPacket.echo_reply(
                    icmp.identifier, icmp.sequence_number, icmp.payload)
                out = build_ipv4_packet(1, hdr.dest_ip, hdr.source_ip,
                                        reply.to_bytes())
                self.port.send(EthernetFrame(
                    frame.src_mac, self.mac, ETHERTYPE_IPV4,
                    out).to_bytes())


def acoustic_node_pings_wifi_host(device: torch.device | str = "cuda") -> None:
    """Run the demo with both acoustic interfaces' PHYs on `device`: node1
    (192.168.1.2, MAC 2) pings 192.168.2.2 through the router (acoustic
    side 192.168.1.1, MAC 1; WiFi side a loopback pair) for up to 30 s of
    airtime.  Raises AssertionError, as the test does, unless the request
    reached the WiFi host and its echo reply came back with the host's
    address, ICMP type 0, the payload and a decremented TTL."""
    cfg, mac_cfg, net_cfg = PhyConfig(), MacConfig(), NetConfig()
    bus = SimulatedBus()

    ep_node = AudioEndpoint("node1")
    if_node = AcousticInterface(ep_node, cfg, mac_cfg, net_cfg,
                                local_mac=2, device=device)

    ep_router = AudioEndpoint("router")
    if_router = AcousticInterface(ep_router, cfg, mac_cfg, net_cfg,
                                  local_mac=1, device=device)
    router = Router(RouterConfig(acoustic_mac=1))
    router.register_port(InterfaceType.ACOUSTIC,
                         AcousticRouterPort(if_router))
    wifi_mine, wifi_theirs = LoopbackPort.pair()
    router.register_port(InterfaceType.WIFI, wifi_mine)
    host = WifiHost(wifi_theirs, "192.168.2.2",
                    bytes([0, 0, 0, 0, 0, 3]))

    class RouterNode:
        def on_tick(self, now):
            if_router.on_tick(now)
            router.poll()
            host.poll()

    bus.attach(ep_node, type("N", (), {
        "on_tick": staticmethod(if_node.on_tick)})())
    bus.attach(ep_router, RouterNode())

    # node1 -> ping 192.168.2.2, next hop = router's acoustic MAC (1)
    echo = IcmpPacket.echo_request(0x99, 1, PAYLOAD)
    pkt = build_ipv4_packet(1, bytes([192, 168, 1, 2]),
                            bytes([192, 168, 2, 2]), echo.to_bytes(),
                            ttl=64)
    if_node.send_packet(pkt, dest_mac=1, frame_type=FRAME_TYPE_DATA)

    reply = None
    for _ in range(int(30 * bus.sample_rate / bus.chunk)):
        bus.step()
        r = if_node.recv_packet()
        if r is not None:
            reply = r
            break
    assert host.pings_seen == 1, "request never reached the wifi host"
    assert reply is not None, "echo reply never returned over sound"
    packet, _ftype, _src_mac = reply
    hdr = Ipv4Header.from_bytes(packet)
    assert bytes(hdr.source_ip) == bytes([192, 168, 2, 2])
    assert bytes(hdr.dest_ip) == bytes([192, 168, 1, 2])
    icmp = IcmpPacket.from_bytes(packet[hdr.ihl_bytes:])
    assert icmp.icmp_type == 0
    assert icmp.payload == PAYLOAD
    # TTL was decremented by the forwarding path
    assert hdr.ttl < 64
