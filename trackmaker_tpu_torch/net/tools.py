"""Ping and IP-host applications over the acoustic link
(reference src/net/tool.rs: run_ping :9-252, run_ip_host :254-425;
counterpart of ``trackmaker_tpu/net/tools.py``).

These are tick-driven apps over :class:`AcousticInterface` on the
simulated bus, so a full ICMP round trip (BASELINE config 5) runs
sample-accurately, its PHY on the card unless the caller asks for another
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from trackmaker_tpu_torch.core.config import FRAME_TYPE_ACK, NetConfig
from trackmaker_tpu_torch.link.interface import AcousticInterface
from trackmaker_tpu_torch.net.arp import ArpTable
from trackmaker_tpu_torch.net.icmp import (
    ICMP_ECHO_REPLY, ICMP_ECHO_REQUEST, IcmpPacket)
from trackmaker_tpu_torch.net.ip import Ipv4Header, build_ipv4_packet

PROTO_ICMP = 1


@dataclass
class PingStats:
    sent: int = 0
    received: int = 0
    rtts_ms: list[float] = field(default_factory=list)

    @property
    def loss_pct(self) -> float:
        return 100.0 * (self.sent - self.received) / max(self.sent, 1)

    def summary(self) -> dict:
        r = self.rtts_ms
        return {
            "sent": self.sent,
            "received": self.received,
            "loss_pct": self.loss_pct,
            "rtt_min_ms": min(r) if r else None,
            "rtt_avg_ms": sum(r) / len(r) if r else None,
            "rtt_max_ms": max(r) if r else None,
        }


class PingApp:
    """ICMP echo client (tool.rs:102-251)."""

    def __init__(self, interface: AcousticInterface, local_ip: str,
                 target_ip: str, net_cfg: NetConfig | None = None,
                 arp: ArpTable | None = None, identifier: int = 0x1234,
                 sample_rate: int = 48_000):
        self.iface = interface
        self.net = net_cfg or NetConfig()
        self.arp = arp or ArpTable()
        self.local_ip = bytes(map(int, local_ip.split(".")))
        self.target_ip = bytes(map(int, target_ip.split(".")))
        self.ident = identifier
        self.sr = sample_rate
        self.stats = PingStats()
        self._seq = 0
        self._next_send = 0
        self._sent_at: dict[int, int] = {}
        self._deadline: dict[int, int] = {}
        dst_mac = self.arp.get_mac(target_ip)
        if dst_mac is None:
            raise ValueError(f"no ARP entry for {target_ip}")
        self.dst_mac = dst_mac

    @property
    def finished(self) -> bool:
        return (self._seq >= self.net.ping_packet_count
                and not self._deadline)

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def on_tick(self, now: int) -> None:
        self.iface.on_tick(now)
        # expire timeouts
        for seq, dl in list(self._deadline.items()):
            if now >= dl:
                del self._deadline[seq]
        # send next request
        if self._seq < self.net.ping_packet_count and now >= self._next_send:
            payload = bytes(self.net.ping_payload_size)
            icmp = IcmpPacket.echo_request(self.ident, self._seq, payload)
            pkt = build_ipv4_packet(PROTO_ICMP, self.local_ip,
                                    self.target_ip, icmp.to_bytes(),
                                    identification=self._seq,
                                    ttl=self.net.ip_ttl)
            self.iface.send_packet(pkt, self.dst_mac)
            self._sent_at[self._seq] = now
            self._deadline[self._seq] = now + self._ms(
                self.net.ping_timeout_ms)
            self.stats.sent += 1
            self._seq += 1
            self._next_send = now + self._ms(self.net.ping_interval_ms)
        # receive replies
        while (rx := self.iface.recv_packet()) is not None:
            packet, _ftype, _src = rx
            hdr = Ipv4Header.from_bytes(packet)
            if hdr.protocol != PROTO_ICMP:
                continue
            icmp = IcmpPacket.from_bytes(packet[hdr.ihl_bytes:])
            if (icmp.icmp_type == ICMP_ECHO_REPLY
                    and icmp.identifier == self.ident
                    and icmp.sequence_number in self._deadline):
                seq = icmp.sequence_number
                rtt = (now - self._sent_at[seq]) * 1000.0 / self.sr
                self.stats.received += 1
                self.stats.rtts_ms.append(rtt)
                del self._deadline[seq]


class IpHostApp:
    """ICMP echo responder (tool.rs:254-425): parse request, swap
    addresses, reply with FrameType::Ack."""

    def __init__(self, interface: AcousticInterface, local_ip: str,
                 arp: ArpTable | None = None, net_cfg: NetConfig | None = None):
        self.iface = interface
        self.arp = arp or ArpTable()
        self.net = net_cfg or NetConfig()
        self.local_ip = bytes(map(int, local_ip.split(".")))
        self.responded = 0

    def on_tick(self, now: int) -> None:
        self.iface.on_tick(now)
        while (rx := self.iface.recv_packet()) is not None:
            packet, _ftype, src_mac = rx
            hdr = Ipv4Header.from_bytes(packet)
            if hdr.protocol != PROTO_ICMP:
                continue
            icmp = IcmpPacket.from_bytes(packet[hdr.ihl_bytes:])
            if icmp.icmp_type != ICMP_ECHO_REQUEST:
                continue
            reply = IcmpPacket.echo_reply(
                icmp.identifier, icmp.sequence_number, icmp.payload)
            pkt = build_ipv4_packet(
                PROTO_ICMP, hdr.dest_ip, hdr.source_ip, reply.to_bytes(),
                identification=hdr.identification, ttl=self.net.ip_ttl)
            self.iface.send_packet(pkt, src_mac, FRAME_TYPE_ACK)
            self.responded += 1


def run_ping_simulation(
    local_ip: str = "192.168.1.1",
    target_ip: str = "192.168.1.2",
    count: int | None = None,
    noise_std: float = 0.0,
    payload_size: int | None = None,
    max_duration_s: float = 60.0,
    seed: int = 0,
    phy_factory=None,
    device: torch.device | str = "cuda",
) -> dict:
    """Full PHY+MAC+NET ICMP round trip in a simulated audio loopback.

    `phy_factory` (optional): `local_mac -> stream PHY` — run the whole
    IP stack over any waveform family (ping over OFDM); else both
    interfaces build the line-coded PHY on `device`."""
    from trackmaker_tpu_torch.core.config import MacConfig, PhyConfig
    from trackmaker_tpu_torch.link.audio import AudioEndpoint
    from trackmaker_tpu_torch.link.bus import SimulatedBus

    net_cfg = NetConfig()
    if count is not None:
        net_cfg = NetConfig(ping_packet_count=count)
    if payload_size is not None:
        net_cfg = NetConfig(ping_packet_count=net_cfg.ping_packet_count,
                            ping_payload_size=payload_size)
    cfg, mac_cfg = PhyConfig(), MacConfig()
    arp = ArpTable()
    bus = SimulatedBus(noise_std=noise_std, seed=seed)
    ep_a, ep_b = AudioEndpoint("ping"), AudioEndpoint("host")
    mac_a, mac_b = arp.get_mac(local_ip), arp.get_mac(target_ip)
    if_a = AcousticInterface(ep_a, cfg, mac_cfg, net_cfg, mac_a,
                             seed=seed,
                             phy=phy_factory(mac_a) if phy_factory
                             else None, device=device)
    if_b = AcousticInterface(ep_b, cfg, mac_cfg, net_cfg, mac_b,
                             seed=seed + 1,
                             phy=phy_factory(mac_b) if phy_factory
                             else None, device=device)
    ping = PingApp(if_a, local_ip, target_ip, net_cfg, arp)
    host = IpHostApp(if_b, target_ip, arp, net_cfg)
    bus.attach(ep_a, ping)
    bus.attach(ep_b, host)
    bus.run(int(max_duration_s * bus.sample_rate),
            until=lambda: ping.finished)
    return ping.stats.summary() | {"responded": host.responded,
                                   "airtime_s": bus.now / bus.sample_rate}
