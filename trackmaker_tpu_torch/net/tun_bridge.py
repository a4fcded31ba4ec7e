"""TUN bridge: expose the acoustic link as a kernel network interface
(reference src/net/tun.rs:19-273; counterpart of
``trackmaker_tpu/net/tun_bridge.py``), so unmodified OS applications (ping,
curl, browsers) run over sound.

Reference behaviors kept: the local acoustic MAC is the last octet of
the local IP (tun.rs:95-96), outbound packets are routed by subnet
membership (in-subnet -> last octet of the destination, off-subnet ->
gateway MAC, tun.rs:125-201), and inbound packets get their IPv4 header
checksum recomputed before being written to the kernel (tun.rs:227-241).
"""

from __future__ import annotations

import ipaddress

from trackmaker_tpu_torch.net.ip import recompute_header_checksum
from trackmaker_tpu_torch.utils.logging import get_logger

log = get_logger("tun")


class TunBridge:
    def __init__(self, acoustic, tun_port, local_ip: str,
                 netmask_bits: int = 24, gateway_ip: str | None = None):
        self.acoustic = acoustic       # AcousticInterface
        self.tun = tun_port            # TunPort (or any IP port)
        self.local_ip = ipaddress.IPv4Address(local_ip)
        self.network = ipaddress.IPv4Network(
            f"{local_ip}/{netmask_bits}", strict=False)
        self.gateway_mac = (int(str(gateway_ip).split(".")[-1])
                            if gateway_ip else None)
        self.tx_packets = 0
        self.rx_packets = 0

    @property
    def local_mac(self) -> int:
        return int(self.local_ip) & 0xFF

    def on_tick(self, now: int) -> None:
        self.acoustic.on_tick(now)
        self.poll()

    def poll(self) -> None:
        # kernel -> acoustic
        while (pkt := self.tun.recv()) is not None:
            if len(pkt) < 20 or (pkt[0] >> 4) != 4:
                continue  # ignore non-IPv4 (e.g. IPv6 RS)
            dst = ipaddress.IPv4Address(bytes(pkt[16:20]))
            if dst in self.network:
                dst_mac = int(dst) & 0xFF
            elif self.gateway_mac is not None:
                dst_mac = self.gateway_mac
            else:
                log.debug("no route for %s, dropping", dst)
                continue
            self.acoustic.send_packet(bytes(pkt), dst_mac)
            self.tx_packets += 1
        # acoustic -> kernel
        while (rx := self.acoustic.recv_packet()) is not None:
            packet, _ftype, _src = rx
            if len(packet) >= 20:
                packet = recompute_header_checksum(packet)
            self.tun.send(packet)
            self.rx_packets += 1
