"""Static ARP table for the acoustic segment (reference src/net/arp.rs:
hardcoded 192.168.1.1/2/3 -> MAC 1/2/3; the router keeps its own learning
tables; counterpart of ``trackmaker_tpu/net/arp.py``)."""

from __future__ import annotations

import ipaddress


class ArpTable:
    def __init__(self, entries: dict[str, int] | None = None):
        entries = entries or {
            "192.168.1.1": 1,
            "192.168.1.2": 2,
            "192.168.1.3": 3,
        }
        self._table = {ipaddress.IPv4Address(k): v for k, v in entries.items()}

    def get_mac(self, ip) -> int | None:
        return self._table.get(ipaddress.IPv4Address(ip))

    def get_ip(self, mac: int):
        for ip, m in self._table.items():
            if m == mac:
                return ip
        return None

    def insert(self, ip, mac: int) -> None:
        self._table[ipaddress.IPv4Address(ip)] = mac
