"""NAT tables: ICMP-identifier masquerade + DNAT "traversal" sessions
(reference src/net/nat.rs; counterpart of ``trackmaker_tpu/net/nat.py``)."""

from __future__ import annotations

import ipaddress


class NatTable:
    def __init__(self):
        self._icmp_map: dict[int, ipaddress.IPv4Address] = {}
        self._dnat_ids: set[int] = set()

    def register_echo_request(self, identifier: int, source_ip) -> None:
        self._icmp_map[identifier] = ipaddress.IPv4Address(source_ip)

    def translate_echo_reply(self, identifier: int):
        return self._icmp_map.get(identifier)

    def register_dnat_session(self, identifier: int) -> None:
        self._dnat_ids.add(identifier)

    def is_dnat_session(self, identifier: int) -> bool:
        return identifier in self._dnat_ids
