"""Network layer (counterpart of ``trackmaker_tpu/net``): IPv4/ICMP codecs,
fragmentation, ARP/NAT, the router, the ping and IP-host tools.

Host code on packet bytes: nothing here is compute-bound, and CSMA/ARQ
latency dominates a round trip.  The card's work stays in the PHY under
``trackmaker_tpu_torch.link.interface.AcousticInterface``; this layer
consumes and produces the packet bytes that interface carries, and every
timer counts samples of the simulated bus (the reassembler's 30 s expiry
alone reads the wall clock, as the JAX package's does).
"""

from trackmaker_tpu_torch.net.ip import Ipv4Header, IP_HEADER_BYTES
from trackmaker_tpu_torch.net.icmp import IcmpPacket, ICMP_ECHO_REQUEST, ICMP_ECHO_REPLY
from trackmaker_tpu_torch.net.fragmentation import (
    FragmentationInfo, IpFragmenter, IpReassembler)
from trackmaker_tpu_torch.net.arp import ArpTable
from trackmaker_tpu_torch.net.nat import NatTable

PROTO_ICMP = 1
PROTO_TCP = 6
PROTO_UDP = 17

__all__ = [
    "Ipv4Header", "IP_HEADER_BYTES", "IcmpPacket",
    "ICMP_ECHO_REQUEST", "ICMP_ECHO_REPLY",
    "FragmentationInfo", "IpFragmenter", "IpReassembler",
    "ArpTable", "NatTable", "PROTO_ICMP", "PROTO_TCP", "PROTO_UDP",
]
