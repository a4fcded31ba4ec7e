"""Router port implementations (counterpart of ``trackmaker_tpu/net/ports.py``).

The reference binds its router to libpcap captures, the acoustic
interface, and a kernel TUN device through dedicated threads
(src/net/router.rs:1008-1323).  Here ports are synchronous duck-typed
objects (``send``/``recv``); in-memory pairs serve tests and the
simulated bus, and real TUN / AF_PACKET ports plug in for kernel
integration.
"""

from __future__ import annotations

from collections import deque

from trackmaker_tpu_torch.core.config import FRAME_TYPE_DATA


class LoopbackPort:
    """One end of an in-memory duplex pipe (ethernet-frame or raw-IP)."""

    def __init__(self):
        self._rx: deque[bytes] = deque()
        self.peer: "LoopbackPort | None" = None

    @classmethod
    def pair(cls) -> tuple["LoopbackPort", "LoopbackPort"]:
        a, b = cls(), cls()
        a.peer, b.peer = b, a
        return a, b

    def send(self, data: bytes, **_kw) -> None:
        assert self.peer is not None
        self.peer._rx.append(bytes(data))

    def recv(self) -> bytes | None:
        return self._rx.popleft() if self._rx else None


class AcousticRouterPort:
    """Adapts :class:`trackmaker_tpu_torch.link.interface.AcousticInterface`
    (1-byte MACs, built-in CSMA) to the router port protocol."""

    def __init__(self, iface):
        self.iface = iface

    def send(self, packet: bytes, dst_mac: int = 0, **_kw) -> None:
        self.iface.send_packet(packet, dst_mac, FRAME_TYPE_DATA)

    def recv(self):
        r = self.iface.recv_packet()
        return None if r is None else r[0]


class TunPort:
    """Kernel TUN device (reference src/net/tun.rs).  Requires
    CAP_NET_ADMIN and /dev/net/tun; raises OSError otherwise."""

    IFF_TUN = 0x0001
    IFF_NO_PI = 0x1000
    TUNSETIFF = 0x400454CA

    def __init__(self, name: str = "tm0", ip: str | None = None,
                 netmask_bits: int = 24, mtu: int | None = None):
        import fcntl
        import os
        import struct
        import subprocess

        self.fd = os.open("/dev/net/tun", os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH22x", name.encode(),
                          self.IFF_TUN | self.IFF_NO_PI)
        fcntl.ioctl(self.fd, self.TUNSETIFF, ifr)
        self.name = name
        if ip is not None:
            subprocess.run(["ip", "addr", "add", f"{ip}/{netmask_bits}",
                            "dev", name], check=True)
        if mtu is not None:
            subprocess.run(["ip", "link", "set", name, "mtu", str(mtu)],
                           check=True)
        subprocess.run(["ip", "link", "set", name, "up"], check=True)

    def send(self, packet: bytes, **_kw) -> None:
        import os
        os.write(self.fd, packet)

    def recv(self) -> bytes | None:
        import os
        try:
            return os.read(self.fd, 65535)
        except BlockingIOError:
            return None

    def close(self) -> None:
        import os
        try:
            os.close(self.fd)
        except OSError:
            pass


# Classic BPF assembly for the protocol filter the reference compiles
# via libpcap ("icmp or arp or tcp or udp", src/net/router.rs:1140-1183,
# pcap_utils.rs:32-42).  Attached with SO_ATTACH_FILTER the program
# runs IN KERNEL, so non-matching frames never cross into userspace —
# same efficiency class as pcap's compiled filter on a busy link.
_BPF_LDH_ABS = 0x28      # A <- half-word at [k]
_BPF_LDB_ABS = 0x30      # A <- byte at [k]
_BPF_JEQ_K = 0x15        # pc += (A == k) ? jt : jf
_BPF_RET_K = 0x06        # return k (accept length; 0 = drop)
_SO_ATTACH_FILTER = 26
_IP_PROTO = {"icmp": 1, "tcp": 6, "udp": 17}


def bpf_protocol_filter(protocols) -> bytes:
    """Packed sock_filter[] accepting Ethernet frames of the given
    protocols (subset of {"arp", "icmp", "tcp", "udp"}), dropping all
    else.  ARP matches ethertype 0x0806; the rest match IPv4 frames
    (ethertype 0x0800) by protocol byte at offset 23."""
    import struct

    protos = sorted(set(protocols))
    unknown = set(protos) - set(_IP_PROTO) - {"arp"}
    assert not unknown, f"unsupported filter protocols: {unknown}"
    want_arp = "arp" in protos
    ip_nums = [_IP_PROTO[p] for p in protos if p in _IP_PROTO]
    assert want_arp or ip_nums, "empty filter would drop everything"

    # symbolic program, jump targets resolved below
    prog: list[tuple] = [(_BPF_LDH_ABS, 0, 0, 12)]
    if want_arp:
        prog.append((_BPF_JEQ_K, "ACCEPT", 0, 0x0806))
    if ip_nums:
        prog.append((_BPF_JEQ_K, 0, "REJECT", 0x0800))
        prog.append((_BPF_LDB_ABS, 0, 0, 23))
        for i, num in enumerate(ip_nums):
            last = i == len(ip_nums) - 1
            prog.append((_BPF_JEQ_K, "ACCEPT",
                         "REJECT" if last else 0, num))
    accept_at = len(prog)
    prog.append((_BPF_RET_K, 0, 0, 0x40000))
    reject_at = len(prog)
    prog.append((_BPF_RET_K, 0, 0, 0))

    def resolve(tgt, pc):
        if tgt == "ACCEPT":
            return accept_at - pc - 1
        if tgt == "REJECT":
            return reject_at - pc - 1
        return tgt

    return b"".join(
        struct.pack("HBBI", code, resolve(jt, pc), resolve(jf, pc), k)
        for pc, (code, jt, jf, k) in enumerate(prog))


class RawEthernetPort:
    """AF_PACKET raw socket (the libpcap-wrapper equivalent,
    reference src/net/pcap_utils.rs).  Requires CAP_NET_RAW.

    `kernel_filter` attaches an in-kernel classic-BPF protocol filter
    (default: the reference router's "icmp or arp or tcp or udp");
    pass None for an unfiltered promiscuous-style capture."""

    def __init__(self, interface: str,
                 kernel_filter=("icmp", "arp", "tcp", "udp")):
        import ctypes
        import socket
        import struct
        self.sock = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                                  socket.htons(0x0003))
        if kernel_filter is not None:
            insns = bpf_protocol_filter(kernel_filter)
            # keep the instruction buffer alive for the socket's life
            self._bpf_buf = ctypes.create_string_buffer(insns)
            fprog = struct.pack("HL", len(insns) // 8,
                                ctypes.addressof(self._bpf_buf))
            self.sock.setsockopt(socket.SOL_SOCKET, _SO_ATTACH_FILTER,
                                 fprog)
        self.sock.bind((interface, 0))
        self.sock.setblocking(False)
        self.interface = interface
        # drain frames queued between socket() and filter attach (the
        # classic race; the filter only applies from attach onward)
        if kernel_filter is not None:
            while True:
                try:
                    self.sock.recv(65535)
                except BlockingIOError:
                    break

    def send(self, frame: bytes, **_kw) -> None:
        self.sock.send(frame)

    def recv(self) -> bytes | None:
        try:
            return self.sock.recv(65535)
        except BlockingIOError:
            return None

    def close(self) -> None:
        self.sock.close()
