"""The port's network codecs and tables (``trackmaker_tpu_torch.net``, its
``NetConfig`` and logging) against the JAX package's, on the CPU.

Every input is made from a seed with numpy's ``default_rng``, and the same
bytes go through both packages' functions.  These are bytes, integers and
booleans, so everything is compared exactly (no tolerance): the outputs,
the tables' answers, and the errors raised.  The module imports the JAX
package's network modules (none of which imports JAX) only inside its
tests, as the port's other test files do.
"""

import dataclasses
import importlib
import itertools
import logging
import struct

import numpy as np
import pytest

from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.config import NetConfig

NET = ("ip", "icmp", "fragmentation", "arp", "nat", "ethernet", "dns", "conntrack", "ports")


def mods(package: str) -> dict:
    return {name: importlib.import_module(f"{package}.net.{name}") for name in NET}


@pytest.fixture(scope="module")
def both():
    """(the port's modules, the JAX package's) by module name."""
    return mods("trackmaker_tpu_torch"), mods("trackmaker_tpu")


def outcome(fn, *args, **kw):
    """fn's result, or the type of the error it raised: two packages agree
    when both return equal values or both raise the same error type."""
    try:
        return fn(*args, **kw)
    except Exception as exc:   # noqa: BLE001 - the error type is compared
        return type(exc)


def rbytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# --- configuration and logging ------------------------------------------------------


def test_net_config_matches_jax():
    from trackmaker_tpu.core.config import NetConfig as JaxNetConfig

    ours = [(f.name, f.default) for f in dataclasses.fields(NetConfig)]
    assert ours == [(f.name, f.default) for f in dataclasses.fields(JaxNetConfig)]
    assert (NetConfig().mtu, NetConfig().acoustic_mtu, NetConfig().ping_packet_count) == (200, 140, 10)
    jnet = JaxNetConfig(mtu=180, ping_packet_count=3, ping_timeout_ms=500, ip_ttl=9)
    got = convert.net_config_from_fields(dataclasses.asdict(jnet))
    assert dataclasses.asdict(got) == dataclasses.asdict(jnet)
    with pytest.raises(KeyError):
        convert.net_config_from_fields({"mtu": 100, "no_such_field": 1})


def test_loggers_match_jax():
    """The router and the bridge log under the JAX package's names."""
    from trackmaker_tpu.net import router as jax_router
    from trackmaker_tpu.net import tun_bridge as jax_bridge
    from trackmaker_tpu_torch.net import router, tun_bridge
    from trackmaker_tpu_torch.utils import get_logger, init_logging

    assert (router.log.name, tun_bridge.log.name) == (jax_router.log.name, jax_bridge.log.name)
    assert (router.log.name, tun_bridge.log.name) == ("router", "tun")
    init_logging()
    assert get_logger("router") is logging.getLogger("router")


# --- IPv4 and ICMP ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 19, 20, 21, 64, 255, 1500])
def test_checksums_match_jax(both, n):
    port, ref = both
    rng = np.random.default_rng(n)
    for _ in range(20):
        data = rbytes(rng, n)
        assert port["ip"].ones_complement_sum(data) == ref["ip"].ones_complement_sum(data)
        assert port["ip"].checksum(data) == ref["ip"].checksum(data)
    ones = b"\xff" * n
    assert port["ip"].ones_complement_sum(ones) == ref["ip"].ones_complement_sum(ones)


def test_ipv4_header_matches_jax(both):
    port, ref = both
    rng = np.random.default_rng(1)
    for _ in range(200):
        total, ident, ttl, proto = (int(v) for v in rng.integers(0, [65536, 65536, 256, 256]))
        src, dst = rbytes(rng, 4), rbytes(rng, 4)
        ours = port["ip"].Ipv4Header.new(total, ident, ttl, proto, src, dst)
        theirs = ref["ip"].Ipv4Header.new(total, ident, ttl, proto, src, dst)
        assert ours.to_bytes() == theirs.to_bytes()
        assert ours.calculate_checksum() == theirs.calculate_checksum()
        assert port["ip"].ones_complement_sum(ours.to_bytes()) == 0xFFFF
        raw = rbytes(rng, 20) + rbytes(rng, int(rng.integers(0, 8)))
        a, b = port["ip"].Ipv4Header.from_bytes(raw), ref["ip"].Ipv4Header.from_bytes(raw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (a.ihl_bytes, a.to_bytes()) == (b.ihl_bytes, b.to_bytes()) and a.to_bytes() == raw[:20]
        payload = rbytes(rng, int(rng.integers(0, 300)))
        args = (proto, src, dst, payload, ident, ttl)
        pkt = port["ip"].build_ipv4_packet(*args)
        assert pkt == ref["ip"].build_ipv4_packet(*args)
        mangled = bytearray(pkt)
        mangled[8] ^= int(rng.integers(1, 256))
        assert port["ip"].recompute_header_checksum(bytes(mangled)) == \
            ref["ip"].recompute_header_checksum(bytes(mangled))
    for short in (b"", bytes(19)):
        assert outcome(port["ip"].Ipv4Header.from_bytes, short) is \
            outcome(ref["ip"].Ipv4Header.from_bytes, short) is ValueError


def test_icmp_matches_jax(both):
    port, ref = both
    rng = np.random.default_rng(2)
    for i in range(200):
        ident, seq = (int(v) for v in rng.integers(0, 65536, 2))
        payload = rbytes(rng, int(rng.integers(0, 80)))
        for make in ("echo_request", "echo_reply"):
            ours = getattr(port["icmp"].IcmpPacket, make)(ident, seq, payload)
            theirs = getattr(ref["icmp"].IcmpPacket, make)(ident, seq, payload)
            assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
            assert ours.to_bytes() == theirs.to_bytes() and ours.verify_checksum()
        raw = rbytes(rng, 8 + i % 40)
        a, b = port["icmp"].IcmpPacket.from_bytes(raw), ref["icmp"].IcmpPacket.from_bytes(raw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert a.verify_checksum() == b.verify_checksum()
        assert a.to_bytes() == b.to_bytes() == raw
    assert (port["icmp"].ICMP_ECHO_REQUEST, port["icmp"].ICMP_ECHO_REPLY) == \
        (ref["icmp"].ICMP_ECHO_REQUEST, ref["icmp"].ICMP_ECHO_REPLY)
    assert outcome(port["icmp"].IcmpPacket.from_bytes, bytes(7)) is \
        outcome(ref["icmp"].IcmpPacket.from_bytes, bytes(7)) is ValueError


# --- fragmentation ------------------------------------------------------------------


def test_fragmentation_info_matches_jax(both):
    port, ref = both
    for value in list(range(0, 65536, 97)) + [0x2000, 0x1FFF, 0x3FFF, 0xFFFF]:
        a = port["fragmentation"].FragmentationInfo.from_u16(value)
        b = ref["fragmentation"].FragmentationInfo.from_u16(value)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert a.to_u16() == b.to_u16() == value & 0x3FFF
    for more, off in itertools.product((False, True), (0, 1, 100, 0x1FFF, 0x2000)):
        assert port["fragmentation"].FragmentationInfo(7, more, off).to_u16() == \
            ref["fragmentation"].FragmentationInfo(7, more, off).to_u16()


def _packet(m, rng, n_payload: int, options: int = 0) -> bytes:
    """An IPv4 packet of `n_payload` random bytes, with `options` bytes of
    options after the 20-byte header (IHL set to match)."""
    pkt = bytearray(m["ip"].build_ipv4_packet(17, bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]),
                                              rbytes(rng, n_payload),
                                              identification=int(rng.integers(0, 65536))))
    if options:
        pkt[0] = 0x40 | (20 + options) // 4
        pkt[20:20] = rbytes(rng, options)
    return bytes(pkt)


def _deliveries(frags: list[bytes], order: str, rng) -> list[bytes]:
    if order == "in order":
        return list(frags)
    if order == "reversed":
        return frags[::-1]
    if order == "duplicated":
        return [f for f in frags for _ in range(2)] + frags[:1]
    if order == "one lost":
        lost = int(rng.integers(0, len(frags))) if len(frags) > 1 else 0
        return [f for i, f in enumerate(frags) if i != lost]
    perm = rng.permutation(len(frags))
    return [frags[i] for i in perm]


MTUS = [60, 140, 200]
ORDERS = ["in order", "reversed", "duplicated", "one lost", "shuffled"]


@pytest.mark.parametrize("mtu", MTUS)
@pytest.mark.parametrize("order", ORDERS)
def test_fragment_and_reassemble_match_jax(both, mtu, order):
    """Packets of mtu-1, mtu, mtu+1 and a few MTUs (payload after a 20-byte
    header, and one with 4 bytes of options) cut by both fragmenters and
    delivered to both reassemblers; every fragment and every return equal."""
    port, ref = both
    rng = np.random.default_rng(mtu * 10 + ORDERS.index(order))
    sizes = [mtu - 1, mtu, mtu + 1, 2 * mtu + 3, 3 * mtu + 5, 7 * mtu]
    fr_port = port["fragmentation"].IpFragmenter(mtu)
    fr_ref = ref["fragmentation"].IpFragmenter(mtu)
    ra_port = port["fragmentation"].IpReassembler()
    ra_ref = ref["fragmentation"].IpReassembler()
    for size in sizes:
        for options in (0, 4):
            pkt = _packet(port, rng, size - 20, options)
            frags = fr_port.fragment_packet(pkt)
            assert frags == fr_ref.fragment_packet(pkt)
            assert all(len(f) <= mtu for f in frags)
            assert len(frags) == 1 if len(pkt) <= mtu else len(frags) > 1
            feed = _deliveries(frags, order, rng)
            got = [ra_port.process_fragment(f) for f in feed]
            assert got == [ra_ref.process_fragment(f) for f in feed]
            done = [p for p in got if p is not None]
            if order == "one lost" and len(frags) > 1:
                assert not done
            elif options == 0 and len(frags) > 1:
                assert done[0][20:] == pkt[20:] and done[0][:2] == pkt[:2]
    assert fr_port.next_identification() == fr_ref.next_identification()


def test_fragmenter_errors_match_jax(both):
    port, ref = both
    cases = [(60, bytes(10) + bytes(80)), (60, bytes([0x44]) + bytes(99)),
             (60, bytes([0x4F]) + bytes(30) + bytes(40)), (27, bytes([0x45]) + bytes(99)),
             (100, bytes(100)), (20, bytes([0x45]) + bytes(25))]
    for mtu, pkt in cases:
        assert outcome(port["fragmentation"].IpFragmenter(mtu).fragment_packet, pkt) == \
            outcome(ref["fragmentation"].IpFragmenter(mtu).fragment_packet, pkt)
    for bad in (bytes(19), bytes([0x44]) + bytes(30), bytes([0x4F]) + bytes(30)):
        assert outcome(port["fragmentation"].IpReassembler().process_fragment, bad) is \
            outcome(ref["fragmentation"].IpReassembler().process_fragment, bad) is ValueError


class FakeClock:
    """Stands in for the ``time`` module of a fragmentation module."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


@pytest.mark.parametrize("gap_s,kept", [(29.0, True), (30.0, True), (30.5, False), (45.0, False)])
def test_reassembly_expiry_on_the_wall_clock_matches_jax(both, monkeypatch, gap_s, kept):
    """The one wall-clock decision of the stack: a partial packet older than
    30 s of wall time is dropped by both reassemblers alike."""
    port, ref = both
    rng = np.random.default_rng(5)
    pkt = _packet(port, rng, 400)
    frags = port["fragmentation"].IpFragmenter(140).fragment_packet(pkt)
    results = []
    for m in (port, ref):
        clock = FakeClock()
        monkeypatch.setattr(m["fragmentation"], "time", clock)
        ra = m["fragmentation"].IpReassembler()
        got = [ra.process_fragment(frags[0])]
        clock.now += gap_s
        got += [ra.process_fragment(f) for f in frags[1:]]
        clock.now += 1.0
        got.append(ra.process_fragment(frags[0]))
        results.append((got, sorted(ra._fragments), sorted(ra._born.values())))
    assert results[0] == results[1]
    got = results[0][0]
    if kept:
        # the packet completes; the first fragment sent again begins anew
        assert got[-2][20:] == pkt[20:] and got[-1] is None and results[0][1]
    else:
        # the first fragment expired, so the last one completes nothing;
        # sent again, it completes the later fragments kept since the gap
        assert all(p is None for p in got[:-1]) and got[-1][20:] == pkt[20:]


# --- ARP, NAT and conntrack tables ----------------------------------------------------


def test_arp_and_nat_tables_match_jax(both):
    port, ref = both
    rng = np.random.default_rng(3)
    arp_p, arp_r = port["arp"].ArpTable(), ref["arp"].ArpTable()
    assert arp_p.get_mac("192.168.1.2") == 2 and str(arp_p.get_ip(3)) == "192.168.1.3"
    custom = {"10.1.0.5": 9, "10.1.0.6": 9}
    tables = [(arp_p, arp_r), (port["arp"].ArpTable(custom), ref["arp"].ArpTable(custom))]
    nat_p, nat_r = port["nat"].NatTable(), ref["nat"].NatTable()
    for step in range(400):
        ip = f"192.168.{int(rng.integers(0, 3))}.{int(rng.integers(0, 5))}"
        mac, ident = int(rng.integers(0, 12)), int(rng.integers(0, 16))
        for a, r in tables:
            if step % 3 == 0:
                a.insert(ip, mac)
                r.insert(ip, mac)
            assert a.get_mac(ip) == r.get_mac(ip)
            assert a.get_ip(mac) == r.get_ip(mac)
        if step % 2:
            nat_p.register_echo_request(ident, ip)
            nat_r.register_echo_request(ident, ip)
        if step % 5 == 0:
            nat_p.register_dnat_session(ident)
            nat_r.register_dnat_session(ident)
        assert nat_p.translate_echo_reply(ident) == nat_r.translate_echo_reply(ident)
        assert nat_p.is_dnat_session(ident) == nat_r.is_dnat_session(ident)


CT = 1, 6, 17       # ICMP, TCP, UDP


@pytest.mark.parametrize("seed", range(4))
def test_conntrack_table_matches_jax(both, seed):
    """A random walk of snat / dnat / note_tcp_flags / expire over a few
    inside hosts, ports and remotes, with short timeouts and a small
    ephemeral range, through both tables: every answer equal."""
    port, ref = both
    rng = np.random.default_rng(seed)
    kw = dict(sample_rate=100, ephemeral_base=60_000, ephemeral_size=6, tcp_timeout_s=3.0,
              tcp_closing_timeout_s=0.5, udp_timeout_s=1.0, icmp_timeout_s=2.0)
    tables = port["conntrack"].ConntrackTable(**kw), ref["conntrack"].ConntrackTable(**kw)
    hosts = [bytes([10, 0, 0, i]) for i in range(1, 5)]
    remotes = [bytes([8, 8, 8, 8]), bytes([1, 1, 1, 1])]
    now = 0
    for _ in range(600):
        now += int(rng.integers(0, 40))
        op = int(rng.integers(0, 8))
        proto = CT[int(rng.integers(0, 3))]
        remote, rport = remotes[int(rng.integers(0, 2))], int(rng.integers(0, 3)) * (proto != 1)
        if op < 4:
            args = (proto, hosts[int(rng.integers(0, 4))], 5000 + int(rng.integers(0, 3)),
                    remote, rport, now)
            got = [outcome(t.snat, *args) for t in tables]
        elif op < 6:
            args = (proto, int(rng.choice([5000, 5001, 5002, 60_000, 60_001, 60_005])), remote,
                    rport, now)
            got = [t.dnat(*args) for t in tables]
        elif op == 6:
            args = (proto, int(rng.choice([5000, 60_000, 60_001])), remote, rport,
                    int(rng.choice([0x01, 0x04, 0x10, 0x11])))
            got = [t.note_tcp_flags(*args) for t in tables]
        else:
            got = [t.expire(now) for t in tables]
        assert got[0] == got[1]
        assert len(tables[0]) == len(tables[1])


# --- Ethernet, ARP frames, DNS ---------------------------------------------------------


def test_ethernet_and_arp_frames_match_jax(both):
    port, ref = both
    pe, re_ = port["ethernet"], ref["ethernet"]
    rng = np.random.default_rng(4)
    for i in range(200):
        raw = rbytes(rng, 14 + i % 60)
        a, b = pe.EthernetFrame.from_bytes(raw), re_.EthernetFrame.from_bytes(raw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b) and a.to_bytes() == raw
        smac, sip, tmac, tip = rbytes(rng, 6), rbytes(rng, 4), rbytes(rng, 6), rbytes(rng, 4)
        for make, args in (("request", (smac, sip, tip)), ("reply", (smac, sip, tmac, tip))):
            x, y = getattr(pe.ArpPacket, make)(*args), getattr(re_.ArpPacket, make)(*args)
            assert x.to_bytes() == y.to_bytes()
            assert x.to_ethernet() == y.to_ethernet()
            assert x.to_ethernet(tmac) == y.to_ethernet(tmac)
            assert dataclasses.astuple(pe.ArpPacket.from_bytes(x.to_bytes())) == \
                dataclasses.astuple(x)
        header = struct.pack(">HHBBH", *[(1, 0x0800, 6, 4, 2), (1, 0x0800, 6, 6, 1),
                                         (2, 0x0800, 6, 4, 1), (1, 0x86DD, 6, 4, 1)][i % 4])
        arp_raw = header + rbytes(rng, 20 + i % 3)
        assert outcome(lambda r: dataclasses.astuple(pe.ArpPacket.from_bytes(r)), arp_raw) == \
            outcome(lambda r: dataclasses.astuple(re_.ArpPacket.from_bytes(r)), arp_raw)
    for short in (b"", bytes(13)):
        assert outcome(pe.EthernetFrame.from_bytes, short) is \
            outcome(re_.EthernetFrame.from_bytes, short) is ValueError
    assert outcome(pe.ArpPacket.from_bytes, bytes(27)) is ValueError
    assert (pe.ETHERTYPE_IPV4, pe.ETHERTYPE_ARP, pe.BROADCAST_MAC, pe.ARP_REQUEST, pe.ARP_REPLY) \
        == (re_.ETHERTYPE_IPV4, re_.ETHERTYPE_ARP, re_.BROADCAST_MAC, re_.ARP_REQUEST, re_.ARP_REPLY)


NAMES = ["aether.local", "a", "node3.acoustic.lan", "x" * 63 + ".io", "UPPER.case"]


@pytest.mark.parametrize("name", NAMES)
def test_dns_codec_matches_jax(both, name):
    port, ref = both
    pd, rd = port["dns"], ref["dns"]
    rng = np.random.default_rng(len(name))
    for tid in (0, 1, 0x1234, 0xFFFF):
        q = pd.build_query(tid, name)
        assert q == rd.build_query(tid, name)
        assert pd.parse_query(q) == rd.parse_query(q) == (tid, name)
        ip, ttl = rbytes(rng, 4), int(rng.integers(0, 2**31))
        resp = pd.build_response(q, ip, ttl=ttl)
        assert resp == rd.build_response(q, ip, ttl=ttl)
        assert pd.parse_response_ip(resp) == rd.parse_response_ip(resp) == ip
        assert pd.parse_query(resp) is rd.parse_query(resp) is None   # a response, not a query
        for cut in range(0, len(q) + 1, 3):
            assert pd.parse_query(q[:cut]) == rd.parse_query(q[:cut])
            assert pd.build_response(q[:cut], ip) == rd.build_response(q[:cut], ip)
    for _ in range(300):
        junk = rbytes(rng, int(rng.integers(0, 64)))
        assert outcome(pd.parse_query, junk) == outcome(rd.parse_query, junk)
        assert outcome(pd.parse_response_ip, junk) == outcome(rd.parse_response_ip, junk)


# --- the ports' pure parts ---------------------------------------------------------------


SUBSETS = [c for n in range(1, 5) for c in itertools.combinations(("arp", "icmp", "tcp", "udp"), n)]


@pytest.mark.parametrize("protocols", SUBSETS, ids="-".join)
def test_bpf_protocol_filter_matches_jax(both, protocols):
    """The classic-BPF program is byte for byte JAX's; run on a few frames
    by a small interpreter, it accepts exactly the protocols asked for,
    except that ARP alone accepts every frame (the ARP test's miss falls
    through to the accept: the JAX package's program, kept as it is)."""
    port, ref = both
    prog = port["ports"].bpf_protocol_filter(protocols)
    assert prog == ref["ports"].bpf_protocol_filter(protocols)
    assert prog == port["ports"].bpf_protocol_filter(reversed(protocols))

    def run(frame: bytes) -> int:
        pc, acc = 0, 0
        while True:
            code, jt, jf, k = struct.unpack_from("HBBI", prog, pc * 8)
            if code == 0x28:
                acc = int.from_bytes(frame[k:k + 2], "big")
            elif code == 0x30:
                acc = frame[k]
            elif code == 0x15:
                pc += jt if acc == k else jf
            else:
                return k
            pc += 1

    frames = {"arp": (0x0806, 0), "icmp": (0x0800, 1), "tcp": (0x0800, 6), "udp": (0x0800, 17),
              "ospf": (0x0800, 89), "ipv6": (0x86DD, 17)}
    for what, (ethertype, proto) in frames.items():
        frame = bytes(12) + ethertype.to_bytes(2, "big") + bytes(9) + bytes([proto]) + bytes(20)
        assert (run(frame) > 0) == (what in protocols or protocols == ("arp",)), what


def test_bpf_protocol_filter_refusals_match_jax(both):
    port, ref = both
    for bad in (("dns",), (), ("icmp", "sctp")):
        assert outcome(port["ports"].bpf_protocol_filter, bad) is \
            outcome(ref["ports"].bpf_protocol_filter, bad) is AssertionError


def test_loopback_port_matches_jax(both):
    port, ref = both
    rng = np.random.default_rng(6)
    pairs = port["ports"].LoopbackPort.pair(), ref["ports"].LoopbackPort.pair()
    got = [[], []]
    for step in range(100):
        data = rbytes(rng, int(rng.integers(0, 30)))
        side = step % 2
        for (a, b), out in zip(pairs, got):
            (a, b)[side].send(bytearray(data))
            if step % 3 == 0:
                out.append(((a, b)[1 - side].recv(), (a, b)[side].recv()))
    assert got[0] == got[1]
