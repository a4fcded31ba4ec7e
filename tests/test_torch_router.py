"""The port's router, its ports and the TUN bridge
(``trackmaker_tpu_torch.net.router``, ``.ports``, ``.conntrack``,
``.tun_bridge``) against the JAX package's, on the CPU, and the acoustic
router run on the card against the port's CPU run.

Each scenario is written once over a package's modules and run over both:
the same packets go in, and every packet each port emits, every reply and
every counter must be equal (bytes and integers: no tolerance).  The
scenarios are ``tests/test_router.py``'s and ``tests/test_conntrack.py``'s
(SNAT, DNAT, the ICMP traversal, DNS, TTL, ARP learning, acoustic egress
fragmentation, conntrack), a seeded random mix of packets on every
interface, ``chip_smoke.py``'s router run (an acoustic node pings a WiFi
host through the router over the simulated bus) and the TUN bridge over a
``LoopbackPort`` in place of the kernel's TUN device, with the IP host
answering over the bus.  No test opens a TUN device, a raw socket or a
network namespace, or runs ``ip``.  This module imports JAX only inside its
tests, so the tests marked ``gpu`` run on a card without it.
"""

import importlib
import ipaddress

import numpy as np
import pytest
import torch

import chip_smoke

MODULES = dict(chip_smoke.NET_MODULES, dns="net.dns", conntrack="net.conntrack",
               fragmentation="net.fragmentation", tun_bridge="net.tun_bridge")
ICMP, TCP, UDP = 1, 6, 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def net(package: str) -> dict:
    return {short: importlib.import_module(f"{package}.{path}") for short, path in MODULES.items()}


def both(scenario, port_kw=None, **kw):
    """scenario's transcript over the port (with `port_kw` too: its
    device) and over the JAX package, which must be equal; returns the
    port's."""
    ours = scenario(net("trackmaker_tpu_torch"), **kw, **(port_kw or {}))
    assert ours == scenario(net("trackmaker_tpu"), **kw)
    return ours


def ip4(s: str) -> bytes:
    return ipaddress.IPv4Address(s).packed


def make_router(m, **cfg):
    rt = m["router"]
    r = rt.Router(rt.RouterConfig(**cfg))
    ports = {}
    for itype in (rt.InterfaceType.ACOUSTIC, rt.InterfaceType.WIFI, rt.InterfaceType.ETHERNET,
                  rt.InterfaceType.TUN):
        mine, theirs = m["ports"].LoopbackPort.pair()
        r.register_port(itype, mine)
        ports[itype.value] = theirs
    return r, ports


def drain(ports) -> dict:
    """Every packet waiting on each far end, by interface name."""
    out = {}
    for name, port in ports.items():
        got = []
        while (p := port.recv()) is not None:
            got.append(p)
        out[name] = got
    return out


def counters(r) -> tuple:
    return (r.forwarded, r.dropped, len(r.pending), dict(r.nat_icmp), dict(r.nat_sessions),
            dict(r.dnat_map), None if r.ct is None else len(r.ct))


def tables(r) -> tuple:
    """The router's ARP table and pending packets, keyed by interface name."""
    return ({k.value: v for k, v in r.arp_table.table.items()},
            {ip: [(p.packet, p.interface.value) for p in q] for ip, q in r.pending.items()})


def eth_ip(m, r, payload: bytes, src_mac: bytes = b"\xaa" * 6, iface: str = "ethernet") -> bytes:
    dst = r.cfg.eth_mac if iface == "ethernet" else r.cfg.wifi_mac
    return m["ethernet"].EthernetFrame(dst, src_mac, m["ethernet"].ETHERTYPE_IPV4,
                                       payload).to_bytes()


def udp(sport: int, dport: int, payload: bytes = b"x" * 8) -> bytes:
    return (sport.to_bytes(2, "big") + dport.to_bytes(2, "big")
            + (8 + len(payload)).to_bytes(2, "big") + b"\x00\x00" + payload)


def tcp(sport: int, dport: int, flags: int) -> bytes:
    return (sport.to_bytes(2, "big") + dport.to_bytes(2, "big") + bytes(9) + bytes([flags])
            + bytes(6))


# --- the tables and helpers ----------------------------------------------------------------


def scenario_tables(m):
    rt = m["router"]
    table = rt.RoutingTable()
    table.add_direct_network("192.168.1.0", "255.255.255.0", rt.InterfaceType.ACOUSTIC)
    table.add_network("0.0.0.0", "0.0.0.0", rt.InterfaceType.ETHERNET, "192.168.2.254")
    out = [(nh, iface.value) for nh, iface in
           (table.lookup(ip4(a)) for a in ("192.168.1.7", "8.8.8.8", "192.168.1.255"))]
    out.append(rt.RoutingTable().lookup(ip4("1.2.3.4")))
    arp = rt.RouterArpTable()
    arp.update(ip4("192.168.2.2"), b"\x03" * 6, rt.InterfaceType.WIFI)
    out += [arp.get_mac(ip4(f"192.168.1.{i}"), rt.InterfaceType.ACOUSTIC) for i in range(5)]
    out += [arp.get_mac(ip4("192.168.2.2"), rt.InterfaceType.WIFI),
            arp.get_mac(ip4("192.168.2.2"), rt.InterfaceType.ETHERNET)]
    dns = rt.DnsTable()
    dns.add_entry("Aether.Local", "192.168.2.2")
    out += [dns.lookup("aether.local"), dns.lookup("AETHER.LOCAL"), dns.lookup("other")]
    rng = np.random.default_rng(0)
    for ttl in (0, 1, 2, 64, 255):
        pkt = bytearray(m["ip"].build_ipv4_packet(UDP, ip4("10.0.0.1"), ip4("10.0.0.2"), b"x" * 8,
                                                  ttl=ttl))
        out.append((rt.decrement_ttl(pkt), bytes(pkt)))
    for proto, l4 in ((ICMP, bytes(3)), (ICMP, bytes(12)), (TCP, bytes(17)), (TCP, bytes(30)),
                      (UDP, bytes(7)), (UDP, bytes(20)), (89, bytes(20))):
        pkt = bytearray(m["ip"].build_ipv4_packet(proto, ip4("10.0.0.1"), ip4("8.8.4.4"),
                                                  bytes(rng.integers(0, 256, len(l4), np.uint8))))
        rt.recompute_l4_checksum(pkt)
        rt.recompute_ip_checksum(pkt)
        out.append(bytes(pkt))
    return out


def test_router_tables_and_checksums_match_jax():
    out = both(scenario_tables)
    assert out[0] == (None, "acoustic") and out[1] == (ip4("192.168.2.254"), "ethernet")
    assert out[3] is None


def test_router_config_matches_jax():
    from trackmaker_tpu.net.router import RouterConfig as JaxRouterConfig
    from trackmaker_tpu_torch.net.router import InterfaceType, RouterConfig
    from trackmaker_tpu.net.router import InterfaceType as JaxInterfaceType

    assert vars(RouterConfig()) == vars(JaxRouterConfig())
    assert [(i.name, i.value) for i in InterfaceType] == [(i.name, i.value) for i in JaxInterfaceType]


# --- tests/test_router.py's scenarios ------------------------------------------------------


def scenario_forward_with_arp(m):
    """Acoustic -> WiFi: no ARP entry, so the packet waits and a request
    goes out; the reply flushes it with the TTL decremented."""
    r, ports = make_router(m)
    eth = m["ethernet"]
    pkt = m["ip"].build_ipv4_packet(ICMP, ip4("192.168.1.2"), ip4("192.168.2.2"),
                                    m["icmp"].IcmpPacket.echo_request(7, 0, b"hi").to_bytes())
    ports["acoustic"].send(pkt)
    r.poll()
    out = [drain(ports), counters(r)]
    reply = eth.ArpPacket.reply(b"\x00" * 5 + b"\x03", ip4("192.168.2.2"), r.cfg.wifi_mac,
                                ip4("192.168.2.1"))
    ports["wifi"].send(reply.to_ethernet())
    r.poll()
    out += [drain(ports), counters(r)]
    # an ARP request for the router's own WiFi address is answered
    req = eth.ArpPacket.request(b"\x05" * 6, ip4("192.168.2.9"), ip4("192.168.2.1"))
    ports["wifi"].send(req.to_ethernet())
    r.poll()
    return out + [drain(ports), counters(r), tables(r)]


def test_forward_acoustic_to_wifi_with_arp_matches_jax():
    out = both(scenario_forward_with_arp)
    assert out[0]["wifi"] and not out[2]["acoustic"]
    flushed = out[2]["wifi"][0]
    assert flushed[14 + 8] == 63                        # the TTL decremented
    assert len(out[4]["wifi"]) == 1                     # the ARP reply


def scenario_snat_dnat(m, conntrack: bool = False):
    """ICMP, UDP and TCP from the acoustic side to the internet: SNAT on
    egress, the replies DNAT'd back to the acoustic host (then a reply for no
    session)."""
    r, ports = make_router(m, conntrack=conntrack)
    rt = m["router"]
    r.arp_table.update(ip4("192.168.2.254"), b"\xaa" * 6, rt.InterfaceType.ETHERNET)
    icmp = m["icmp"].IcmpPacket
    out = []
    for src in ("192.168.1.2", "192.168.1.3"):
        ports["acoustic"].send(m["ip"].build_ipv4_packet(
            ICMP, ip4(src), ip4("8.8.8.8"), icmp.echo_request(0x42, 1, b"ping!").to_bytes()))
        ports["acoustic"].send(m["ip"].build_ipv4_packet(UDP, ip4(src), ip4("8.8.8.8"),
                                                         udp(7777, 9999)))
        ports["acoustic"].send(m["ip"].build_ipv4_packet(TCP, ip4(src), ip4("1.1.1.1"),
                                                         tcp(4000, 80, 0x02)))
        r.on_tick(len(out) * 1000)
        out += [drain(ports), counters(r)]
    sent = out[0]["ethernet"] + out[2]["ethernet"]
    for frame in sent:
        pkt = m["ethernet"].EthernetFrame.from_bytes(frame).payload
        proto, src, dst = pkt[9], pkt[12:16], pkt[16:20]
        l4 = pkt[20:]
        if proto == ICMP:
            reply = icmp.echo_reply(int.from_bytes(l4[4:6], "big"), 1, b"ping!").to_bytes()
        elif proto == UDP:
            reply = udp(9999, int.from_bytes(l4[0:2], "big"))
        else:
            reply = tcp(80, int.from_bytes(l4[0:2], "big"), 0x11)
        ports["ethernet"].send(eth_ip(m, r, m["ip"].build_ipv4_packet(proto, dst, src, reply)))
    ports["ethernet"].send(eth_ip(m, r, m["ip"].build_ipv4_packet(UDP, ip4("8.8.8.8"),
                                                                  ip4("10.20.0.1"), udp(53, 1))))
    r.on_tick(5000)
    return out + [drain(ports), counters(r)]


@pytest.mark.parametrize("conntrack", [False, True])
def test_snat_and_dnat_match_jax(conntrack):
    out = both(scenario_snat_dnat, conntrack=conntrack)
    egress = [m[12:16] for m in (f[14:] for f in out[0]["ethernet"] + out[2]["ethernet"])]
    assert egress == [ip4("10.20.0.1")] * 6
    to = sorted(p[16:20] for p in out[4]["acoustic"])
    if conntrack:                                       # each reply to its own host
        assert to == [ip4("192.168.1.2")] * 3 + [ip4("192.168.1.3")] * 3
    else:                                               # the reference's maps: the last host a key
        assert to == [ip4("192.168.1.3")] * 6


def scenario_local_services(m):
    """The router answers a ping to itself, serves DNS on UDP:53, runs the
    traversal DNAT both ways and drops on TTL expiry and junk."""
    r, ports = make_router(m)
    rt = m["router"]
    icmp = m["icmp"].IcmpPacket
    node3_mac = b"\x00" * 5 + b"\x03"
    r.arp_table.update(ip4("192.168.2.2"), node3_mac, rt.InterfaceType.WIFI)
    r.dns_table.add_entry("aether.local", "192.168.2.2")
    ip = m["ip"].build_ipv4_packet
    ports["acoustic"].send(ip(ICMP, ip4("192.168.1.2"), ip4("192.168.1.1"),
                              icmp.echo_request(9, 3, b"router?").to_bytes()))
    for name in ("aether.local", "nobody.local"):
        query = m["dns"].build_query(0x1234, name)
        ports["acoustic"].send(ip(UDP, ip4("192.168.1.2"), ip4("192.168.1.1"),
                                  udp(40000, 53, query)))
    ports["acoustic"].send(ip(UDP, ip4("192.168.1.2"), ip4("192.168.1.1"), udp(40000, 53, b"??")))
    ports["acoustic"].send(ip(ICMP, ip4("192.168.1.2"), ip4("192.168.1.1"),
                              icmp.echo_request(0x77, 0, bytes([0xAA]) + b"trav").to_bytes()))
    ports["acoustic"].send(ip(UDP, ip4("192.168.1.2"), ip4("192.168.2.2"), b"x" * 8, ttl=1))
    ports["acoustic"].send(b"\x60" + bytes(30))                     # not IPv4
    r.poll()
    out = [drain(ports), counters(r)]
    to_node3 = m["ethernet"].EthernetFrame.from_bytes(out[0]["wifi"][0]).payload
    reply = icmp.echo_reply(0x77, 0, bytes([0xAA]) + b"trav").to_bytes()
    ports["wifi"].send(eth_ip(m, r, ip(ICMP, ip4("192.168.2.2"), to_node3[12:16], reply),
                              node3_mac, "wifi"))
    ports["wifi"].send(b"\x00" * 10)                                 # runt frame
    ports["wifi"].send(m["ethernet"].EthernetFrame(r.cfg.wifi_mac, node3_mac, 0x86DD,
                                                   bytes(40)).to_bytes())
    ports["tun"].send(ip(ICMP, ip4("10.0.0.2"), ip4("192.168.1.2"),
                         icmp.echo_request(5, 5, bytes([0xBB])).to_bytes()))
    r.poll()
    return out + [drain(ports), counters(r)]


def test_local_services_match_jax():
    out = both(scenario_local_services)
    first = out[0]["acoustic"]
    assert first[0][20] == 0 and first[0][28:] == b"router?"          # echo reply
    assert first[1][-4:] == ip4("192.168.2.2")                        # the DNS answer
    assert out[0]["wifi"][0][14 + 16:14 + 20] == ip4("192.168.2.2")   # traversal to node3
    assert out[2]["acoustic"][0][16:20] == ip4("192.168.1.2")         # and back
    assert out[1][1] >= 4                                             # the drops


def scenario_acoustic_fragments(m):
    """WiFi -> acoustic, 400 bytes: fragments at the acoustic MTU, which a
    reassembler puts back together."""
    r, ports = make_router(m)
    big = m["ip"].build_ipv4_packet(UDP, ip4("192.168.2.2"), ip4("192.168.1.2"),
                                    bytes(range(200)) * 2)
    ports["wifi"].send(eth_ip(m, r, big, b"\x02" * 6, "wifi"))
    r.poll()
    frags = drain(ports)["acoustic"]
    ra = m["fragmentation"].IpReassembler()
    done = [p for p in (ra.process_fragment(f) for f in frags) if p is not None]
    return [frags, done, counters(r)]


def test_acoustic_egress_fragments_match_jax():
    frags, done, _ = both(scenario_acoustic_fragments)
    assert len(frags) >= 3 and all(len(f) <= 140 for f in frags)
    assert done[0][20:] == bytes(range(200)) * 2


def scenario_conntrack_expiry(m):
    """A UDP session idles past its timeout: its reply is dropped."""
    r, ports = make_router(m, conntrack=True)
    r.arp_table.update(ip4("192.168.2.254"), b"\xaa" * 6, m["router"].InterfaceType.ETHERNET)
    r.ct._timeouts[UDP] = 48_000
    ports["acoustic"].send(m["ip"].build_ipv4_packet(UDP, ip4("192.168.1.2"), ip4("8.8.8.8"),
                                                     udp(6000, 53)))
    out = []
    for now, reply in ((0, False), (30_000, True), (130_000, True)):
        if reply:
            ports["ethernet"].send(eth_ip(m, r, m["ip"].build_ipv4_packet(
                UDP, ip4("8.8.8.8"), ip4("10.20.0.1"), udp(53, 6000))))
        r.on_tick(now)
        out += [drain(ports), counters(r)]
    return out


def test_conntrack_expiry_matches_jax():
    out = both(scenario_conntrack_expiry)
    assert len(out[2]["acoustic"]) == 1 and not out[4]["acoustic"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("conntrack", [False, True])
def test_random_traffic_matches_jax(seed, conntrack):
    """A seeded mix of ICMP, UDP, TCP, ARP and junk on every interface, to
    and from every segment, the router polled at random sample times."""

    def scenario(m):
        rng = np.random.default_rng(seed)
        r, ports = make_router(m, conntrack=conntrack)
        r.dns_table.add_entry("aether.local", "192.168.2.2")
        addrs = ["192.168.1.2", "192.168.1.3", "192.168.1.1", "192.168.2.2", "192.168.2.254",
                 "10.20.0.1", "10.20.0.7", "10.0.0.2", "8.8.8.8", "255.255.255.255"]
        macs = [b"\xaa" * 6, b"\x00" * 5 + b"\x03", b"\x02" * 6]
        icmp = m["icmp"].IcmpPacket
        eth = m["ethernet"]
        out, now = [], 0
        for _ in range(120):
            src, dst = (addrs[int(i)] for i in rng.integers(0, len(addrs), 2))
            kind = int(rng.integers(0, 7))
            ident = int(rng.choice([0x42, 0x43, 7]))
            if kind == 0:
                body = getattr(icmp, ["echo_request", "echo_reply"][int(rng.integers(0, 2))])(
                    ident, 1, bytes([int(rng.choice([0xAA, 0xBB, 0]))]) + b"p").to_bytes()
                proto = ICMP
            elif kind == 1:
                body, proto = udp(int(rng.choice([53, 7777, 5000])), int(rng.choice([53, 7777, 5000])),
                                  m["dns"].build_query(ident, "aether.local")), UDP
            elif kind == 2:
                body, proto = tcp(int(rng.choice([4000, 80])), int(rng.choice([4000, 80])),
                                  int(rng.choice([0x02, 0x11, 0x04]))), TCP
            else:
                body, proto = bytes(rng.integers(0, 256, int(rng.integers(0, 40)), np.uint8)), \
                    int(rng.choice([ICMP, UDP, TCP, 89]))
            pkt = m["ip"].build_ipv4_packet(proto, ip4(src), ip4(dst), body,
                                            ttl=int(rng.choice([1, 2, 64])))
            where = ["acoustic", "wifi", "ethernet", "tun"][int(rng.integers(0, 4))]
            if where in ("wifi", "ethernet"):
                smac = macs[int(rng.integers(0, 3))]
                if kind == 5:
                    arp = eth.ArpPacket.request(smac, ip4(src), ip4(dst))
                    ports[where].send(arp.to_ethernet())
                elif kind == 6:
                    arp = eth.ArpPacket.reply(smac, ip4(src), r.cfg.eth_mac, ip4(dst))
                    ports[where].send(arp.to_ethernet())
                else:
                    ports[where].send(eth_ip(m, r, pkt, smac, where))
            else:
                ports[where].send(pkt if kind != 4 else pkt[:int(rng.integers(0, 20))])
            if rng.random() < 0.5:
                now += int(rng.integers(0, 60_000))
                r.on_tick(now)
                out += [drain(ports), counters(r)]
        r.poll()
        return out + [drain(ports), counters(r), tables(r)]

    out = both(scenario)
    assert sum(len(v) for t in out if isinstance(t, dict) for v in t.values()) > 0


# --- the router over the simulated bus, and the TUN bridge ------------------------------


def test_router_run_matches_jax():
    """chip_smoke.py's router run: the reply's fields and the counters equal
    the JAX package's and PING_EXPECT."""
    got = both(chip_smoke.router_run, port_kw={"device": "cpu"})
    assert got == chip_smoke.PING_EXPECT["router"]
    assert got["ttl"] < 64 and got["icmp_type"] == 0 and got["payload"] == chip_smoke.ROUTER_PAYLOAD


def bridge_run(m, **kw) -> list:
    """The TUN bridge with a LoopbackPort where the kernel's TUN device
    would be: the "kernel" side sends an echo request to the far acoustic
    node, an IPv6 packet and an off-subnet packet; the far node's IpHostApp
    answers over the bus, and the reply comes out of the bridge."""
    config = m["config"]
    cfg, mac, netc = config.PhyConfig(), config.MacConfig(), config.NetConfig()
    bus = m["bus"].SimulatedBus()
    ep_a, ep_b = m["audio"].AudioEndpoint("tun-side"), m["audio"].AudioEndpoint("host-side")
    if_a = m["interface"].AcousticInterface(ep_a, cfg, mac, netc, local_mac=1, **kw)
    if_b = m["interface"].AcousticInterface(ep_b, cfg, mac, netc, local_mac=2, **kw)
    kernel, tun = m["ports"].LoopbackPort.pair()
    bridge = m["tun_bridge"].TunBridge(if_a, tun, "10.78.0.1")
    gw_bridge = m["tun_bridge"].TunBridge(if_a, m["ports"].LoopbackPort.pair()[1], "10.78.0.1",
                                          gateway_ip="10.78.0.254")
    host = m["tools"].IpHostApp(if_b, "10.78.0.2")
    bus.attach(ep_a, bridge)
    bus.attach(ep_b, host)
    echo = m["icmp"].IcmpPacket.echo_request(0x5151, 0, b"tunping!")
    kernel.send(b"\x60" + bytes(47))                                    # IPv6: ignored
    kernel.send(m["ip"].build_ipv4_packet(ICMP, ip4("10.78.0.1"), ip4("10.9.9.9"), b"x" * 8))
    kernel.send(m["ip"].build_ipv4_packet(ICMP, ip4("10.78.0.1"), ip4("10.78.0.2"),
                                          echo.to_bytes(), identification=7))
    replies = []
    for _ in range(30 * 48_000 // bus.chunk):
        bus.step()
        if (p := kernel.recv()) is not None:
            replies.append(p)
            break
    return [replies, bridge.tx_packets, bridge.rx_packets, host.responded, bus.now,
            bridge.local_mac, gw_bridge.gateway_mac, bridge.gateway_mac]


def test_tun_bridge_over_a_loopback_matches_jax():
    replies, tx, rx, responded, now, local_mac, gw_mac, no_gw = both(
        bridge_run, port_kw={"device": "cpu"})
    assert tx == 1 and rx == 1 and responded == 1 and local_mac == 1
    assert (gw_mac, no_gw) == (254, None)
    reply = replies[0]
    assert reply[12:16] == ip4("10.78.0.2") and reply[16:20] == ip4("10.78.0.1")
    assert reply[20] == 0 and reply[28:] == b"tunping!"
    from trackmaker_tpu_torch.net.ip import ones_complement_sum

    assert ones_complement_sum(reply[:20]) == 0xFFFF


def test_router_port_adapter_matches_jax():
    """AcousticRouterPort sends data frames to the MAC it is given and hands
    up the packet alone."""

    class Iface:
        def __init__(self):
            self.sent, self.rx = [], [(b"pkt", 2, 3)]

        def send_packet(self, *args):
            self.sent.append(args)

        def recv_packet(self):
            return self.rx.pop() if self.rx else None

    got = []
    for package in ("trackmaker_tpu_torch", "trackmaker_tpu"):
        iface = Iface()
        port = importlib.import_module(f"{package}.net.ports").AcousticRouterPort(iface)
        port.send(b"abc", dst_mac=7)
        port.send(b"d")
        got.append((iface.sent, port.recv(), port.recv()))
    assert got[0] == got[1] == ([(b"abc", 7, 1), (b"d", 0, 1)], b"pkt", None)


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_router_run_on_the_card_equals_the_cpu(cuda):
    mods = chip_smoke.net_modules("trackmaker_tpu_torch")
    assert chip_smoke.router_run(mods, device=cuda) == chip_smoke.router_run(mods, device="cpu")


@pytest.mark.gpu
def test_tun_bridge_on_the_card_equals_the_cpu(cuda):
    m = net("trackmaker_tpu_torch")
    assert bridge_run(m, device=cuda) == bridge_run(m, device="cpu")
