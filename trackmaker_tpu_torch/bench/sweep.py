"""MAC/PHY parameter sweep harness (counterpart of ``trackmaker_tpu/bench/sweep.py``).

Every parameter is runtime config and the "processes" are deterministic
simulated nodes, so a sweep is a plain loop, and the contended-channel
scenario (two sender/receiver pairs on one bus) is reproducible.  The
line-coded PHY of every node encodes and decodes on `device`, the card
unless the caller asks for another.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import time

import torch

from trackmaker_tpu_torch.core.config import MacConfig, PhyConfig
from trackmaker_tpu_torch.link.audio import AudioEndpoint
from trackmaker_tpu_torch.link.bus import SimulatedBus
from trackmaker_tpu_torch.link.csma import CsmaReceiver, CsmaSender
from trackmaker_tpu_torch.link.transfer import chunk_payload


def contended_transfer(
    data_ab: bytes, data_cd: bytes,
    cfg: PhyConfig | None = None, mac_cfg: MacConfig | None = None,
    noise_std: float = 0.0, max_duration_s: float = 300.0,
    seed: int = 0, device: torch.device | str = "cuda",
) -> dict:
    """Two transfers sharing one acoustic channel (CSMA contention + ARQ
    under collisions)."""
    cfg = cfg or PhyConfig()
    mac_cfg = mac_cfg or MacConfig()
    bus = SimulatedBus(noise_std=noise_std, seed=seed)

    nodes = {}
    for i, name in enumerate(["a", "b", "c", "d"]):
        nodes[name] = AudioEndpoint(name)
    # pair 1: a(mac 1) -> b(mac 2); pair 2: c(mac 3) -> d(mac 4)
    s1 = CsmaSender(nodes["a"], cfg, mac_cfg, 1, 2, seed=seed, device=device)
    r1 = CsmaReceiver(nodes["b"], cfg, mac_cfg, 2, 1, device=device)
    s2 = CsmaSender(nodes["c"], cfg, mac_cfg, 3, 4, seed=seed + 17, device=device)
    r2 = CsmaReceiver(nodes["d"], cfg, mac_cfg, 4, 3, device=device)
    for name, node in zip("abcd", [s1, r1, s2, r2]):
        bus.attach(nodes[name], node)

    for chunk in chunk_payload(data_ab, cfg.max_frame_data_size):
        s1.send(chunk)
    for chunk in chunk_payload(data_cd, cfg.max_frame_data_size):
        s2.send(chunk)

    n1 = -(-len(data_ab) // cfg.max_frame_data_size)
    n2 = -(-len(data_cd) // cfg.max_frame_data_size)
    bus.run(int(max_duration_s * bus.sample_rate),
            until=lambda: (s1.finished and s2.finished
                           and len(r1.received) >= n1
                           and len(r2.received) >= n2))
    got1 = b"".join(r1.received)
    got2 = b"".join(r2.received)
    total_bits = (len(got1) + len(got2)) * 8
    return {
        "exact": got1 == data_ab and got2 == data_cd,
        "airtime_s": bus.now / bus.sample_rate,
        "retransmissions": s1.retransmissions + s2.retransmissions,
        "duplicates": r1.duplicates + r2.duplicates,
        "aggregate_throughput_bps":
            total_bits / max(bus.now / bus.sample_rate, 1e-9),
    }


def contended_window_transfer(
    data_ab: bytes, data_cd: bytes,
    arq: str = "sr", window: int = 8,
    cfg: PhyConfig | None = None, mac_cfg: MacConfig | None = None,
    noise_std: float = 0.0, max_duration_s: float = 300.0,
    seed: int = 0, device: torch.device | str = "cuda",
) -> dict:
    """Two window-ARQ transfers (gbn or sr) sharing one channel.  The window senders carrier-sense before each burst and back off
    randomly on ACK timeout (contention-window growth mirroring the
    CSMA sender's cw quirk), so colliding pairs desynchronize."""
    if arq == "gbn":
        from trackmaker_tpu_torch.link.gbn import GbnReceiver as Rx
        from trackmaker_tpu_torch.link.gbn import GbnSender as Tx
    else:
        from trackmaker_tpu_torch.link.sr import SrReceiver as Rx
        from trackmaker_tpu_torch.link.sr import SrSender as Tx
    cfg = cfg or PhyConfig()
    mac_cfg = mac_cfg or MacConfig()
    bus = SimulatedBus(noise_std=noise_std, seed=seed)

    nodes = {name: AudioEndpoint(name) for name in "abcd"}
    s1 = Tx(nodes["a"], cfg, mac_cfg, 1, 2, window=window, seed=seed, device=device)
    r1 = Rx(nodes["b"], cfg, mac_cfg, 2, 1, device=device)
    s2 = Tx(nodes["c"], cfg, mac_cfg, 3, 4, window=window, seed=seed + 17, device=device)
    r2 = Rx(nodes["d"], cfg, mac_cfg, 4, 3, device=device)
    for name, node in zip("abcd", [s1, r1, s2, r2]):
        bus.attach(nodes[name], node)

    for chunk in chunk_payload(data_ab, cfg.max_frame_data_size):
        s1.send(chunk)
    for chunk in chunk_payload(data_cd, cfg.max_frame_data_size):
        s2.send(chunk)

    n1 = -(-len(data_ab) // cfg.max_frame_data_size)
    n2 = -(-len(data_cd) // cfg.max_frame_data_size)
    bus.run(int(max_duration_s * bus.sample_rate),
            until=lambda: (s1.finished and s2.finished
                           and len(r1.received) >= n1
                           and len(r2.received) >= n2))
    got1 = b"".join(r1.received)
    got2 = b"".join(r2.received)
    total_bits = (len(got1) + len(got2)) * 8
    return {
        "exact": got1 == data_ab and got2 == data_cd,
        "airtime_s": bus.now / bus.sample_rate,
        "retransmit_bursts": s1.retransmit_bursts + s2.retransmit_bursts,
        "aggregate_throughput_bps":
            total_bits / max(bus.now / bus.sample_rate, 1e-9),
    }


def mac_parameter_sweep(
    data: bytes,
    samples_per_level=(3,),
    preamble_bytes=(2,),
    line_codings=("manchester", "4b5b"),
    cw_maxes=(100,),
    noise_stds=(0.0,),
    repeats: int = 1,
    out_json: str | pathlib.Path | None = None,
    device: torch.device | str = "cuda",
) -> list[dict]:
    """Grid sweep over runtime PHY/MAC parameters, one contended 2x2
    transfer per point."""
    results = []
    for spl, pb, lc, cw, noise in itertools.product(
            samples_per_level, preamble_bytes, line_codings, cw_maxes,
            noise_stds):
        cfg = PhyConfig(samples_per_level=spl, preamble_pattern_bytes=pb,
                        line_coding=lc)
        mac_cfg = MacConfig(cw_max=cw)
        for rep in range(repeats):
            t0 = time.time()
            stats = contended_transfer(data, data[::-1], cfg, mac_cfg,
                                       noise_std=noise, seed=rep, device=device)
            results.append({
                "samples_per_level": spl,
                "preamble_bytes": pb,
                "line_coding": lc,
                "cw_max": cw,
                "noise_std": noise,
                "repeat": rep,
                "wall_s": time.time() - t0,
                **stats,
            })
    if out_json:
        pathlib.Path(out_json).write_text(json.dumps(results, indent=2))
    return results
