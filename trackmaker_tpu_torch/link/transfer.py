"""File transfers over the simulated acoustic link (counterpart of
``trackmaker_tpu/link/transfer.py``): chunk the file by the max frame
payload, CSMA-send it, collect what arrives."""

from __future__ import annotations

import pathlib

import torch

from trackmaker_tpu_torch.core.config import MacConfig, PhyConfig
from trackmaker_tpu_torch.link.audio import AudioEndpoint
from trackmaker_tpu_torch.link.bus import SimulatedBus
from trackmaker_tpu_torch.link.csma import CsmaReceiver, CsmaSender


def chunk_payload(data: bytes, chunk_size: int) -> list[bytes]:
    return [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)]


def transfer_over_bus(
    data: bytes,
    cfg: PhyConfig | None = None,
    mac_cfg: MacConfig | None = None,
    noise_std: float = 0.0,
    max_duration_s: float = 120.0,
    seed: int = 0,
    src: int = 1,
    dst: int = 2,
    phy_factory=None,
    device: torch.device | str = "cuda",
) -> tuple[bytes, dict]:
    """One-directional file transfer between two simulated nodes.

    `phy_factory` (optional): callable `local_addr -> stream PHY`
    (encode_frames / process_samples duck type) — swaps the waveform
    under the unchanged CSMA/ARQ MAC (OFDM, adaptive OFDM, FSK, PSK);
    None keeps the line-coded default.  Each node gets its OWN
    instance (stream PHYs carry receive-buffer state).  The line-coded
    default encodes and decodes on `device`, the card unless the caller
    asks for another.

    Returns (received_bytes, stats).
    """
    cfg = cfg or PhyConfig()
    mac_cfg = mac_cfg or MacConfig()
    bus = SimulatedBus(noise_std=noise_std, seed=seed)
    ep_tx, ep_rx = AudioEndpoint("tx"), AudioEndpoint("rx")
    sender = CsmaSender(ep_tx, cfg, mac_cfg, src, dst, seed=seed,
                        phy=phy_factory(src) if phy_factory else None,
                        device=device)
    receiver = CsmaReceiver(ep_rx, cfg, mac_cfg, dst, src,
                            phy=phy_factory(dst) if phy_factory else None,
                            device=device)
    bus.attach(ep_tx, sender)
    bus.attach(ep_rx, receiver)

    for chunk in chunk_payload(data, cfg.max_frame_data_size):
        sender.send(chunk)
    total_chunks = -(-len(data) // cfg.max_frame_data_size) if data else 0

    bus.run(int(max_duration_s * bus.sample_rate),
            until=lambda: sender.finished
            and len(receiver.received) >= total_chunks)

    received = b"".join(receiver.received)
    stats = {
        "airtime_samples": bus.now,
        "airtime_s": bus.now / bus.sample_rate,
        "acked": sender.acked,
        "retransmissions": sender.retransmissions,
        "duplicates": receiver.duplicates,
        "throughput_bps": (len(received) * 8) / max(
            bus.now / bus.sample_rate, 1e-9),
    }
    return received, stats


def run_file_transfer(input_path: str | pathlib.Path,
                      output_path: str | pathlib.Path, **kw) -> dict:
    data = pathlib.Path(input_path).read_bytes()
    received, stats = transfer_over_bus(data, **kw)
    pathlib.Path(output_path).write_bytes(received)
    stats["exact"] = received == data
    return stats
