"""Runtime PHY, MAC and network configuration (counterpart of ``trackmaker_tpu/core/config.py``).

Field-for-field copies of the JAX package's frozen dataclasses and frame
constants.  The port cannot import the original: importing any module
under ``trackmaker_tpu.core`` runs that package's ``__init__``, which pulls
in jax.  ``tests/test_torch_bitops_framing.py`` holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


MANCHESTER = "manchester"
FOUR_B_FIVE_B = "4b5b"

# Frame byte layout: [Len:2][CRC8:1][Type:1][Seq:1][Src:1][Dst:1][Data:N]
PHY_HEADER_BYTES = 7

FRAME_TYPE_DATA = 0x01
FRAME_TYPE_ACK = 0x02


@dataclass(frozen=True)
class PhyConfig:
    """Physical-layer parameters; every shape below is a Python int."""

    sample_rate: int = 48_000
    samples_per_level: int = 3
    preamble_pattern_bytes: int = 2
    max_frame_data_size: int = 128
    inter_frame_gap_samples: int = 48  # 1 ms at 48 kHz
    line_coding: str = MANCHESTER
    correlation_threshold: float = 0.9

    @property
    def max_frame_bytes(self) -> int:
        """Decoder body cap: twice the largest payload."""
        return self.max_frame_data_size * 2

    @property
    def header_bits(self) -> int:
        return 8 * PHY_HEADER_BYTES

    def replace(self, **kw) -> "PhyConfig":
        return dataclasses.replace(self, **kw)

    def samples_for_bits(self, num_bits: int) -> int:
        """Samples occupied by `num_bits` frame bits after line coding."""
        if self.line_coding == MANCHESTER:
            return num_bits * self.samples_per_level * 2
        elif self.line_coding == FOUR_B_FIVE_B:
            num_nibbles = (num_bits + 3) // 4
            return num_nibbles * 5 * self.samples_per_level
        raise ValueError(f"unknown line coding {self.line_coding!r}")

    @property
    def preamble_len(self) -> int:
        """Preamble length in samples (pattern_bytes*8 line-coded bits)."""
        return self.samples_for_bits(self.preamble_pattern_bytes * 8)

    @property
    def sync_len(self) -> int:
        """Sync word (last preamble byte, 8 bits) length in samples."""
        return self.samples_for_bits(8)

    @property
    def sync_margin(self) -> int:
        """±1-bit sync realignment margin."""
        return self.samples_for_bits(1)

    @property
    def header_samples(self) -> int:
        return self.samples_for_bits(self.header_bits)

    @property
    def max_frame_samples(self) -> int:
        """Samples for the largest frame (header + max payload)."""
        total_bits = (PHY_HEADER_BYTES + self.max_frame_bytes) * 8
        return self.samples_for_bits(total_bits)

    def frame_samples(self, data_len: int) -> int:
        """Samples for one encoded frame body (without preamble)."""
        return self.samples_for_bits((PHY_HEADER_BYTES + data_len) * 8)


@dataclass(frozen=True)
class MacConfig:
    """MAC parameters: carrier sense, backoff and ACK timing."""

    ack_timeout_ms: int = 200
    energy_threshold: float = 0.5
    energy_detection_samples: int = 20
    difs_duration_ms: int = 20
    cw_min: int = 1
    cw_max: int = 100
    slot_time_ms: int = 5
    max_retries: int = 16


@dataclass(frozen=True)
class NetConfig:
    """Network-layer parameters: TTL, MTUs and the ping tool's defaults."""

    ip_ttl: int = 64
    mtu: int = 200           # the interface's fragmentation MTU
    acoustic_mtu: int = 140  # the router's acoustic egress MTU
    ping_packet_count: int = 10
    ping_payload_size: int = 32
    ping_timeout_ms: int = 2000
    ping_interval_ms: int = 1000
