"""Plain PHY arithmetic of TrackMaker-rs's line-coded frames.

The benchmark's own copy of the frame layout, the CRC8, the preamble and
the two line codes (Manchester; 4B5B + NRZI), written from the protocol
and sharing no code with the program under test.  The traffic generator
encodes with it and the plain reference decodes with it.

Frame bytes: ``[Len:2][CRC8:1][Type:1][Seq:1][Src:1][Dst:1][Data:N]``,
big-endian length, CRC8 (poly 0x07, init 0) over the payload.  A frame on
the air is the preamble (0x33 repeated, then the sync byte 0x5A) and the
frame's bits, MSB first, each line-coded on its own: Manchester sends bit
0 as levels (+1, -1) and bit 1 as (-1, +1); 4B5B maps each nibble to a
5-bit symbol and NRZI flips the level on every coded 1, starting from +1.
Every level lasts `samples_per_level` samples.
"""

from __future__ import annotations

import numpy as np
import torch

HEADER_BYTES = 7
FRAME_TYPE_DATA = 1
FRAME_TYPE_ACK = 2
MIN_HEADER_BITS = 49        # a header parses from 7 whole or partial bytes
NEAR_ZERO = 1e-6            # a 4B5B level mean at most this far from 0 has no sign

# the keys of a configuration file that are the program's PhyConfig fields
CONFIG_KEYS = ("sample_rate", "samples_per_level", "preamble_pattern_bytes", "max_frame_data_size",
               "inter_frame_gap_samples", "line_coding", "correlation_threshold")

PATTERN_BYTE = 0x33
SYNC_BYTE = 0x5A

FOURB5B = np.array([0b11110, 0b01001, 0b10100, 0b10101, 0b01010, 0b01011, 0b01110,
                    0b01111, 0b10010, 0b10011, 0b10110, 0b10111, 0b11010, 0b11011,
                    0b11100, 0b11101], dtype=np.int64)
FIVEB4B = np.full(32, -1, dtype=np.int64)
FIVEB4B[FOURB5B] = np.arange(16)


def crc8_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for byte in range(256):
        c = byte
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        table[byte] = c
    return table


CRC8 = crc8_table()


class Phy:
    """The sizes of one PHY configuration (a configuration file's keys)."""

    def __init__(self, cfg: dict):
        self.line_coding = cfg["line_coding"]
        if self.line_coding not in ("manchester", "4b5b"):
            raise ValueError(f"unknown line coding {self.line_coding!r}")
        self.spl = int(cfg["samples_per_level"])
        self.pattern_bytes = int(cfg["preamble_pattern_bytes"])
        self.max_frame_bytes = 2 * int(cfg["max_frame_data_size"])   # the decoder's body cap
        self.threshold = float(cfg["correlation_threshold"])
        self.sample_rate = int(cfg["sample_rate"])

    def samples_for_bits(self, n_bits):
        """Samples that `n_bits` frame bits occupy on the air (int or array)."""
        if self.line_coding == "manchester":
            return n_bits * 2 * self.spl
        return (n_bits + 3) // 4 * 5 * self.spl

    @property
    def preamble(self) -> np.ndarray:
        pattern = [PATTERN_BYTE] * (self.pattern_bytes - 1) + [SYNC_BYTE]
        bits = np.unpackbits(np.array(pattern, np.uint8)).astype(np.int64)
        return levels_host(self.line_coding, bits).repeat(self.spl).astype(np.float32)

    @property
    def preamble_len(self) -> int:
        return self.samples_for_bits(8 * self.pattern_bytes)

    @property
    def sync_len(self) -> int:
        return self.samples_for_bits(8)

    @property
    def sync_margin(self) -> int:
        return self.samples_for_bits(1)

    @property
    def header_samples(self) -> int:
        return self.samples_for_bits(8 * HEADER_BYTES)

    @property
    def max_window(self) -> int:
        """Samples of the largest frame the decoder accepts (header + body cap)."""
        return self.samples_for_bits(8 * (HEADER_BYTES + self.max_frame_bytes))

    def frame_samples(self, payload: int) -> int:
        """Samples of a whole frame on the air, preamble included."""
        return self.preamble_len + self.samples_for_bits(8 * (HEADER_BYTES + payload))


def levels_host(line_coding: str, bits: np.ndarray) -> np.ndarray:
    """One frame's line levels (+-1) of bits int[N] (N a multiple of 4 for 4B5B)."""
    if line_coding == "manchester":
        first = 1.0 - 2.0 * bits
        return np.stack([first, -first], -1).reshape(-1)
    nibbles = bits.reshape(-1, 4) @ np.array([8, 4, 2, 1])
    coded = (FOURB5B[nibbles][:, None] >> np.arange(4, -1, -1)) & 1
    return np.where(np.cumsum(coded.reshape(-1)) % 2 == 0, 1.0, -1.0)


def frame_bytes(payload: torch.Tensor, ftype: torch.Tensor, seq: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Serialized frames uint8[N, 7 + L] of payloads uint8[N, L]."""
    n, length = payload.shape
    dev = payload.device
    hdr = torch.stack([
        torch.full((n,), length >> 8, dtype=torch.int64, device=dev),
        torch.full((n,), length & 0xFF, dtype=torch.int64, device=dev),
        crc8_prefix(payload, torch.full((n,), length, device=dev)), ftype.to(torch.int64),
        seq.to(torch.int64) & 0xFF, src.to(torch.int64), dst.to(torch.int64)], dim=1)
    return torch.cat([hdr.to(torch.uint8), payload.to(torch.uint8)], dim=1)


def encode(phy: Phy, frames: torch.Tensor) -> torch.Tensor:
    """Waveforms f32[N, preamble + body] of serialized frames uint8[N, B]:
    the preamble, then the frame's bits line-coded from the initial level."""
    dev = frames.device
    shifts = torch.arange(7, -1, -1, device=dev)
    bits = ((frames.to(torch.int64)[..., None] >> shifts) & 1).reshape(frames.shape[0], -1)
    if phy.line_coding == "manchester":
        first = 1.0 - 2.0 * bits.to(torch.float32)
        levels = torch.stack([first, -first], dim=-1).reshape(bits.shape[0], -1)
    else:
        nibbles = (bits.reshape(bits.shape[0], -1, 4) * torch.tensor([8, 4, 2, 1], device=dev)).sum(-1)
        symbols = torch.from_numpy(FOURB5B).to(dev)[nibbles]
        coded = ((symbols[..., None] >> torch.arange(4, -1, -1, device=dev)) & 1)
        flips = coded.reshape(bits.shape[0], -1).cumsum(-1)
        levels = torch.where(flips % 2 == 0, 1.0, -1.0)
    body = levels.to(torch.float32).repeat_interleave(phy.spl, dim=-1)
    pre = torch.from_numpy(phy.preamble).to(dev).expand(frames.shape[0], -1)
    return torch.cat([pre, body], dim=-1)


def decode_bits(phy: Phy, win: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits int64[N, M], valid bool[N, M]) of line-coded windows [N, S],
    in the windows' own dtype.  Manchester: a bit is 0 where its first
    half's mean exceeds its second half's, and every bit is valid.  4B5B:
    a level whose mean is within NEAR_ZERO of 0 carries no sign and is
    skipped; a coded 1 is a level of the other sign than the last signed
    level before it (+1 before the first); bits are valid up to the first
    symbol outside the 4B5B table."""
    spl = phy.spl
    n = win.shape[0]
    if phy.line_coding == "manchester":
        m = win.shape[1] // (2 * spl)
        halves = win[:, :m * 2 * spl].reshape(n, m, 2, spl).mean(-1)
        bits = (halves[..., 0] <= halves[..., 1]).to(torch.int64)
        return bits, torch.ones_like(bits, dtype=torch.bool)
    n_lvl = win.shape[1] // spl // 5 * 5
    avg = win[:, :n_lvl * spl].reshape(n, n_lvl, spl).mean(-1)
    signed = avg.abs() > NEAR_ZERO
    # the last signed level before each level: its index by a running maximum
    idx = torch.arange(n_lvl, device=win.device).expand(n, n_lvl)
    last = torch.where(signed, idx, -1).cummax(-1).values
    before = torch.cat([torch.full((n, 1), -1, dtype=last.dtype, device=win.device),
                        last[:, :-1]], dim=1)
    prev = torch.where(before >= 0, avg.gather(1, before.clamp(min=0)),
                       torch.ones((), dtype=avg.dtype, device=win.device))
    coded = (prev * avg < 0).to(torch.int64).reshape(n, -1, 5)
    symbols = (coded * torch.tensor([16, 8, 4, 2, 1], device=win.device)).sum(-1)
    nib = torch.from_numpy(FIVEB4B).to(win.device)[symbols]
    good = torch.cumprod((nib >= 0).to(torch.int64), dim=-1).bool()
    bits = (nib.clamp(min=0)[..., None] >> torch.arange(3, -1, -1, device=win.device)) & 1
    return bits.reshape(n, -1), good.repeat_interleave(4, dim=-1)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first bytes int64[N, M // 8] of bits int[N, M]."""
    n, m = bits.shape
    weights = 1 << torch.arange(7, -1, -1, device=bits.device)
    return (bits[:, :m // 8 * 8].reshape(n, -1, 8).to(torch.int64) * weights).sum(-1)


def crc8_prefix(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """CRC8 of the first length[i] bytes of each row of data int[N, L]."""
    table = torch.from_numpy(CRC8).to(data.device)
    c = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    for j in range(int(length.max()) if len(length) else 0):
        c = torch.where(j < length, table[c ^ data[:, j].to(torch.int64)], c)
    return c
