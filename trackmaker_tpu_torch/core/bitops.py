"""Bit packing and CRC8 on tensors (counterpart of ``trackmaker_tpu/core/bitops.py``).

CRC8 uses poly 0x07 with init 0x00.  The host versions work on bytes and
numpy arrays; the tensor versions batch over any leading axes and run on
whatever device their input lies on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CRC8_POLY = 0x07


def _build_crc8_table(poly: int = CRC8_POLY) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
        table[byte] = crc
    return table


CRC8_TABLE = _build_crc8_table()


def crc8_host(data: bytes | np.ndarray) -> int:
    """CRC8 of a byte string."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    crc = np.uint8(0)
    for b in arr:
        crc = CRC8_TABLE[crc ^ b]
    return int(crc)


def bytes_to_bits_host(data: bytes | np.ndarray) -> np.ndarray:
    """MSB-first unpack."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return np.unpackbits(arr)


def bits_to_bytes_host(bits: np.ndarray) -> np.ndarray:
    """MSB-first pack; a trailing partial byte is zero-padded on the right."""
    return np.packbits(np.asarray(bits, dtype=np.uint8))


def unpack_bits(bytes_t: torch.Tensor) -> torch.Tensor:
    """uint8[..., N] -> uint8[..., N*8], MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bytes_t.device)
    bits = (bytes_t.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(*bytes_t.shape[:-1], bytes_t.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., N*8] -> uint8[..., N], MSB first (N*8 must divide by 8)."""
    n = bits.shape[-1]
    if n % 8:
        raise ValueError("pack_bits needs a multiple of 8 bits")
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=bits.device)
    grouped = bits.reshape(*bits.shape[:-1], n // 8, 8).to(torch.int32)
    return (grouped * weights).sum(-1).to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _crc8_distance_table(n: int) -> np.ndarray:
    """T[d, b] = CRC8 of byte b followed by d zero bytes, for d in [0, n)."""
    table = np.zeros((max(n, 1), 256), dtype=np.uint8)
    table[0] = CRC8_TABLE
    for d in range(1, n):
        table[d] = CRC8_TABLE[table[d - 1]]
    return table


def crc8(data: torch.Tensor, length: torch.Tensor | None = None) -> torch.Tensor:
    """CRC8 over uint8[..., N] with an optional per-item `length`.

    Bytes at index >= length do not enter the CRC.  A zero-init CRC8 is
    linear over GF(2), so the CRC is the XOR of each byte's contribution
    at its distance from the message end: one table gather, then an XOR
    tree over the byte axis.  Exact integer arithmetic throughout.
    """
    dev = data.device
    n = data.shape[-1]
    lead = data.shape[:-1]
    if length is None:
        length = torch.full(lead, n, dtype=torch.int64, device=dev)
    length = torch.as_tensor(length, device=dev).to(torch.int64).expand(lead)
    if n == 0:
        return torch.zeros(lead, dtype=torch.uint8, device=dev)
    table = torch.from_numpy(_crc8_distance_table(n).reshape(-1)).to(dev)
    idx = torch.arange(n, device=dev)
    dist = length[..., None] - 1 - idx
    contrib = table[dist.clamp(min=0) * 256 + data.to(torch.int64)]
    contrib = torch.where(idx < length[..., None], contrib, 0)
    width = 1 << (n - 1).bit_length()
    if width > n:
        contrib = torch.nn.functional.pad(contrib, (0, width - n))
    while contrib.shape[-1] > 1:
        half = contrib.shape[-1] // 2
        contrib = contrib[..., :half] ^ contrib[..., half:]
    return contrib[..., 0]


def crc8_bits(bits: torch.Tensor, length_bytes) -> torch.Tensor:
    """CRC8 of MSB-first message bits uint8[..., N*8] that are zero past
    `length_bytes` bytes (counterpart of ``crc8_bits_matmul``, whose GF(2)
    matmul is a TPU construction): the bits packed, then :func:`crc8`."""
    return crc8(pack_bits(bits), length_bytes)
