"""Forward error correction on bit tensors (counterpart of
``trackmaker_tpu/core/fec.py``).

* Hamming(7,4) with single-error correction: encode is a product with the
  generator over GF(2); decode computes every codeword's 3-bit syndrome and
  flips the bit it names.
* A block interleaver: a plain transpose that spreads burst errors (a fade
  over adjacent subcarriers) across codewords.

Bits are uint8 tensors of 0s and 1s on any device, batched over leading
axes.  The GF(2) products are integer sums, so no float matmul enters.
"""

from __future__ import annotations

import numpy as np
import torch

# G: 4 data bits -> 7 coded bits [d1 d2 d3 d4 p1 p2 p3]
_G = np.asarray([
    [1, 0, 0, 0, 1, 1, 0],
    [0, 1, 0, 0, 1, 0, 1],
    [0, 0, 1, 0, 0, 1, 1],
    [0, 0, 0, 1, 1, 1, 1],
], dtype=np.int32)

# H: parity check (3 x 7); syndrome = H c^T
_H = np.asarray([
    [1, 1, 0, 1, 1, 0, 0],
    [1, 0, 1, 1, 0, 1, 0],
    [0, 1, 1, 1, 0, 0, 1],
], dtype=np.int32)

# syndrome value (as integer b2b1b0 from H rows) -> bit position to flip,
# 7 = no flip
_SYN2BIT = np.full(8, 7, dtype=np.int64)
for _i in range(7):
    _SYN2BIT[(_H[0, _i] << 2) | (_H[1, _i] << 1) | _H[2, _i]] = _i


def _gf2_product(v: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(v @ m) % 2 for int bits v[..., k, r] and a host matrix m[r, c]."""
    mt = torch.from_numpy(m).to(v.device)
    return (v[..., :, None] * mt).sum(-2) % 2


def _pad_last(bits: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(bits, (0, pad)) if pad else bits


def hamming74_encode(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., n] -> uint8[..., 7·ceil(n/4)] (the input zero-padded to a
    multiple of 4)."""
    bits = _pad_last(bits, (-bits.shape[-1]) % 4)
    nib = bits.reshape(*bits.shape[:-1], -1, 4).to(torch.int32)
    code = _gf2_product(nib, _G)
    return code.reshape(*code.shape[:-2], -1).to(torch.uint8)


def hamming74_decode(coded: torch.Tensor) -> torch.Tensor:
    """uint8[..., 7k] -> uint8[..., 4k], correcting one bit a codeword."""
    if coded.shape[-1] % 7:
        raise ValueError(f"{coded.shape[-1]} coded bits are not whole codewords")
    cw = coded.reshape(*coded.shape[:-1], -1, 7).to(torch.int32)
    syn = _gf2_product(cw, _H.T)                                  # (..., k, 3)
    syn_val = (syn[..., 0] << 2) | (syn[..., 1] << 1) | syn[..., 2]
    flip_pos = torch.from_numpy(_SYN2BIT).to(cw.device)[syn_val.to(torch.int64)]
    flip = (torch.arange(7, device=cw.device) == flip_pos[..., None]).to(torch.int32)
    data = ((cw ^ flip) & 1)[..., :4]
    return data.reshape(*data.shape[:-2], -1).to(torch.uint8)


def interleave(bits: torch.Tensor, depth: int) -> torch.Tensor:
    """Block interleaver along the last axis: `depth` rows written in
    order, read out by column (zero-padded to a multiple of `depth`)."""
    cols = -(-bits.shape[-1] // depth)
    bits = _pad_last(bits, depth * cols - bits.shape[-1])
    m = bits.reshape(*bits.shape[:-1], depth, cols)
    return m.transpose(-1, -2).reshape(*bits.shape[:-1], depth * cols)


def deinterleave(bits: torch.Tensor, depth: int, out_len: int) -> torch.Tensor:
    """The inverse of :func:`interleave`, cut to `out_len` bits."""
    n = bits.shape[-1]
    m = bits.reshape(*bits.shape[:-1], n // depth, depth)
    return m.transpose(-1, -2).reshape(*bits.shape[:-1], n)[..., :out_len]


def coded_len(n_bits: int) -> int:
    """Hamming(7,4) output length for n data bits."""
    return (-(-n_bits // 4)) * 7
