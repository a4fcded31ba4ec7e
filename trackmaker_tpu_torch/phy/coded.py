"""Viterbi-coded line-coded PHYs (counterpart of ``trackmaker_tpu/phy/coded.py``):
forward error correction under the CRC for the Manchester and 4B5B+NRZI
waveforms, at rate 1/2 or, punctured, 3/4.

Wire format per frame: preamble ‖ wire(interleaved [punctured]
conv(header, 56 bits)) ‖ wire(interleaved [punctured] conv(payload)).  The
header and the payload are code blocks of their own, each flushed, so the
length decodes from a fixed-size prefix; each block's waveform starts the
line code afresh (NRZI level +1).

Soft values per waveform, as the JAX package computes them:

* Manchester: mean(second half) - mean(first half) of each bit;
* 4B5B+NRZI: the level means, the transition metric -l[t-1]·l[t]
  (positive = a transition = wire bit 1), and a max-log-MAP demap over
  the 16 codewords: each data bit's value is the best codeword score with
  the bit 1 less the best with it 0.

The Viterbi decoder decides on these values, so they equal the JAX
package's bit for bit, and so follow the arithmetic XLA gives them on the
CPU: a mean is the samples summed in index order times the f32 reciprocal
of their count; the Manchester difference fuses the second half's product
into the subtraction (an FMA, computed exactly in f64 here); a codeword
score sums its five signed metrics in order or pairwise, as XLA's dot
does at the product's size (``XLA_ORDERED_DOT_ROWS``).  No step uses
``torch.mean`` or a matmul, whose order on the card is not this one.  A block's deinterleave is an index gather by the
inverse permutation, and a window past the padded capture starts where
``jax.lax.dynamic_slice`` clamps it.

``decode_equal_frames`` is the batched decode of captures each holding
equal-length frames (``batched_decode_fn``): one pattern sync
(``sync.find_pattern_starts``, kernel #1's dense correlation), one soft
demod of every header and every payload, and one Viterbi launch
(``csrc/viterbi.cu``) for all headers and one for all payloads.
``process_samples`` is the streaming receiver, the MAC's duck type
(``encode_frames`` / ``process_samples`` / ``reset``): its buffer lives on
the host and each call copies it, zero-padded to a power-of-two bucket, to
the PHY's device once; a hit on the correlation there becomes a header
decode, then a payload decode.  Every PHY takes `device`, the card unless
the caller asks for another.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu_torch.core.convcode import (
    block_interleaver,
    conv_encode,
    depuncture_34,
    puncture_34,
    punctured_len_34,
    viterbi_decode,
)
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy.ofdm import _bucket, _join, const
from trackmaker_tpu_torch.sync import auto_xcorr, find_pattern_starts


def _windows(padded: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """padded[b, start[b, ...] + i] for i < n, f32[B, ..., n], each start
    clamped to [0, T - n] as ``jax.lax.dynamic_slice`` clamps it."""
    b, t = padded.shape
    begin = start.to(torch.int64).clamp(min=0, max=t - n)
    idx = begin[..., None] + torch.arange(n, device=padded.device)
    return padded.gather(1, idx.reshape(b, -1)).reshape(idx.shape)


# XLA's CPU dot sums a codeword score's five products in order where the
# whole product has at most this many symbol rows, and as ((p0 + p1) +
# (p2 + p3)) + p4 beyond (tests/test_torch_coded.py pins both sides)
XLA_ORDERED_DOT_ROWS = 50


def _level_sums(seg: torch.Tensor, spl: int) -> torch.Tensor:
    """f32[..., n·spl] -> each run of spl samples summed in index order,
    f32[..., n]."""
    x = seg.reshape(*seg.shape[:-1], -1, spl)
    acc = x[..., 0]
    for k in range(1, spl):
        acc = acc + x[..., k]
    return acc


def _recip(spl: int) -> float:
    """The f32 reciprocal of spl: XLA's CPU ``jnp.mean`` multiplies by it."""
    return float(np.float32(1.0) / np.float32(spl))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to f32, for f32 tensors, on any device: the
    product is exact in f64, the f64 sum and its error (TwoSum) give the
    exact result, and where the f64 sum lies on an f32 midpoint the error's
    sign picks the side."""
    c64 = c.double()
    p = a.double() * b.double()
    s = p + c64
    bp = s - c64
    e = (p - bp) + (c64 - (s - bp))          # p + c == s + e exactly
    y = s.float()
    d = s - y.double()
    y2 = torch.nextafter(y, torch.where(d > 0, torch.inf, -torch.inf).to(y.dtype))
    tie = (d != 0) & ((y.double() + y2.double()) * 0.5 == s)
    return torch.where(tie & (e != 0) & ((e > 0) == (d > 0)), y2, y)


def soft_bits(spl: int, padded: torch.Tensor, n_bits: int, start: torch.Tensor) -> torch.Tensor:
    """Soft Manchester values f32[B, ..., n_bits] of the n_bits bits from
    sample start[b, ...] of padded f32[B, T]: mean(second half) - mean(first
    half), positive = bit 1, as XLA computes it on the CPU: each half's
    samples summed in index order, times the f32 reciprocal of spl, the
    second half's product fused with the subtraction, fma(s1, 1/spl,
    -(s0 · 1/spl))."""
    sums = _level_sums(_windows(padded, start, n_bits * 2 * spl), spl)
    sums = sums.reshape(*sums.shape[:-1], n_bits, 2)
    r = _recip(spl)
    return fma_f32(sums[..., 1], torch.full_like(sums[..., 1], r), -(sums[..., 0] * r))


@functools.lru_cache(maxsize=2)
def _demap_tables() -> tuple[np.ndarray, np.ndarray]:
    """(codewords as +-1 (16, 5), data-bit membership (16, 4))."""
    cw = ((line_coding.FOURB_FIVEB_ENCODE[:, None]
           >> np.arange(4, -1, -1)) & 1).astype(np.float32) * 2.0 - 1.0
    nb = ((np.arange(16)[:, None] >> np.arange(3, -1, -1)) & 1).astype(bool)
    return cw, nb


def soft_bits_4b5b(spl: int, padded: torch.Tensor, n_sym: int,
                   start: torch.Tensor) -> torch.Tensor:
    """Max-log-MAP soft 4B5B demap f32[B, ..., n_sym·4] of the n_sym symbols
    from sample start[b, ...] of padded f32[B, T]: level means, transition
    metrics from a fresh NRZI level +1, each data bit's best codeword score
    with the bit 1 less the best with it 0.  Positive = coded bit 1."""
    avg = _level_sums(_windows(padded, start, n_sym * 5 * spl), spl) * _recip(spl)
    prev = torch.cat([torch.ones_like(avg[..., :1]), avg[..., :-1]], dim=-1)
    tr = -(prev * avg)                                   # > 0 <=> a transition
    tr = tr.reshape(*tr.shape[:-1], n_sym, 5, 1)
    cw, nb = _demap_tables()
    cw_t = const(cw.T.copy().reshape(-1), padded.device).reshape(5, 16)
    p = tr * cw_t                                          # [..., n_sym, 5, 16], exact
    if tr.numel() // 5 <= XLA_ORDERED_DOT_ROWS:
        scores = (((p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]) + p[..., 3, :]) + p[..., 4, :]
    else:
        scores = ((p[..., 0, :] + p[..., 1, :]) + (p[..., 2, :] + p[..., 3, :])) + p[..., 4, :]
    member = const(nb.T.copy().reshape(-1), padded.device).reshape(4, 16)
    s = scores[..., None, :]
    pos = torch.where(member, s, -1e30).amax(-1)
    neg = torch.where(~member, s, -1e30).amax(-1)         # [..., n_sym, 4]
    return (pos - neg).reshape(*pos.shape[:-2], n_sym * 4)


class _CodedPhyBase:
    """The code arithmetic, the encoder and both receivers of the coded
    line-coded PHYs; a subclass supplies the waveform."""

    HDR_BITS = 56
    HDR_CODED = 2 * (56 + 6)          # 124 mother-code bits

    def __init__(self, cfg: PhyConfig, max_frame_bytes: int, local_addr: int | None,
                 rate34: bool, device: torch.device | str):
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.rate34 = rate34
        self.device = torch.device(device)
        self.pre = line_coding.preamble_waveform(cfg)
        self.preamble_len = len(self.pre)
        self.hdr_kept = self._kept(self.HDR_CODED)
        self.max_kept = self._kept_payload(max_frame_bytes - 7)
        self._buf = np.zeros(0, np.float32)
        self.decode_calls = 0

    # -- code arithmetic -------------------------------------------------------------

    def _kept(self, n_coded: int) -> int:
        return punctured_len_34(n_coded) if self.rate34 else n_coded

    @staticmethod
    def _payload_coded(n_payload_bytes: int) -> int:
        return 2 * (8 * n_payload_bytes + 6)

    def _kept_payload(self, n_payload_bytes: int) -> int:
        return self._kept(self._payload_coded(n_payload_bytes))

    def frame_samples(self, n_payload: int) -> int:
        return (self.preamble_len + self._wire_samples(self.hdr_kept)
                + self._wire_samples(self._kept_payload(n_payload)))

    # -- waveform hooks (subclass) -----------------------------------------------------

    def _wire_samples(self, n_kept: int) -> int:
        raise NotImplementedError

    def _encode_kept(self, kept_bits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _soft_kept(self, padded: torch.Tensor, n_kept: int, start: torch.Tensor) -> torch.Tensor:
        """Soft values f32[B, ..., n_kept] of the first n_kept transmitted bits
        of the blocks starting at samples start[b, ...] of padded f32[B, T]."""
        raise NotImplementedError

    # -- the batched decode (equal-length frames) ----------------------------------------

    def _deinterleave(self, soft: torch.Tensor, n_coded: int) -> torch.Tensor:
        """soft f32[..., kept] -> the decoder's input f32[..., n_coded]: a
        gather by the inverse permutation, then the depuncture at rate 3/4."""
        inv = np.argsort(block_interleaver(soft.shape[-1]))
        deint = soft[..., const(inv, soft.device)]
        return depuncture_34(deint, n_coded) if self.rate34 else deint

    def soft_blocks(self, x: torch.Tensor, starts: torch.Tensor, payload_len: int):
        """(headers f32[B, F, 124], payloads f32[B, F, 2·(8·payload_len + 6)]):
        the Viterbi decoder's inputs for the frames whose preambles start at
        starts int[B, F] (-1 read as 0) in captures x f32[B, T], x padded by
        zeros past its end as the batched decode pads it."""
        kept_h, kept_p = self.hdr_kept, self._kept_payload(payload_len)
        hdr_wire = self._wire_samples(kept_h)
        tail = (self.preamble_len + hdr_wire + self._wire_samples(kept_p)
                + 16 * self.cfg.samples_per_level + 64)
        pad = torch.nn.functional.pad(x.to(torch.float32), (0, tail))
        body = starts.clamp(min=0).to(torch.int64) + self.preamble_len
        return (self._deinterleave(self._soft_kept(pad, kept_h, body), self.HDR_CODED),
                self._deinterleave(self._soft_kept(pad, kept_p, body + hdr_wire),
                                   self._payload_coded(payload_len)))

    def batched_decode_fn(self, n_frames: int, payload_len: int):
        """The batch decoder ``x f32[B, T] -> (starts int32[B, n_frames], bits
        uint8[B, n_frames, 56 + 8·payload_len])`` of captures holding
        equal-length coded frames, on x's device: the pattern sync at the
        correlation threshold with the cursor moved a frame past each start,
        the soft demod of every header and payload, the deinterleave, [the
        depuncture,] and one Viterbi call for all headers and one for all
        payloads."""
        frame_len = self.frame_samples(payload_len)

        def decode(x: torch.Tensor):
            starts = find_pattern_starts(x.to(torch.float32), self.pre,
                                         self.cfg.correlation_threshold, n_frames,
                                         min_sep=frame_len)
            hdr, pay = self.soft_blocks(x, starts, payload_len)
            return starts, torch.cat([viterbi_decode(hdr, self.HDR_BITS, soft=True),
                                      viterbi_decode(pay, 8 * payload_len, soft=True)], dim=-1)

        return decode

    def decode_equal_frames(self, caps, n_frames: int, payload_len: int) -> list[list[Frame]]:
        """The CRC-valid frames (addressed to this PHY, where it has an
        address) of each capture of caps f32[B, T], each holding up to
        `n_frames` frames of `payload_len` bytes: a tensor decodes on its own
        device, a NumPy array on the PHY's."""
        if not isinstance(caps, torch.Tensor):
            caps = torch.from_numpy(np.asarray(caps, np.float32)).to(self.device)
        starts, bits = self.batched_decode_fn(n_frames, payload_len)(caps)
        starts, bits = starts.cpu().numpy(), bits.cpu().numpy()
        out: list[list[Frame]] = []
        for b in range(bits.shape[0]):
            row = []
            for k in range(bits.shape[1]):
                if starts[b, k] < 0:
                    continue
                f = Frame.from_bits(bits[b, k])
                if f is None or (self.local_addr is not None and f.dst != self.local_addr):
                    continue
                row.append(f)
            out.append(row)
        return out

    # -- encoder side --------------------------------------------------------------------

    def _encode_block(self, bits: np.ndarray) -> torch.Tensor:
        coded = conv_encode(torch.from_numpy(bits).to(self.device))
        if self.rate34:
            coded = puncture_34(coded)
        perm = block_interleaver(coded.shape[-1])
        return self._encode_kept(coded[const(perm, self.device)])

    def encode_frame(self, frame: Frame) -> np.ndarray:
        fb = frame.to_bytes()
        hdr = bitops.bytes_to_bits_host(fb[:7])
        pay = bitops.bytes_to_bits_host(fb[7:]) if len(fb) > 7 else np.zeros(0, np.uint8)
        body = torch.cat([self._encode_block(hdr), self._encode_block(pay)]).cpu().numpy()
        return np.concatenate([self.pre, body])

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        return _join([self.encode_frame(f) for f in frames], gap_samples)

    # -- streaming decoder side ----------------------------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def _correlate(self, pj: torch.Tensor) -> np.ndarray:
        """The preamble's normalized correlation of a padded bucket on the
        device (``auto_xcorr``: kernel #1's dense form), read to the host."""
        self.decode_calls += 1
        return auto_xcorr(pj, self.pre).cpu().numpy()

    def _decode_at(self, pj: torch.Tensor, n_kept: int, n_kept_max: int, start: int,
                   n_coded: int, n_bits: int) -> np.ndarray:
        """The n_bits bits of the block at sample `start` of the bucket: the
        soft values of a block of n_kept_max (its window as the JAX package
        clamps it), the first n_kept decoded."""
        at = torch.full((1, 1), start, dtype=torch.int64, device=pj.device)
        soft = self._soft_kept(pj[None], n_kept_max, at)[0, 0, :n_kept]
        return viterbi_decode(self._deinterleave(soft, n_coded), n_bits, soft=True).cpu().numpy()

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        cfg = self.cfg
        if len(self._buf) < self.preamble_len + 1:
            return []
        out: list[Frame] = []
        hdr_wire = self._wire_samples(self.hdr_kept)
        padded = np.zeros(_bucket(len(self._buf) + hdr_wire
                                  + self._wire_samples(self.max_kept) + 8), np.float32)
        padded[: len(self._buf)] = self._buf
        pj = torch.from_numpy(padded).to(self.device)
        corr = self._correlate(pj)
        hits = np.nonzero(corr[: max(len(self._buf) - self.preamble_len + 1, 0)]
                          >= cfg.correlation_threshold)[0]
        consumed = 0
        k = 0
        # the 0x33 pattern bytes are 4-bit periodic, so a window partly over
        # the preamble can cross a lowered threshold a period early: refine
        # over the whole preamble (the next frame is a frame away)
        refine = self.preamble_len
        while k < len(hits):
            i = int(hits[k])
            if i < consumed:
                k += 1
                continue
            s = i + int(np.argmax(corr[i: i + refine]))
            body = s + self.preamble_len
            if body + hdr_wire > len(self._buf):
                break  # header still arriving
            hdr_bits = self._decode_at(pj, self.hdr_kept, self.hdr_kept, body,
                                       self.HDR_CODED, self.HDR_BITS)
            hdr = np.packbits(hdr_bits)
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - 7:
                consumed = s + self.preamble_len
                k += 1
                continue
            kept_p = self._kept_payload(data_len)
            frame_end = body + hdr_wire + self._wire_samples(kept_p)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            if data_len:
                pay_bits = self._decode_at(pj, kept_p, self.max_kept, body + hdr_wire,
                                           self._payload_coded(data_len), 8 * data_len)
            else:
                pay_bits = np.zeros(0, np.uint8)
            f = Frame.from_bits(np.concatenate([hdr_bits, pay_bits]))
            consumed = frame_end
            k += 1
            if f is None:
                continue
            if self.local_addr is not None and f.dst != self.local_addr:
                continue
            out.append(f)
        if consumed:
            keep = max(consumed - (self.preamble_len - 1), 0)
            self._buf = self._buf[keep:]
        elif len(self._buf) > 10 * 48_000:
            self._buf = self._buf[-self.preamble_len:]
        return out


class CodedManchesterPhy(_CodedPhyBase):
    """Streaming coded-Manchester PHY (MAC duck type), on `device`."""

    def __init__(self, cfg: PhyConfig = PhyConfig(), max_frame_bytes: int = 263,
                 local_addr: int | None = None, rate34: bool = False,
                 device: torch.device | str = "cuda"):
        if cfg.line_coding != MANCHESTER:
            raise ValueError("CodedManchesterPhy is defined on the Manchester waveform")
        super().__init__(cfg, max_frame_bytes, local_addr, rate34, device)

    def _wire_samples(self, n_kept: int) -> int:
        return n_kept * 2 * self.cfg.samples_per_level

    def _encode_kept(self, kept_bits: torch.Tensor) -> torch.Tensor:
        return line_coding.manchester_encode(kept_bits, self.cfg.samples_per_level)

    def _soft_kept(self, padded, n_kept, start):
        return soft_bits(self.cfg.samples_per_level, padded, n_kept, start)


class CodedFourB5BPhy(_CodedPhyBase):
    """Streaming coded 4B5B+NRZI PHY (MAC duck type), on `device`: 1.6x the
    coded-Manchester wire density at the same code rate; the soft demapper
    weighs only the 16 valid codewords."""

    def __init__(self, cfg: PhyConfig = PhyConfig(line_coding=FOUR_B_FIVE_B),
                 max_frame_bytes: int = 263, local_addr: int | None = None,
                 rate34: bool = False, device: torch.device | str = "cuda"):
        if cfg.line_coding != FOUR_B_FIVE_B:
            raise ValueError("CodedFourB5BPhy is defined on the 4B5B+NRZI waveform")
        super().__init__(cfg, max_frame_bytes, local_addr, rate34, device)

    @staticmethod
    def _n_sym(n_kept: int) -> int:
        return -(-n_kept // 4)

    def _wire_samples(self, n_kept: int) -> int:
        return self._n_sym(n_kept) * 5 * self.cfg.samples_per_level

    def _encode_kept(self, kept_bits: torch.Tensor) -> torch.Tensor:
        pad = (-kept_bits.shape[-1]) % 4
        if pad:
            kept_bits = torch.nn.functional.pad(kept_bits, (0, pad))
        return line_coding.fourb5b_encode(kept_bits, self.cfg.samples_per_level)

    def _soft_kept(self, padded, n_kept, start):
        return soft_bits_4b5b(self.cfg.samples_per_level, padded, self._n_sym(n_kept),
                              start)[..., :n_kept]
