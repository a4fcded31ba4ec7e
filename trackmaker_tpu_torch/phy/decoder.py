"""PHY decoder: 48 kHz captures -> frames (counterpart of ``trackmaker_tpu/phy/decoder.py``).

``decode_capture`` is the exact scan: the receiver's sequential decisions
replayed one candidate at a time.  From the cursor it takes the first
correlation hit, refines the frame start on the sync word (first maximum
wins), decodes and checks the header, applies the length, destination and
completeness rules, and moves the cursor by what the attempt consumed.
Manchester bodies never fail to decode, so the bodies of the accepted
frames are decoded and CRC-checked together afterwards.  A 4B5B body can
stop at an invalid symbol, and then the cursor moves by the valid part
only, so each 4B5B step decodes its body and checks its CRC in the scan;
the optimistic mode (``optimistic=True``) assumes no such stop, decodes
the bodies afterwards as Manchester does, and reports whether the
assumption held.  It is the fallback and the oracle of the speculative
decode (``phy/spec_decode.py``), which ``decode_capture_fast`` runs first.

``PhyDecoder`` is the receiver's chunked-feed facade, the one the MAC
(``link/``) polls: it buffers samples on the host and decodes the whole
buffer on every call, through the speculative decode's cursor where it
applies and the exact scan's elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.config import (
    FOUR_B_FIVE_B,
    FRAME_TYPE_ACK,
    FRAME_TYPE_DATA,
    MANCHESTER,
    PHY_HEADER_BYTES,
    PhyConfig,
)
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.sync import auto_xcorr
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.utils.trace import span, spanned

_BIG = 2**30
_HIT_BLOCK = 512   # the reference's hit lookup clamps the cursor to its blocks


class DecodedFrames(NamedTuple):
    """Fixed-size decode results over `max_frames` slots ([K] or [B, K])."""

    valid: torch.Tensor        # bool: CRC-passed frame addressed to us
    frame_bytes: torch.Tensor  # uint8[..., 7+max_frame_bytes] (zero-padded)
    length: torch.Tensor       # int32: payload length
    frame_type: torch.Tensor   # int32
    sequence: torch.Tensor     # int32
    src: torch.Tensor          # int32
    dst: torch.Tensor          # int32
    start: torch.Tensor        # int32: preamble start sample (-1 if empty)
    corr: torch.Tensor         # f32: detection correlation

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)

    def to_frames(self, row: int | None = None) -> list[Frame]:
        """Host side: the valid slots as Frame objects (pass `row` to pick
        one capture of a batch)."""
        valid = self.valid.cpu().numpy()
        fb = self.frame_bytes.cpu().numpy()
        ln = self.length.cpu().numpy()
        if row is not None:
            valid, fb, ln = valid[row], fb[row], ln[row]
        out = []
        for k in np.nonzero(valid)[0]:
            f = Frame.from_bytes(fb[k, : PHY_HEADER_BYTES + ln[k]].tobytes())
            assert f is not None
            out.append(f)
        return out


def _empty_frames(cfg: PhyConfig, k: int, device) -> DecodedFrames:
    z = torch.zeros(k, dtype=torch.int32, device=device)
    return DecodedFrames(
        valid=torch.zeros(k, dtype=torch.bool, device=device),
        frame_bytes=torch.zeros((k, PHY_HEADER_BYTES + cfg.max_frame_bytes),
                                dtype=torch.uint8, device=device),
        length=z, frame_type=z.clone(), sequence=z.clone(), src=z.clone(),
        dst=z.clone(), start=torch.full((k,), -1, dtype=torch.int32, device=device),
        corr=torch.zeros(k, dtype=torch.float32, device=device))


def _decode_body(cfg: PhyConfig, window: torch.Tensor, dlen: torch.Tensor):
    """(frame bytes, valid bit count, payload CRC8) of body windows
    f32[..., max_window] holding frames of `dlen` payload bytes.  Bits past
    the frame are zero in the bytes and do not count."""
    bits, bit_ok = line_coding.decode(cfg, window)
    total_bits = (PHY_HEADER_BYTES + dlen) * 8
    in_frame = torch.arange(bits.shape[-1], device=bits.device) < total_bits[..., None]
    n_valid_bits = (bit_ok & in_frame).sum(-1)
    frame_bytes = bitops.pack_bits(torch.where(in_frame, bits, 0))
    crc = bitops.crc8(frame_bytes[..., PHY_HEADER_BYTES:],
                      dlen.clamp(0, cfg.max_frame_bytes))
    return frame_bytes, n_valid_bits, crc


def _decode_body_opt(cfg: PhyConfig, window: torch.Tensor, dlen: torch.Tensor):
    """(frame bytes, non-conformant, payload CRC8) of 4B5B body windows
    f32[N, max_window] holding frames of `dlen` payload bytes, decoded
    optimistically: a frame is non-conformant when an invalid symbol or a
    near-zero level lies inside it."""
    bits, bit_ok, near0 = line_coding.fourb5b_decode_opt(window, cfg.samples_per_level)
    total_bits = (PHY_HEADER_BYTES + dlen) * 8
    in_frame = torch.arange(bits.shape[-1], device=bits.device) < total_bits[:, None]
    lvl_in_frame = (torch.arange(near0.shape[-1], device=bits.device)
                    < (total_bits // 4 * 5)[:, None])
    nonconf = (~bit_ok & in_frame).any(-1) | (near0 & lvl_in_frame).any(-1)
    masked = torch.where(in_frame, bits, 0)
    frame_bytes = bitops.pack_bits(masked)
    crc = bitops.crc8_bits(masked[:, PHY_HEADER_BYTES * 8:], dlen.clamp(0, cfg.max_frame_bytes))
    return frame_bytes, nonconf, crc


def decode_capture(
    cfg: PhyConfig,
    samples: torch.Tensor,       # f32[T]
    local_addr: int,
    max_frames: int = 64,
    valid_len: int | None = None,
    with_cursor: bool = False,
    start_cursor: int | None = None,
    scan_limit: int | None = None,
    optimistic: bool = False,
):
    """Decode one capture with the exact scan.

    `valid_len` is the true length of a zero-padded capture: frames that
    run past it are incomplete, and the scan stops on them.  The walk
    starts at `start_cursor` (earlier hits are skipped) and ends at the
    first candidate at or past `scan_limit`.  A local address below 0
    accepts every destination.  With ``with_cursor=True`` the result is
    ``(frames, searched_until, final_cursor)``, the last two as ints:
    `searched_until` is the start of a pending incomplete frame if the
    scan stopped on one, ``valid_len - (preamble_len - 1)`` if it ran out
    of candidates, else the cursor where `max_frames` ran out.

    ``optimistic=True`` (4B5B only, without the cursor) walks as if no
    attempted frame held an invalid symbol or a near-zero level, reading
    each header with ``fourb5b_decode_opt``, and decodes the attempted
    frames' bodies and CRCs in one pass after the walk.  It returns
    ``(frames, conformant)``: when `conformant` is False an attempted frame
    line-failed or held a near-zero level, or an examined header held one,
    so the walk may differ from the exact scan's from there on, and the
    caller must decode the capture again without it.  When True the frames
    equal the exact scan's, slot for slot.
    """
    if optimistic:
        assert cfg.line_coding == FOUR_B_FIVE_B, "optimistic mode is the 4B5B fast path"
        assert not with_cursor, "optimistic mode has no cursor semantics"
    if samples.ndim != 1:
        raise ValueError("samples must be f32[T]")
    x = samples.to(torch.float32)
    dev = x.device
    t = x.shape[0]
    vlen = t if valid_len is None else int(valid_len)
    cursor = 0 if start_cursor is None else int(start_cursor)
    limit = _BIG if scan_limit is None else int(scan_limit)

    pre = line_coding.preamble_waveform(cfg)
    l_pre = len(pre)
    sync_len, margin = cfg.sync_len, cfg.sync_margin
    hdr_samples, hdr_bits = cfg.header_samples, cfg.header_bits
    max_total_bytes = PHY_HEADER_BYTES + cfg.max_frame_bytes
    max_window = cfg.samples_for_bits(max_total_bytes * 8)
    # Manchester bodies decode in one batch after the scan: decoding each in
    # its step made a flagship row 75-112 ms in place of 44-68 ms (H100,
    # `chip_smoke.py` phase 4, two runs of each)
    body_in_scan = cfg.line_coding != MANCHESTER and not optimistic
    if t < l_pre:   # shorter than the preamble: nothing to find
        x = torch.nn.functional.pad(x, (0, l_pre - t))
        t = l_pre

    corr = auto_xcorr(x, pre, preamble_energy(pre))
    hits = torch.nonzero(corr >= cfg.correlation_threshold).flatten().cpu().numpy()
    last_lag = -(-corr.shape[0] // _HIT_BLOCK) * _HIT_BLOCK - 1
    padded = torch.nn.functional.pad(x, (0, max_window + l_pre + margin + sync_len + 8))
    sync = torch.from_numpy(pre[l_pre - sync_len:]).to(dev)
    sync_e = preamble_energy(pre[l_pre - sync_len:])
    n_pos = 2 * margin + 1
    k = torch.arange(n_pos, device=dev)
    win_idx = k[:, None] + torch.arange(sync_len, device=dev)
    hdr_idx = torch.arange(hdr_samples, device=dev)
    hdr_bit_idx = torch.arange(hdr_bits, device=dev)
    body_idx = torch.arange(max_window, device=dev)
    slab_len = 2 * margin + sync_len + hdr_samples

    done, pending = False, _BIG
    kept = []   # (slot, i, fs, dlen, ftype, seq, src, dst, crc)
    kept_bytes = []   # 4B5B: the frame bytes of each kept slot
    attempted = []    # optimistic: (fs, dlen) of each attempted frame
    attempt_row = {}  # optimistic: slot -> its row in `attempted`
    hdr_nonconf = False
    for step in range(max_frames):
        j = np.searchsorted(hits, min(max(cursor, 0), last_lag))
        first = int(hits[j]) if j < len(hits) else _BIG
        if first >= limit:            # no candidate left in this scan
            done = True
            break
        i = min(first, t)
        expected = i + l_pre - sync_len
        base = max(expected - margin, 0)
        slab = padded[base: base + slab_len]
        wins = slab[win_idx]
        dot = wins @ sync
        we = (wins * wins).sum(-1)
        cc = torch.where(we > 1e-6, dot / (torch.sqrt(we) * sync_e), 0.0)
        posk = base + k
        ok_k = ((posk >= expected - margin) & (posk <= expected + margin)
                & (posk <= vlen - sync_len))
        cc = torch.where(ok_k, cc, -torch.inf)
        best_pos = torch.where(cc.amax() > -1.0, base + cc.argmax(), expected)
        fs_t = best_pos + sync_len
        off = (fs_t - base).clamp(0, slab_len - hdr_samples)
        if optimistic:
            bits, bit_ok, near0 = line_coding.fourb5b_decode_opt(
                slab[off + hdr_idx], cfg.samples_per_level)
        else:
            bits, bit_ok = line_coding.decode(cfg, slab[off + hdr_idx])
        n_hdr = bit_ok[:hdr_bits].sum()
        hdr = bitops.pack_bits(torch.where(hdr_bit_idx < n_hdr, bits[:hdr_bits], 0))
        vals = [fs_t.reshape(1), n_hdr.reshape(1), hdr.to(torch.int64)]
        if optimistic:
            vals.append(near0.any().reshape(1))
        if body_in_scan:
            body_bytes, n_valid_bits, crc_calc = _decode_body(
                cfg, padded[fs_t + body_idx], hdr[0].to(torch.int64) * 256 + hdr[1])
            vals += [n_valid_bits.reshape(1), crc_calc.to(torch.int64).reshape(1)]
        fields = torch.cat(vals).tolist()   # the step's one host sync
        fs, n_hdr, dlen_hi, dlen_lo, crc, ftype, seq, src, dst = fields[:9]
        dlen = dlen_hi * 256 + dlen_lo
        # a near-zero level in any examined header: the receiver's skip
        # could change its bytes without an invalid symbol
        hdr_nonconf = hdr_nonconf or (optimistic and bool(fields[9]))

        hdr_incomplete = fs + hdr_samples > vlen
        header_ok = (n_hdr >= line_coding.MIN_HEADER_BITS
                     and ftype in (FRAME_TYPE_DATA, FRAME_TYPE_ACK))
        len_bad = (ftype == FRAME_TYPE_DATA and dlen == 0) or dlen > cfg.max_frame_bytes
        total_bits = (PHY_HEADER_BYTES + dlen) * 8
        total_samples = cfg.samples_for_bits(total_bits)
        incomplete = fs + total_samples > vlen
        if body_in_scan:
            n_valid_bits, crc_ok = fields[9], fields[10] == crc
        else:   # every bit decodes (optimistic: assumed); the CRC is checked after the scan
            n_valid_bits, crc_ok = total_bits, True
        line_fail = n_valid_bits < total_bits
        if hdr_incomplete or (header_ok and not len_bad and incomplete):
            # wait for more data: the drain point stays at this preamble
            pending = min(pending, i)
            done = True
            break
        if optimistic and header_ok and not len_bad:
            attempt_row[step] = len(attempted)
            attempted.append((fs, dlen))
        if (header_ok and not len_bad and not line_fail and crc_ok
                and (dst == local_addr or local_addr < 0)):
            kept.append((step, i, fs, dlen, ftype, seq, src, dst, crc))
            if body_in_scan:
                kept_bytes.append(body_bytes)
        if not header_ok:
            cursor = i + hdr_samples
        elif len_bad:
            cursor = i + 1
        elif line_fail:
            cursor = i + l_pre + cfg.samples_for_bits(n_valid_bits)
        else:
            cursor = i + l_pre + total_samples

    res = _empty_frames(cfg, max_frames, dev)
    conformant = not hdr_nonconf
    if optimistic and attempted:
        # every attempted frame's body, the foreign ones too: their
        # consumption depended on the assumption as well
        a_fs, a_dlen = (torch.tensor(col, device=dev) for col in zip(*attempted))
        body, nonconf, crc_opt = _decode_body_opt(cfg, padded[a_fs[:, None] + body_idx],
                                                  a_dlen)
        conformant = conformant and not bool(nonconf.any())
    if kept:
        slot, i, fs, dlen, ftype, seq, src, dst, crc = (
            torch.tensor(col, device=dev) for col in zip(*kept))
        if body_in_scan:
            frame_bytes = torch.stack(kept_bytes)
            good = torch.ones_like(slot, dtype=torch.bool)
        elif optimistic:   # kept frames are attempted ones: their rows of the pass
            rows = torch.tensor([attempt_row[k] for k, *_ in kept], device=dev)
            frame_bytes = body[rows]
            good = (crc_opt[rows].to(torch.int64) == crc) & ~nonconf[rows]
        else:
            frame_bytes, _, crc_calc = _decode_body(
                cfg, padded[fs[:, None] + body_idx], dlen)
            good = crc_calc.to(torch.int64) == crc
        slot = slot[good]
        res.valid[slot] = True
        res.frame_bytes[slot] = frame_bytes[good]
        for field, col in ((res.length, dlen), (res.frame_type, ftype),
                           (res.sequence, seq), (res.src, src), (res.dst, dst),
                           (res.start, i)):
            field[slot] = col[good].to(torch.int32)
        lag = i[good].clamp(0, corr.shape[0] - 1)
        res.corr[slot] = corr[lag]
    if optimistic:
        return res, conformant
    if not with_cursor:
        return res
    if pending < _BIG:
        searched = pending
    else:
        searched = vlen - (l_pre - 1) if done else cursor
    return res, min(max(searched, 0), vlen), cursor


def decode_captures(cfg: PhyConfig, x: torch.Tensor, local_addr: int,
                    max_frames: int, valid_len: list[int]) -> DecodedFrames:
    """The exact scan of every row of x f32[B, T], stacked to [B, K]."""
    rows = []
    for r in range(x.shape[0]):
        with span("tm.exact.row"):
            rows.append(decode_capture(cfg, x[r], local_addr, max_frames, valid_len=valid_len[r]))
    return DecodedFrames(*(torch.stack(col) for col in zip(*rows)))


def as_capture(samples, device: torch.device | str | None = None) -> torch.Tensor:
    """`samples` as float32 for the decode entry points: a tensor stays on
    its own device, a NumPy array goes to the card; `device` moves either."""
    if not isinstance(samples, torch.Tensor):
        samples = torch.from_numpy(np.asarray(samples, np.float32))
        device = "cuda" if device is None else device
    return samples.to(device=device, dtype=torch.float32)


@spanned("tm.entry.decode")
def decode_capture_fast(
    cfg: PhyConfig,
    samples: torch.Tensor,       # f32[T] or f32[B, T]
    local_addr: int,
    max_frames: int = 64,
    valid_len=None,              # int, or int per row of a zero-padded batch
) -> DecodedFrames:
    """Batch decode through the speculative path where it applies.

    The speculative decode (kernels on a CUDA tensor, their plain versions
    on a CPU tensor) runs first; the rows it flags not ``ok`` (a candidate
    table that overflowed, or, for 4B5B, a near-zero level in an attempted
    frame) are decoded again by the exact scan and take its result.  A 4B5B
    configuration the kernels do not cover takes the optimistic scan first
    (``decode_capture(optimistic=True)``), and its rows that are not
    conformant the exact scan.  Every row equals :func:`decode_capture`
    frame for frame; the speculative rows hold their frames in the leading
    slots, the others in the exact scan's.
    """
    from trackmaker_tpu_torch.phy import spec_decode

    x = samples.to(torch.float32)
    batched = x.ndim == 2
    xb = x if batched else x[None]
    b, t = xb.shape
    vlens = torch.as_tensor(t if valid_len is None else valid_len,
                            dtype=torch.int32).expand(b).tolist()
    if spec_decode.spec_supported_cfg(cfg):
        res, ok = spec_decode.decode_capture_spec(
            cfg, xb, local_addr, max_frames=max_frames, valid_len=vlens)
        with span("tm.entry.ok_sync"):
            redo = torch.nonzero(~ok).flatten().tolist()
        if redo:
            exact = decode_captures(cfg, xb[redo], local_addr, max_frames,
                                    [vlens[r] for r in redo])
            for field, fix in zip(res, exact):
                field[redo] = fix
    elif cfg.line_coding == FOUR_B_FIVE_B:
        rows = [decode_capture(cfg, xb[r], local_addr, max_frames, valid_len=vlens[r],
                               optimistic=True) for r in range(b)]
        rows = [res_r if conformant else decode_capture(cfg, xb[r], local_addr, max_frames,
                                                        valid_len=vlens[r])
                for r, (res_r, conformant) in enumerate(rows)]
        res = DecodedFrames(*(torch.stack(col) for col in zip(*rows)))
    else:
        res = decode_captures(cfg, xb, local_addr, max_frames, vlens)
    return res if batched else DecodedFrames(*(f[0] for f in res))


class PhyDecoder:
    """Host streaming facade with the receiver's chunked-feed API.

    Buffers incoming sample chunks (host NumPy) and, on every call that
    leaves at least a preamble and a header buffered, decodes the whole
    buffer, zero-padded to a power-of-two bucket of at least 4,096 samples
    and copied to `device` (the card unless the caller asks for another),
    with ``valid_len`` its true length.  The speculative decode runs where
    ``spec_decode.spec_supported_cfg`` holds (its kernels on the card, their
    plain versions on the CPU); a row it flags not ``ok``, and every other
    configuration, takes the exact scan.  Either way the searched prefix is
    dropped after the call, so a frame cut by the buffer's end is decoded
    again, whole, on a later call.  ``decode_calls`` counts the decodes and
    ``exact_calls`` those the exact scan made.
    """

    def __init__(self, cfg: PhyConfig, local_addr: int,
                 max_frames_per_call: int = 64,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frames = max_frames_per_call
        self.device = torch.device(device)
        self._buf = np.zeros(0, dtype=np.float32)
        self.decode_calls = 0
        self.exact_calls = 0

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)

    @staticmethod
    def _bucket(n: int, min_bucket: int = 4096) -> int:
        b = min_bucket
        while b < n:
            b *= 2
        return b

    def process_samples(self, samples) -> list[Frame]:
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        if len(self._buf) < self.cfg.preamble_len + self.cfg.header_samples:
            return []
        n = len(self._buf)
        padded = np.zeros(self._bucket(n), np.float32)
        padded[:n] = self._buf
        res, searched = self._decode_with_cursor(
            torch.from_numpy(padded).to(self.device), n)
        frames = res.to_frames()
        # drain the searched prefix even when nothing decoded: a noise-only
        # stream would otherwise grow the buffer and decode it again and again
        if searched > 0:
            self._buf = self._buf[searched:]
        return frames

    def _decode_with_cursor(self, padded: torch.Tensor, n: int) -> tuple[DecodedFrames, int]:
        """(frames, searched_until) of one padded buffer of true length n."""
        from trackmaker_tpu_torch.phy import spec_decode

        self.decode_calls += 1
        if spec_decode.spec_supported_cfg(self.cfg):
            res, ok, searched, _ = spec_decode.decode_capture_spec(
                self.cfg, padded[None], self.local_addr,
                max_frames=self.max_frames, valid_len=n, with_cursor=True)
            ok_row, searched_row = torch.stack(
                [ok[0].to(torch.int32), searched[0]]).tolist()
            if ok_row:
                return DecodedFrames(*(f[0] for f in res)), searched_row
        self.exact_calls += 1
        res, searched, _ = decode_capture(
            self.cfg, padded, self.local_addr, max_frames=self.max_frames,
            valid_len=n, with_cursor=True)
        return res, searched
