"""The plain reference of the line-coded PHY receivers: the exact scan.

TrackMaker-rs's receiver walks a recording with a cursor.  At each step it
takes the first lag at or past the cursor whose normalized correlation
with the preamble reaches the threshold, refines the frame start on the
sync word within +-1 bit (the first maximum wins), decodes the 7-byte
header and applies its rules, and moves the cursor past what the attempt
consumed:

* a header with fewer than 49 valid bits or another type than DATA or ACK
  consumes the header's samples;
* a zero-length DATA frame or a length over the body cap consumes 1 sample;
* a 4B5B frame whose body meets a symbol outside the table consumes its
  valid part; any other frame consumes the preamble and the whole frame;
* a header or an announced frame that runs past the recording's end stops
  the walk, as does the end of the hits or `max_frames` steps.

A frame is kept when its header holds, its length is sane, every bit
decoded, its CRC8 matches and it is addressed to the local address (a
local address below 0 takes every destination).

This module computes the same decisions from the samples alone, in plain
PyTorch on whatever device the samples lie on, in the precision it is
asked for (float64 for the reference; a lower one for the control), and
the walk on the host.  Each candidate's refine, header and body depend only
on its lag, so they are computed for every hit at once, and the walk then
replays the cursor over them.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import phy as P

LAG_BLOCK = 512      # the receiver's hit lookup clamps the cursor to its blocks of lags
ENERGY_EPS = 1e-6    # windows with less energy than this correlate to 0
HIT_CHUNK = 1024     # candidates decoded at once
ROW_BLOCK_SAMPLES = 2**26   # samples of the recordings correlated at once


def correlate(x: torch.Tensor, pattern: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """corr[r, i] = <x[r, i:i+L], p> / max(||x[r, i:i+L]|| ||p||, 1e-30), 0
    where the window's energy is under ENERGY_EPS, for every lag of the
    rows x [R, T], computed in `dtype` by one shifted product a tap."""
    xd = x.to(dtype)
    l = len(pattern)
    n = xd.shape[1] - l + 1
    p = torch.from_numpy(pattern.astype(np.float64)).to(dtype=dtype, device=x.device)
    sq = xd * xd
    dot = torch.zeros((xd.shape[0], n), dtype=dtype, device=x.device)
    energy = torch.zeros_like(dot)
    for k in range(l):
        dot += p[k] * xd[:, k:k + n]
        energy += sq[:, k:k + n]
    pe = torch.sqrt((p * p).sum())
    denom = (torch.sqrt(energy.clamp(min=0)) * pe).clamp(min=1e-30)
    return torch.where(energy < ENERGY_EPS, torch.zeros((), dtype=dtype, device=x.device),
                       dot / denom)


def candidates(phy: P.Phy, xpad: torch.Tensor, rows: torch.Tensor, lags: torch.Tensor,
               vlen: int, dtype: torch.dtype) -> dict:
    """The cursor-independent decisions of the candidates at `lags` of
    rows `rows` of the zero-padded recordings xpad [R, T + pad]: the
    refined frame start, the header fields, the valid bits of the largest
    frame, the frame bytes and the payload CRC8, as host NumPy arrays."""
    dev = xpad.device
    l_pre, sync_len, margin = phy.preamble_len, phy.sync_len, phy.sync_margin
    sync = torch.from_numpy(phy.preamble[l_pre - sync_len:].astype(np.float64)).to(dev, dtype)
    sync_e = torch.sqrt((sync * sync).sum())
    tp = xpad.shape[1]
    flat = xpad.reshape(-1)
    rows64, lags64 = rows.to(torch.int64), lags.to(torch.int64)
    expected = lags64 + l_pre - sync_len
    base = (expected - margin).clamp(min=0)
    k = torch.arange(2 * margin + 1, device=dev)
    pos = base[:, None] + k                                     # [N, positions]
    idx = rows64[:, None, None] * tp + pos[..., None] + torch.arange(sync_len, device=dev)
    wins = flat[idx].to(dtype)
    dot = (wins * sync).sum(-1)
    we = (wins * wins).sum(-1)
    cc = torch.where(we > ENERGY_EPS, dot / (torch.sqrt(we) * sync_e),
                     torch.zeros((), dtype=dtype, device=dev))
    ok = ((pos >= expected[:, None] - margin) & (pos <= expected[:, None] + margin)
          & (pos <= vlen - sync_len))
    cc = torch.where(ok, cc, torch.full((), -torch.inf, dtype=dtype, device=dev))
    best = torch.where(cc.amax(-1) > -1.0, base + cc.argmax(-1), expected)   # first maximum
    fs = best + sync_len
    body = flat[rows64[:, None] * tp + fs[:, None]
                + torch.arange(phy.max_window, device=dev)].to(dtype)
    bits, valid = P.decode_bits(phy, body)
    n_hdr = valid[:, :8 * P.HEADER_BYTES].sum(-1)
    hdr_bits = torch.where(torch.arange(8 * P.HEADER_BYTES, device=dev) < n_hdr[:, None],
                           bits[:, :8 * P.HEADER_BYTES], 0)
    hdr = P.pack(hdr_bits)
    dlen = hdr[:, 0] * 256 + hdr[:, 1]
    in_frame = torch.arange(bits.shape[1], device=dev) < ((P.HEADER_BYTES + dlen) * 8)[:, None]
    frame = P.pack(torch.where(in_frame, bits, 0))
    crc = P.crc8_prefix(frame[:, P.HEADER_BYTES:], dlen.clamp(0, phy.max_frame_bytes))
    host = lambda t: t.cpu().numpy()  # noqa: E731
    return {
        "fs": host(fs), "n_hdr": host(n_hdr), "dlen": host(dlen), "crc": host(hdr[:, 2]),
        "ftype": host(hdr[:, 3]), "seq": host(hdr[:, 4]), "src": host(hdr[:, 5]),
        "dst": host(hdr[:, 6]), "n_valid_bits": host((valid & in_frame).sum(-1)),
        "crc_calc": host(crc), "frame": host(frame.to(torch.uint8)),
    }


def walk(phy: P.Phy, hits: np.ndarray, cand: dict, corr: np.ndarray, vlen: int,
         n_lags: int, local_addr: int, max_frames: int) -> list[tuple]:
    """The receiver's cursor over one recording's sorted hit lags, with
    each candidate's decisions `cand` (row j for hits[j]): the kept frames
    as (start, frame bytes, length, type, seq, src, dst, corr)."""
    last_lag = -(-n_lags // LAG_BLOCK) * LAG_BLOCK - 1
    hdr_samples = phy.header_samples
    cursor, kept = 0, []
    for _ in range(max_frames):
        j = int(np.searchsorted(hits, min(max(cursor, 0), last_lag)))
        if j >= len(hits):
            break
        i = int(hits[j])
        fs, dlen, ftype, dst = (int(cand[key][j]) for key in ("fs", "dlen", "ftype", "dst"))
        header_ok = cand["n_hdr"][j] >= P.MIN_HEADER_BITS and ftype in (P.FRAME_TYPE_DATA,
                                                                        P.FRAME_TYPE_ACK)
        len_bad = (ftype == P.FRAME_TYPE_DATA and dlen == 0) or dlen > phy.max_frame_bytes
        total_bits = (P.HEADER_BYTES + dlen) * 8
        total_samples = phy.samples_for_bits(total_bits)
        n_valid_bits = int(cand["n_valid_bits"][j])
        line_fail = n_valid_bits < total_bits
        if fs + hdr_samples > vlen or (header_ok and not len_bad and fs + total_samples > vlen):
            break                       # the frame runs past the recording: wait for more
        if (header_ok and not len_bad and not line_fail
                and cand["crc_calc"][j] == cand["crc"][j]
                and (dst == local_addr or local_addr < 0)):
            kept.append((i, cand["frame"][j, :P.HEADER_BYTES + dlen].tobytes(), dlen, ftype,
                         int(cand["seq"][j]), int(cand["src"][j]), dst, float(corr[j])))
        if not header_ok:
            cursor = i + hdr_samples
        elif len_bad:
            cursor = i + 1
        elif line_fail:
            cursor = i + phy.preamble_len + phy.samples_for_bits(n_valid_bits)
        else:
            cursor = i + phy.preamble_len + total_samples
    return kept


def decode(phy: P.Phy, x: torch.Tensor, local_addr: int, max_frames: int | None,
           dtype: torch.dtype = torch.float64) -> dict:
    """The exact scan of every row of the recordings x [R, T] (any
    device), in `dtype`: ``{"frames": each row's kept frames in order,
    "hits": each row's hit lags}``.  `max_frames` None walks until the hits
    run out."""
    frames, hits = [], []
    pre = phy.preamble
    l_pre = len(pre)
    t = x.shape[1]
    vlen = t
    pad = phy.max_window + l_pre + phy.sync_margin + phy.sync_len + 8
    rows_per_block = max(1, ROW_BLOCK_SAMPLES // max(t, 1))
    for r0 in range(0, x.shape[0], rows_per_block):
        xb = x[r0:r0 + rows_per_block]
        if t < l_pre:
            xb = torch.nn.functional.pad(xb, (0, l_pre - t))
        corr = correlate(xb, pre, dtype)
        n_lags = corr.shape[1]
        hit_rows, hit_lags = torch.nonzero(corr >= phy.threshold, as_tuple=True)
        hit_corr = corr[hit_rows, hit_lags].to(torch.float64).cpu().numpy()
        del corr
        xpad = torch.nn.functional.pad(xb, (0, pad))
        cand = [candidates(phy, xpad, hit_rows[c:c + HIT_CHUNK], hit_lags[c:c + HIT_CHUNK],
                           vlen, dtype) for c in range(0, len(hit_rows), HIT_CHUNK)]
        cand = ({key: np.concatenate([c[key] for c in cand]) for key in cand[0]} if cand
                else None)
        rows_np, lags_np = hit_rows.cpu().numpy(), hit_lags.cpu().numpy()
        for r in range(xb.shape[0]):
            sel = np.nonzero(rows_np == r)[0]
            row_cand = {key: v[sel] for key, v in cand.items()} if cand else {}
            frames.append(walk(phy, lags_np[sel], row_cand, hit_corr[sel], vlen, n_lags, local_addr,
                               max_frames if max_frames is not None else len(sel) + 1))
            hits.append(lags_np[sel])
    return {"frames": frames, "hits": hits}
