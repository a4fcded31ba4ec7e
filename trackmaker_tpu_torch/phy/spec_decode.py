"""Speculative batched decode (counterpart of ``trackmaker_tpu/phy/pallas_decode.py``).

``decode_capture_spec`` decodes a batch of captures in six steps:

1. correlation and per-row hits (kernel ``sync/xcorr_hits``);
2. ``compact_hit_rows``: the sorted candidate table and its overflow flag;
3. the attempt kernel of the line code, ``attempt_manchester`` or
   ``attempt_4b5b``: the sync refine and the frame bytes of every
   candidate, independent of where the walk will go;
4. ``spec_phase_a``'s epilogue: header fields, length sanity, destination
   filter and CRC8, giving each candidate's consumed/stop/keep fields;
5. ``spec_walk`` (kernel): the sequential consumption walk over the table;
6. ``spec_compact``: the kept frames, in position order, into the leading
   slots.

``extract_candidates`` is the table's other source, from a dense hit
vector (the timing gate's retry candidates, and the ASK receiver's at 8
a block).

Because every hit is in the table, the walk replays the exact scan's cursor
decisions.  A capture goes to the exact scan (``phy/decoder.py:
decode_capture_fast`` does this) only when its table overflowed, or, for
4B5B, when an attempted candidate holds a near-zero level: the attempt
kernel reads each transition against the level just before, while the
receiver skips near-zero levels.  Each kernel wrapper runs its ``*_plain``
version on CPU tensors.

With the sync-refine fold on (``SYNC_FOLD``, from the environment variable
``TM_SYNC_FOLD``), step 1 runs ``xcorr_hits_refine``, which also refines
the frame start of each hit, step 2 carries those starts, and step 3 runs
the attempt kernels' fold forms, which decode from them and skip their own
refine.  Both modes make the same decisions: the two refines add the same
way.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.core import bitops, framing
from trackmaker_tpu_torch.core.config import (
    FOUR_B_FIVE_B,
    FRAME_TYPE_DATA,
    MANCHESTER,
    PHY_HEADER_BYTES,
    PhyConfig,
)
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy.decoder import DecodedFrames
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import (
    BIGI,
    HIT_SLOTS,
    ROW_LAGS,
    refine_deltas_plain,
    xcorr_hits,
    xcorr_hits_refine,
)
from trackmaker_tpu_torch.utils.trace import span, spanned

GROUP_ROWS = 32     # hit rows per first-stage compaction group
GROUP_SLOTS = 16    # hits a group may hold before the table overflows
HIT_BLOCK = 512     # the dense-hit extraction's block ...
HITS_PER_BLOCK = 4  # ... and the hits it takes from each before the table overflows
SYNC_POSITIONS = 13
FRAME_BYTES = PHY_HEADER_BYTES + 256   # 263, the largest frame
BIT_SAMPLES = 6

# 4B5B attempt (kernel csrc/attempt_4b5b.cu)
SYNC_POSITIONS_4B5B = 31
SYNC_LEN_4B5B = 30
FRAME_SYMBOLS = 2 * FRAME_BYTES     # 526 symbols hold the largest frame
ZERO_SYMBOLS = 640                  # symbols searched for a near-zero level
SYMBOL_SAMPLES = 15                 # 5 levels x 3 samples
HEADER_SYMBOLS = 2 * PHY_HEADER_BYTES
MIN_HEADER_SYMBOLS = -(-line_coding.MIN_HEADER_BITS // 4)   # 13 nibbles
LEVEL_NEAR_ZERO = 4e-6              # |3-sample level sum| at most this is near zero

# The sync-refine fold: "1" refines in the correlation kernel, "0" and
# "auto" in the attempt kernels (legacy); a bool set here is honoured.
SYNC_FOLD = os.environ.get("TM_SYNC_FOLD", "auto")


def _resolve_fold() -> bool:
    if isinstance(SYNC_FOLD, bool):
        return SYNC_FOLD
    return SYNC_FOLD == "1"


def spec_supported_cfg(cfg: PhyConfig) -> bool:
    """The configurations the attempt kernels are specialized for."""
    if cfg.samples_per_level != 3 or PHY_HEADER_BYTES + cfg.max_frame_bytes != FRAME_BYTES:
        return False
    if cfg.line_coding == MANCHESTER:
        return (cfg.preamble_len == 96 and cfg.sync_len == 48
                and cfg.sync_margin == 6 and cfg.header_samples == 336)
    if cfg.line_coding == FOUR_B_FIVE_B:
        return (cfg.preamble_len == 60 and cfg.sync_len == 30
                and cfg.sync_margin == 15 and cfg.header_samples == 210)
    return False


def _check_cfg(cfg: PhyConfig) -> None:
    if not spec_supported_cfg(cfg):
        raise ValueError("the speculative decode is specialized for the spl=3 "
                         "Manchester and 4B5B configurations")


@spanned("tm.glue.upload")
def _per_row(value, b: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device).expand(b).contiguous()


# --- step 2 -----------------------------------------------------------------


def _compact(vals: torch.Tensor, valid: torch.Tensor, n_out: int, fill):
    """Pack the valid entries of vals[..., N] in order into n_out slots."""
    return _compact_all([(vals, fill)], valid, n_out)[0]


def _compact_all(arrays, valid: torch.Tensor, n_out: int) -> list[torch.Tensor]:
    """_compact of each (vals, fill) in `arrays`, all under one `valid`."""
    rank = valid.cumsum(-1) - 1
    slot = torch.where(valid & (rank < n_out), rank, n_out)   # n_out = sink
    return [torch.full((*vals.shape[:-1], n_out + 1), fill, dtype=vals.dtype,
                       device=vals.device).scatter_(-1, slot, vals)[..., :n_out].contiguous()
            for vals, fill in arrays]


@spanned("tm.glue.compact_hits")
def compact_hit_rows(rows: torch.Tensor, n_cand: int, with_fs: bool = False):
    """(cand, corr, n_valid, overflow) from hit rows int32[B, R, 16].

    cand int32[B, n_cand] holds every extracted hit position, ascending,
    padded with 2^30; corr f32[B, n_cand] the correlation at each (0 past
    n_valid); n_valid int32[B] counts the extracted hits, uncapped.  The
    compaction runs in two stages, first within groups of 32 rows to 16
    slots, then globally.  The table overflows when a row holds more than
    four hits, a group more than 16, or the capture more than `n_cand`; an
    overflowed capture must be decoded by the exact scan.

    ``with_fs=True`` reads rows of ``xcorr_hits_refine``, carries each
    hit's refine delta (columns 9..12) along and returns a fifth result,
    the frame start fs int32[B, n_cand] = cand + delta of each slot c <
    min(n_valid, n_cand), and 0, as the attempt kernels report it, elsewhere.
    """
    b, r, _ = rows.shape
    counts = rows[..., HIT_SLOTS]
    # the starts, the corr bits (moved as int32) and, with fs, the deltas
    arrays = [rows[..., :HIT_SLOTS], rows[..., HIT_SLOTS + 1:2 * HIT_SLOTS + 1]]
    fills = [BIGI, 0]
    if with_fs:
        arrays.append(rows[..., 2 * HIT_SLOTS + 1:3 * HIT_SLOTS + 1])
        fills.append(0)
    ng = -(-r // GROUP_ROWS)
    pad = ng * GROUP_ROWS - r
    if pad:
        arrays = [torch.nn.functional.pad(a, (0, 0, 0, pad), value=f)
                  for a, f in zip(arrays, fills)]
    grouped = [a.reshape(b, ng, GROUP_ROWS * HIT_SLOTS) for a in arrays]
    vg = grouped[0] < BIGI
    grp_n = vg.sum(-1)
    stage1 = [a.reshape(b, ng * GROUP_SLOTS)
              for a in _compact_all(zip(grouped, fills), vg, GROUP_SLOTS)]

    valid = stage1[0] < BIGI
    cand, corr_bits, *delta = _compact_all(zip(stage1, fills), valid, n_cand)
    corr = corr_bits.view(torch.float32)
    n_valid = valid.sum(-1, dtype=torch.int32)
    overflow = ((counts > HIT_SLOTS).any(-1) | (grp_n > GROUP_SLOTS).any(-1)
                | (counts.sum(-1) > n_cand))
    if not with_fs:
        return cand, corr, n_valid, overflow
    fs = torch.where(cand < BIGI, cand + delta[0], 0).to(torch.int32)   # live slots hold a hit
    return cand, corr, n_valid, overflow, fs


def extract_candidates(hits: torch.Tensor, n_cand: int, per_block: int = HITS_PER_BLOCK):
    """(cand int32[B, n_cand], n_valid int32[B], overflow bool[B]) from a
    dense hit vector bool[B, T].

    Each HIT_BLOCK-sample block gives its first `per_block` hits; cand holds
    the first n_cand of those, ascending, padded with 2^30, and n_valid
    counts them all.  The table overflows when a block holds more than
    `per_block` hits or the capture more than n_cand.  The defaults are
    the line-coded decode's (the timing gate's retry candidates); the ASK
    receiver keeps 8 a block."""
    b, t = hits.shape
    hb = -(-t // HIT_BLOCK)
    rows = torch.nn.functional.pad(hits, (0, hb * HIT_BLOCK - t)).reshape(b, hb, HIT_BLOCK)
    keep = (rows & (rows.cumsum(-1) <= per_block)).reshape(b, hb * HIT_BLOCK)
    pos = torch.arange(hb * HIT_BLOCK, dtype=torch.int32, device=hits.device).expand(b, -1)
    cand = _compact(pos, keep, n_cand, BIGI)
    per_row = rows.sum(-1)
    overflow = (per_row > per_block).any(-1) | (per_row.sum(-1) > n_cand)
    return cand, keep.sum(-1, dtype=torch.int32), overflow


# --- step 3: the attempt kernels -----------------------------------------------


def _live(cand: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """bool[B, C]: the slots c < min(n_valid, C) an attempt kernel decodes."""
    n_cand = cand.shape[1]
    return torch.arange(n_cand, device=cand.device) < n_valid.clamp(max=n_cand)[:, None]


def _one_capture(x: torch.Tensor) -> torch.Tensor:
    """x f32[B, T] itself or, when its rows are one capture (row stride 0,
    as ``x.expand(B, -1)`` makes it), that capture f32[1, T], so a plain
    version reads it once."""
    return x[:1] if x.stride(0) == 0 else x


def _windows(x: torch.Tensor, start: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """x[b, start[b, ...] + offsets] for x f32[B, T]; samples at or past T
    read as zero."""
    b, t = x.shape
    # column t reads as zero
    xz = torch.nn.functional.pad(_one_capture(x), (0, 1)).expand(b, -1)
    idx = (start[..., None].to(torch.int64) + offsets).clamp(max=t)
    return xz.gather(1, idx.reshape(b, -1)).reshape(idx.shape)


def _refine_plain(x: torch.Tensor, i_c: torch.Tensor, vlen: torch.Tensor,
                  sync: np.ndarray, sync_e: float, base_offset: int,
                  n_pos: int) -> torch.Tensor:
    """The sync refine of every slot: the frame start int32[B, C] behind
    the best of `n_pos` sync-word positions from i_c + base_offset, as the
    attempt kernels compute it; with no valid position, the expected one."""
    b, n_cand = i_c.shape
    xs = _one_capture(x)
    blk = torch.arange(b, device=x.device).repeat_interleave(n_cand)
    delta = refine_deltas_plain(xs, blk % xs.shape[0], i_c.reshape(-1), vlen[blk], sync, sync_e,
                                base_offset, n_pos,
                                base_offset + (n_pos - 1) // 2 + len(sync))
    return (i_c + delta.reshape(b, n_cand)).to(torch.int32)


def _require(*specs) -> None:
    """Each (name, tensor, shape, dtype) must be a contiguous tensor of that
    shape and type."""
    for name, tensor, shape, dtype in specs:
        if (tuple(tensor.shape) != shape or tensor.dtype != dtype
                or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype}{list(shape)}")


def _check_x(x, b: int) -> None:
    """x must be f32[b, T], contiguous or with rows that are one contiguous
    capture (row stride 0)."""
    if (x.ndim != 2 or x.shape[0] != b or x.dtype != torch.float32
            or not (x.is_contiguous() or (x.stride(0) == 0 and x[0].is_contiguous()))):
        raise ValueError(f"x must be a contiguous torch.float32[{b}, T], or one capture "
                         "expanded to those rows")


def _check_attempt_args(x, cand, n_valid, vlen, sync, sync_len: int) -> None:
    b, n_cand = cand.shape
    _check_x(x, b)
    _require(("cand", cand, (b, n_cand), torch.int32),
             ("n_valid", n_valid, (b,), torch.int32), ("vlen", vlen, (b,), torch.int32))
    if len(sync) != sync_len:
        raise ValueError(f"the sync word must hold {sync_len} samples")


def _check_fold_args(x, fs, n_valid) -> None:
    b, n_cand = fs.shape
    _check_x(x, b)
    _require(("fs", fs, (b, n_cand), torch.int32), ("n_valid", n_valid, (b,), torch.int32))


def _clamped(cand: torch.Tensor, t: int) -> torch.Tensor:
    return torch.minimum(cand, torch.tensor(t, dtype=cand.dtype, device=cand.device))


def attempt_manchester_plain(x: torch.Tensor, cand: torch.Tensor,
                             n_valid: torch.Tensor, vlen: torch.Tensor,
                             sync: np.ndarray, sync_e: float):
    """Plain PyTorch version of :func:`attempt_manchester`."""
    fs = _refine_plain(x, _clamped(cand, x.shape[1]), vlen, sync, sync_e,
                       base_offset=42, n_pos=SYNC_POSITIONS)
    return attempt_manchester_fold_plain(x, fs, n_valid)


def attempt_manchester_fold_plain(x: torch.Tensor, fs: torch.Tensor, n_valid: torch.Tensor):
    """Plain PyTorch version of :func:`attempt_manchester_fold`."""
    b, _ = x.shape
    n_cand = fs.shape[1]
    dev = x.device
    live = _live(fs, n_valid)
    body = _windows(x, fs, torch.arange(FRAME_BYTES * 8 * BIT_SAMPLES, device=dev))
    w = body.reshape(b, n_cand, FRAME_BYTES * 8, BIT_SAMPLES)
    d = (w[..., 0] + w[..., 1] + w[..., 2]) - (w[..., 3] + w[..., 4] + w[..., 5])
    byts = bitops.pack_bits((d <= 0.0).to(torch.uint8))
    byts = torch.where(live[..., None], byts, 0)
    fs = torch.where(live, fs, 0).to(torch.int32)
    return byts, fs


# x, its row stride, then the tables, sizes and outputs
_ATTEMPT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 3


def _count(wrapper, x: torch.Tensor) -> None:
    """One more launch on the wrapper's counter: ``shared_launches`` when
    the rows of x are one capture (row stride 0, the kernel's shared-capture
    form), else ``launches``."""
    if x.stride(0) == 0:
        wrapper.shared_launches += 1
    else:
        wrapper.launches += 1


@spanned("tm.kernel.attempt_manchester")
def attempt_manchester(x: torch.Tensor, cand: torch.Tensor,
                       n_valid: torch.Tensor, vlen: torch.Tensor,
                       sync: np.ndarray, sync_e: float):
    """Sync refine and frame decode of every live candidate slot.

    x f32[B, T], cand int32[B, C], n_valid int32[B], vlen int32[B]; `sync`
    is the 48-sample sync word and `sync_e` its norm.  Returns the frame
    bytes uint8[B, C, 263] and the refined frame start fs int32[B, C] of
    each slot c < min(n_valid, C), zeros elsewhere (see the kernel's note
    in ``csrc/attempt_manchester.cu``).  x may be one capture expanded to
    every row (``x.expand(B, -1)``, row stride 0): every row of the tables
    then reads that capture (the long-capture blocked decode), counted in
    ``shared_launches``.  The sync word goes to the kernel by value: a call
    copies nothing to the card.
    """
    if not _build.on_cuda(x, cand, n_valid, vlen):
        return attempt_manchester_plain(x, cand, n_valid, vlen, sync, sync_e)
    _check_attempt_args(x, cand, n_valid, vlen, sync, 48)
    b, t = x.shape
    n_cand = cand.shape[1]
    s = np.ascontiguousarray(sync, np.float32)     # read on the host, passed by value
    byts = torch.empty((b, n_cand, FRAME_BYTES), dtype=torch.uint8, device=x.device)
    fs = torch.empty((b, n_cand), dtype=torch.int32, device=x.device)
    fn = _build.entry("attempt_manchester", "tm_attempt_manchester",
                      _ATTEMPT_ARGTYPES)
    err = fn(x.data_ptr(), x.stride(0), cand.data_ptr(), n_valid.data_ptr(), vlen.data_ptr(),
             s.ctypes.data, b, t, n_cand, sync_e, byts.data_ptr(), fs.data_ptr(),
             _build.stream_ptr(x))
    _build.check(err, "attempt_manchester")
    _count(attempt_manchester, x)
    return byts, fs


attempt_manchester.launches = 0
attempt_manchester.shared_launches = 0

_FOLD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 3)


@spanned("tm.kernel.attempt_manchester_fold")
def attempt_manchester_fold(x: torch.Tensor, fs: torch.Tensor, n_valid: torch.Tensor):
    """The frame decode of :func:`attempt_manchester` from given frame
    starts fs int32[B, C] (the sync-refine fold): bytes uint8[B, C, 263]
    and fs, each zero at slots c >= min(n_valid, C).  x as for
    :func:`attempt_manchester`."""
    if not _build.on_cuda(x, fs, n_valid):
        return attempt_manchester_fold_plain(x, fs, n_valid)
    _check_fold_args(x, fs, n_valid)
    b, t = x.shape
    n_cand = fs.shape[1]
    byts = torch.empty((b, n_cand, FRAME_BYTES), dtype=torch.uint8, device=x.device)
    fs_out = torch.empty((b, n_cand), dtype=torch.int32, device=x.device)
    fn = _build.entry("attempt_manchester", "tm_attempt_manchester_fold", _FOLD_ARGTYPES)
    err = fn(x.data_ptr(), x.stride(0), fs.data_ptr(), n_valid.data_ptr(), b, t, n_cand,
             byts.data_ptr(), fs_out.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "attempt_manchester_fold")
    _count(attempt_manchester_fold, x)
    return byts, fs_out


attempt_manchester_fold.launches = 0
attempt_manchester_fold.shared_launches = 0


def attempt_4b5b_plain(x: torch.Tensor, cand: torch.Tensor,
                       n_valid: torch.Tensor, vlen: torch.Tensor,
                       sync: np.ndarray, sync_e: float):
    """Plain PyTorch version of :func:`attempt_4b5b`."""
    fs = _refine_plain(x, _clamped(cand, x.shape[1]), vlen, sync, sync_e,
                       base_offset=15, n_pos=SYNC_POSITIONS_4B5B)
    return attempt_4b5b_fold_plain(x, fs, n_valid)


def attempt_4b5b_fold_plain(x: torch.Tensor, fs: torch.Tensor, n_valid: torch.Tensor):
    """Plain PyTorch version of :func:`attempt_4b5b_fold`."""
    dev = x.device
    live = _live(fs, n_valid)
    body = _windows(x, fs, torch.arange(ZERO_SYMBOLS * SYMBOL_SAMPLES, device=dev))
    w = body.reshape(*fs.shape, ZERO_SYMBOLS * 5, 3)
    level = (w[..., 0] + w[..., 1]) + w[..., 2]          # the kernel's order
    prev = torch.cat([torch.ones_like(level[..., :1]), level[..., :-1]], dim=-1)
    tr = (prev * level < 0.0).to(torch.int64).reshape(*fs.shape, ZERO_SYMBOLS, 5)
    sym = (tr[..., :FRAME_SYMBOLS, :]
           * torch.tensor([16, 8, 4, 2, 1], device=dev)).sum(-1)
    nib = torch.from_numpy(line_coding.FOURB_FIVEB_DECODE).to(dev)[sym]
    near0 = (level.abs() <= LEVEL_NEAR_ZERO).reshape(*fs.shape, ZERO_SYMBOLS, 5).any(-1)

    def first(flag: torch.Tensor) -> torch.Tensor:
        n = flag.shape[-1]
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        return torch.where(flag, pos, n).amin(-1).to(torch.int32)

    first_bad = first(nib < 0)
    first_zero = first(near0)
    sym_idx = torch.arange(FRAME_SYMBOLS, device=dev)
    nib = torch.where(sym_idx < first_bad[..., None], nib, 0)
    byts = (nib[..., 0::2] * 16 + nib[..., 1::2]).to(torch.uint8)
    byts = torch.where(live[..., None], byts, 0)
    return (byts, torch.where(live, fs, 0), torch.where(live, first_bad, 0),
            torch.where(live, first_zero, 0))


_ATTEMPT_4B5B_ARGTYPES = _ATTEMPT_ARGTYPES + [ctypes.c_void_p] * 2   # + first_bad, first_zero


@spanned("tm.kernel.attempt_4b5b")
def attempt_4b5b(x: torch.Tensor, cand: torch.Tensor,
                 n_valid: torch.Tensor, vlen: torch.Tensor,
                 sync: np.ndarray, sync_e: float):
    """Sync refine and 4B5B + NRZI decode of every live candidate slot.

    x f32[B, T], cand int32[B, C], n_valid int32[B], vlen int32[B]; `sync`
    is the 30-sample sync word and `sync_e` its norm.  Returns, for each
    slot c < min(n_valid, C) (zeros elsewhere):

    * ``bytes`` uint8[B, C, 263]: the nibble pairs of the first 526
      symbols, zero from the first invalid symbol on;
    * ``fs`` int32[B, C]: the refined frame start;
    * ``first_bad`` int32[B, C]: the first invalid symbol, 526 if none;
    * ``first_zero`` int32[B, C]: the first of 640 symbols holding a
      near-zero level sum, 640 if none.

    Each transition is read against the level just before it (see the
    kernel's note in ``csrc/attempt_4b5b.cu``).  x may be one capture
    expanded to every row, as for :func:`attempt_manchester`.  The sync
    word goes to the kernel by value: a call copies nothing to the card.
    """
    if not _build.on_cuda(x, cand, n_valid, vlen):
        return attempt_4b5b_plain(x, cand, n_valid, vlen, sync, sync_e)
    _check_attempt_args(x, cand, n_valid, vlen, sync, SYNC_LEN_4B5B)
    b, t = x.shape
    n_cand = cand.shape[1]
    s = np.ascontiguousarray(sync, np.float32)     # read on the host, passed by value
    byts = torch.empty((b, n_cand, FRAME_BYTES), dtype=torch.uint8, device=x.device)
    fs, first_bad, first_zero = (
        torch.empty((b, n_cand), dtype=torch.int32, device=x.device) for _ in range(3))
    fn = _build.entry("attempt_4b5b", "tm_attempt_4b5b", _ATTEMPT_4B5B_ARGTYPES)
    err = fn(x.data_ptr(), x.stride(0), cand.data_ptr(), n_valid.data_ptr(), vlen.data_ptr(),
             s.ctypes.data, b, t, n_cand, sync_e, byts.data_ptr(), fs.data_ptr(),
             first_bad.data_ptr(), first_zero.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "attempt_4b5b")
    _count(attempt_4b5b, x)
    return byts, fs, first_bad, first_zero


attempt_4b5b.launches = 0
attempt_4b5b.shared_launches = 0

_FOLD_4B5B_ARGTYPES = _FOLD_ARGTYPES + [ctypes.c_void_p] * 2   # + first_bad, first_zero


@spanned("tm.kernel.attempt_4b5b_fold")
def attempt_4b5b_fold(x: torch.Tensor, fs: torch.Tensor, n_valid: torch.Tensor):
    """The decode of :func:`attempt_4b5b` from given frame starts fs
    int32[B, C] (the sync-refine fold): (bytes, fs, first_bad, first_zero),
    each zero at slots c >= min(n_valid, C).  x as for
    :func:`attempt_manchester`."""
    if not _build.on_cuda(x, fs, n_valid):
        return attempt_4b5b_fold_plain(x, fs, n_valid)
    _check_fold_args(x, fs, n_valid)
    b, t = x.shape
    n_cand = fs.shape[1]
    byts = torch.empty((b, n_cand, FRAME_BYTES), dtype=torch.uint8, device=x.device)
    fs_out, first_bad, first_zero = (
        torch.empty((b, n_cand), dtype=torch.int32, device=x.device) for _ in range(3))
    fn = _build.entry("attempt_4b5b", "tm_attempt_4b5b_fold", _FOLD_4B5B_ARGTYPES)
    err = fn(x.data_ptr(), x.stride(0), fs.data_ptr(), n_valid.data_ptr(), b, t, n_cand,
             byts.data_ptr(), fs_out.data_ptr(), first_bad.data_ptr(), first_zero.data_ptr(),
             _build.stream_ptr(x))
    _build.check(err, "attempt_4b5b_fold")
    _count(attempt_4b5b_fold, x)
    return byts, fs_out, first_bad, first_zero


attempt_4b5b_fold.launches = 0
attempt_4b5b_fold.shared_launches = 0


# --- step 4 -----------------------------------------------------------------


class SpecFields(NamedTuple):
    """Cursor-independent products of steps 1-4, per candidate."""
    cand: torch.Tensor       # int32[B, C] candidate preamble starts (2^30 pad)
    fields: torch.Tensor     # int32[B, 4, C] walk rows: pos/consumed/stop/keep
    overflow: torch.Tensor   # bool[B] candidate table overflowed
    nonconf: torch.Tensor    # bool[B, C] the exact scan may differ if attempted
    bytes_m: torch.Tensor    # uint8[B, C, 263] frame bytes, masked to length
    dlen: torch.Tensor       # int32[B, C]
    ftype: torch.Tensor      # int32[B, C]
    seq: torch.Tensor        # int32[B, C]
    src: torch.Tensor        # int32[B, C]
    dst: torch.Tensor        # int32[B, C]
    corr: torch.Tensor       # f32[B, C] correlation at each candidate


def spec_phase_a(cfg: PhyConfig, x: torch.Tensor, local_addr: int,
                 n_cand: int, vlens: torch.Tensor,
                 flat_blocks: tuple[int, int] | None = None) -> SpecFields:
    """Steps 1-4 for captures x f32[B, T] with true lengths vlens int32[B].

    ``flat_blocks=(n_blocks, block)`` is the long-capture mode: x is one
    flat capture f32[n_blocks * block], zero-padded past its true length,
    with ``block % 128 == 0``.  It is correlated once; its hit rows split
    into one candidate table per block of `block` samples, with positions
    in the whole capture; and the attempt kernels' shared-capture forms
    decode every block's candidates from the one capture (expanded to the
    blocks, a row stride of 0), so a frame near a block's end reads the
    samples that follow it.  vlens int32[n_blocks] then holds the capture's
    true length for every block.
    """
    pre = line_coding.preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    fold = _resolve_fold()
    if flat_blocks is not None:
        n_blocks, block = flat_blocks
        if x.ndim != 1 or block % ROW_LAGS or x.shape[0] != n_blocks * block:
            raise ValueError("flat_blocks needs x f32[n_blocks * block] with block % 128 == 0")
        x = x[None]
    if fold:
        rows = xcorr_hits_refine(
            x, vlens[:x.shape[0]], pre, sync, cfg.correlation_threshold,
            sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
            n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len, fall_off=cfg.preamble_len)
    else:
        _, rows = xcorr_hits(x, pre, cfg.correlation_threshold)
    if flat_blocks is not None:
        # block b's hit rows are the flat capture's rows b * block/128 on;
        # compact_hit_rows groups rows within each block, never across one
        rows = rows[0].reshape(n_blocks, block // ROW_LAGS, rows.shape[-1])
        x = x.expand(n_blocks, -1)
    if fold:
        cand, corr, n_valid, overflow, fs = compact_hit_rows(rows, n_cand, with_fs=True)
        if cfg.line_coding == MANCHESTER:
            byts, fs = attempt_manchester_fold(x, fs, n_valid)
        else:
            byts, fs, first_bad, first_zero = attempt_4b5b_fold(x, fs, n_valid)
    else:
        cand, corr, n_valid, overflow = compact_hit_rows(rows, n_cand)
        if cfg.line_coding == MANCHESTER:
            byts, fs = attempt_manchester(x, cand, n_valid, vlens, sync, preamble_energy(sync))
        else:
            byts, fs, first_bad, first_zero = attempt_4b5b(
                x, cand, n_valid, vlens, sync, preamble_energy(sync))

    with span("tm.glue.epilogue"):
        hdr = framing.parse_header(byts)
        dlen, ftype, dst = hdr["length"], hdr["frame_type"], hdr["dst"]
        total_bits = (PHY_HEADER_BYTES + dlen) * 8
        total_samples = cfg.samples_for_bits(8) * (PHY_HEADER_BYTES + dlen)
        if cfg.line_coding == MANCHESTER:   # every Manchester bit decodes
            header_ok = hdr["type_valid"]
            line_fail = torch.zeros_like(header_ok)
            nonconf = torch.zeros_like(header_ok)
            fail_samples = total_samples
        else:
            # a symbol past the frame decides nothing: frames of at most 263
            # bytes end by symbol 526, and a longer length is len_bad
            symbols = total_bits // 4
            valid_symbols = torch.minimum(first_bad, symbols)
            header_ok = hdr["type_valid"] & (first_bad >= MIN_HEADER_SYMBOLS)
            line_fail = 4 * valid_symbols < total_bits
            # a near-zero level in the header or the frame: the receiver skips
            # it when it reads transitions, the kernel does not
            nonconf = ((first_zero < HEADER_SYMBOLS)
                       | (first_zero < symbols.clamp(max=ZERO_SYMBOLS)))
            fail_samples = valid_symbols * SYMBOL_SAMPLES
        len_bad = ((ftype == FRAME_TYPE_DATA) & (dlen == 0)) | (dlen > cfg.max_frame_bytes)
        vl = vlens[:, None]
        hdr_incomplete = fs + cfg.header_samples > vl
        incomplete = fs + total_samples > vl
        dst_ok = (dst == local_addr) | (local_addr < 0)

        in_frame = torch.arange(FRAME_BYTES, device=x.device) < (PHY_HEADER_BYTES + dlen)[..., None]
        bytes_m = torch.where(in_frame, byts, 0)
        crc = bitops.crc8(bytes_m[..., PHY_HEADER_BYTES:],
                          dlen.clamp(0, cfg.max_frame_bytes))
        crc_ok = crc.to(torch.int32) == hdr["crc"]

        consumed = torch.where(
            ~header_ok, cfg.header_samples,
            torch.where(len_bad, 1, cfg.preamble_len
                        + torch.where(line_fail, fail_samples, total_samples)))
        stopf = hdr_incomplete | (header_ok & ~len_bad & incomplete)
        keepf = (~hdr_incomplete & header_ok & ~len_bad & ~incomplete & ~line_fail
                 & dst_ok & crc_ok)
        fields = torch.stack([cand, consumed.to(torch.int32), stopf.to(torch.int32),
                              keepf.to(torch.int32)], dim=1)
    return SpecFields(cand=cand, fields=fields, overflow=overflow, nonconf=nonconf,
                      bytes_m=bytes_m, dlen=dlen, ftype=ftype, seq=hdr["sequence"],
                      src=hdr["src"], dst=dst, corr=corr)


# --- step 5: kernel 3 ---------------------------------------------------------


class WalkResult(NamedTuple):
    keep: torch.Tensor        # bool[B, C] attempted and kept
    attempted: torch.Tensor   # bool[B, C] reached by the cursor
    cur_f: torch.Tensor       # int32[B] final cursor
    done: torch.Tensor        # bool[B] stopped, or fewer than max_frames attempts
    pending: torch.Tensor     # int32[B] start of the incomplete frame (2^30 if none)
    att: torch.Tensor         # int32[B] attempts made


def spec_walk_plain(fields: torch.Tensor, start_cursor: torch.Tensor,
                    scan_limit: torch.Tensor, max_frames: int) -> WalkResult:
    """Plain PyTorch version of :func:`spec_walk`, by the kernel's
    algorithm: a successor table and pointer doubling.  The successor of
    candidate c is the first candidate at or past pos_c + consumed_c
    (positions ascend); stop candidates and absent ones lead to a sink at
    index C.  The attempted set is
    the first `max_frames` nodes of the chain from s0, the first candidate
    at or past the start cursor: round k marks the 2^k-th successor of
    every node marked at distance d from s0 with d + 2^k, then doubles the
    jumps, until 2^k reaches min(max_frames, C)."""
    b, _, c_n = fields.shape
    dev = fields.device
    pos, consumed = fields[:, 0].contiguous(), fields[:, 1]
    stopf, keepf = fields[:, 2] > 0, fields[:, 3] > 0
    exists = (pos < BIGI) & (pos < scan_limit[:, None])
    nxt = torch.searchsorted(pos, (pos + consumed).contiguous())
    nxt = torch.where(stopf | ~exists, c_n, nxt)
    jump = torch.cat([nxt, torch.full((b, 1), c_n, dtype=nxt.dtype, device=dev)], -1)

    s0 = torch.searchsorted(pos, start_cursor[:, None].contiguous())
    off = 2**62                                     # a node off the chain
    nodes = torch.arange(c_n + 1, device=dev)
    dist = torch.where(nodes == s0, 0, off)
    step = 1
    while step < min(max_frames, c_n):
        mark = (dist < off) & (jump < c_n)
        dist = dist.scatter_reduce(1, torch.where(mark, jump, c_n),
                                   torch.where(mark, dist + step, off), "amin")
        jump = jump.gather(1, jump)
        step *= 2

    att = (dist[:, :c_n] < max_frames) & exists
    att_n = att.sum(-1, dtype=torch.int32)
    stop_at = att & stopf
    pending = torch.where(stop_at, pos, BIGI).amin(-1)
    adv_end = torch.where(att & ~stopf, pos + consumed, -1).amax(-1)
    return WalkResult(
        keep=att & keepf & ~stopf,
        attempted=att,
        cur_f=torch.maximum(start_cursor, adv_end).to(torch.int32),
        done=stop_at.any(-1) | (att_n < max_frames),
        pending=pending.to(torch.int32),
        att=att_n)


# the tables, the sizes, then keep, attempted, done and state int32[3, B]
_WALK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5


@spanned("tm.kernel.spec_walk")
def spec_walk(fields: torch.Tensor, start_cursor: torch.Tensor,
              scan_limit: torch.Tensor, max_frames: int) -> WalkResult:
    """The consumption walk of every capture over fields int32[B, 4, C]
    from start_cursor int32[B], ignoring candidates at or past
    scan_limit int32[B], for at most `max_frames` attempts (see the
    kernel's note in ``csrc/spec_walk.cu``): one launch, which writes every
    field; C may be 1..2,730."""
    if not _build.on_cuda(fields, start_cursor, scan_limit):
        return spec_walk_plain(fields, start_cursor, scan_limit, max_frames)
    b, rows, c_n = fields.shape
    if rows != 4 or fields.dtype != torch.int32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous int32[B, 4, C]")
    for name, tensor in (("start_cursor", start_cursor), ("scan_limit", scan_limit)):
        if (tuple(tensor.shape) != (b,) or tensor.dtype != torch.int32
                or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32[{b}]")
    flags = torch.empty((2 * c_n + 1) * b, dtype=torch.bool, device=fields.device)
    state = torch.empty((3, b), dtype=torch.int32, device=fields.device)
    keep, attempted = flags[:2 * b * c_n].view(2, b, c_n)
    done = flags[2 * b * c_n:]
    fn = _build.entry("spec_walk", "tm_spec_walk", _WALK_ARGTYPES)
    err = fn(fields.data_ptr(), start_cursor.data_ptr(), scan_limit.data_ptr(),
             b, c_n, max_frames, keep.data_ptr(), attempted.data_ptr(), done.data_ptr(),
             state.data_ptr(), _build.stream_ptr(fields))
    _build.check(err, "spec_walk")
    spec_walk.launches += 1
    cur_f, pending, att = state
    return WalkResult(keep=keep, attempted=attempted, cur_f=cur_f, done=done,
                      pending=pending, att=att)


spec_walk.launches = 0


# --- step 6 -----------------------------------------------------------------


@spanned("tm.glue.compact")
def spec_compact(a: SpecFields, keep: torch.Tensor, max_frames: int) -> DecodedFrames:
    """The kept candidates, in position order, in the leading `max_frames`
    slots; the other slots are empty (invalid, zero, start -1)."""
    b, c_n = keep.shape
    src_idx = torch.arange(c_n, device=keep.device).expand(b, c_n)
    idx = _compact(src_idx, keep, max_frames, c_n)
    valid = idx < c_n
    g = idx.clamp(max=c_n - 1)

    def pick(arr: torch.Tensor, empty=0) -> torch.Tensor:
        return torch.where(valid, arr.gather(1, g), empty)

    frame_bytes = a.bytes_m.gather(1, g[..., None].expand(b, max_frames, FRAME_BYTES))
    return DecodedFrames(
        valid=valid,
        frame_bytes=torch.where(valid[..., None], frame_bytes, 0),
        length=pick(a.dlen),
        frame_type=pick(a.ftype),
        sequence=pick(a.seq),
        src=pick(a.src),
        dst=pick(a.dst),
        start=pick(a.cand, -1),
        corr=pick(a.corr, 0.0))


@spanned("tm.glue.spec")
def decode_capture_spec(
    cfg: PhyConfig,
    samples: torch.Tensor,       # f32[B, T]
    local_addr: int,
    max_frames: int = 64,
    n_cand: int = 128,
    valid_len=None,
    start_cursor=None,
    scan_limit=None,
    with_cursor: bool = False,
):
    """Batched speculative decode; returns ``(DecodedFrames, ok[B])``.

    Rows with ``ok`` False must be decoded again by the exact scan: their
    candidate table overflowed, or (4B5B) an attempted candidate holds a
    near-zero level.  Kept frames fill the leading slots in
    position order; the exact scan leaves failed attempts as empty slots
    between them, so the two agree frame for frame, not slot for slot.

    `valid_len`, `start_cursor` and `scan_limit` (scalars or int per row)
    follow the exact scan's cursor semantics; ``with_cursor=True`` returns
    ``(frames, ok, searched_until[B], final_cursor[B])``.
    """
    _check_cfg(cfg)
    if samples.ndim != 2:
        raise ValueError("samples must be f32[B, T]")
    x = samples.to(torch.float32).contiguous()
    b, t = x.shape
    dev = x.device
    vlens = _per_row(t if valid_len is None else valid_len, b, dev)
    a = spec_phase_a(cfg, x, local_addr, n_cand, vlens)
    cur0 = _per_row(0 if start_cursor is None else start_cursor, b, dev)
    limit = _per_row(BIGI if scan_limit is None else scan_limit, b, dev)
    walk = spec_walk(a.fields, cur0, limit, max_frames)
    res = spec_compact(a, walk.keep, max_frames)
    with span("tm.glue.ok"):
        ok = ~(a.overflow | (walk.attempted & a.nonconf).any(-1))
        if not with_cursor:
            return res, ok
        drained = torch.where(walk.done, vlens - (cfg.preamble_len - 1), walk.cur_f)
        searched_until = torch.where(walk.pending < BIGI, walk.pending, drained)
        searched_until = torch.minimum(searched_until.clamp(min=0), vlens)
        return res, ok, searched_until, walk.cur_f
