"""Speculative batched ASK receiver (counterpart of ``trackmaker_tpu/phy/ask_spec.py``).

The exact scan (``phy/ask.py:demodulate``) replays the reference's record
chain one frame slot at a time.  ``demodulate_spec`` restructures it for a
batch of captures in five steps:

1. ``dense_fire_candidates`` (kernel ``csrc/ask_fire.cu``): position r can
   be a fired peak only if ``upd_ok[r]`` and no strictly greater masked
   sync lies in (r, r+guard+1], because a record is displaced only by a
   strictly better update arriving before its fire check at r+guard+1;
2. ``extract_candidates``: those positions, ascending, per capture, with
   an overflow flag;
3. ``chain_windows`` and ``phase_b``: every candidate c treated as "a
   frame just decoded with peak c": the exact warm-up correlations after
   it, the first update, and the record chain over a 512-aligned window
   (kernel ``csrc/ask_chain.cu``, via ``phy/ask.py:ask_chain``), giving
   its successor.  Slot 0 is a virtual candidate whose cursor is exactly 0;
4. ``ask_walk`` (kernel ``csrc/ask_walk.cu``): the frame loop as a walk
   through the successor table by binary lifting; slot k of the walk is
   step k of the exact scan;
5. the dense demodulation (``phy/ask.py:demod_dense``, two 30-tap
   sliding dots) and a strided pick for every slot.

A capture whose table overflowed, whose walk met a fired peak outside the
table (a fire inside a warm-up region), or whose chain did not resolve
inside its window is flagged not ``ok``; ``phy/ask.py:demodulate_fast``
decodes such rows again with the exact scan.  Each kernel wrapper runs
its ``*_plain`` version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.phy import ask
from trackmaker_tpu_torch.phy.ask import AskConfig, AskDecoded
from trackmaker_tpu_torch.phy.spec_decode import extract_candidates as _extract

BIGI = 2**30
ROW = 512           # chain windows start on multiples of ROW, as in the JAX package
CHAIN_WINDOW = 512  # the chain covers CHAIN_WINDOW + ROW samples from its window's start
CAND_PER_BLOCK = 8  # candidates a 512-sample block may hold before the table overflows


def spec_supported_cfg(cfg: AskConfig) -> bool:
    """The speculative receiver needs the dense demodulation's geometry."""
    return ask._demod_dense_tables_np(cfg) is not None


# --- step 1: kernel csrc/ask_fire.cu -----------------------------------------------


def _check_fire_args(sync: torch.Tensor, upd_ok: torch.Tensor) -> None:
    if sync.ndim != 2 or sync.dtype != torch.float32 or not sync.is_contiguous():
        raise ValueError("sync must be a contiguous f32[B, T]")
    if (upd_ok.shape != sync.shape or upd_ok.dtype != torch.bool
            or not upd_ok.is_contiguous()):
        raise ValueError(f"upd_ok must be a contiguous bool{list(sync.shape)}")


def dense_fire_candidates_plain(cfg: AskConfig, sync: torch.Tensor,
                                upd_ok: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dense_fire_candidates`."""
    w = cfg.peak_guard + 1
    masked = torch.where(upd_ok, sync, -math.inf)
    padded = torch.nn.functional.pad(masked, (0, w), value=-math.inf)
    fwd = padded[:, 1:].unfold(-1, w, 1).amax(-1)     # max of (r, r+w]
    return upd_ok & (masked >= fwd)


_FIRE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def dense_fire_candidates(cfg: AskConfig, sync: torch.Tensor,
                          upd_ok: torch.Tensor) -> torch.Tensor:
    """bool[B, T]: upd_ok[r] and masked[r] >= max(masked(r, r+w]), with
    masked = upd_ok ? sync : -inf, w = peak_guard + 1 and -inf past T:
    the positions that fire if they become the chain's record.  Max and
    compare only, so the kernel and its plain version agree exactly."""
    if not _build.on_cuda(sync, upd_ok):
        return dense_fire_candidates_plain(cfg, sync, upd_ok)
    _check_fire_args(sync, upd_ok)
    b, t = sync.shape
    hit = torch.empty_like(upd_ok)
    fn = _build.entry("ask_fire", "tm_ask_fire", _FIRE_ARGTYPES)
    err = fn(sync.data_ptr(), upd_ok.data_ptr(), b, t, cfg.peak_guard + 1,
             hit.data_ptr(), _build.stream_ptr(sync))
    _build.check(err, "ask_fire")
    dense_fire_candidates.launches += 1
    return hit


dense_fire_candidates.launches = 0


# --- step 2 ------------------------------------------------------------------------


def extract_candidates(hits: torch.Tensor, n_cand: int):
    """(cand int32[B, n_cand], n_valid int32[B], overflow bool[B]) from
    hits bool[B, T]: ``spec_decode.extract_candidates`` with
    CAND_PER_BLOCK hits a block (fire candidates are denser than preamble
    hits)."""
    return _extract(hits, n_cand, CAND_PER_BLOCK)


# --- step 3 ------------------------------------------------------------------------


def chain_windows(cfg: AskConfig, rx: torch.Tensor, power: torch.Tensor,
                  sync: torch.Tensor, upd_ok: torch.Tensor, cand_full: torch.Tensor):
    """The record-chain rows of every candidate: (vals f32[B·C1, W], base
    int32[B·C1], has bool[B, C1]) for captures rx f32[B, T] with their dense
    arrays and the ascending candidates cand_full int32[B, C1] (slot 0 the
    virtual candidate at -(frame_samples+1), pads 2^30).

    The cursor after candidate c is min(c + frame_samples + 1, 2^30).  Its
    chain runs over the ROW-aligned window of W = CHAIN_WINDOW + ROW
    samples that holds the first update at or after the cursor (base is
    the window's first sample), with the columns before that update masked
    off and the warm-up band [cursor, cursor+L) taken from the exact
    warm-up correlations.  has is False where no update follows."""
    b, t = rx.shape
    c1 = cand_full.shape[1]
    l_pre = cfg.preamble_len
    win = CHAIN_WINDOW + ROW
    dev = rx.device
    cursor = (cand_full.to(torch.int64) + cfg.frame_samples + 1).clamp(max=BIGI)

    # warm-up correlations: [B, C1, L], samples at or past T read as zero
    pos = cursor[..., None] + torch.arange(l_pre, device=dev)
    inside = pos < t
    gidx = pos.clamp(max=t).reshape(b, -1)
    slab = torch.nn.functional.pad(rx, (0, 1)).gather(1, gidx).reshape(b, c1, l_pre)
    pw = torch.nn.functional.pad(power, (0, 1)).gather(1, gidx).reshape(b, c1, l_pre)
    sync_w = ask.true_div(matmul_f32(slab, _warmup_band(cfg, dev)), cfg.sync_divisor)
    ok_w = (sync_w > cfg.sync_power_factor * pw) & (sync_w > cfg.sync_abs_threshold) & inside

    first_warm = torch.where(ok_w, pos, BIGI).amin(-1)
    first_dense, has_dense = ask.first_upd_from(ask.upd_block_tables(upd_ok), cursor + l_pre)
    first = torch.minimum(first_warm, torch.where(has_dense, first_dense, BIGI))
    has = first < BIGI
    i0 = first.clamp(0, t - 1)

    # the chain windows: [B, C1, W]
    base = i0 // ROW * ROW
    idx = base[..., None] + torch.arange(win, device=dev)
    gidx = idx.clamp(max=t).reshape(b, -1)
    sp = torch.nn.functional.pad(sync, (0, 1), value=-math.inf).gather(1, gidx)
    ok = torch.nn.functional.pad(upd_ok, (0, 1)).gather(1, gidx)
    rel = idx - cursor[..., None]                # column -> warm-up band offset
    in_warm = (rel >= 0) & (rel < l_pre)
    wi = rel.clamp(0, l_pre - 1)
    sp = torch.where(in_warm, sync_w.gather(2, wi), sp.reshape(b, c1, win))
    ok = torch.where(in_warm, ok_w.gather(2, wi), ok.reshape(b, c1, win))
    ok = ok & (idx >= i0[..., None])
    vals = torch.where(ok, sp, -math.inf)
    return vals.reshape(b * c1, win), base.reshape(-1).to(torch.int32), has


@functools.lru_cache(maxsize=8)
def _warmup_band(cfg: AskConfig, device: torch.device) -> torch.Tensor:
    """The warm-up correlation's band matrix f32[L, L] on `device`, made
    once per configuration and device: a call copies nothing to the card."""
    return torch.from_numpy(ask._warmup_band_np(cfg).copy()).to(device)


def phase_b(cfg: AskConfig, rx: torch.Tensor, power: torch.Tensor,
            sync: torch.Tensor, upd_ok: torch.Tensor, cand_full: torch.Tensor) -> torch.Tensor:
    """Successor fields int32[B, 6, C1] of every candidate, rows has / fired
    / complete / peak / succ / nonconf: the chain rows of `chain_windows`
    through the record-chain kernel.  succ is the index of the fired peak in
    cand_full, -1 when it is not a candidate; nonconf marks a chain that did
    not fire inside its window."""
    b, t = rx.shape
    c1 = cand_full.shape[1]
    vals, base, has = chain_windows(cfg, rx, power, sync, upd_ok, cand_full)
    fired, peak = ask.ask_chain(vals, base, cfg.peak_guard)
    fired, peak = fired.reshape(b, c1), peak.reshape(b, c1)
    complete = peak + cfg.frame_samples < t
    succ = torch.searchsorted(cand_full, peak, out_int32=True)
    found = (succ < c1) & (cand_full.gather(1, succ.clamp(max=c1 - 1).to(torch.int64)) == peak)
    succ = torch.where(found, succ, -1)
    nonconf = has & ~fired
    return torch.stack([has.to(torch.int32), fired.to(torch.int32), complete.to(torch.int32),
                        peak, succ, nonconf.to(torch.int32)], dim=1).contiguous()


# --- step 4: kernel csrc/ask_walk.cu ---------------------------------------------


def ask_walk_plain(fields: torch.Tensor, max_frames: int):
    """Plain PyTorch version of :func:`ask_walk`, the kernel's algorithm in
    tensor ops, batched over captures: the step function on 2 * (C+1)
    nodes (candidate i active, or the sink of i, where the walk is done),
    and each slot's node by binary lifting."""
    if max_frames < 1:
        raise ValueError("max_frames must be at least 1")
    b, _, c1 = fields.shape
    dev = fields.device
    has, fired, complete, peak, succ, nc = fields.unbind(1)
    emit = (has > 0) & (fired > 0) & (complete > 0)
    miss = (emit & (succ < 0)) | (nc > 0)
    node = torch.arange(c1, device=dev).expand(b, c1)
    nxt = torch.where(emit & (succ >= 0), succ.to(torch.int64), node)
    # node i: the active candidate i for i < C+1, the sink of i - (C+1) past
    # it; a sink loops to itself
    jump = torch.cat([torch.where(~emit | miss, nxt + c1, nxt), node + c1], dim=1)
    pos = torch.zeros((b, max_frames), dtype=torch.int64, device=dev)
    h = 1
    while h < max_frames:           # slots [h, 2h) from [0, h) through f^h
        n = min(h, max_frames - h)
        pos[:, h:h + n] = jump.gather(1, pos[:, :n])
        if 2 * h < max_frames:
            jump = jump.gather(1, jump)
        h *= 2
    active = pos < c1
    cand = torch.where(active, pos, pos - c1)
    return (peak.gather(1, cand), active & emit.gather(1, cand),
            (active & miss.gather(1, cand)).any(1))


_WALK_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def ask_walk(fields: torch.Tensor, max_frames: int):
    """The frame loop of every capture as a walk through its successor
    table fields int32[B, 6, C+1] (rows has / fired / complete / peak /
    succ / nonconf, succ < C+1), from candidate 0, for `max_frames` slots:

        active = !done;  ok_fire = active & has & fired
        emit = ok_fire & complete            (slot k: peak, emit)
        miss = (emit & succ < 0) | (active & nonconf)
        done |= active & (!has | !fired | (ok_fire & !complete) | miss)
        i = emit & succ >= 0 ? succ : i;     bad |= miss

    Returns (peaks int32[B, K], fire_ok bool[B, K], bad bool[B]); a row
    with bad set met a candidate the table cannot represent exactly.  The
    kernel finds every slot's candidate by binary lifting (see
    ``csrc/ask_walk.cu``), in one launch that copies nothing to the card;
    it takes C+1 up to 2,048."""
    if not _build.on_cuda(fields):
        return ask_walk_plain(fields, max_frames)
    b, rows, c1 = fields.shape
    if rows != 6 or fields.dtype != torch.int32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous int32[B, 6, C+1]")
    peaks = torch.empty((b, max_frames), dtype=torch.int32, device=fields.device)
    fire_ok = torch.empty((b, max_frames), dtype=torch.bool, device=fields.device)
    bad = torch.empty(b, dtype=torch.bool, device=fields.device)
    fn = _build.entry("ask_walk", "tm_ask_walk", _WALK_ARGTYPES)
    err = fn(fields.data_ptr(), b, c1, max_frames, peaks.data_ptr(), fire_ok.data_ptr(),
             bad.data_ptr(), _build.stream_ptr(fields))
    _build.check(err, "ask_walk")
    ask_walk.launches += 1
    return peaks, fire_ok, bad


ask_walk.launches = 0


# --- the receiver ------------------------------------------------------------------


def demodulate_spec(cfg: AskConfig, rx: torch.Tensor, max_frames: int = 128,
                    n_cand: int = 96):
    """Batched speculative receive of captures rx f32[B, T]; returns
    ``(AskDecoded[B, K], ok[B])``.

    Rows with ``ok`` False (candidate-table overflow, a warm-up-region fire
    the successor table cannot represent, or a chain unresolved inside
    CHAIN_WINDOW + ROW samples) must be decoded again by the exact scan;
    ``phy/ask.py:demodulate_fast`` does so.  The other rows equal the exact
    scan slot for slot: a chain that fires inside the smaller window fires
    the same way in the scan's 4096-sample window."""
    if not spec_supported_cfg(cfg):
        raise ValueError("the speculative receiver needs a configuration that "
                         "admits the dense demodulation")
    if rx.ndim != 2:
        raise ValueError("rx must be f32[B, T]")
    x = rx.to(torch.float32).contiguous()
    b = x.shape[0]
    power, sync, upd_ok = ask.dense_arrays(cfg, x)
    hits = dense_fire_candidates(cfg, sync, upd_ok)
    cand, _, overflow = extract_candidates(hits, n_cand)
    virt = torch.full((b, 1), -(cfg.frame_samples + 1), dtype=torch.int32, device=x.device)
    fields = phase_b(cfg, x, power, sync, upd_ok, torch.cat([virt, cand], dim=1))
    peaks, fire_ok, bad = ask_walk(fields, max_frames)
    ds, dc = ask.demod_dense(cfg, x)
    res = ask.demod_slots_dense(cfg, ds, dc, peaks, fire_ok)
    return AskDecoded(**res), ~(overflow | bad)
