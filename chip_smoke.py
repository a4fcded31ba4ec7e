#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``trackmaker_tpu_torch``) on one card.

Run from the repository root on a machine with one NVIDIA Hopper card,
PyTorch built for CUDA and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (non-zero exit):

0. setup: TF32 off, the card's name and power limit, the kernels built
   from ``trackmaker_tpu_torch/csrc`` (one nvcc per source, in parallel)
   and the toolchain (nvcc, the driver, torch),
   and the window health probe ``tools.health.health`` on the card (its
   path: 1,201 launches of the probe kernel), printed with the card;
1. each kernel against its plain PyTorch version on the card: the
   Manchester kernels at the flagship shapes (32 captures x 433,464
   samples, 128 candidates), then the correlation at the 60-sample 4B5B
   preamble and the 4B5B attempt at the fourb5b_b32 shapes (32 captures x
   275,640 samples, 128 candidates), then the four ASK kernels at the
   ask_b16 shapes (16 captures x 338,752 samples, 97 candidate rows): the
   sliding dot at L=440 and L=30 and, bit for bit, at 15 pattern lengths
   in 1..512 (RAW_LS) on 3 captures of 50,001 samples, the fire rule on
   the batch's sync, the
   record chain on the batch's chain rows and on random rows with ties,
   the walk on the batch's successor table and on random tables; the
   line-coded walk on random tables and, with the Manchester attempt's four
   forms, on the edge inputs of tests/test_torch_walk_attempt_design.py
   (walk tables of 1 to 1,000 candidates at the caps that bind; attempt
   windows across T and the valid length, at every offset mod 4, bases at
   and past T, a first sample off a 16-byte boundary, row stride 0); the
   4B5B attempt's four forms and the ASK walk on the edge inputs of
   tests/test_torch_ask_walk_4b5b_design.py (the same kinds of windows,
   near-zero levels, invalid symbols at 0 and 525; ASK tables of C+1 in
   1..2,048 at max_frames 1..300 with self-loops, cycles, misses and a
   clean chain longer than max_frames); the record chain and the fire rule
   on the edge inputs of tests/test_torch_ask_fire_chain_design.py (chain
   rows of widths 1..4,096 across its segment and tile edges, the fire
   rule at w 1..11,264 and T 1..339,453 around its tile and halo, its
   arrays aligned and one element in; w = 0 and past its limit refused);
   then the
   row stats at the equalized_b32 (L=96) and fourb5b_b32 (L=60) shapes and
   at L=440 on the ask_b16 captures, each against its plain version and
   exactly against the row reduction of the dense normalized correlation
   and, at L <= 128, of the hit kernel's dense corr, and the dense
   normalized correlation at L=440 (the ASK chirp, on the ask_b16
   captures) against its plain version and, at L=96, exactly against the
   hit kernel's dense corr; then, at the flagship and
   fourb5b_b32 shapes, the hit kernel's refine entry (the sync-refine fold)
   against its plain version, its columns 0..8 against the hit kernel's
   rows bit for bit and its frame starts against the legacy attempt
   kernels', and the attempt kernels' fold forms against their plain
   versions and, given the legacy frame starts, against the legacy
   kernels; the hit kernel's corr against the normalized correlation
   kernel's bit for bit, and its rows against the plain rows of that corr,
   at every pattern length 1..128 (the preamble repeated and cut) on 3
   captures of 50,001 samples; the refine entry on dense hits (4 captures
   of 60,001 samples at thresholds 0.3 / 0.4 and -2, rows of 1 to 4 and
   more hits, every slot live), with the checks of the fold above, at both
   line codes; the hit kernel's batch-folded entry against the hit kernel's
   rows at the flagship shape; the attempt kernels' shared-capture forms
   (legacy and fold) against their plain versions on two long captures
   split into blocks: blocked_600s (Manchester, 600 s, 64 blocks,
   candidates past 2^24) and a 60 s 4B5B capture in 8 blocks with a frame
   across every seam, each with live candidates that read past their
   block's end; then the tools' kernels: the probe kernel against its
   plain version, the two-stream correlation (``tools.exp_xcorr_streams``)
   against its plain version and, bit for bit, against the hit kernel's
   rows, its noep form against its plain version and the truncation of the
   hit kernel's dense corr, on the flagship captures and on the tool's
   noise corpus (32 x 433,464, L=96, threshold 0.5), and the profiler's
   attempt-only stage, fold off and on, against the plain attempts; the
   threshold tie (the 4B5B preamble's first 39, 48 or 57 samples before a
   frame: lag 0 correlates to 0.9 in exact arithmetic), kernel #1's corr
   there against its plain version bit for bit and the frame found by the
   fast decode and the exact scan; the experiments' kernels: every
   attempt-tile variant (``tools.exp_attempt_tiles``) and base's _nodma,
   _nostore and _u5 against the plain version bit for bit on the tool's
   corpus (32 captures) and an integer-valued copy, each at rings of 1 to
   4 stages, a ring that does not fit refused, and the three offset-add
   forms (``tools.exp_offset_add``) against their plain versions and the
   NumPy oracles, bit for bit; the attempt tiles and the two-stream rows
   on the edge inputs of tests/test_torch_tiles_streams_design.py (the
   tiles' _u1.._u65, _nostore, noop, _nodma and the other kinds at rings of
   1 to 4 on two captures; the streams at L in 2..129 and T in
   129..50,001 around their tile, halo and zero tail, with a hit at the
   last lag, against kernel #1's rows bit for bit and the plain version);
   the probe and the offset add on the edge inputs of
   tests/test_torch_probe_offset_design.py (the probe where x + c rounds,
   near 2^24, at ties, inf, NaN and -0.0, bit for bit; the offset add's
   forms on N(0, 1) inputs within their f32 error bound of float64);
2. the main paths, each with its kernels' launch counts set to 0 just
   before it and read just after: the flagship and fourb5b_b32 through
   ``decode_capture_fast`` (32 noisy captures of 64 frames of 128-byte
   payloads, 200-sample gaps, noise sigma 0.05), then the same captures
   with the sync-refine fold on (manchester_b32_fold, fourb5b_b32_fold:
   one launch each of the refine entry, the fold attempt and the walk, none
   of the hit kernel, and every result equal to the legacy decode's);
   equalized_b32, the
   flagship's frames through the echo channel (taps 1 and 0.45 at delay 7,
   noise sigma 0.02 from a seeded ``torch.Generator``), through
   ``equalize_capture`` and then ``decode_capture_fast``; ask_b16 through
   ``ask.demodulate_fast`` (16 tracks of 64 ASK frames of b"the quick
   brown fox", ``build_track`` seeds 7-22, no noise); and ``auto_xcorr``
   at L=440 once.  Each decode has a payload gate, every row ``ok``,
   agreement with the exact scan on two rows, and each kernel of its path
   launched (equalized_b32: each exactly once).  Then the long-capture
   blocked decode through ``decode_blocked_single_chip``: blocked_600s
   (bench.py's row: 48 frames of bytes([i]) * 64 at (i + 1) * (t // 49) in
   28.8 M samples of noise sigma 0.05, 64 blocks, 8 frames per block, 128
   candidates) and the 4B5B seam capture, each legacy and with the fold
   on: every frame once with its exact start and payload, the speculative
   route ok, one launch of the correlation kernel (or its refine entry)
   and of the shared attempt, one walk per fixpoint turn, and the fold's
   frames equal to the legacy decode's.  Then the profiler path
   (``tools.prof_fused``): every stage on the flagship captures, the
   full-decode stage through the payload gate, the attempt-only stage fold
   off and on each launching one correlation entry, one attempt and no
   walk, and the two-stream experiment's row check; then both
   experiments' ``main()`` (the attempt tiles' six default variants, 5
   calls a repeat, and the three offset-add forms against their oracles);
3. the fallbacks: a Manchester capture that overflows the candidate table,
   a 4B5B capture with a zeroed level inside an attempted frame, and an
   ASK capture of 150 back-to-back chirps before three frames (more fire
   candidates than its table holds) go to the exact scan on the card, and
   each merged batch equals the exact scan; a noise-only batch passes the
   equalizer bit for bit; the 4B5B seam capture with a level zeroed in the
   frame across seam 1 makes the blocked decode's speculative route not
   ok, and decode_blocked_single_chip returns the exact blocked route's
   frames, equal to the sequential exact scan's;
4. timings with CUDA events (median of 30 runs after warm-up) of each
   kernel against its plain version (the sliding dot and the normalized
   correlation also against ``conv1d``), of the equalizer's steps, of
   ``decode_capture_spec`` (legacy and fold, in turns), ``equalize_capture``
   (alone and before the decode) and ``demodulate_spec`` end to end, and of
   the exact scan of one
   row (median of 5), with peak device memory and, for the equalized
   decode, the device's busy share (torch.profiler); at blocked_600s,
   ``decode_blocked_single_chip`` end to end (median of 30, and its
   real-time multiple), its steps (phase A, the fixpoint's walks, the
   compaction), its peak memory and busy share, each shared-capture attempt
   against its plain version and its bound, and one call of the exact
   blocked route; the launch floor, the two-stream experiment's times
   beside the hit kernel's at the tool's shapes with their bound, the
   tools' kernels against their plain versions, and the profiler's stage
   table (min and median of 3 runs of 10 calls); the hit kernel's entries'
   own device time (torch.profiler, median of 30 launches, from a session
   that traced all 30, else "not measured") beside each wrapper's
   CUDA-event time, and kernel #1 over the two-stream kernel at
   the tool's shapes in the same run; the same for every other kernel on
   a path (the sliding dot at L=440 and L=30, the normalized correlation,
   the row stats at L=96 and L=60, the attempts in every form, the walk,
   the ASK kernels), beside its bound and its launches, ranked by
   launches x (device - bound); the raw sliding dot's unfused floor; the
   Manchester and 4B5B attempts' contract floor (each live slot's window
   read once); the registers, spills and FFMA / FMUL / FADD / LDS counts of
   each kernel of sliding_dot.cu, xcorr_norm.cu, xcorr_hits.cu and
   xcorr_streams.cu, which share the register tile of xcorr_tile.cuh, and
   of spec_walk.cu, attempt_manchester.cu, attempt_4b5b.cu, ask_walk.cu,
   ask_fire.cu, ask_chain.cu, attempt_tiles.cu, seq_probe.cu and
   offset_add.cu (cuobjdump); the device time of the window probe, of
   the offset add's three forms, of the attempt tiles' noop and of the
   two-stream kernel, each beside an empty
   kernel at its grid (the probe's and the offset add's also at their
   first design's grid); the record chain on the exact scan's row
   (4,096 columns) and on its first 512 columns, each one launch, and two
   yardsticks that compute part of #10's and #9's functions
   (``torch.cummax`` of the chain rows, ``max_pool1d`` of the masked rows);
   every attempt-tile
   variant of phase 1 (CUDA events and device time) and every offset-add
   form against its plain version and its bound (bf16b's also at the f32
   rate), beside torch.bmm of the body products and torch.matmul with the
   sliced add; each printed beside the card's name and power limit.

The line before the last is a JSON object with the kernels' measurements:
``launches`` counts each kernel's launches in the main-path runs of
phase 2 (the line-coded paths, the blocked runs and the profiler path; the
probe's in phase 0's health run; the batch-folded hit rows are on no path
and count 0),
``ms`` and ``plain_ms`` time it at the shapes of its first path, and
``bound_ms`` is the least time the card could take for that work (bytes
over 3.35 TB/s or operations over 67 TFLOP/s, the attempt tiles' bf16
body over 989 TFLOP/s, whichever is larger).  ``attempt_tiles`` and
``offset_add`` give the base variant's and form A's numbers, and count the
launches of the experiments' main() runs.  The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

import numpy as np

N_FRAMES = 64
BATCH = 32
PAYLOAD = 128
GAP = 200
NOISE = 0.05
MAX_FRAMES = N_FRAMES + 8
N_CAND = 128
LOCAL_ADDR = 2
CORR_ATOL = 1e-5    # summation order differs between kernel and plain version
EDGE_THR = 0.5      # the refine-edge batch's threshold: hits off each preamble's lag
EQ_TAPS = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.45)   # bench.py's equalized row
EQ_NOISE = 0.02
RUNS = 30
ASK_BATCH = 16
ASK_FRAMES = 64
ASK_TEXT = b"the quick brown fox"
ASK_MAX_FRAMES = ASK_FRAMES + 8
BLOCKED_SECONDS = 600       # bench.py's blocked_600s row: one 600 s capture
BLOCKED_BLOCKS = 64
BLOCKED_FRAMES = 48
BLOCKED_PAYLOAD = 64
BLOCKED_MFPB = 8            # max_frames_per_block
SEAM_SECONDS = 60           # the 4B5B seam capture: a frame across every seam
SEAM_BLOCKS = 8
SWEEP_B, SWEEP_T = 3, 50_001  # the tap sweep's captures: T not a multiple of a block's lags
# the raw sliding dot's sweep: every remainder of an 8-tap step near 8, 16
# and 128, the dense dots' 30, the chirp's 440 and the kernel's last 512
RAW_LS = (1, 2, 7, 8, 9, 15, 16, 17, 30, 127, 128, 129, 440, 511, 512)
DENSE_B, DENSE_T = 4, 60_001  # the dense-hit refine captures
DENSE_THR = {"manchester": 0.3, "4b5b": 0.4}   # rows of 0 to 5 and more hits there
FULL_THR = -2.0             # every lag a hit: every slot of every row refined
PROFILE_SESSIONS = 3        # torch.profiler sessions a device time may take
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 on the tensor cores, dense
# the kernel each wrapper launches, where the two names differ
KERNEL_NAMES = {"sliding_dot_scaled": "sliding_dot", "dense_fire_candidates": "ask_fire",
                "normalized_xcorr_dense": "normalized_xcorr"}
# the source of each kernel, where it is not csrc/<name>.cu
SOURCES = {"normalized_xcorr": "xcorr_norm", "xcorr_rowstats": "xcorr_norm",
           "xcorr_hits_2s": "xcorr_streams", "attempt_sum": "attempt_manchester",
           "xcorr_hits_refine": "xcorr_hits", "xcorr_hits_batched": "xcorr_hits",
           "attempt_manchester_fold": "attempt_manchester", "attempt_4b5b_fold": "attempt_4b5b",
           "attempt_manchester_shared": "attempt_manchester",
           "attempt_manchester_fold_shared": "attempt_manchester",
           "attempt_4b5b_shared": "attempt_4b5b", "attempt_4b5b_fold_shared": "attempt_4b5b"}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, runs: int = RUNS) -> float:
    """Median milliseconds of `fn` on the card, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_share(torch, fn, calls: int = 5) -> float | None:
    """The share of wall time the card spends in kernels and copies over
    `calls` calls of `fn` (torch.profiler's device events), or None when the
    profiler traced no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / wall_us if busy_us > 0 else None


def peak_memory(torch, fn) -> str:
    """The peak device memory of one call of `fn`, and how far it rose above
    what was resident before it (the inputs of every phase so far)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 2**20:.1f} MiB ({(peak - resident) / 2**20:.1f} MiB above the "
            f"{resident / 2**20:.1f} MiB resident before the call)")


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, what sets it) for work moving `n_bytes` and doing `n_ops`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bench_frames(rng):
    """The bench's 64 frames of random 128-byte payloads."""
    from trackmaker_tpu_torch.core.framing import Frame

    return [Frame.new_data(i & 0xFF, 1, 2, rng.integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes())
            for i in range(N_FRAMES)]


def captures(torch, cfg, seed: int, dev):
    """The bench's input for `cfg`: 64 frames and 32 noisy captures on `dev`."""
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    rng = np.random.default_rng(seed)
    frames = bench_frames(rng)
    wave = PhyEncoder(cfg, device=dev).encode_frames(frames, gap_samples=GAP)
    noise = rng.normal(0, NOISE, (BATCH, wave.shape[0])).astype(np.float32)
    return frames, (wave[None] + torch.from_numpy(noise).to(dev)).contiguous()


def eq_captures(torch, cfg, seed: int, dev):
    """The equalized_b32 input (bench.py's equalized row), built on `dev`:
    64 frames through the echo channel, 32 captures with noise from a
    seeded generator."""
    from trackmaker_tpu_torch.dsp import channel
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    frames = bench_frames(np.random.default_rng(seed))
    wave = PhyEncoder(cfg, device=dev).encode_frames(frames, gap_samples=GAP)
    ech = channel.multipath(wave, EQ_TAPS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((BATCH, ech.shape[0]), generator=gen, device=dev) * EQ_NOISE
    return frames, (ech[None] + noise).contiguous()


def frame_list(res, row: int | None = None):
    """The valid frames of one capture (of a batch: row `row`), in slot
    order, as comparable tuples."""
    pick = (lambda a: a.cpu().numpy()) if row is None else (lambda a: a[row].cpu().numpy())
    valid = pick(res.valid)
    cols = [pick(getattr(res, f)) for f in
            ("length", "frame_type", "sequence", "src", "dst", "start")]
    fb = pick(res.frame_bytes)
    out = []
    for k in np.nonzero(valid)[0]:
        n = 7 + int(cols[0][k])
        out.append((fb[k, :n].tobytes(), *(int(c[k]) for c in cols)))
    return out


def compare_rows(torch, rows_k, rows_p, corr_p, thr, what: str) -> tuple[float, int, int]:
    """Hit rows of a kernel against its plain version's: a lag within
    CORR_ATOL of the threshold may fall on either side of it, and every
    other lag must give the same hits, counts and refine deltas, with the
    corr at each hit within CORR_ATOL.  Returns (hit corr max |err|, lags
    near the threshold, rows differing there)."""
    b, n_rows, _ = rows_k.shape
    near = (corr_p - thr).abs() < CORR_ATOL
    near_rows = torch.nn.functional.pad(near, (0, n_rows * 128 - near.shape[1]))
    near_rows = near_rows.reshape(b, n_rows, 128).any(-1)
    same = (rows_k[..., :5] == rows_p[..., :5]).all(-1) & (rows_k[..., 9:] == rows_p[..., 9:]).all(-1)
    require(bool((same | near_rows).all()), f"{what} hit rows differ away from the threshold")
    hit_vals = rows_k[..., 5:9].contiguous().view(torch.float32)
    hit_vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    val_err = (hit_vals - hit_vals_p)[same].abs().max().item()
    require(val_err <= CORR_ATOL, f"{what} hit corr differs by {val_err}")
    return val_err, int(near.sum()), int((~same).sum())


def refine_kw(cfg) -> dict:
    """The sync-refine fold's settings of `cfg`, as the decode sets them."""
    return dict(sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
                n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len, fall_off=cfg.preamble_len)


def check_xcorr(torch, xcorr_hits, xcorr_hits_plain, x, pre, thr, tag: str):
    """xcorr_hits against its plain version; returns (max |err|, rows, plain corr)."""
    corr_k, rows_k = xcorr_hits(x, pre, thr, emit_corr=True)
    torch.cuda.synchronize()
    corr_p, rows_p = xcorr_hits_plain(x, pre, thr, emit_corr=True)
    err = (corr_k - corr_p).abs().max().item()
    require(err <= CORR_ATOL, f"xcorr_hits ({tag}) corr differs by {err}")
    _, rows_main = xcorr_hits(x, pre, thr)
    require(torch.equal(rows_main, rows_k), f"xcorr_hits ({tag}) rows depend on emit_corr")
    val_err, n_near, n_diff = compare_rows(torch, rows_k, rows_p, corr_p, thr, f"xcorr_hits ({tag})")
    log(f"phase 1: xcorr_hits == plain at L={len(pre)} (corr max |err| {err:.3g}, hit corr "
        f"{val_err:.3g}, {n_near} lags within {CORR_ATOL} of the threshold, "
        f"{n_diff} rows differing there)")
    return max(err, val_err), rows_k, corr_p


def check_fold(torch, sd, xh, cfg, x, vlens, thr, corr_p, tag: str) -> tuple[dict, dict]:
    """Phase 1 for the sync-refine fold at one line code's shapes, at
    threshold `thr`: the refine entry against its plain version and, in
    columns 0..8, the hit kernel's rows bit for bit; its frame starts
    against the legacy attempt kernel's on the same candidates; the fold
    attempt against its plain version and against the legacy kernel.
    Returns the max |err| per kernel and the fold's inputs and outputs."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    kw = refine_kw(cfg)
    _, rows_k = xh.xcorr_hits(x, pre, thr)
    rows_r = xh.xcorr_hits_refine(x, vlens, pre, sync, thr, **kw)
    torch.cuda.synchronize()
    rows_rp = xh.xcorr_hits_refine_plain(x, vlens, pre, sync, thr, **kw)
    val_err, n_near, n_diff = compare_rows(torch, rows_r, rows_rp, corr_p, thr,
                                           f"xcorr_hits_refine ({tag})")
    require(torch.equal(rows_r[..., :9], rows_k[..., :9]),
            f"xcorr_hits_refine ({tag}) columns 0..8 differ from xcorr_hits' rows")
    cand, _, n_valid, _ = sd.compact_hit_rows(rows_k, N_CAND)
    cand_r, _, n_valid_r, _, fs_r = sd.compact_hit_rows(rows_r, N_CAND, with_fs=True)
    require(torch.equal(cand_r, cand) and torch.equal(n_valid_r, n_valid),
            f"the fold's candidate table ({tag}) differs from the legacy one")
    if cfg.line_coding == "manchester":
        attempt, fold, fold_plain = (sd.attempt_manchester, sd.attempt_manchester_fold,
                                     sd.attempt_manchester_fold_plain)
    else:
        attempt, fold, fold_plain = sd.attempt_4b5b, sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain
    legacy = attempt(x, cand, n_valid, vlens, sync, preamble_energy(sync))
    require(torch.equal(fs_r, legacy[1]),
            f"the fold's frame starts ({tag}) differ from {attempt.__name__}'s")
    got = fold(x, fs_r, n_valid)
    torch.cuda.synchronize()
    want = fold_plain(x, fs_r, n_valid)
    fold_err = 0
    for g, w, l_ in zip(got, want, legacy):
        require(torch.equal(g, w), f"{fold.__name__} ({tag}) differs from its plain version")
        require(torch.equal(g, l_), f"{fold.__name__} ({tag}) differs from {attempt.__name__}")
        fold_err = max(fold_err, (g.int() - w.int()).abs().max().item())
    live = sd._live(cand, n_valid)
    hit = rows_r[..., :4] < 2**30
    deltas = rows_r[..., 9:13][hit]
    log(f"phase 1: xcorr_hits_refine == plain at L={len(pre)}, W={len(sync)} ({tag}: hit corr "
        f"{val_err:.3g}, {n_near} lags near the threshold, {n_diff} rows differing there), "
        f"columns 0..8 == xcorr_hits bit for bit, cand + delta == {attempt.__name__}'s fs on all "
        f"{int(live.sum())} live candidates ({deltas.numel()} refined hits, deltas "
        f"{int(deltas.min())}..{int(deltas.max())}); {fold.__name__} == plain and == "
        f"{attempt.__name__}")
    return ({"xcorr_hits_refine": val_err, fold.__name__: fold_err},
            dict(rows=rows_r, hit=hit, fs=fs_r, n_valid=n_valid, kw=kw, sync=sync,
                 hits=int(hit.sum())))


def check_refine_edges(torch, sd, xh, cfg, x, corr_p, tag: str) -> dict:
    """The fold's checks on a batch where the refine must move and must
    fall back: the main path's captures at threshold EDGE_THR, which makes
    hits of the lags around each preamble and in the payload (their sync
    word lies off the expected position), and valid lengths that, in each
    even capture r, cut the refine window of one hit, in a block's last row
    where one lies among the first candidates, to m = r/2 mod (n_pos + 1)
    valid positions (m = 0: the fallback), and every window past it to
    none; odd captures keep their full length.
    Returns the max |err| per kernel."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

    kw = refine_kw(cfg)
    b, t = x.shape
    _, rows0 = xh.xcorr_hits(x, preamble_waveform(cfg), EDGE_THR)
    cand0 = sd.compact_hit_rows(rows0, N_CAND)[0][:, 8:N_CAND // 2].cpu().numpy()
    vlen = np.full(b, t, np.int64)
    for r in range(0, b, 2):
        last = cand0[r][(cand0[r] // 128) % 8 == 7]
        h = int(last[0] if last.size else cand0[r, 0])
        vlen[r] = h + kw["sync_off"] + kw["sync_len"] - 1 + (r // 2) % (kw["n_pos"] + 1)
    vlens = torch.from_numpy(vlen.astype(np.int32)).to(x.device)
    errs, out = check_fold(torch, sd, xh, cfg, x, vlens, EDGE_THR, corr_p, f"{tag} edges")
    rows, hit = out["rows"], out["hit"]
    pos = rows[..., :4].long()
    n_ok = (vlens.long()[:, None, None] - kw["sync_len"] - kw["sync_off"] - pos + 1).clamp(
        0, kw["n_pos"])                                     # valid refine positions of each hit
    deltas = rows[..., 9:13]
    moved = hit & (deltas != kw["fall_off"])
    last_row = (torch.arange(rows.shape[1], device=x.device) % 8 == 7)[None, :, None]
    trimmed = hit & (n_ok > 0) & (n_ok < kw["n_pos"])
    fallback = hit & (n_ok == 0)
    counts = {"moved": int(moved.sum()), "moved in a block's last row": int((moved & last_row).sum()),
              "trimmed": int(trimmed.sum()), "fallback": int(fallback.sum())}
    require(all(counts.values()), f"xcorr_hits_refine ({tag} edges): a case is missing: {counts}")
    require(bool((deltas[fallback] == kw["fall_off"]).all()),
            f"xcorr_hits_refine ({tag} edges): a hit with no valid position did not fall back")
    require(bool((deltas[trimmed] - kw["sync_off"] - kw["sync_len"] < n_ok[trimmed]).all()),
            f"xcorr_hits_refine ({tag} edges): a trimmed refine chose an invalid position")
    log(f"phase 1: xcorr_hits_refine ({tag} edges, threshold {EDGE_THR}): {out['hits']} refined "
        f"hits, {counts}")
    return errs


def check_tap_sweep(torch, xh, xn, x, pre, thr) -> int:
    """Kernel #1's dense corr against tm_normalized_xcorr's (xcorr_norm.cu,
    the first design's loop), bit for bit, for every pattern length L in
    1..128 (the preamble repeated and cut) on SWEEP_B captures of SWEEP_T
    samples, and its rows against the plain hit rows of that corr, bit for
    bit: every remainder of the kernel's tap steps.  Returns the hits."""
    xx = x[:SWEEP_B, :SWEEP_T].contiguous()
    n_rows = -(-SWEEP_T // 128)
    patterns = np.tile(pre, -(-xh.MAX_PATTERN // len(pre)))
    hits = 0
    for l in range(1, xh.MAX_PATTERN + 1):
        corr, rows = xh.xcorr_hits(xx, patterns[:l], thr, emit_corr=True)
        dense = xn.normalized_xcorr_dense(xx, patterns[:l])
        torch.cuda.synchronize()
        require(torch.equal(corr, dense),
                f"tap sweep: xcorr_hits' corr at L={l} differs from normalized_xcorr's")
        require(torch.equal(rows, xh.hit_rows_plain(corr, n_rows, thr)),
                f"tap sweep: xcorr_hits' rows at L={l} differ from the plain rows of its corr")
        hits += int(rows[..., 4].sum())
    require(hits > 0, "tap sweep: no hit at any pattern length")
    log(f"phase 1: tap sweep: xcorr_hits' corr == normalized_xcorr's bit for bit and its rows == "
        f"the plain rows of that corr at every L in 1..{xh.MAX_PATTERN} on {SWEEP_B} x "
        f"{SWEEP_T} ({hits} hits in all)")
    return hits


def check_dense_refine(torch, sd, xh, xn, cfg, x, tag: str) -> dict:
    """The refine entry on dense hits: the first DENSE_B captures cut to
    DENSE_T samples, at DENSE_THR (rows of 1, 2, 3 and 4 or more hits in
    the same blocks) and at FULL_THR (every slot of every row live), with
    check_fold's checks (deltas equal the plain refine's, cand + delta the
    legacy attempt's frame start).  Returns the max |err| per kernel."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

    xx = x[:DENSE_B, :DENSE_T].contiguous()
    vlens = torch.full((DENSE_B,), DENSE_T, dtype=torch.int32, device=x.device)
    corr_p = xn.normalized_xcorr_dense_plain(xx, preamble_waveform(cfg))
    errs = {}
    for thr in (DENSE_THR[cfg.line_coding], FULL_THR):
        e, out = check_fold(torch, sd, xh, cfg, xx, vlens, thr, corr_p,
                            f"{tag} dense hits at {thr}")
        for k_name, v in e.items():
            errs[k_name] = max(errs.get(k_name, 0), v)
        counts = out["rows"][..., 4].clamp(max=4)
        need = [1, 2, 3, 4] if thr == DENSE_THR[cfg.line_coding] else [4]
        seen = {n: int((counts == n).sum()) for n in need}
        require(all(seen.values()), f"xcorr_hits_refine ({tag} dense hits at {thr}): rows of "
                                    f"each count {need} wanted, got {seen}")
        log(f"phase 1: xcorr_hits_refine ({tag} dense hits at threshold {thr}, {DENSE_B} x "
            f"{DENSE_T}): rows by hit count (4 = 4 or more) {seen}, {out['hits']} refined hits")
    return errs


def device_ms(torch, fn, kernel: str, calls: int = RUNS) -> tuple[float, int] | None:
    """The median device time (ms) of a launch of the CUDA kernel whose name
    holds `kernel`, over `calls` calls of `fn` (torch.profiler's kernel
    events), and the profiling sessions it took: the first of
    PROFILE_SESSIONS sessions that traced every one of the `calls`
    launches; None when none did (the profiler can drop kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) == calls:
            return statistics.median(times), attempt
        log(f"device time of {kernel}: {len(times)} of {calls} launches traced "
            f"(session {attempt} of {PROFILE_SESSIONS})")
    return None


def toolchain(torch, _build) -> str:
    """nvcc's release, the driver's version and torch's build: the large
    launch parameters of xcorr_norm.cu need CUDA 12.1 or later."""
    import subprocess

    nvcc = [line for line in subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                                            text=True, check=True).stdout.splitlines()
            if "release" in line][0]
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True,
                            timeout=60).stdout.strip().splitlines()[0]
    return f"nvcc {nvcc}, driver {driver}, torch {torch.__version__} (CUDA {torch.version.cuda})"


SASS_OPS = ("FFMA", "FMUL", "FADD", "LDS")   # the sums' instructions and shared loads


def kernel_resources(_build, src: str) -> dict[str, dict[str, int]]:
    """The registers, stack, static shared memory and local memory (spills)
    of each kernel function in the library built from csrc/<src>.cu, as
    ``cuobjdump -res-usage`` (beside nvcc) reads them, and the count of each
    of SASS_OPS in its code (``cuobjdump -sass``, any suffix)."""
    import re
    import subprocess
    from pathlib import Path

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lib = str(_build.library_path(src))
    out = subprocess.run([str(tool), "-res-usage", lib], capture_output=True, text=True,
                         check=True).stdout
    found = {m.group(1): {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                            m.group(2))}
             for m in re.finditer(r"Function (\S+):\s*\n([^\n]*)", out)}
    require(bool(found) and all(len(v) == 4 for v in found.values()),
            f"cuobjdump -res-usage on {src} gave no resource line:\n{out}")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn_name, code = part.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", code)
        require(fn_name.strip() in found, f"cuobjdump -sass on {src}: unknown function {fn_name}")
        found[fn_name.strip()].update({op: ops.count(op) for op in SASS_OPS})
    require(all(len(v) == 4 + len(SASS_OPS) for v in found.values()),
            f"cuobjdump -sass on {src} did not give every function's code")
    return found


def check_walk_attempt_edges(torch, sd, dev) -> dict:
    """The walk and the four Manchester attempt forms against their plain
    versions, bit for bit, on the edge inputs of
    tests/test_torch_walk_attempt_design.py: walk tables of 1 to 1,000
    candidates (none present, all present, a stop first, duplicate
    positions, a cursor past all, a limit mid-table) at caps 1, L - 1, L
    and C + 1; attempts at windows across T and the valid length, starts at
    every offset mod 4, bases at and past T, a first sample off a 16-byte
    boundary, row stride 0, rows without a live slot and with more hits
    than slots."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_walk_attempt_design as edges

    errs = {"spec_walk": 0}
    n_tables = 0
    for c in edges.WALK_CS:
        for fields, cur0, limit, cap in edges.walk_edge_tables(c):
            args = (fields.to(dev), cur0.to(dev), limit.to(dev), cap)
            got = sd.spec_walk(*args)
            torch.cuda.synchronize()
            for field, g, w in zip(got._fields, got, sd.spec_walk_plain(*args)):
                require(torch.equal(g, w), f"spec_walk {field} differs on the edge table of "
                                           f"{c} candidates (max_frames {cap})")
            n_tables += 1
    inputs = edges.attempt_edge_inputs(dev)
    n_live = 0
    for form in edges.ATTEMPT_FORMS:
        xx, args = inputs[form]
        wrapper, plain = edges.attempt_call(form)
        got = wrapper(xx, *args)
        torch.cuda.synchronize()
        for field, g, w in zip(("bytes", "fs"), got, plain(xx, *args)):
            require(torch.equal(g, w), f"{wrapper.__name__} ({form}) {field} differs from its "
                                       "plain version on the edge inputs")
        k_name = wrapper.__name__ + ("_shared" if xx.stride(0) == 0 else "")
        errs[k_name] = 0
        n_live = int(sd._live(got[1], args[1]).sum())
    log(f"phase 1: spec_walk == plain on {n_tables} edge tables of {list(edges.WALK_CS)} "
        f"candidates; attempt_manchester and its fold form, per row and shared, == plain on "
        f"the edge inputs ({edges.ATT_B} x {edges.ATT_T} samples, {n_live} live slots of "
        f"{edges.ATT_B * edges.ATT_C})")
    return errs


def check_ask_walk_4b5b_edges(torch, sd, ask_spec, dev) -> dict:
    """The four 4B5B attempt forms and the ASK walk against their plain
    versions, bit for bit, on the edge inputs of
    tests/test_torch_ask_walk_4b5b_design.py: attempts at windows across T
    and the valid length, starts at every offset mod 4, bases at and past T,
    a first sample off a 16-byte boundary, row stride 0, rows without a live
    slot and with more hits than slots, near-zero levels and invalid
    symbols at 0 and 525; ASK tables of C+1 in 1..2,048 (a self-loop, a
    cycle, a miss at an emitting node, nonconf with a successor, a clean
    chain longer than max_frames) at max_frames 1..300."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_ask_walk_4b5b_design as edges

    errs = {}
    inputs = edges.fourb5b_edge_inputs(dev)
    n_live = 0
    for form in edges.FOURB_FORMS:
        xx, args = inputs[form]
        wrapper, plain = edges.attempt_4b5b_call(form)
        got = wrapper(xx, *args)
        torch.cuda.synchronize()
        for field, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got, plain(xx, *args)):
            require(torch.equal(g, w), f"{wrapper.__name__} ({form}) {field} differs from its "
                                       "plain version on the edge inputs")
        errs[wrapper.__name__ + ("_shared" if xx.stride(0) == 0 else "")] = 0
        n_live = int(sd._live(args[0], args[1]).sum())
    n_tables = 0
    for c1 in edges.ASK_C1S:
        fields = edges.ask_edge_tables(c1).to(dev)
        for mf in edges.ASK_MFS:
            got = ask_spec.ask_walk(fields, mf)
            torch.cuda.synchronize()
            for field, g, w in zip(("peaks", "fire_ok", "bad"), got,
                                   ask_spec.ask_walk_plain(fields, mf)):
                require(torch.equal(g, w), f"ask_walk {field} differs on the edge table of "
                                           f"C+1 = {c1} (max_frames {mf})")
            n_tables += 1
    errs["ask_walk"] = 0
    log(f"phase 1: attempt_4b5b and its fold form, per row and shared, == plain on the edge "
        f"inputs ({edges.B4} x {edges.T4} samples, {n_live} live slots of "
        f"{edges.B4 * edges.C4}); ask_walk == plain on {n_tables} edge tables "
        f"(C+1 in {list(edges.ASK_C1S)}, max_frames in {list(edges.ASK_MFS)})")
    return errs


def check_fire_chain_edges(torch, ask, ask_spec, dev) -> None:
    """The fire rule and the record chain against their plain versions, bit
    for bit, on the edge inputs of tests/test_torch_ask_fire_chain_design.py:
    the chain at widths 1..4,096 across its segment (32) and tile (1,024)
    edges, guards 200 and 3 (all -inf, a lone update, ties across a segment
    and a tile edge, fires at the guard, after a segment and a tile edge and
    at the last column, a row that never fires); the fire rule at w 1..11,264
    and T 1..339,453 around its tile of 4,096 and its halo (30% of upd
    set, all, none; ties at the windows' ends), its arrays aligned (float4
    and word loads) and one element into their buffers (scalar loads); w
    = 0 and past FIRE_MAX_W refused, FIRE_MAX_W taken."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_ask_fire_chain_design as edges

    n_rows = 0
    for win in edges.CHAIN_WS:
        for guard in edges.CHAIN_GUARDS:
            vals, base = (a.to(dev) for a in edges.chain_edge_rows(win, guard))
            got = ask.ask_chain(vals, base, guard)
            torch.cuda.synchronize()
            for field, g, w in zip(("fired", "peak"), got, ask.ask_chain_plain(vals, base, guard)):
                require(torch.equal(g, w), f"ask_chain {field} differs on the edge rows of width "
                                           f"{win} (guard {guard})")
            n_rows += vals.shape[0]
    n_inputs = 0
    for w in edges.FIRE_WS:
        cfg = edges.fire_cfg(w)
        for t in edges.FIRE_TS:
            for offset in (0, 1):
                sync, upd = edges.fire_edge_inputs(w, t, offset, dev)
                got = ask_spec.dense_fire_candidates(cfg, sync, upd)
                torch.cuda.synchronize()
                require(torch.equal(got, ask_spec.dense_fire_candidates_plain(cfg, sync, upd)),
                        f"ask_fire differs on the edge inputs at w={w}, T={t}, offset {offset}")
                n_inputs += 1
    sync, upd = edges.fire_edge_inputs(edges.FIRE_MAX_W, 50_001, device=dev)
    cfg = edges.fire_cfg(edges.FIRE_MAX_W)
    got = ask_spec.dense_fire_candidates(cfg, sync, upd)
    torch.cuda.synchronize()
    require(torch.equal(got, ask_spec.dense_fire_candidates_plain(cfg, sync, upd)),
            f"ask_fire differs at w={edges.FIRE_MAX_W}")
    for w in (0, edges.FIRE_MAX_W + 1):
        try:
            ask_spec.dense_fire_candidates(edges.fire_cfg(w), sync, upd)
        except RuntimeError:
            continue
        raise RuntimeError(f"ask_fire took w={w}")
    log(f"phase 1: ask_chain == plain on {n_rows} edge rows (widths {list(edges.CHAIN_WS)}, "
        f"guards {list(edges.CHAIN_GUARDS)}); ask_fire == plain on {n_inputs} edge inputs of 3 "
        f"rows (w in {list(edges.FIRE_WS)}, T in {list(edges.FIRE_TS)}, aligned and one element "
        f"in) and at w={edges.FIRE_MAX_W}; w=0 and w={edges.FIRE_MAX_W + 1} refused")


def digest(tensors) -> str:
    """A short SHA-256 of the tensors' bytes, in order: equal digests from
    two trees mean the same decisions bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg, x, frames,
                  kernels, tag: str, front=None, expect=None) -> dict[str, int]:
    """One main-path run through decode_capture_fast, behind the front-end
    `front` (captures in, captures out) where given, with its gates; returns
    the launch count of each kernel in `kernels`, each of which must be
    positive, or equal to `expect` where given."""
    b = x.shape[0]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if front is not None:
        x = front(x)
    res = decode_capture_fast(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    what = "decode_capture_fast" if front is None else f"{front.__name__} + decode_capture_fast"
    log(f"phase 2 ({tag}): {what} took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    if expect is not None:
        require(launches == expect, f"{tag} launches {launches}, expected {expect}")
    for k_name, n in launches.items():
        require(n > 0 or expect is not None, f"the {tag} main path never launched {k_name}")
    counts = res.count.cpu().numpy()
    require(bool((counts == N_FRAMES).all()),
            f"{tag} count gate failed: {sorted(set(counts.tolist()))}")
    fb = res.frame_bytes.cpu().numpy()
    valid = res.valid.cpu().numpy()
    for r in range(b):
        for k, f in zip(np.nonzero(valid[r])[0], frames):
            require(fb[r, k, 7:7 + PAYLOAD].tobytes() == f.data,
                    f"{tag} payload gate failed at row {r} slot {k}")
    spec_res, ok = sd.decode_capture_spec(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(bool(ok.all()), f"a {tag} row is not ok")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            f"{tag}: decode_capture_fast differs from decode_capture_spec with every row ok")
    for r in (0, b - 1):
        exact = decode_capture(cfg, x[r], LOCAL_ADDR, MAX_FRAMES)
        require(frame_list(res, r) == frame_list(exact), f"{tag} row {r} differs from the exact scan")
        corr_gap = (res.corr[r][res.valid[r]] - exact.corr[exact.valid]).abs().max().item()
        require(corr_gap <= CORR_ATOL, f"{tag} row {r} corr differs from the exact scan by {corr_gap}")
    log(f"phase 2 ({tag}): payload gate passed ({b} rows x {N_FRAMES} frames), every row ok, "
        f"rows 0 and {b - 1} equal the exact scan; decisions digest {digest(res)}"
        + ("" if front is None else f", front end's output digest {digest([x])}"))
    return launches


def check_fallback(torch, decode_capture_fast, decode_captures, sd, cfg, small, want_frames,
                   tag: str, what: str) -> None:
    """Row 0 of `small` must be not ok and row 1 ok; the merged batch must
    equal the exact scan."""
    _, small_ok = sd.decode_capture_spec(cfg, small, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(small_ok.tolist() == [False, True], f"{tag} fallback flags {small_ok.tolist()}")
    merged = decode_capture_fast(cfg, small, LOCAL_ADDR, max_frames=MAX_FRAMES)
    exact = decode_captures(cfg, small, LOCAL_ADDR, MAX_FRAMES, [small.shape[1]] * 2)
    require(all(torch.equal(p[0], q[0]) for p, q in zip(merged, exact)),
            f"the {tag} fallback row differs from the exact scan")
    require(frame_list(merged, 1) == frame_list(exact, 1),
            f"the {tag} clean row differs from the exact scan")
    require(merged.count.tolist() == want_frames,
            f"{tag} fallback frames {merged.count.tolist()}, expected {want_frames}")
    log(f"phase 3 ({tag}): fallback row ({what}) re-decoded by the exact scan on the card; "
        f"merged batch equals it ({merged.count.tolist()} frames)")


def ask_captures(torch, ask, cfg, dev):
    """The ask_b16 input (bench.py's ask row): 16 tracks of 64 frames,
    zero-padded to the longest, on `dev`."""
    frames = ask.build_frames(ASK_TEXT, cfg, num_frames=ASK_FRAMES)
    waves = [ask.build_track(cfg, frames, seed=7 + r) for r in range(ASK_BATCH)]
    caps = np.zeros((ASK_BATCH, max(len(w) for w in waves)), np.float32)
    for r, w in enumerate(waves):
        caps[r, :len(w)] = w
    return frames, torch.from_numpy(caps).to(dev)


def chain_rows(torch, rng, n: int, win: int, dev):
    """Random record-chain rows with ties, an empty row and a flat row."""
    vals = np.full((n, win), -np.inf, np.float32)
    mask = rng.random((n, win)) < 0.05
    vals[mask] = rng.normal(1, 0.5, mask.sum()).astype(np.float32)
    vals[3, 40] = vals[3, 60] = np.float32(2.5)
    vals[4] = -np.inf
    vals[5] = np.float32(0.5)
    return (torch.from_numpy(vals).to(dev),
            torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(dev))


def walk_table(torch, rng, b: int, c1: int, dev):
    """A random ASK successor table int32[b, 6, c1]."""
    fields = np.stack([rng.random((b, c1)) < 0.95, rng.random((b, c1)) < 0.95,
                       rng.random((b, c1)) < 0.95, rng.integers(-5, 400_000, (b, c1)),
                       rng.integers(-1, c1, (b, c1)), rng.random((b, c1)) < 0.03], axis=1)
    return torch.from_numpy(fields.astype(np.int32)).to(dev)


def chain_columns(torch, vals, base, guard: int) -> int:
    """The columns the record chain needs on these rows: each row up to its
    first fire, all of it when it never fires."""
    n, win = vals.shape
    m = torch.nn.functional.pad(vals.cummax(-1).values[:, :-1], (1, 0), value=-np.inf)
    upd = vals > m
    idx = base[:, None] + torch.arange(win, dtype=torch.int32, device=vals.device)
    rec = torch.where(upd, idx, -(2**30)).cummax(-1).values
    rec = torch.nn.functional.pad(rec[:, :-1], (1, 0), value=-(2**30))
    fire = ~upd & (idx > rec + guard) & (m > -np.inf)
    lane = torch.arange(win, device=vals.device)
    return int((torch.where(fire, lane, win - 1).amin(-1) + 1).sum())


def check_ask_kernels(torch, ask, ask_spec, sdot, cfg, xa, rng) -> tuple[dict, dict]:
    """Phase 1 for the four ASK kernels at the ask_b16 shapes; returns
    (max |err| per kernel, the inputs phase 4 times them on)."""
    dev = xa.device
    b = xa.shape[0]
    pre = ask._chirp_np(cfg)
    k30 = ask._demod_dense_tables_np(cfg)[0]
    demod_in = ask.demod_dense_input(cfg, xa)
    errs = dict.fromkeys(("sliding_dot", "ask_fire", "ask_chain", "ask_walk"), 0)

    def record(k_name: str, got, want, what: str) -> None:
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{k_name} differs {what}")
        errs[k_name] = max([errs[k_name]] + [(g.double() - w.double()).abs().max().item()
                                             for g, w in zip(got, want)])

    for x, pattern, scale in ((xa, pre, 1.0 / cfg.sync_divisor), (demod_in, k30, 1.0)):
        got = sdot.sliding_dot_scaled(x, pattern, scale)
        torch.cuda.synchronize()
        record("sliding_dot", [got], [sdot.sliding_dot_scaled_plain(x, pattern, scale)],
               f"at L={len(pattern)}")
    log(f"phase 1: sliding_dot == plain at L=440 on {b} x {xa.shape[1]} and at L=30 on "
        f"{demod_in.shape[0]} x {demod_in.shape[1]}")
    xx = xa[:SWEEP_B, :SWEEP_T].contiguous()
    patterns = np.tile(pre, -(-sdot.MAX_PATTERN // len(pre)))
    for l in RAW_LS:
        got = sdot.sliding_dot_scaled(xx, patterns[:l], 1.0 / cfg.sync_divisor)
        torch.cuda.synchronize()
        record("sliding_dot", [got],
               [sdot.sliding_dot_scaled_plain(xx, patterns[:l], 1.0 / cfg.sync_divisor)],
               f"at L={l} on {SWEEP_B} x {SWEEP_T}")
    log(f"phase 1: sliding_dot == plain bit for bit at every L in {list(RAW_LS)} (the chirp "
        f"repeated and cut) on {SWEEP_B} x {SWEEP_T}")

    power, sync, upd_ok = ask.dense_arrays(cfg, xa)
    hits = ask_spec.dense_fire_candidates(cfg, sync, upd_ok)
    torch.cuda.synchronize()
    record("ask_fire", [hits], [ask_spec.dense_fire_candidates_plain(cfg, sync, upd_ok)],
           "on the batch's sync")
    log(f"phase 1: ask_fire == plain ({int(upd_ok.sum())} updates, {int(hits.sum())} fire "
        "candidates)")

    cand, n_valid, overflow = ask_spec.extract_candidates(hits, 96)
    virt = torch.full((b, 1), -(cfg.frame_samples + 1), dtype=torch.int32, device=dev)
    cand_full = torch.cat([virt, cand], dim=1)
    vals, base, _ = ask_spec.chain_windows(cfg, xa, power, sync, upd_ok, cand_full)
    rows = [(vals, base)] + [chain_rows(torch, rng, 300, win, dev) for win in (1000, 1024, 4096)]
    for v, bs in rows:
        got = ask.ask_chain(v, bs, cfg.peak_guard)
        torch.cuda.synchronize()
        record("ask_chain", got, ask.ask_chain_plain(v, bs, cfg.peak_guard),
               f"on rows of {v.shape[1]}")
    log(f"phase 1: ask_chain == plain on the batch's {vals.shape[0]} chain rows "
        f"({int(ask.ask_chain(vals, base, cfg.peak_guard)[0].sum())} fire) and on random rows "
        "with ties (widths 1000, 1024, 4096)")

    fields = ask_spec.phase_b(cfg, xa, power, sync, upd_ok, cand_full)
    tables = [(fields, ASK_MAX_FRAMES)] + [(walk_table(torch, rng, 16, 97, dev), mf)
                                           for mf in (1, 72, 128)]
    for f, mf in tables:
        got = ask_spec.ask_walk(f, mf)
        torch.cuda.synchronize()
        record("ask_walk", got, ask_spec.ask_walk_plain(f, mf), f"(max_frames {mf})")
    log(f"phase 1: ask_walk == plain on the batch's table (candidates per capture "
        f"{int(n_valid.min())}..{int(n_valid.max())}, overflow {int(overflow.sum())}) and on "
        "three random tables")
    return errs, dict(demod_in=demod_in, sync=sync, upd_ok=upd_ok, vals=vals, base=base,
                      fields=fields, k30=k30, pre=pre)


def run_ask_main_path(torch, ask, ask_spec, cfg, xa, frames, kernels) -> dict[str, int]:
    """The ask_b16 main path through ask.demodulate_fast, with its gates;
    returns the launch count of each kernel in `kernels`."""
    b = xa.shape[0]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ask.demodulate_fast(cfg, xa, max_frames=ASK_MAX_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {KERNEL_NAMES.get(k.__name__, k.__name__): k.launches for k in kernels}
    log(f"phase 2 (ask_b16): demodulate_fast took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    for k_name, n in launches.items():
        require(n > 0, f"the ask_b16 main path never launched {k_name}")
    spec_res, ok = ask_spec.demodulate_spec(cfg, xa, max_frames=ASK_MAX_FRAMES)
    require(bool(ok.all()), "an ask_b16 row is not ok")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            "ask_b16: demodulate_fast differs from demodulate_spec with every row ok")
    counts = res.count.cpu().numpy()
    require(bool((counts == ASK_FRAMES).all()),
            f"ask_b16 count gate failed: {sorted(set(counts.tolist()))}")
    bits, valid = res.bits.cpu().numpy(), res.valid.cpu().numpy()
    for r in range(b):
        require(np.array_equal(bits[r][valid[r]], frames[:, 8:]),
                f"ask_b16 payload gate failed at row {r}")
    for r in (0, b - 1):
        exact = ask.demodulate(cfg, xa[r], max_frames=ASK_MAX_FRAMES)
        require(all(torch.equal(p[r], q) for p, q in zip(res, exact)),
                f"ask_b16 row {r} differs from the exact scan")
    log(f"phase 2 (ask_b16): payload gate passed ({b} rows x {ASK_FRAMES} frames), every row "
        f"ok, rows 0 and {b - 1} equal the exact scan in all four fields; decisions digest "
        f"{digest(res)}")
    return launches


def check_ask_fallback(torch, ask, ask_spec, cfg, dev) -> None:
    """Row 0, 150 back-to-back chirps before three frames, overflows its
    candidate table; row 1, the three frames alone, is clean.  The merged
    batch must equal the exact scan."""
    frames = ask.build_frames(b"fallback", cfg, num_frames=3)
    tail = ask.build_track(cfg, frames, seed=2)
    crowded = np.concatenate([np.tile(ask._chirp_np(cfg), 150), np.zeros(500, np.float32), tail])
    clean = np.pad(tail, (0, len(crowded) - len(tail)))
    small = torch.from_numpy(np.stack([crowded, clean])).to(dev)
    _, small_ok = ask_spec.demodulate_spec(cfg, small, max_frames=ASK_MAX_FRAMES)
    require(small_ok.tolist() == [False, True], f"ask fallback flags {small_ok.tolist()}")
    merged = ask.demodulate_fast(cfg, small, max_frames=ASK_MAX_FRAMES)
    for r in range(2):
        exact = ask.demodulate(cfg, small[r], max_frames=ASK_MAX_FRAMES)
        require(all(torch.equal(p[r], q) for p, q in zip(merged, exact)),
                f"ask fallback row {r} differs from the exact scan")
    require(merged.count.tolist() == [2, 3],
            f"ask fallback frames {merged.count.tolist()}, expected [2, 3]")
    log("phase 3 (ask): fallback row (150 back-to-back chirps, more fire candidates than the "
        f"table holds) re-decoded by the exact scan on the card; merged batch equals it "
        f"({merged.count.tolist()} frames)")


def rows_of(torch, corr, n_rows: int):
    """corr f32[B, N] padded with -3.4e38 to rows of 128 lags."""
    return torch.nn.functional.pad(corr, (0, n_rows * 128 - corr.shape[1]),
                                   value=-3.4e38).reshape(corr.shape[0], n_rows, 128)


def check_rowstats(torch, xn, xcorr_hits, x, pre, tag: str) -> float:
    """xcorr_rowstats against its plain version (row maxima within
    CORR_ATOL, positions equal on rows whose two largest lags differ by
    more) and, exactly, against the row reduction of normalized_xcorr's
    dense corr and, at L <= 128, of xcorr_hits'; returns the max |err|
    against the plain version."""
    from trackmaker_tpu_torch.sync.correlate import pattern_norm, preamble_energy

    require(pattern_norm(pre) == float(np.float32(preamble_energy(pre))),
            f"xcorr_rowstats ({tag}): the two norms of the pattern differ")
    rowmax, rowpos = xn.xcorr_rowstats(x, pre)
    torch.cuda.synchronize()
    rowmax_p, rowpos_p = xn.xcorr_rowstats_plain(x, pre)
    b, n_rows = rowmax.shape
    require(rowmax_p.shape == (b, n_rows) and rowpos.shape == (b, n_rows),
            f"xcorr_rowstats ({tag}) shapes {list(rowmax.shape)} / {list(rowmax_p.shape)}")
    err = (rowmax - rowmax_p).abs().max().item()
    require(err <= CORR_ATOL, f"xcorr_rowstats ({tag}) row maxima differ by {err}")
    top2 = rows_of(torch, xn.normalized_xcorr_dense_plain(x, pre), n_rows).topk(2, -1).values
    clear = top2[..., 0] - top2[..., 1] > CORR_ATOL
    require(torch.equal(rowpos[clear], rowpos_p[clear]),
            f"xcorr_rowstats ({tag}) positions differ on an unambiguous row")
    denses = {"normalized_xcorr": xn.normalized_xcorr_dense(x, pre)}
    if len(pre) <= 128:
        denses["xcorr_hits"] = xcorr_hits(x, pre, float("inf"), emit_corr=True)[0]
    for k_name, dense in denses.items():
        mx, lane = rows_of(torch, dense, n_rows).max(-1)
        pos = (torch.arange(n_rows, device=x.device) * 128 + lane).to(torch.int32)
        require(torch.equal(rowmax, mx) and torch.equal(rowpos, pos),
                f"xcorr_rowstats ({tag}) differs from the row reduction of {k_name}' corr")
    log(f"phase 1: xcorr_rowstats == plain at L={len(pre)} on {b} x {x.shape[1]} (row max "
        f"|err| {err:.3g}, positions equal on {int(clear.sum())} of {clear.numel()} unambiguous "
        f"rows) and == the row reduction of {' and '.join(denses)}' dense corr, bit for bit")
    return err


def check_dense(torch, xn, xcorr_hits, xa, chirp, xe, pre) -> float:
    """normalized_xcorr_dense against its plain version at L=440 on the
    ask_b16 captures and, exactly, against xcorr_hits' dense corr at L=96;
    returns the max |err| against the plain version."""
    got = xn.normalized_xcorr_dense(xa, chirp)
    torch.cuda.synchronize()
    want = xn.normalized_xcorr_dense_plain(xa, chirp)
    require(got.shape == want.shape, f"normalized_xcorr shape {list(got.shape)}")
    err = (got - want).abs().max().item()
    require(err <= CORR_ATOL, f"normalized_xcorr at L={len(chirp)} differs by {err}")
    corr, _ = xcorr_hits(xe, pre, float("inf"), emit_corr=True)
    require(torch.equal(xn.normalized_xcorr_dense(xe, pre), corr),
            f"normalized_xcorr at L={len(pre)} differs from xcorr_hits' dense corr")
    log(f"phase 1: normalized_xcorr == plain at L={len(chirp)} on {xa.shape[0]} x {xa.shape[1]} "
        f"(max |err| {err:.3g}, peak corr {got.max().item():.4f}) and == xcorr_hits' dense corr "
        f"at L={len(pre)} on {xe.shape[0]} x {xe.shape[1]}, bit for bit")
    return err


def check_equalizer_noise(torch, equalizer, cfg, dev, seed: int) -> None:
    """A noise-only batch passes the equalizer bit for bit, untrained."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((4, 40_000), generator=gen, device=dev) * 0.1
    out, info = equalizer.equalize_capture(cfg, noise)
    require(not bool(info["applied"].any()), "the equalizer trained on noise")
    require(torch.equal(out, noise), "a noise-only capture came back changed")
    log("phase 3 (equalizer): a noise-only batch of 4 passes unchanged (quality "
        f"{info['quality'].max().item():.3f} < 0.5, output bit-identical)")


def planted_capture(torch, cfg, frames, starts, t: int, seed: int, dev):
    """`frames` at `starts` in t samples of noise (sigma NOISE, a seeded
    numpy generator), as bench.py builds its long capture, on `dev`."""
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    enc = PhyEncoder(cfg, device=dev)
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, NOISE, t).astype(np.float32)).to(dev)
    for s, f in zip(starts, frames):
        w = enc.encode_frame(f)
        x[s:s + w.shape[0]] += w
    return x


def blocked_input(torch, cfg, seed: int, dev):
    """bench.py's blocked_600s input: 48 frames of bytes([i]) * 64 at
    (i + 1) * (t // 49) in 600 s; returns (frames, starts, capture f32[t])."""
    from trackmaker_tpu_torch.core.framing import Frame

    t = BLOCKED_SECONDS * cfg.sample_rate
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * BLOCKED_PAYLOAD) for i in range(BLOCKED_FRAMES)]
    starts = [(i + 1) * (t // (BLOCKED_FRAMES + 1)) for i in range(BLOCKED_FRAMES)]
    return frames, starts, planted_capture(torch, cfg, frames, starts, t, seed, dev)


def seam_input(torch, stream, cfg, seed: int, dev):
    """The 4B5B seam capture: 60 s in 8 blocks, a frame starting 1,000
    samples before each seam and one in the middle of each block."""
    from trackmaker_tpu_torch.core.framing import Frame

    t = SEAM_SECONDS * cfg.sample_rate
    block = stream.spec_block(t, SEAM_BLOCKS)
    starts = sorted([k * block - 1000 for k in range(1, SEAM_BLOCKS)]
                    + [k * block + block // 2 for k in range(SEAM_BLOCKS)])
    frames = [Frame.new_data(i, 1, 2, bytes([100 + i]) * BLOCKED_PAYLOAD)
              for i in range(len(starts))]
    return frames, starts, planted_capture(torch, cfg, frames, starts, t, seed, dev)


def flat_input(torch, stream, x, n_blocks: int):
    """(flat capture f32[1, n_blocks * block], block, vlens int32[n_blocks]),
    as decode_blocked_spec pads a capture."""
    t = x.shape[0]
    block = stream.spec_block(t, n_blocks)
    xf = torch.nn.functional.pad(x, (0, n_blocks * block - t))[None].contiguous()
    return xf, block, torch.full((n_blocks,), t, dtype=torch.int32, device=x.device)


def shared_attempts(sd, cfg):
    """(legacy, fold, legacy plain, fold plain) attempt wrappers of cfg's
    line code."""
    if cfg.line_coding == "manchester":
        return (sd.attempt_manchester, sd.attempt_manchester_fold, sd.attempt_manchester_plain,
                sd.attempt_manchester_fold_plain)
    return sd.attempt_4b5b, sd.attempt_4b5b_fold, sd.attempt_4b5b_plain, sd.attempt_4b5b_fold_plain


def check_shared(torch, sd, xh, stream, cfg, x, n_blocks: int, tag: str,
                 need_past_2_24: bool) -> tuple[dict, dict]:
    """Phase 1 for the shared-capture attempts on one long capture: the
    legacy and fold forms against their plain versions, the fold's frame
    starts against the legacy form's; some live candidate must read past
    its block's end (a kernel reading one block's samples fails there)
    and, where asked, lie past 2^24.  Returns the max |err| per kernel and
    the inputs phase 4 times them on."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    xf, block, vlens = flat_input(torch, stream, x, n_blocks)
    rows = xh.xcorr_hits(xf, pre, thr)[1][0].reshape(n_blocks, block // 128, -1)
    rows_r = xh.xcorr_hits_refine(xf, vlens[:1], pre, sync, thr, **refine_kw(cfg))
    rows_r = rows_r[0].reshape(n_blocks, block // 128, -1)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, N_CAND)
    cand_r, _, n_valid_r, _, fs_r = sd.compact_hit_rows(rows_r, N_CAND, with_fs=True)
    require(torch.equal(cand_r, cand) and torch.equal(n_valid_r, n_valid),
            f"the fold's candidate tables ({tag}) differ from the legacy ones")
    legacy, fold, legacy_plain, fold_plain = shared_attempts(sd, cfg)
    xe = xf.expand(n_blocks, -1)    # every block reads the one capture: row stride 0
    calls = {f"{legacy.__name__}_shared": (legacy, legacy_plain,
                                           (xe, cand, n_valid, vlens, sync, preamble_energy(sync))),
             f"{fold.__name__}_shared": (fold, fold_plain, (xe, fs_r, n_valid))}
    errs, outs = {}, {}
    for k_name, (kernel, plain, args) in calls.items():
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"{k_name} ({tag}) differs from its plain version")
        errs[k_name] = max((g.long() - w.long()).abs().max().item() for g, w in zip(got, want))
        outs[k_name] = got
    for g, w in zip(*outs.values()):
        require(torch.equal(g, w), f"the shared fold attempt ({tag}) differs from the legacy one")
    live = sd._live(cand, n_valid)
    fs = outs[f"{legacy.__name__}_shared"][1]
    body = (sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES if cfg.line_coding == "manchester"
            else sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES)
    block_end = (torch.arange(n_blocks, device=x.device)[:, None] + 1) * block
    crossing = int((live & (fs + body > block_end)).sum())
    past = int((live & (cand >= 2**24)).sum())
    require(crossing > 0, f"no live candidate of {tag} reads past its block's end")
    require(past > 0 or not need_past_2_24, f"no live candidate of {tag} lies past 2^24")
    log(f"phase 1: {' and '.join(calls)} == plain on {tag} ({x.shape[0]} samples, {n_blocks} "
        f"blocks of {block}): {int(live.sum())} live candidates, {crossing} reading past their "
        f"block's end, {past} past 2^24; the fold's frame starts and bytes == the legacy form's")
    return errs, dict(calls=calls, live=int(live.sum()), xf=xf, block=block, vlens=vlens)


def frame_set(res):
    """The valid frames of a flat result as sorted (start, sequence, bytes)."""
    return sorted((s, q, b) for b, _, _, q, _, _, s in frame_list(res))


def run_blocked_path(torch, sd, stream, cfg, x, frames, starts, n_blocks: int, counters,
                     tag: str, cross_check: bool):
    """One main-path run of decode_blocked_single_chip with its gates: every
    frame once, at its start, with its payload; the speculative route ok
    and equal to the returned frames; each kernel in `counters` (name,
    wrapper, counter attribute, expected launches or None for one per
    fixpoint turn) launched as expected.  With `cross_check`, the plain
    walk's fixpoint on the same candidate tables must take as many turns,
    and more than one.  Returns (the launches, the frames)."""
    for _, fn, attr, _ in counters:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stream.decode_blocked_single_chip(cfg, x, LOCAL_ADDR, n_blocks, BLOCKED_MFPB, N_CAND)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(fn, attr) for name, fn, attr, _ in counters}
    log(f"phase 2 ({tag}): decode_blocked_single_chip took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    spec_res, ok, turns = stream.decode_blocked_spec(cfg, x, LOCAL_ADDR, n_blocks, BLOCKED_MFPB,
                                                     N_CAND)
    require(bool(ok), f"the {tag} speculative route is not ok")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            f"{tag}: decode_blocked_single_chip differs from its speculative route")
    expect = {name: turns if n is None else n for name, _, _, n in counters}
    require(launches == expect, f"{tag} launches {launches}, expected {expect}")
    if cross_check:
        xf, block, vlens = flat_input(torch, stream, x, n_blocks)
        a = sd.spec_phase_a(cfg, xf[0], LOCAL_ADDR, N_CAND, vlens, flat_blocks=(n_blocks, block))
        block_starts = torch.arange(n_blocks, dtype=torch.int32, device=x.device) * block
        _, plain_turns = stream.seam_fixpoint(sd.spec_walk_plain, a.fields, block_starts,
                                              block_starts + block, BLOCKED_MFPB)
        require(plain_turns == turns > 1, f"{tag}: the fixpoint took {turns} turn(s), the "
                f"plain walk's {plain_turns}; more than one expected")
    got = frame_set(res)
    want = sorted((s, f.sequence, f.to_bytes()) for s, f in zip(starts, frames))
    require([q for _, q, _ in got] == [q for _, q, _ in want] and got == want,
            f"{tag} payload gate failed: {len(got)} of {len(frames)} frames, sequences "
            f"{[q for _, q, _ in got]}")
    log(f"phase 2 ({tag}): payload gate passed ({len(frames)} frames, starts up to "
        f"{max(starts)}, each exact), ok, {turns} fixpoint turn(s), one walk each")
    return launches, res


def check_blocked_fallback(torch, stream, decode_capture, cfg, x, starts) -> None:
    """The 4B5B seam capture with a level zeroed inside the frame across
    seam 1 (a near-zero level the attempt kernel reads otherwise than the
    receiver): the speculative route is not ok, decode_blocked_single_chip
    returns the exact route's frames, and they equal the sequential exact
    scan's."""
    seam = stream.spec_block(x.shape[0], SEAM_BLOCKS)
    require(seam - 1000 in starts, "no frame across seam 1 of the seam capture")
    zeroed = x.clone()
    level0 = seam - 1000 + cfg.preamble_len + 20 * 15 + 3
    zeroed[level0:level0 + 3] = 0.0
    _, ok, _ = stream.decode_blocked_spec(cfg, zeroed, LOCAL_ADDR, SEAM_BLOCKS, BLOCKED_MFPB, N_CAND)
    require(not bool(ok), "the zeroed level did not make the speculative route not ok")
    got = stream.decode_blocked_single_chip(cfg, zeroed, LOCAL_ADDR, SEAM_BLOCKS, BLOCKED_MFPB,
                                            N_CAND)
    exact = stream.decode_blocked_exact(cfg, zeroed, LOCAL_ADDR, SEAM_BLOCKS, BLOCKED_MFPB)
    require(all(torch.equal(p, q) for p, q in zip(got, exact)),
            "decode_blocked_single_chip did not return the exact route's frames")
    seq = decode_capture(cfg, zeroed, LOCAL_ADDR, max_frames=len(starts) + 8)
    require(frame_set(got) == frame_set(seq), "the exact blocked route differs from the exact scan")
    log(f"phase 3 (blocked 4b5b): a zeroed level across seam 1 makes the speculative route not "
        f"ok; decode_blocked_single_chip returned the exact route's {len(frame_set(got))} frames "
        f"(of {len(starts)} planted), equal to the sequential exact scan's")


def shared_bound(sd, cfg, k_name: str, info: dict) -> tuple[float, str]:
    """The least time of a shared-capture attempt: the samples its live
    candidates need (at most the whole capture) and its small inputs read,
    its outputs written; the refine taps (legacy forms) and the decode's
    operations of each live candidate."""
    slots = info["vlens"].numel() * N_CAND
    fold = "_fold" in k_name
    if cfg.line_coding == "manchester":
        body, out_per_slot = sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES, sd.FRAME_BYTES + 4
        refine, decode_ops = (13 + 47, 13 * 48 * 4), sd.FRAME_BYTES * 8 * 6
    else:
        body, out_per_slot = sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES, sd.FRAME_BYTES + 12
        refine, decode_ops = (31 + 29, 31 * 30 * 4), sd.ZERO_SYMBOLS * 5 * 4
    window = body + (0 if fold else refine[0])
    reads = min(info["xf"].numel(), info["live"] * window) * 4
    small = slots * 4 + info["vlens"].numel() * 4 * (1 if fold else 2)
    return bound(reads + small + slots * out_per_slot,
                 info["live"] * (decode_ops + (0 if fold else refine[1])))


def check_tools(torch, hp, exs, pf, sd, xh, xn, cfg, x, vlens, corr_p, tool) -> dict:
    """Phase 1 for the tools' kernels: the probe against its plain version
    (exact); the two-stream rows against their plain version and, bit for
    bit, against kernel #1's rows, and the noep form against its plain
    version and, bit for bit, against the truncation of kernel #1's dense
    corr, on the flagship captures and on the tool's noise corpus; the
    attempt-only stage, fold off and on, against the plain attempts on its
    compacted candidates.  Returns the max |err| per kernel."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    xk = torch.from_numpy(np.random.default_rng(5).normal(0, 100, (8, 128)).astype(np.float32))
    xk = xk.to(x.device)
    got = hp.seq_probe(xk)
    torch.cuda.synchronize()
    want = hp.seq_probe_plain(xk)
    require(torch.equal(got, want), "seq_probe differs from its plain version")
    errs = {"seq_probe": (got - want).abs().max().item(), "xcorr_hits_2s": 0.0}
    log("phase 1: seq_probe == plain (128 blocks x 64 threads, 128 float4 stores of x + c into "
        "shared memory a thread, then x + 127 written once)")
    pre = preamble_waveform(cfg)
    xt, pat_t = tool
    for tag, xx, pattern, thr, cp in (
            ("flagship", x, pre, cfg.correlation_threshold, corr_p),
            ("the tool's noise", xt, pat_t, exs.THR, xn.normalized_xcorr_dense_plain(xt, pat_t))):
        rows = exs.xcorr_hits_2s(xx, pattern, thr)
        torch.cuda.synchronize()
        require(torch.equal(rows, xh.xcorr_hits(xx, pattern, thr)[1]),
                f"xcorr_hits_2s ({tag}) rows differ from kernel #1's")
        val_err, n_near, n_diff = compare_rows(torch, rows, exs.xcorr_hits_2s_plain(
            xx, pattern, thr), cp, thr, f"xcorr_hits_2s ({tag})")
        errs["xcorr_hits_2s"] = max(errs["xcorr_hits_2s"], val_err)
        noep = exs.xcorr_hits_2s(xx, pattern, thr, epilogue=False)
        torch.cuda.synchronize()
        edge = exs.noep_plain(((cp.abs() - 1.0).abs() < CORR_ATOL).float(), rows.shape[1]) > 0
        require(bool(((noep == exs.xcorr_hits_2s_plain(xx, pattern, thr, epilogue=False))
                      | edge).all()), f"xcorr_hits_2s noep ({tag}) differs from its plain version")
        dense, _ = xh.xcorr_hits(xx, pattern, thr, emit_corr=True)
        require(torch.equal(noep, exs.noep_plain(dense, rows.shape[1])),
                f"xcorr_hits_2s noep ({tag}) differs from the truncation of kernel #1's corr")
        log(f"phase 1: xcorr_hits_2s == kernel #1's rows bit for bit and == plain on {tag} "
            f"({xx.shape[0]} x {xx.shape[1]}, L={len(pattern)}, threshold {thr}: "
            f"{int(rows[..., 4].sum())} hits, hit corr {val_err:.3g}, {n_near} lags near the "
            f"threshold, {n_diff} rows differing there); noep == plain and == int(kernel #1's "
            f"corr) bit for bit ({int((noep != 0).sum())} nonzero lanes)")
    # exact +-1 copies of the preamble's first 64 samples in silence
    # correlate to +-1 (integer sums, and sqrt(64) is exact in f32, so the
    # division gives exactly +-1): the noep form's nonzero lanes
    pre64 = pre[:64]
    xe = torch.zeros((2, 40_000), dtype=torch.float32, device=x.device)
    pre_t = torch.from_numpy(pre64).to(x.device)
    copies = [(0, 128 * 3 + 2, 1.0), (0, 128 * 100 + 15, -1.0), (1, 128 * 7, 1.0)]
    for r, lag, sign in copies:
        xe[r, lag:lag + len(pre64)] = sign * pre_t
    noep = exs.xcorr_hits_2s(xe, pre64, cfg.correlation_threshold, epilogue=False)
    torch.cuda.synchronize()
    dense, _ = xh.xcorr_hits(xe, pre64, cfg.correlation_threshold, emit_corr=True)
    require(torch.equal(noep, exs.noep_plain(dense, noep.shape[1])),
            "xcorr_hits_2s noep (exact copies) differs from the truncation of kernel #1's corr")
    require([int(noep[r, lag // 128, lag % 128]) for r, lag, _ in copies]
            == [int(sg) for _, _, sg in copies] and int((noep != 0).sum()) == len(copies),
            "xcorr_hits_2s noep (exact copies): the +-1 lanes are not where the copies are")
    log(f"phase 1: xcorr_hits_2s noep on {len(copies)} exact +-1 copies of the preamble's first "
        "64 samples in silence == "
        "int(kernel #1's corr) bit for bit, +-1 at each copy's lane and 0 elsewhere")
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    legacy = pf.attempt_sum(cfg, x, vlens, False)
    fold = pf.attempt_sum(cfg, x, vlens, True)
    torch.cuda.synchronize()
    cand, _, n_valid, _ = sd.compact_hit_rows(xh.xcorr_hits(x, pre, thr)[1], N_CAND)
    _, _, _, _, fs = sd.compact_hit_rows(xh.xcorr_hits_refine(x, vlens, pre, sync, thr,
                                                              **refine_kw(cfg)),
                                         N_CAND, with_fs=True)
    for got, want, what in (
            (legacy, sd.attempt_manchester_plain(x, cand, n_valid, vlens, sync,
                                                 preamble_energy(sync)), "fold off"),
            (fold, sd.attempt_manchester_fold_plain(x, fs, n_valid), "fold on"),
            (fold, legacy, "fold on against fold off")):
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"attempt_sum ({what}) differs from the plain attempt")
    errs["attempt_sum"] = 0
    log(f"phase 1: attempt_sum == the plain attempts on its {int(n_valid.sum())} compacted "
        "candidates, fold off and on, and the two equal")
    return errs


def run_profiler_path(torch, pf, exs, cfg, x, frames, vlens, tool, kernels) -> dict[str, int]:
    """The profiler path: every stage of ``prof_fused.stages`` on the
    flagship captures, the full-decode stage through the payload gate; the
    attempt-only stage fold off and on, each call launching one
    correlation entry, one attempt and no walk; the two-stream experiment's
    row check.  Returns the launches of `kernels` (name -> wrapper)."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = {name: fn(x) for name, fn in pf.stages(cfg, x, vlens).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res, ok = outs["full spec decode"]
    require(bool(ok.all()), "a row of the profiler's full-decode stage is not ok")
    counts = res.count.cpu().numpy()
    require(bool((counts == N_FRAMES).all()),
            f"the profiler's full-decode count gate failed: {sorted(set(counts.tolist()))}")
    fb, valid = res.frame_bytes.cpu().numpy(), res.valid.cpu().numpy()
    for r in range(x.shape[0]):
        for k, f in zip(np.nonzero(valid[r])[0], frames):
            require(fb[r, k, 7:7 + PAYLOAD].tobytes() == f.data,
                    f"the profiler's full-decode payload gate failed at row {r} slot {k}")
    for fold in (False, True):
        before = {n: k.launches for n, k in kernels.items()}
        pf.attempt_sum(cfg, x, vlens, fold)
        torch.cuda.synchronize()
        delta = {n: k.launches - before[n] for n, k in kernels.items() if n != "xcorr_hits_2s"}
        expect = {"xcorr_hits": int(not fold), "xcorr_hits_refine": int(fold),
                  "attempt_manchester": int(not fold), "attempt_manchester_fold": int(fold),
                  "spec_walk": 0}
        require(delta == expect, f"attempt_sum (fold {fold}) launched {delta}, expected {expect}")
    exs.check_streams(*tool, exs.THR)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    for k_name, n in launches.items():
        require(n > 0, f"the profiler path never launched {k_name}")
    log(f"phase 2 (profiler): {len(outs)} stages of prof_fused.stages took {wall * 1e3:.1f} ms "
        f"(first calls); full-decode payload gate passed ({x.shape[0]} rows x {N_FRAMES} frames), "
        "every row ok; attempt_sum fold off and on each launched one correlation entry, one "
        f"attempt and no walk; exp_xcorr_streams' 2stream rows == current; launches {launches}")
    return launches


def empty_kernel(torch, dev):
    """An empty kernel's launcher, (blocks, threads) -> None, built from
    ``tools/exp_walk_attempt.py``'s source: the floor a tiny kernel's device
    time is read against."""
    import ctypes

    from trackmaker_tpu_torch import _build
    from trackmaker_tpu_torch.tools.exp_walk_attempt import EMPTY_SOURCE, build_source

    fn = ctypes.CDLL(str(build_source("empty", EMPTY_SOURCE))).tm_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lambda blocks, threads: _build.check(fn(blocks, threads, stream), "empty")


def tiles_bound(et, variant: str, inputs, bf16_rate: bool = True) -> tuple[float, str]:
    """(least ms, what sets it) of one attempt-tile call on `inputs`: the
    output written once (zero-filled), the rows of x each candidate reads,
    the table rows this run's candidates read (sync slices from q, body
    slices from the sync's best), each once, and w; every multiply-add of
    the sync, the body and the pack, the body's at the bf16 tensor-core
    rate for bf16b (with `bf16_rate`; else at the f32 rate, the function
    as the port defines it: its sums stay on the FP32 pipes) and all
    others at the f32 rate."""
    spec = et.parse_variant(variant)
    x, ts, tsc, tb, tbn, w, wn = inputs
    b, n = x.shape[0], spec.n_cand
    out_bytes = b * et.NV * et.BROWS * et.LANES * 4
    if spec.kind == "noop":          # x01[0, 0:8] of the 8 slabs, an add each
        return bound(b * 8 * 8 * 4 + out_bytes, b * n * 8)
    best = et.sync_plain(spec, x, ts, tsc)[3].cpu().numpy()
    c = np.arange(n)
    q = 37 * c % et.DROW
    o2 = (53 * c + best) % et.DROW                     # [b, n]
    rows = {}                                          # table -> rows read, as v * 768 + row
    for table, starts in ((tsc if spec.merged else ts, q), (tbn if spec.n128 else tb, o2)):
        key = (table.data_ptr(), table.shape[-1])
        first = (starts % 8) * et.TROWS + starts - starts % 8
        rows.setdefault(key, set()).update(np.unique(first.reshape(-1)[:, None]
                                                     + np.arange(et.DROW)).tolist())
    table_bytes = sum(len(r) * width * 4 for (_, width), r in rows.items())
    half, bits = (64, 64) if spec.n128 else (128, 128)
    body = 2 * et.BROWS * half * et.DROW * 2 * b * n                 # flops
    rest = (et.BROWS * et.LANES * bits + et.SYNC_LANES * 4 * et.DROW) * 2 * b * n
    x_bytes = b * (9 * 7 + et.SLAB_ROWS) * et.DROW * 4
    by_bytes = (out_bytes + x_bytes + table_bytes + (wn if spec.n128 else w).numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    by_ops = (body / (BF16_OPS_PER_S if spec.kind == "bf16b" and bf16_rate else F32_OPS_PER_S)
              + rest / F32_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def probe_bound() -> tuple[float, str]:
    """(least ms, what sets it) of the window probe: x f32[8, 128] read
    once, the f32[256, 128] output written once, 128 adds an element.
    Whatever implements it; the stores it stages on chip are not counted."""
    return bound(8 * 128 * 4 + 256 * 128 * 4, 128 * 256 * 128)


def offset_bound(form: str) -> tuple[float, str]:
    """(least ms, what sets it) of one offset-add form: the rows of x and
    the columns of t it reads, the output, and its multiply-adds."""
    x_rows, t_cols, sums = {"A": (33, 256, 32 * 128 * 768), "B": (2, 256, 128 * 768),
                            "C": (33, 128, 32 * 128 * 384)}[form]
    return bound((x_rows * 384 + 384 * t_cols + 32 * 128) * 4, 2 * sums)


def check_threshold_tie(torch, xh, decode_capture_fast, decode_capture, cfg4, pre4, dev) -> None:
    """The 4B5B preamble's first n samples before a frame, on the card: lag
    0 correlates to 54/60 = 0.9 in exact arithmetic and, dividing as the
    reference does, to 0.8999999 in f32.  Kernel #1's corr at lag 0 must
    equal the plain version's bit for bit, below the threshold, and the
    fast decode and the exact scan must find the frame at n."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    wave = PhyEncoder(cfg4, device=dev).encode_frames([Frame.new_data(5, 1, 2, b"hello")],
                                                      gap_samples=0)
    thr = cfg4.correlation_threshold
    for n in (39, 48, 57):
        x = torch.cat([torch.from_numpy(pre4[:n]).to(dev), wave])[None].contiguous()
        corr, _ = xh.xcorr_hits(x, pre4, thr, emit_corr=True)
        torch.cuda.synchronize()
        corr_p, _ = xh.xcorr_hits_plain(x, pre4, thr, emit_corr=True)
        c0, p0 = corr[0, 0].item(), corr_p[0, 0].item()
        require(c0 == p0 and c0 < thr and abs(c0 - thr) < 1e-6,
                f"threshold tie (n={n}): corr at lag 0 {c0!r}, plain {p0!r}")
        for res in (decode_capture_fast(cfg4, x, LOCAL_ADDR, max_frames=4),
                    decode_capture(cfg4, x[0], LOCAL_ADDR, 4)):
            valid = res.valid.reshape(-1)
            require(int(valid.sum()) == 1 and int(res.start.reshape(-1)[valid].item()) == n,
                    f"threshold tie (n={n}): the frame at {n} was not found alone")
    log(f"phase 1: threshold tie (4B5B preamble's first 39/48/57 samples before a frame): "
        f"kernel #1's corr at lag 0 == plain bit for bit ({c0!r} < {thr}), decode_capture_fast "
        "and the exact scan find the frame at its start")


TILE_CHECKS = ("noop", "base", "n128", "sync1", "both", "bf16b", "base_nodma", "base_nostore",
               "base_u5")


def check_experiments(torch, et, eo, dev) -> tuple[dict, dict]:
    """Phase 1 for the two experiments' kernels: every attempt-tile variant,
    and base's _nodma, _nostore and _u5, against the plain version on the
    tool's corpus and on an integer-valued copy (x of integers -2..2), bit
    for bit both (the products are exact and both sum in k order), at
    rings of 1 to 4 stages; a ring that does not fit refused; the three
    offset-add forms against their plain versions and the NumPy oracles,
    bit for bit.  Returns (max |err| per kernel, the inputs phase 4 times
    them on)."""
    errs = {"attempt_tiles": 0.0, "offset_add": 0.0}
    corpora = {"normal": et.tool_input(dev), "integer": et.tool_input(dev, integer=True)}
    for tag, inputs in corpora.items():
        for variant in TILE_CHECKS:
            want = et.attempt_tiles_plain(variant, *inputs)
            for pipe in range(1, et.PIPE + 1):
                got = et.attempt_tiles(variant, *inputs, pipe=pipe)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                errs["attempt_tiles"] = max(errs["attempt_tiles"], (got - want).abs().max().item())
                require(n_diff == 0, f"attempt_tiles {variant} ({tag} corpus, ring {pipe}): "
                        f"{n_diff} values differ from the plain version")
                require(bool(torch.isfinite(got).all()), f"attempt_tiles {variant}: not finite")
        log(f"phase 1: attempt_tiles == plain bit for bit on the tool's {tag} corpus "
            f"({inputs[0].shape[0]} x {et.NV} candidates) for {', '.join(TILE_CHECKS)}, each at "
            f"rings of 1 to {et.PIPE} stages")
    launches = et.attempt_tiles.launches
    try:
        et.attempt_tiles("base", *corpora["normal"], pipe=5)
        refused = False
    except ValueError:
        refused = True
    require(refused and et.attempt_tiles.launches == launches,
            "attempt_tiles took a ring of 5 stages, which does not fit a block")
    log(f"phase 1: attempt_tiles refuses a ring of 5 stages ({5 * et.STAGE_BYTES} B), runs 4 "
        f"({et.stage_smem(et.parse_variant('base'), 4)} B of the {et.SMEM_PER_BLOCK} each of "
        f"{et.BLOCKS_PER_SM} blocks an SM may use)")
    x, t = eo.tool_input(dev)
    for form in eo.FORMS:
        got = eo.offset_add(form, x, t)
        torch.cuda.synchronize()
        require(torch.equal(got, eo.offset_add_plain(form, x, t)),
                f"offset_add {form} differs from its plain version")
        max_abs, max_rel = eo.errors(form, got, x, t)
        errs["offset_add"] = max(errs["offset_add"], max_abs)
        require(max_abs == 0.0, f"offset_add {form} differs from its oracle by {max_abs}")
    log(f"phase 1: offset_add A, B, C == plain and == the NumPy oracles bit for bit "
        f"(lane shift {eo.lane_shift(x)} from a sum of {int(x[0, :8].sum())})")
    return errs, {"tiles": corpora["normal"], "offset": (x, t)}


def check_tiles_streams_edges(torch, et, exs, xh, dev) -> None:
    """The attempt tiles and the two-stream rows on the edge inputs of
    tests/test_torch_tiles_streams_design.py: the tiles' edge variants
    (_u1, _u2, _u5, _u13, _u65, _nostore, noop, _nodma and the other kinds)
    at rings of 1 to 4 on two captures of the normal corpus, bit for bit;
    the streams at L in 2..129 and T in 129..50,001 around the tile of
    1,024 lags, the second stream's 128 samples and the 8 zero-filled past
    them, with a hit at the last lag: the rows and the noep form equal
    kernel #1's bit for bit (L <= 128) and the plain version's away from
    the threshold and from |corr| = 1."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_tiles_streams_design as edges

    inputs = edges.tile_edge_input(dev)
    for variant in edges.TILE_EDGE_VARIANTS:
        want = et.attempt_tiles_plain(variant, *inputs)
        for pipe in edges.TILE_RINGS:
            got = et.attempt_tiles(variant, *inputs, pipe=pipe)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"attempt_tiles {variant} differs on the edge input "
                                            f"at ring {pipe}")
    n_hits = 0
    for l in edges.STREAM_LS:
        for t in edges.STREAM_TS:
            x, pattern = edges.stream_edge_input(l, t, dev)
            rows = exs.xcorr_hits_2s(x, pattern, edges.STREAM_THR)
            noep = exs.xcorr_hits_2s(x, pattern, edges.STREAM_THR, epilogue=False)
            torch.cuda.synchronize()
            if l <= 128:
                corr, rows_1 = xh.xcorr_hits(x, pattern, edges.STREAM_THR, emit_corr=True)
                require(torch.equal(rows, rows_1) and torch.equal(
                    noep, exs.noep_plain(corr, noep.shape[1])),
                    f"xcorr_hits_2s differs from kernel #1 at L={l}, T={t}")
            corr_p = exs.normalized_xcorr_dense_plain(x, pattern)
            try:
                edges.assert_rows_agree(rows.cpu(), exs.xcorr_hits_2s_plain(
                    x, pattern, edges.STREAM_THR).cpu(), corr_p.cpu(), edges.STREAM_THR)
            except AssertionError as exc:
                raise AssertionError(f"xcorr_hits_2s differs from plain at L={l}, T={t}") from exc
            edge = exs.noep_plain(((corr_p.abs() - 1.0).abs() < CORR_ATOL).float(),
                                  noep.shape[1]) > 0
            require(bool(((noep == exs.xcorr_hits_2s_plain(x, pattern, edges.STREAM_THR, False))
                          | edge).all()), f"xcorr_hits_2s noep differs from plain at L={l}, T={t}")
            require(int(rows[0, (t - l) // 128, 4]) >= 1, f"no hit at the last lag, L={l} T={t}")
            n_hits += int(rows[..., 4].sum())
    log(f"phase 1: attempt_tiles == plain bit for bit on the edge input (2 captures) for "
        f"{', '.join(edges.TILE_EDGE_VARIANTS)} at rings {list(edges.TILE_RINGS)}; xcorr_hits_2s "
        f"== kernel #1's rows and noep bit for bit (L <= 128) and == plain at L in "
        f"{list(edges.STREAM_LS)}, T in {list(edges.STREAM_TS)} ({n_hits} hits, one at each "
        "last lag)")


def check_probe_offset_edges(torch, hp, eo, dev) -> None:
    """The window probe and the offset add on the edge inputs of
    tests/test_torch_probe_offset_design.py: the probe where x + c rounds
    (near 2^24, ties at 3 * 2^23, inf, NaN, -0.0), bit for bit as its plain
    version (NaN as NaN); the offset add's forms on N(0, 1) inputs, C also
    at the lane shifts 0, 63 and 59, within 2 * 768 * 2^-24 * sum |x_j t_jk|
    of a float64 product and epilogue."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_probe_offset_design as edges

    for kind in edges.PROBE_EDGES:
        x = edges.probe_edge_input(kind, dev)
        got = hp.seq_probe(x)
        torch.cuda.synchronize()
        try:
            edges.assert_probe_equal(got.cpu().numpy(), hp.seq_probe_plain(x).cpu().numpy())
        except AssertionError as exc:
            raise AssertionError(f"seq_probe differs from plain on the {kind} input") from exc
    worst = 0.0
    for form, head in [(form, None) for form in eo.FORMS] + [
            ("C", h) for h, _ in edges.SHIFT_HEADS.values()]:
        x, t = edges.offset_random_input(7, head, dev)
        got = eo.offset_add(form, x, t)
        torch.cuda.synchronize()
        err = np.abs(got.cpu().numpy().astype(np.float64) - edges.reference64(form, x, t))
        bnd = edges.error_bound(form, x, t)
        require(bool(np.all(err <= bnd)), f"offset_add {form} (head {head}) is off the float64 "
                f"product by {err.max()}, past its bound")
        worst = max(worst, float((err / bnd).max()))
    log(f"phase 1: seq_probe == plain bit for bit on {', '.join(edges.PROBE_EDGES)} (NaN as "
        f"NaN); offset_add A, B, C on N(0, 1) inputs (C also at lane shifts 0, 63, 59) within "
        f"2 * 768 * 2^-24 * sum |x t| of float64, at most {worst:.4f} of it")


def run_experiments(torch, et, eo) -> dict[str, int]:
    """Phase 2 for the experiments: both tools' main(), the attempt tiles'
    over its default variants (5 calls a repeat), with the launch counts
    set to 0 just before and read just after."""
    et.attempt_tiles.launches = eo.offset_add.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    et.main(["5"])
    eo.main([])
    torch.cuda.synchronize()
    launches = {"attempt_tiles": et.attempt_tiles.launches, "offset_add": eo.offset_add.launches}
    require(launches == {"attempt_tiles": len(et.VARIANTS) * (1 + 3 * 5), "offset_add": 3},
            f"the experiments' main() launched {launches}")
    log(f"phase 2 (experiments): exp_attempt_tiles.main and exp_offset_add.main took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches {launches}")
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from trackmaker_tpu_torch import PhyConfig, _build
    except ImportError as exc:
        raise SystemExit(f"chip_smoke.py must run from a checkout of the repository: {exc}")
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.dsp import equalizer
    from trackmaker_tpu_torch.parallel import stream
    from trackmaker_tpu_torch.phy import ask, ask_spec
    from trackmaker_tpu_torch.phy import spec_decode as sd
    from trackmaker_tpu_torch.phy.decoder import (
        decode_capture, decode_capture_fast, decode_captures)
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync import auto_xcorr
    from trackmaker_tpu_torch.sync import sliding_dot as sdot
    from trackmaker_tpu_torch.sync import xcorr_norm as xn
    from trackmaker_tpu_torch.sync.correlate import preamble_energy
    from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits, xcorr_hits_plain
    from trackmaker_tpu_torch.tools import exp_attempt_tiles as et
    from trackmaker_tpu_torch.tools import exp_fire_chain as efc
    from trackmaker_tpu_torch.tools import exp_offset_add as eo
    from trackmaker_tpu_torch.tools import exp_probe_offset as epo
    from trackmaker_tpu_torch.tools import exp_xcorr_streams as exs
    from trackmaker_tpu_torch.tools import health as hp
    from trackmaker_tpu_torch.tools import prof_fused as pf
    xh = importlib.import_module("trackmaker_tpu_torch.sync.xcorr_hits")   # the module

    # --- phase 0: setup ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = hp.card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for path in _build.build_all():
        log(f"built {path.name}")
    empty = empty_kernel(torch, dev)     # built here: no compiler runs once profiling starts
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s; {toolchain(torch, _build)}")
    hp.seq_probe.launches = 0
    torch.cuda.synchronize()
    snap = hp.health(dev)
    torch.cuda.synchronize()
    probe_launches = hp.seq_probe.launches
    require(probe_launches == 1 + hp.LAUNCHES * hp.REPEATS,
            f"the health probe launched seq_probe {probe_launches} times")
    require(all(np.isfinite(snap[k]) and snap[k] > 0
                for k in ("rtt_ms", "noop_kernel_us", "stream_gbps")), f"health gave {snap}")
    log(f"phase 0: health: rtt_ms {snap['rtt_ms']:.4f}, noop_kernel_us "
        f"{snap['noop_kernel_us']:.4f}, stream_gbps {snap['stream_gbps']:.1f} "
        f"({probe_launches} seq_probe launches) [{card}]")

    cfg = PhyConfig()
    cfg4 = PhyConfig(line_coding="4b5b")
    frames, x = captures(torch, cfg, args.seed, dev)
    frames4, x4 = captures(torch, cfg4, args.seed + 1, dev)
    frames_e, xe = eq_captures(torch, cfg, args.seed + 2, dev)
    b, t = x.shape
    t4 = x4.shape[1]
    acfg = ask.AskConfig()
    frames_a, xa = ask_captures(torch, ask, acfg, dev)
    frames_b, starts_b, xb = blocked_input(torch, cfg, args.seed + 3, dev)
    frames_s, starts_s, xs = seam_input(torch, stream, cfg4, args.seed + 4, dev)
    log(f"flagship input: {b} x {t} samples; fourb5b_b32 input: {b} x {t4} samples; "
        f"equalized_b32 input: {b} x {xe.shape[1]} samples; {N_FRAMES} frames per capture; "
        f"ask_b16 input: {xa.shape[0]} x {xa.shape[1]} samples, {ASK_FRAMES} frames per capture; "
        f"blocked_600s input: {xb.shape[0]} samples, {len(frames_b)} frames; 4B5B seam input: "
        f"{xs.shape[0]} samples, {len(frames_s)} frames")
    pre, pre4 = preamble_waveform(cfg), preamble_waveform(cfg4)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    sync4 = pre4[cfg4.preamble_len - cfg4.sync_len:]
    sync_e, sync_e4 = preamble_energy(sync), preamble_energy(sync4)
    vlens = torch.full((b,), t, dtype=torch.int32, device=dev)
    vlens4 = torch.full((b,), t4, dtype=torch.int32, device=dev)
    errs = {}

    # --- phase 1: kernels against their plain versions -------------------------
    errs["xcorr_hits"], rows_k, corr_p = check_xcorr(
        torch, xcorr_hits, xcorr_hits_plain, x, pre, cfg.correlation_threshold, "flagship")
    err4, rows4, corr_p4 = check_xcorr(
        torch, xcorr_hits, xcorr_hits_plain, x4, pre4, cfg4.correlation_threshold, "4b5b")
    errs["xcorr_hits"] = max(errs["xcorr_hits"], err4)
    rows_b = xh.xcorr_hits_batched(x, pre, cfg.correlation_threshold)
    torch.cuda.synchronize()
    require(torch.equal(rows_b, rows_k), "xcorr_hits_batched differs from xcorr_hits' rows")
    errs["xcorr_hits_batched"], n_near, n_diff = compare_rows(
        torch, rows_b, xh.xcorr_hits_batched_plain(x, pre, cfg.correlation_threshold), corr_p,
        cfg.correlation_threshold, "xcorr_hits_batched")
    log(f"phase 1: xcorr_hits_batched (8 captures a block) == xcorr_hits' rows bit for bit and "
        f"== plain at the flagship shape (hit corr {errs['xcorr_hits_batched']:.3g}, {n_near} "
        f"lags near the threshold, {n_diff} rows differing there)")

    cand, _, n_valid, _ = sd.compact_hit_rows(rows_k, N_CAND)
    bytes_k, fs_k = sd.attempt_manchester(x, cand, n_valid, vlens, sync, sync_e)
    torch.cuda.synchronize()
    bytes_p, fs_p = sd.attempt_manchester_plain(x, cand, n_valid, vlens, sync, sync_e)
    require(torch.equal(bytes_k, bytes_p), "attempt_manchester bytes differ")
    require(torch.equal(fs_k, fs_p), "attempt_manchester fs differ")
    errs["attempt_manchester"] = max(
        (bytes_k.int() - bytes_p.int()).abs().max().item(),
        (fs_k - fs_p).abs().max().item())
    log(f"phase 1: attempt_manchester == plain on {int(n_valid.sum())} candidates "
        f"(n_valid per capture {int(n_valid.min())}..{int(n_valid.max())})")

    cand4, _, n_valid4, _ = sd.compact_hit_rows(rows4, N_CAND)
    got4 = sd.attempt_4b5b(x4, cand4, n_valid4, vlens4, sync4, sync_e4)
    torch.cuda.synchronize()
    want4 = sd.attempt_4b5b_plain(x4, cand4, n_valid4, vlens4, sync4, sync_e4)
    errs["attempt_4b5b"] = 0
    for field, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got4, want4):
        require(torch.equal(g, w), f"attempt_4b5b {field} differs")
        errs["attempt_4b5b"] = max(errs["attempt_4b5b"], (g.int() - w.int()).abs().max().item())
    log(f"phase 1: attempt_4b5b == plain (bytes, fs, first_bad, first_zero) on "
        f"{int(n_valid4.sum())} candidates (n_valid per capture "
        f"{int(n_valid4.min())}..{int(n_valid4.max())}, "
        f"{int(((got4[3] < sd.ZERO_SYMBOLS) & sd._live(cand4, n_valid4)).sum())} "
        "with a near-zero level in their 640 symbols)")
    fold_in = {}
    for tag, c, xx, vl, cp in (("flagship", cfg, x, vlens, corr_p),
                                ("fourb5b_b32", cfg4, x4, vlens4, corr_p4)):
        fold_errs, fold_in[tag] = check_fold(torch, sd, xh, c, xx, vl, c.correlation_threshold,
                                             cp, tag)
        for e in (fold_errs, check_refine_edges(torch, sd, xh, c, xx, cp, tag)):
            for k_name, v in e.items():
                errs[k_name] = max(errs.get(k_name, 0), v)
    fold_in, fold_in4 = fold_in["flagship"], fold_in["fourb5b_b32"]
    check_tap_sweep(torch, xh, xn, x, pre, cfg.correlation_threshold)
    for tag, c, xx in (("flagship", cfg, x), ("fourb5b_b32", cfg4, x4)):
        for k_name, v in check_dense_refine(torch, sd, xh, xn, c, xx, tag).items():
            errs[k_name] = max(errs.get(k_name, 0), v)
    shared_in = {}
    for tag, c, xx, n_blocks, past in (("blocked_600s", cfg, xb, BLOCKED_BLOCKS, True),
                                       ("the 4B5B seam capture", cfg4, xs, SEAM_BLOCKS, False)):
        shared_errs, shared_in[c.line_coding] = check_shared(torch, sd, xh, stream, c, xx,
                                                             n_blocks, tag, past)
        errs.update(shared_errs)
    tool = exs.tool_input(dev)
    errs.update(check_tools(torch, hp, exs, pf, sd, xh, xn, cfg, x, vlens, corr_p, tool))
    check_threshold_tie(torch, xh, decode_capture_fast, decode_capture, cfg4, pre4, dev)
    exp_errs, exp_in = check_experiments(torch, et, eo, dev)
    errs.update(exp_errs)
    check_tiles_streams_edges(torch, et, exs, xh, dev)
    check_probe_offset_edges(torch, hp, eo, dev)
    del corr_p, corr_p4, cp, rows_b     # the dense corr: keep it out of phase 4's peak memory

    rng = np.random.default_rng(args.seed + 17)
    walk_err = 0
    tables = []
    for cap in (1, 2, 5, 72, 128, 256):
        pos = np.full((b, N_CAND), 2**30, np.int64)
        for r in range(b):
            k = int(rng.integers(0, N_CAND + 1))
            pos[r, :k] = np.sort(rng.integers(0, 40_000, k))
        fields = np.stack([pos, rng.integers(1, 3000, (b, N_CAND)),
                           rng.random((b, N_CAND)) < 0.25, rng.random((b, N_CAND)) < 0.6],
                          axis=1).astype(np.int32)
        cur0 = rng.integers(0, 30_000, b).astype(np.int32)
        limit = rng.choice([20_000, 41_000, 2**30], b).astype(np.int32)
        tables.append((torch.from_numpy(fields).to(dev), torch.from_numpy(cur0).to(dev),
                       torch.from_numpy(limit).to(dev), cap))
    phase_a = sd.spec_phase_a(cfg, x, LOCAL_ADDR, N_CAND, vlens)
    phase_a4 = sd.spec_phase_a(cfg4, x4, LOCAL_ADDR, N_CAND, vlens4)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    no_limit = torch.full((b,), 2**30, dtype=torch.int32, device=dev)
    tables += [(phase_a.fields, zeros, no_limit, MAX_FRAMES),
               (phase_a4.fields, zeros, no_limit, MAX_FRAMES)]
    for fields, cur0, limit, cap in tables:
        got = sd.spec_walk(fields, cur0, limit, cap)
        torch.cuda.synchronize()
        want = sd.spec_walk_plain(fields, cur0, limit, cap)
        for field, g, w in zip(got._fields, got, want):
            require(torch.equal(g, w), f"spec_walk {field} differs (max_frames {cap})")
            walk_err = max(walk_err, (g.long() - w.long()).abs().max().item())
    errs["spec_walk"] = walk_err
    log(f"phase 1: spec_walk == plain on {len(tables)} tables "
        "(random ones with caps 1..256, the flagship's and fourb5b_b32's)")
    for k_name, v in check_walk_attempt_edges(torch, sd, dev).items():
        errs[k_name] = max(errs.get(k_name, 0), v)
    for k_name, v in check_ask_walk_4b5b_edges(torch, sd, ask_spec, dev).items():
        errs[k_name] = max(errs.get(k_name, 0), v)
    ask_errs, ask_in = check_ask_kernels(torch, ask, ask_spec, sdot, acfg, xa, rng)
    errs.update(ask_errs)
    check_fire_chain_edges(torch, ask, ask_spec, dev)
    chirp = ask._chirp_np(acfg)        # dsp/osc.py's chirp
    errs["xcorr_rowstats"] = max(check_rowstats(torch, xn, xcorr_hits, xe, pre, "equalized_b32"),
                                 check_rowstats(torch, xn, xcorr_hits, x4, pre4, "fourb5b_b32"),
                                 check_rowstats(torch, xn, xcorr_hits, xa, chirp, "ask_b16"))
    errs["normalized_xcorr"] = check_dense(torch, xn, xcorr_hits, xa, chirp, xe, pre)

    # --- phase 2: the main paths -----------------------------------------------
    xh.xcorr_hits_batched.launches = 0     # no path runs it: it must stay 0
    launches = run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg, x, frames,
                             (xcorr_hits, sd.attempt_manchester, sd.spec_walk), "flagship")
    launches4 = run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg4, x4,
                              frames4, (xcorr_hits, sd.attempt_4b5b, sd.spec_walk), "fourb5b_b32")
    fold_launches = {}
    for tag, c, xx, fr, attempt_fold in (
            ("manchester_b32_fold", cfg, x, frames, sd.attempt_manchester_fold),
            ("fourb5b_b32_fold", cfg4, x4, frames4, sd.attempt_4b5b_fold)):
        legacy = sd.decode_capture_spec(c, xx, LOCAL_ADDR, max_frames=MAX_FRAMES, with_cursor=True)
        kernels = (xh.xcorr_hits_refine, xcorr_hits, attempt_fold, sd.spec_walk)
        old_fold = sd.SYNC_FOLD
        sd.SYNC_FOLD = True
        try:
            got = run_main_path(torch, decode_capture_fast, decode_capture, sd, c, xx, fr,
                                kernels, tag, expect={k.__name__: int(k is not xcorr_hits)
                                                      for k in kernels})
            fold = sd.decode_capture_spec(c, xx, LOCAL_ADDR, max_frames=MAX_FRAMES,
                                          with_cursor=True)
        finally:
            sd.SYNC_FOLD = old_fold
        require(all(torch.equal(p, q) for p, q in zip([*fold[0], *fold[1:]],
                                                      [*legacy[0], *legacy[1:]])),
                f"{tag}: the fold decode differs from the legacy decode")
        log(f"phase 2 ({tag}): frames, ok and cursors equal the legacy decode's")
        for k_name, n in got.items():
            fold_launches[k_name] = fold_launches.get(k_name, 0) + n
    eq_info = {}

    def equalize_capture(xx):
        out, info = equalizer.equalize_capture(cfg, xx)
        eq_info.update(info)
        return out

    eq_kernels = (xn.xcorr_rowstats, xcorr_hits, sd.attempt_manchester, sd.spec_walk)
    launches_e = run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg, xe, frames_e,
                               eq_kernels, "equalized_b32", front=equalize_capture)
    require(launches_e == dict.fromkeys(launches_e, 1),
            f"equalized_b32 launches {launches_e}, expected one of each kernel")
    require(bool(eq_info["applied"].all()), "an equalized_b32 row was not equalized")
    stock_e = decode_capture_fast(cfg, xe, LOCAL_ADDR, max_frames=MAX_FRAMES).count
    log(f"phase 2 (equalized_b32): every row applied (lam {eq_info['lam'].min().item():.3g}.."
        f"{eq_info['lam'].max().item():.3g}, quality {eq_info['quality'].min().item():.4f}.."
        f"{eq_info['quality'].max().item():.4f}); the stock decode of the same captures finds "
        f"{int(stock_e.min())}..{int(stock_e.max())} of {N_FRAMES} frames per row")
    for launch_counts in (launches4, fold_launches, launches_e):
        for k_name, n in launch_counts.items():
            launches[k_name] = launches.get(k_name, 0) + n
    launches["xcorr_hits_batched"] = xh.xcorr_hits_batched.launches
    xn.normalized_xcorr_dense.launches = 0
    torch.cuda.synchronize()
    corr_a = auto_xcorr(xa, chirp)
    torch.cuda.synchronize()
    launches["normalized_xcorr"] = xn.normalized_xcorr_dense.launches
    require(launches["normalized_xcorr"] == 1,
            f"auto_xcorr at L={len(chirp)} launched normalized_xcorr "
            f"{launches['normalized_xcorr']} times")
    require(corr_a.shape == (xa.shape[0], xa.shape[1] - len(chirp) + 1)
            and bool(torch.isfinite(corr_a).all()), "auto_xcorr at L=440 gave a bad result")
    log(f"phase 2 (auto_xcorr): L={len(chirp)} on {xa.shape[0]} x {xa.shape[1]} launched "
        f"normalized_xcorr once; peak corr per track {corr_a.amax(-1).min().item():.4f}.."
        f"{corr_a.amax(-1).max().item():.4f}")
    ask_kernels = (sdot.sliding_dot_scaled, ask_spec.dense_fire_candidates, ask.ask_chain,
                   ask_spec.ask_walk)
    launches.update(run_ask_main_path(torch, ask, ask_spec, acfg, xa, frames_a, ask_kernels))
    blocked = {}
    for tag, c, xx, fr, st, n_blocks, fold in (
            ("blocked_600s", cfg, xb, frames_b, starts_b, BLOCKED_BLOCKS, False),
            ("blocked_600s_fold", cfg, xb, frames_b, starts_b, BLOCKED_BLOCKS, True),
            ("fourb5b_seam_60s", cfg4, xs, frames_s, starts_s, SEAM_BLOCKS, False),
            ("fourb5b_seam_60s_fold", cfg4, xs, frames_s, starts_s, SEAM_BLOCKS, True)):
        legacy, fold_fn, _, _ = shared_attempts(sd, c)
        counters = [("xcorr_hits", xcorr_hits, "launches", int(not fold)),
                    ("xcorr_hits_refine", xh.xcorr_hits_refine, "launches", int(fold)),
                    (f"{legacy.__name__}_shared", legacy, "shared_launches", int(not fold)),
                    (f"{fold_fn.__name__}_shared", fold_fn, "shared_launches", int(fold)),
                    (legacy.__name__, legacy, "launches", 0),
                    ("spec_walk", sd.spec_walk, "launches", None)]
        old_fold = sd.SYNC_FOLD
        sd.SYNC_FOLD = fold
        try:
            got, blocked[tag] = run_blocked_path(torch, sd, stream, c, xx, fr, st, n_blocks,
                                                 counters, tag, tag == "fourb5b_seam_60s")
        finally:
            sd.SYNC_FOLD = old_fold
        for k_name, n in got.items():
            launches[k_name] = launches.get(k_name, 0) + n
        if fold:
            require(all(torch.equal(p, q) for p, q in zip(blocked[tag], blocked[tag[:-5]])),
                    f"{tag}: the fold's frames differ from the legacy decode's")
            log(f"phase 2 ({tag}): every field equals the legacy decode's")

    prof_kernels = {"xcorr_hits": xcorr_hits, "xcorr_hits_refine": xh.xcorr_hits_refine,
                    "attempt_manchester": sd.attempt_manchester,
                    "attempt_manchester_fold": sd.attempt_manchester_fold,
                    "spec_walk": sd.spec_walk, "xcorr_hits_2s": exs.xcorr_hits_2s}
    prof = run_profiler_path(torch, pf, exs, cfg, x, frames, vlens, tool, prof_kernels)
    for k_name in ("xcorr_hits", "xcorr_hits_refine", "attempt_manchester",
                   "attempt_manchester_fold", "spec_walk"):
        launches[k_name] = launches.get(k_name, 0) + prof[k_name]
    launches["xcorr_hits_2s"] = prof["xcorr_hits_2s"]
    launches["attempt_sum"] = prof["attempt_manchester"] + prof["attempt_manchester_fold"]
    launches["seq_probe"] = probe_launches
    launches.update(run_experiments(torch, et, eo))

    # --- phase 3: the fallbacks ----------------------------------------------
    enc = PhyEncoder(cfg, device=dev)
    tail = enc.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 20) for i in range(3)],
                             gap_samples=300)
    crowded = torch.cat([torch.from_numpy(pre).to(dev).repeat(150),
                         torch.zeros(500, device=dev), tail])
    clean = torch.cat([tail, torch.zeros(crowded.shape[0] - tail.shape[0], device=dev)])
    check_fallback(torch, decode_capture_fast, decode_captures, sd, cfg,
                   torch.stack([crowded, clean]), [3, 3], "flagship",
                   "150 back-to-back preambles")
    enc4 = PhyEncoder(cfg4, device=dev)
    tail4 = enc4.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 20) for i in range(3)],
                               gap_samples=300)
    zeroed = tail4.clone()
    level0 = cfg4.preamble_len + 20 * 15 + 3   # a level inside the first frame
    zeroed[level0:level0 + 3] = 0.0
    check_fallback(torch, decode_capture_fast, decode_captures, sd, cfg4,
                   torch.stack([zeroed, tail4]), [2, 3], "4b5b",
                   "a zeroed level inside an attempted frame")
    check_ask_fallback(torch, ask, ask_spec, acfg, dev)
    check_equalizer_noise(torch, equalizer, cfg, dev, args.seed + 23)
    check_blocked_fallback(torch, stream, decode_capture, cfg4, xs, starts_s)

    # --- phase 4: timings ------------------------------------------------------
    ms = {
        "xcorr_hits": time_ms(torch, lambda: xcorr_hits(x, pre, cfg.correlation_threshold)),
        "attempt_manchester": time_ms(torch, lambda: sd.attempt_manchester(
            x, cand, n_valid, vlens, sync, sync_e)),
        "attempt_4b5b": time_ms(torch, lambda: sd.attempt_4b5b(
            x4, cand4, n_valid4, vlens4, sync4, sync_e4)),
        "spec_walk": time_ms(torch, lambda: sd.spec_walk(
            phase_a.fields, zeros, no_limit, MAX_FRAMES)),
    }
    plain_ms = {
        "xcorr_hits": time_ms(torch, lambda: xcorr_hits_plain(
            x, pre, cfg.correlation_threshold)),
        "attempt_manchester": time_ms(torch, lambda: sd.attempt_manchester_plain(
            x, cand, n_valid, vlens, sync, sync_e)),
        "attempt_4b5b": time_ms(torch, lambda: sd.attempt_4b5b_plain(
            x4, cand4, n_valid4, vlens4, sync4, sync_e4)),
        "spec_walk": time_ms(torch, lambda: sd.spec_walk_plain(
            phase_a.fields, zeros, no_limit, MAX_FRAMES)),
    }
    xcorr4_ms = time_ms(torch, lambda: xcorr_hits(x4, pre4, cfg4.correlation_threshold))
    thr = cfg.correlation_threshold
    fold_calls = {
        "xcorr_hits_refine": (xh.xcorr_hits_refine, xh.xcorr_hits_refine_plain,
                              (x, vlens, pre, sync, thr), fold_in["kw"]),
        "xcorr_hits_batched": (xh.xcorr_hits_batched, xh.xcorr_hits_batched_plain,
                               (x, pre, thr), {}),
        "attempt_manchester_fold": (sd.attempt_manchester_fold, sd.attempt_manchester_fold_plain,
                                    (x, fold_in["fs"], n_valid), {}),
        "attempt_4b5b_fold": (sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain,
                              (x4, fold_in4["fs"], n_valid4), {}),
    }
    for k_name, (kernel, plain, call_args, kw) in fold_calls.items():
        ms[k_name] = time_ms(torch, lambda: kernel(*call_args, **kw))
        plain_ms[k_name] = time_ms(torch, lambda: plain(*call_args, **kw))
    refine4_ms = time_ms(torch, lambda: xh.xcorr_hits_refine(
        x4, vlens4, pre4, sync4, cfg4.correlation_threshold, **fold_in4["kw"]))
    sync_scale = 1.0 / acfg.sync_divisor
    demod_in, k30 = ask_in["demod_in"], ask_in["k30"]
    ask_calls = {
        "sliding_dot": (sdot.sliding_dot_scaled, sdot.sliding_dot_scaled_plain,
                        (xa, ask_in["pre"], sync_scale)),
        "ask_fire": (ask_spec.dense_fire_candidates, ask_spec.dense_fire_candidates_plain,
                     (acfg, ask_in["sync"], ask_in["upd_ok"])),
        "ask_chain": (ask.ask_chain, ask.ask_chain_plain,
                      (ask_in["vals"], ask_in["base"], acfg.peak_guard)),
        "ask_walk": (ask_spec.ask_walk, ask_spec.ask_walk_plain,
                     (ask_in["fields"], ASK_MAX_FRAMES)),
    }
    for k_name, (kernel, plain, ask_args) in ask_calls.items():
        ms[k_name] = time_ms(torch, lambda: kernel(*ask_args))
        plain_ms[k_name] = time_ms(torch, lambda: plain(*ask_args))
    ms["xcorr_rowstats"] = time_ms(torch, lambda: xn.xcorr_rowstats(xe, pre))
    plain_ms["xcorr_rowstats"] = time_ms(torch, lambda: xn.xcorr_rowstats_plain(xe, pre))
    rowstats4_ms = time_ms(torch, lambda: xn.xcorr_rowstats(x4, pre4))
    ms["normalized_xcorr"] = time_ms(torch, lambda: xn.normalized_xcorr_dense(xa, chirp))
    plain_ms["normalized_xcorr"] = time_ms(torch, lambda: xn.normalized_xcorr_dense_plain(
        xa, chirp))
    sd30_ms = time_ms(torch, lambda: sdot.sliding_dot_scaled(demod_in, k30, 1.0))
    sd30_plain_ms = time_ms(torch, lambda: sdot.sliding_dot_scaled_plain(demod_in, k30, 1.0))
    # the library yardstick of the sliding dot: one cuDNN convolution (TF32
    # off since phase 0), the scale folded into its weights
    conv_w = {n: torch.from_numpy(p * np.float32(sc)).to(dev).view(1, 1, -1)
              for n, p, sc in ((440, ask_in["pre"], sync_scale), (30, k30, 1.0))}

    def conv_dot(xx, n):
        return torch.nn.functional.conv1d(xx[:, None], conv_w[n], padding=n - 1)[:, 0, :xx.shape[1]]

    conv_err = (conv_dot(xa, 440) - sdot.sliding_dot_scaled(xa, ask_in["pre"], sync_scale)
                ).abs().max().item()
    library_ms = {"sliding_dot": time_ms(torch, lambda: conv_dot(xa, 440))}
    # the normalized correlation's nearest PyTorch calls: the dot and the
    # window energy, each one valid-mode cuDNN convolution (TF32 off)
    chirp_w = torch.from_numpy(chirp).to(dev).view(1, 1, -1)
    ones_w = torch.ones_like(chirp_w)

    def conv_dot_energy():
        xx = xa[:, None]
        return (torch.nn.functional.conv1d(xx, chirp_w),
                torch.nn.functional.conv1d(xx * xx, ones_w))

    library_ms["normalized_xcorr"] = time_ms(torch, conv_dot_energy)
    conv30_ms = time_ms(torch, lambda: conv_dot(demod_in, 30))

    # least times, from the shapes and this run's candidates
    live = int(n_valid.clamp(max=N_CAND).sum())
    live4 = int(n_valid4.clamp(max=N_CAND).sum())
    n_lags = t - len(pre) + 1
    n_lags_e = xe.shape[1] - len(pre) + 1
    n_lags_a = xa.shape[1] - len(chirp) + 1
    small_in = 3 * b * 4 + b * N_CAND * 4            # cand, n_valid, vlen
    chain_cols = chain_columns(torch, ask_in["vals"], ask_in["base"], acfg.peak_guard)
    bounds = {
        # each lag: len(pre) multiply-adds for the dot and for the energy
        "xcorr_hits": bound(x.numel() * 4 + rows_k.numel() * 4,
                            b * n_lags * 4 * len(pre)),
        # each candidate: 13 x 48 refine taps (4 ops), 2104 bits of 6 ops
        "attempt_manchester": bound(
            x.numel() * 4 + small_in + b * N_CAND * (sd.FRAME_BYTES + 4),
            live * (13 * 48 * 4 + sd.FRAME_BYTES * 8 * 6)),
        # each candidate: 31 x 30 refine taps (4 ops), 3200 levels of 2 adds,
        # a product and a compare
        "attempt_4b5b": bound(
            x4.numel() * 4 + small_in + b * N_CAND * (sd.FRAME_BYTES + 12),
            live4 * (31 * 30 * 4 + sd.ZERO_SYMBOLS * 5 * 4)),
        # the fields in, keep/attempted, done and three ints per capture
        # out; a few integer ops per candidate
        "spec_walk": bound(phase_a.fields.numel() * 4 + 2 * b * 4 + 2 * b * N_CAND + b
                           + 3 * b * 4, b * N_CAND * 4),
        # each lag: 440 products and 440 sums, then the scale
        "sliding_dot": bound(2 * xa.numel() * 4, xa.numel() * (2 * 440 + 1)),
        # sync and upd in, hits out; a select per sample (the block scans
        # and the window's three maxima are a few more a sample, far below
        # the bytes term)
        "ask_fire": bound(xa.numel() * 6, xa.numel()),
        # each row up to its first fire (all of it when none): the value in,
        # a max, a compare, an index select and a max per column
        "ask_chain": bound(4 * chain_cols + ask_in["base"].numel() * 9, 4 * chain_cols),
        # the table in, a peak and a flag per slot out; about 12 integer
        # ops per slot
        "ask_walk": bound(ask_in["fields"].numel() * 4 + xa.shape[0] * (ASK_MAX_FRAMES * 5 + 1),
                          xa.shape[0] * ASK_MAX_FRAMES * 12),
        # xcorr_hits' work, and each refined hit (the first four of a row):
        # 13 positions x 48 taps, a product and a sum for the dot and for
        # the energy; vlens in
        "xcorr_hits_refine": bound(x.numel() * 4 + b * 4 + rows_k.numel() * 4,
                                   b * n_lags * 4 * len(pre)
                                   + fold_in["hits"] * fold_in["kw"]["n_pos"] * len(sync) * 4),
        "xcorr_hits_batched": bound(x.numel() * 4 + rows_k.numel() * 4,
                                    b * n_lags * 4 * len(pre)),
        # the legacy attempts' work without the refine: fs in for the
        # candidate table
        "attempt_manchester_fold": bound(
            x.numel() * 4 + b * N_CAND * 4 + b * 4 + b * N_CAND * (sd.FRAME_BYTES + 4),
            live * sd.FRAME_BYTES * 8 * 6),
        "attempt_4b5b_fold": bound(
            x4.numel() * 4 + b * N_CAND * 4 + b * 4 + b * N_CAND * (sd.FRAME_BYTES + 12),
            live4 * sd.ZERO_SYMBOLS * 5 * 4),
        # each lag: len(pre) multiply-adds for the dot and for the energy;
        # a max and a position per 128 lags out
        "xcorr_rowstats": bound(xe.numel() * 4 + b * -(-n_lags_e // 128) * 8,
                                b * n_lags_e * 4 * len(pre)),
        # each lag: 440 multiply-adds for the dot and for the energy; the
        # captures in, the dense correlation out
        "normalized_xcorr": bound(xa.numel() * 4 + xa.shape[0] * n_lags_a * 4,
                                  xa.shape[0] * n_lags_a * 4 * len(chirp)),
    }
    sd30_bound = bound(2 * demod_in.numel() * 4, demod_in.numel() * (2 * 30 + 1))
    for k_name in ms:
        log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms, "
            f"bound {bounds[k_name][0]:.4f} ms ({bounds[k_name][1]}) [{card}]")
    log(f"phase 4: xcorr_hits at the fourb5b_b32 shape (L=60): kernel {xcorr4_ms:.4f} ms "
        f"[{card}]")
    log(f"phase 4: xcorr_hits_refine at the fourb5b_b32 shape (L=60, W=30, 31 positions, "
        f"{fold_in4['hits']} refined hits): kernel {refine4_ms:.4f} ms [{card}]")
    log(f"phase 4: normalized_xcorr at L=440 vs conv1d dot + conv1d energy: "
        f"{library_ms['normalized_xcorr']:.4f} ms [{card}]")
    log(f"phase 4: sliding_dot at L=440 vs conv1d: {library_ms['sliding_dot']:.4f} ms "
        f"(max |conv1d - kernel| {conv_err:.3g}); at L=30 ({demod_in.shape[0]} x "
        f"{demod_in.shape[1]}): kernel {sd30_ms:.4f} ms, plain {sd30_plain_ms:.4f} ms, conv1d "
        f"{conv30_ms:.4f} ms, bound {sd30_bound[0]:.4f} ms ({sd30_bound[1]}) [{card}]")
    steps = {
        "compact_hit_rows": time_ms(torch, lambda: sd.compact_hit_rows(rows_k, N_CAND)),
        "spec_phase_a": time_ms(torch, lambda: sd.spec_phase_a(
            cfg, x, LOCAL_ADDR, N_CAND, vlens)),
        "spec_phase_a 4b5b": time_ms(torch, lambda: sd.spec_phase_a(
            cfg4, x4, LOCAL_ADDR, N_CAND, vlens4)),
        "spec_compact": time_ms(torch, lambda: sd.spec_compact(
            phase_a, sd.spec_walk(phase_a.fields, zeros, no_limit, MAX_FRAMES).keep,
            MAX_FRAMES)),
    }
    for step, v in steps.items():
        log(f"phase 4: step {step}: {v:.4f} ms [{card}]")

    def decode_ms(c, xx, fold: bool) -> float:
        old_fold = sd.SYNC_FOLD
        sd.SYNC_FOLD = fold
        try:
            return time_ms(torch, lambda: sd.decode_capture_spec(
                c, xx, LOCAL_ADDR, max_frames=MAX_FRAMES))
        finally:
            sd.SYNC_FOLD = old_fold

    for tag, c, xx in (("flagship", cfg, x), ("fourb5b_b32", cfg4, x4)):
        e2e = decode_ms(c, xx, False)
        rt = xx.numel() / c.sample_rate / (e2e / 1e3)
        log(f"phase 4: decode_capture_spec {tag} {xx.shape[0]} x {xx.shape[1]}: {e2e:.4f} ms, "
            f"{rt:.1f}x real time [{card}]")
        # the fold against legacy: four turns each, in the order L F F L L F F L
        turns = [(fold, decode_ms(c, xx, fold)) for fold in (False, True, True, False) * 2]
        log(f"phase 4: decode_capture_spec {tag}, legacy and fold in turns (L F F L L F F L): "
            + ", ".join(f"{v:.4f}" for _, v in turns) + " ms; medians legacy "
            f"{statistics.median(v for f, v in turns if not f):.4f}, fold "
            f"{statistics.median(v for f, v in turns if f):.4f} ms [{card}]")
        peak = peak_memory(torch, lambda: sd.decode_capture_spec(c, xx, LOCAL_ADDR,
                                                                 max_frames=MAX_FRAMES))
        log(f"phase 4: decode_capture_spec {tag} peak device memory {peak} [{card}]")
        scan = time_ms(torch, lambda: decode_capture(c, xx[0], LOCAL_ADDR, MAX_FRAMES), runs=5)
        log(f"phase 4: exact scan {tag}, one row of {N_FRAMES} frames: {scan:.4f} ms [{card}]")
    power_a, sync_a, upd_a = ask.dense_arrays(acfg, xa)
    hits_a = ask_spec.dense_fire_candidates(acfg, sync_a, upd_a)
    cand_a, _, _ = ask_spec.extract_candidates(hits_a, 96)
    cand_full_a = torch.cat([torch.full((xa.shape[0], 1), -(acfg.frame_samples + 1),
                                        dtype=torch.int32, device=dev), cand_a], dim=1)
    ask_steps = {
        "dense_arrays": lambda: ask.dense_arrays(acfg, xa),
        "dense_fire_candidates": lambda: ask_spec.dense_fire_candidates(acfg, sync_a, upd_a),
        "extract_candidates": lambda: ask_spec.extract_candidates(hits_a, 96),
        "phase_b": lambda: ask_spec.phase_b(acfg, xa, power_a, sync_a, upd_a, cand_full_a),
        "ask_walk": lambda: ask_spec.ask_walk(ask_in["fields"], ASK_MAX_FRAMES),
        "demod_dense": lambda: ask.demod_dense(acfg, xa),
    }
    for step, fn in ask_steps.items():
        log(f"phase 4: ask_b16 step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    e2e = time_ms(torch, lambda: ask_spec.demodulate_spec(acfg, xa, max_frames=ASK_MAX_FRAMES))
    rt = xa.numel() / acfg.sample_rate / (e2e / 1e3)
    log(f"phase 4: demodulate_spec ask_b16 {xa.shape[0]} x {xa.shape[1]}: {e2e:.4f} ms, "
        f"{rt:.1f}x real time [{card}]")
    peak = peak_memory(torch, lambda: ask_spec.demodulate_spec(acfg, xa,
                                                               max_frames=ASK_MAX_FRAMES))
    log(f"phase 4: demodulate_spec ask_b16 peak device memory {peak} [{card}]")
    scan = time_ms(torch, lambda: ask.demodulate(acfg, xa[0], max_frames=ASK_MAX_FRAMES), runs=5)
    log(f"phase 4: exact scan ask_b16, one row of {ASK_FRAMES} frames: {scan:.4f} ms [{card}]")

    _, info_e = equalizer.equalize_capture(cfg, xe)
    anchors_e = info_e["anchor"][:, None].expand(-1, 4).contiguous()   # the fit's shape
    g_t = equalizer._mmse_taps(info_e["h"], info_e["lam"])
    eq_steps = {
        "auto_xcorr_row_stats": lambda: xn.xcorr_rowstats(xe, pre),
        "estimate_channel (4 anchors)": lambda: equalizer.estimate_channel(cfg, xe, anchors_e),
        "_mmse_taps": lambda: equalizer._mmse_taps(info_e["h"], info_e["lam"]),
        "_apply_fir": lambda: equalizer._apply_fir(xe, g_t),
    }
    for step, fn in eq_steps.items():
        log(f"phase 4: equalized_b32 step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    eq_ms = time_ms(torch, lambda: equalizer.equalize_capture(cfg, xe))
    rt = xe.numel() / cfg.sample_rate / (eq_ms / 1e3)
    log(f"phase 4: equalize_capture equalized_b32 {b} x {xe.shape[1]}: {eq_ms:.4f} ms, "
        f"{rt:.1f}x real time [{card}]")

    def eq_decode():
        return sd.decode_capture_spec(cfg, equalizer.equalize_capture(cfg, xe)[0], LOCAL_ADDR,
                                      max_frames=MAX_FRAMES)

    e2e = time_ms(torch, eq_decode)
    rt = xe.numel() / cfg.sample_rate / (e2e / 1e3)
    log(f"phase 4: equalize_capture + decode_capture_spec equalized_b32 {b} x {xe.shape[1]}: "
        f"{e2e:.4f} ms, {rt:.1f}x real time [{card}]")
    for what, fn in (("equalize_capture", lambda: equalizer.equalize_capture(cfg, xe)),
                     ("equalize_capture + decode_capture_spec", eq_decode)):
        peak = peak_memory(torch, fn)
        share = busy_share(torch, fn)
        busy = "not measured (no device events traced)" if share is None else f"{share:.3f}"
        log(f"phase 4: {what} equalized_b32 peak device memory {peak}, device busy "
            f"share over 5 calls (torch.profiler) {busy} [{card}]")

    # blocked_600s: end to end, its steps, memory, busy share, the shared
    # attempts at their captures' shapes, one exact blocked decode
    def blocked_call():
        return stream.decode_blocked_single_chip(cfg, xb, LOCAL_ADDR, BLOCKED_BLOCKS,
                                                 BLOCKED_MFPB, N_CAND)

    e2e = time_ms(torch, blocked_call)
    log(f"phase 4: decode_blocked_single_chip blocked_600s ({xb.shape[0]} samples, "
        f"{BLOCKED_BLOCKS} blocks): {e2e:.4f} ms, {BLOCKED_SECONDS / (e2e / 1e3):.1f}x real time "
        f"[{card}]")
    info_b = shared_in["manchester"]
    xbf, block_b, vlens_b = info_b["xf"][0], info_b["block"], info_b["vlens"]
    a_b = sd.spec_phase_a(cfg, xbf, LOCAL_ADDR, N_CAND, vlens_b,
                          flat_blocks=(BLOCKED_BLOCKS, block_b))
    starts_t = torch.arange(BLOCKED_BLOCKS, dtype=torch.int32, device=dev) * block_b
    walk_b, turns_b = stream.seam_fixpoint(sd.spec_walk, a_b.fields, starts_t, starts_t + block_b,
                                           BLOCKED_MFPB)
    blocked_steps = {
        "spec_phase_a (flat)": lambda: sd.spec_phase_a(cfg, xbf, LOCAL_ADDR, N_CAND, vlens_b,
                                                       flat_blocks=(BLOCKED_BLOCKS, block_b)),
        f"seam_fixpoint ({turns_b} walk turn(s))": lambda: stream.seam_fixpoint(
            sd.spec_walk, a_b.fields, starts_t, starts_t + block_b, BLOCKED_MFPB),
        "spec_compact": lambda: sd.spec_compact(a_b, walk_b.keep, BLOCKED_MFPB),
    }
    for step, fn in blocked_steps.items():
        log(f"phase 4: blocked_600s step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    peak = peak_memory(torch, blocked_call)
    share = busy_share(torch, blocked_call)
    busy = "not measured (no device events traced)" if share is None else f"{share:.3f}"
    log(f"phase 4: decode_blocked_single_chip blocked_600s peak device memory {peak} (the "
        f"capture itself {xb.numel() * 4 / 2**20:.1f} MiB), device busy share over 5 calls "
        f"(torch.profiler) {busy} [{card}]")
    for c in (cfg, cfg4):
        info = shared_in[c.line_coding]
        for k_name, (kernel, plain, call_args) in info["calls"].items():
            ms[k_name] = time_ms(torch, lambda: kernel(*call_args))
            plain_ms[k_name] = time_ms(torch, lambda: plain(*call_args))
            bounds[k_name] = shared_bound(sd, c, k_name, info)
            log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms, "
                f"bound {bounds[k_name][0]:.6f} ms ({bounds[k_name][1]}) at {info['live']} live "
                f"of {info['vlens'].numel() * N_CAND} slots [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact_b = stream.decode_blocked_exact(cfg, xb, LOCAL_ADDR, BLOCKED_BLOCKS, BLOCKED_MFPB)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    require(frame_set(exact_b) == frame_set(blocked["blocked_600s"]),
            "blocked_600s: the exact blocked route differs from the speculative one")
    log(f"phase 4: decode_blocked_exact blocked_600s, one call: {exact_s * 1e3:.1f} ms "
        f"({BLOCKED_SECONDS / exact_s:.1f}x real time), frames equal the speculative route's "
        f"[{card}]")

    # the tools: the launch floor, the two-stream experiment beside kernel
    # #1 at the tool's shapes, the profiler's stage table
    log(f"phase 4: launch floor noop_kernel_us {snap['noop_kernel_us']:.4f} us (health: "
        f"{hp.LAUNCHES} seq_probe launches back to back, median of {hp.REPEATS}) [{card}]")
    xt, pat_t = tool
    n_lags_t = xt.shape[1] - len(pat_t) + 1
    n_rows_t = -(-xt.shape[1] // 128)
    n_tiles_t = -(-n_rows_t // 8)
    # each lag: L multiply-adds for the dot and for the energy; the captures
    # and the halo of the second stream in, the rows out
    bounds["xcorr_hits_2s"] = bound(xt.numel() * 4 + xt.shape[0] * n_tiles_t * 128 * 4
                                    + xt.shape[0] * n_rows_t * 16 * 4,
                                    xt.shape[0] * n_lags_t * 4 * len(pat_t))
    for form, (mn, med) in exs.experiment(xt, pat_t, exs.THR, iters=50).items():
        log(f"phase 4: exp_xcorr_streams {form}: min {mn:.4f} ms, median {med:.4f} ms a call "
            f"(50 back to back, 3 repeats) [{card}]")
    log(f"phase 4: exp_xcorr_streams bound (current, 2stream, 2stream_noep): "
        f"{bounds['xcorr_hits_2s'][0]:.4f} ms ({bounds['xcorr_hits_2s'][1]}) [{card}]")
    streams_t = exs.two_streams(xt)
    ms["xcorr_hits_2s"] = time_ms(torch, lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR,
                                                                   streams=streams_t))
    plain_ms["xcorr_hits_2s"] = time_ms(torch, lambda: exs.xcorr_hits_2s_plain(xt, pat_t, exs.THR))
    noep_ms = time_ms(torch, lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR, False, streams_t))
    xcorr_t_ms = time_ms(torch, lambda: xcorr_hits(xt, pat_t, exs.THR))
    log(f"phase 4: at the tool's shapes ({xt.shape[0]} x {xt.shape[1]}, L={len(pat_t)}), median "
        f"of {RUNS}: xcorr_hits_2s {ms['xcorr_hits_2s']:.4f} ms, noep {noep_ms:.4f} ms, kernel #1 "
        f"{xcorr_t_ms:.4f} ms, plain {plain_ms['xcorr_hits_2s']:.4f} ms; bound "
        f"{bounds['xcorr_hits_2s'][0]:.4f} ms ({bounds['xcorr_hits_2s'][1]}) [{card}]")
    # the hit kernel's own device time (torch.profiler) beside the CUDA-event
    # median of its wrapper call; at the tool's shapes beside the two-stream
    # kernel, which runs the same register tile on its two streams: their
    # ratio in one run compares the two ways of delivering the operand
    thr4 = cfg4.correlation_threshold
    dev_calls = {
        "xcorr_hits flagship (L=96)": (lambda: xcorr_hits(x, pre, thr), "xcorr_hits_kernel",
                                       ms["xcorr_hits"]),
        "xcorr_hits fourb5b_b32 (L=60)": (lambda: xcorr_hits(x4, pre4, thr4),
                                          "xcorr_hits_kernel", xcorr4_ms),
        "xcorr_hits_refine flagship": (lambda: xh.xcorr_hits_refine(
            x, vlens, pre, sync, thr, **fold_in["kw"]), "xcorr_hits_kernel",
            ms["xcorr_hits_refine"]),
        "xcorr_hits_refine fourb5b_b32": (lambda: xh.xcorr_hits_refine(
            x4, vlens4, pre4, sync4, thr4, **fold_in4["kw"]), "xcorr_hits_kernel", refine4_ms),
        "xcorr_hits_batched flagship": (lambda: xh.xcorr_hits_batched(x, pre, thr),
                                        "xcorr_hits_kernel", ms["xcorr_hits_batched"]),
        "xcorr_hits tool input": (lambda: xcorr_hits(xt, pat_t, exs.THR), "xcorr_hits_kernel",
                                  xcorr_t_ms),
        "xcorr_hits_2s tool input": (lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR,
                                                               streams=streams_t),
                                     "xcorr_hits_2s_kernel", ms["xcorr_hits_2s"]),
        "xcorr_hits_2s noep tool input": (lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR, False,
                                                                    streams_t),
                                          "xcorr_hits_2s_kernel", noep_ms),
    }
    dev_ms = {}
    for what, (fn, kernel, event_ms) in dev_calls.items():
        got = device_ms(torch, fn, kernel)
        dev_ms[what] = None if got is None else got[0]
        traced = ("not measured (no session traced every launch)" if got is None
                  else f"{got[0]:.4f} ms (all {RUNS} launches traced, session {got[1]})")
        log(f"phase 4: device time {what}: {traced}; CUDA events around the wrapper "
            f"{event_ms:.4f} ms [{card}]")
    one, two = dev_ms["xcorr_hits tool input"], dev_ms["xcorr_hits_2s tool input"]
    log(f"phase 4: kernel #1 / xcorr_hits_2s at the tool's shapes, same run: device "
        f"{'not measured' if one is None or two is None else f'{one / two:.4f}'}, CUDA events "
        f"{xcorr_t_ms / ms['xcorr_hits_2s']:.4f} [{card}]")
    # every other path kernel's own device time beside its wrapper's
    # CUDA-event time, its bound and its launches on the main paths; the
    # ASK decode launches the sliding dot once at L=440 and once at L=30
    n_lags_4 = x4.shape[1] - len(pre4) + 1
    rowstats4_bound = bound(x4.numel() * 4 + b * -(-n_lags_4 // 128) * 8,
                            b * n_lags_4 * 4 * len(pre4))
    path_calls = {
        "sliding_dot ask_b16 (L=440)": (ask_calls["sliding_dot"], "sliding_dot_kernel",
                                        ms["sliding_dot"], bounds["sliding_dot"],
                                        launches["sliding_dot"] // 2),
        "sliding_dot dense dots (L=30)": (
            (sdot.sliding_dot_scaled, None, (demod_in, k30, 1.0)), "sliding_dot_kernel",
            sd30_ms, sd30_bound, launches["sliding_dot"] // 2),
        "normalized_xcorr ask_b16 (L=440)": (
            (xn.normalized_xcorr_dense, None, (xa, chirp)), "normalized_xcorr_kernel",
            ms["normalized_xcorr"], bounds["normalized_xcorr"], launches["normalized_xcorr"]),
        "xcorr_rowstats equalized_b32 (L=96)": (
            (xn.xcorr_rowstats, None, (xe, pre)), "xcorr_rowstats_kernel",
            ms["xcorr_rowstats"], bounds["xcorr_rowstats"], launches["xcorr_rowstats"]),
        "xcorr_rowstats fourb5b_b32 (L=60)": (
            (xn.xcorr_rowstats, None, (x4, pre4)), "xcorr_rowstats_kernel", rowstats4_ms,
            rowstats4_bound, 0),
    }
    for k_name in ("attempt_manchester", "attempt_4b5b", "attempt_manchester_fold",
                   "attempt_4b5b_fold", "attempt_manchester_shared",
                   "attempt_manchester_fold_shared", "attempt_4b5b_shared",
                   "attempt_4b5b_fold_shared", "spec_walk", "ask_fire", "ask_chain", "ask_walk"):
        if k_name in ask_calls:
            call = ask_calls[k_name]
        elif k_name in fold_calls:
            kernel, _, call_args, kw = fold_calls[k_name]
            call = (lambda kernel=kernel, call_args=call_args, kw=kw: kernel(*call_args, **kw),
                    None, ())
        elif k_name.endswith("_shared"):
            call = shared_in["4b5b" if "4b5b" in k_name else "manchester"]["calls"][k_name]
        else:
            call = ({"attempt_manchester": lambda: sd.attempt_manchester(
                         x, cand, n_valid, vlens, sync, sync_e),
                     "attempt_4b5b": lambda: sd.attempt_4b5b(
                         x4, cand4, n_valid4, vlens4, sync4, sync_e4),
                     "spec_walk": lambda: sd.spec_walk(
                         phase_a.fields, zeros, no_limit, MAX_FRAMES)}[k_name], None, ())
        kernel_fn = KERNEL_NAMES.get(k_name, k_name).replace("_fold", "").replace("_shared", "")
        path_calls[k_name] = (call, f"{kernel_fn}_kernel", ms[k_name], bounds[k_name],
                              launches[k_name])
    loss = {}
    for what, ((kernel, _, call_args), k_fn, event_ms, bnd, n) in path_calls.items():
        got = device_ms(torch, lambda: kernel(*call_args), k_fn)
        if got is None:
            log(f"phase 4: device time {what}: not measured (no session traced every launch); "
                f"CUDA events around the wrapper {event_ms:.4f} ms, bound {bnd[0]:.6f} ms "
                f"({bnd[1]}) [{card}]")
            continue
        loss[what] = n * (got[0] - bnd[0])
        log(f"phase 4: device time {what}: {got[0]:.4f} ms (all {RUNS} launches traced, session "
            f"{got[1]}); CUDA events around the wrapper {event_ms:.4f} ms; bound {bnd[0]:.6f} ms "
            f"({bnd[1]}); {n} launches on the paths, launches x (device - bound) "
            f"{loss[what]:.4f} ms [{card}]")
    # the attempts' contract: every live slot reads its own window (legacy
    # 60 + 12,624 samples, fold 12,624; 4B5B legacy 60 + 9,600, fold
    # 9,600), once each, beside the bound, which counts the capture once
    for k_name, n_live in (("attempt_manchester", live), ("attempt_manchester_fold", live),
                           ("attempt_manchester_shared", shared_in["manchester"]["live"]),
                           ("attempt_manchester_fold_shared", shared_in["manchester"]["live"]),
                           ("attempt_4b5b", live4), ("attempt_4b5b_fold", live4),
                           ("attempt_4b5b_shared", shared_in["4b5b"]["live"]),
                           ("attempt_4b5b_fold_shared", shared_in["4b5b"]["live"])):
        body = (sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES if "4b5b" in k_name
                else sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES)
        window = body + (0 if "_fold" in k_name else 60)
        log(f"phase 4: {k_name}: contract floor {n_live * window * 4 / HBM_BYTES_PER_S * 1e3:.6f}"
            f" ms ({n_live} live slots x {window} samples, each window read once) beside its "
            f"bound {bounds[k_name][0]:.6f} ms [{card}]")
    log("phase 4: path kernels by launches x (device - bound): "
        + ", ".join(f"{w} {v:.4f}" for w, v in sorted(loss.items(), key=lambda kv: -kv[1]))
        + f" ms [{card}]")
    # the raw sliding dot rounds each product and each sum on its own: two
    # f32 instructions a tap at half the card's 67 TFLOP/s (FMA counted as 2)
    unfused_ms = xa.numel() * len(ask_in["pre"]) * 2 / (F32_OPS_PER_S / 2) * 1e3
    log(f"phase 4: sliding_dot ask_b16 (L=440) unfused floor {unfused_ms:.4f} ms beside its "
        f"bound {bounds['sliding_dot'][0]:.4f} ms [{card}]")
    # the exact scan's record chain, one row a launch: its first row on the
    # first track (phy/ask.py's CHAIN_WINDOW, 4,096 columns) and that row's
    # first 512 columns
    scan_row, scan_base = efc.exact_scan_row(acfg, xa[0])
    for width, v in ((scan_row.shape[1], scan_row), (512, scan_row[:, :512].contiguous())):
        def chain_row(v=v):
            return ask.ask_chain(v, scan_base, acfg.peak_guard)

        got = device_ms(torch, chain_row, "ask_chain_kernel")
        traced = ("not measured (no session traced every launch)" if got is None
                  else f"{got[0]:.4f} ms (all {RUNS} launches traced, session {got[1]})")
        row_plain = time_ms(torch, lambda v=v: ask.ask_chain_plain(v, scan_base, acfg.peak_guard))
        log(f"phase 4: device time ask_chain exact scan row ({width} columns): {traced}; CUDA "
            f"events around the wrapper {time_ms(torch, chain_row):.4f} ms, plain "
            f"{row_plain:.4f} ms; fires {bool(chain_row()[0][0])} [{card}]")
    # yardsticks, each one PyTorch call that computes only part of its
    # kernel's function: torch.cummax of the chain rows (the running maximum
    # alone) and max_pool1d (kernel w, stride 1) of the masked rows (the
    # window maxima alone)
    w_fire = acfg.peak_guard + 1
    masked_a = torch.where(ask_in["upd_ok"], ask_in["sync"], -np.inf)[:, None]
    cummax_ms = time_ms(torch, lambda: ask_in["vals"].cummax(-1))
    pool_ms = time_ms(torch, lambda: torch.nn.functional.max_pool1d(masked_a, w_fire, 1))
    log(f"phase 4: yardsticks, each only part of its kernel's function: ask_chain "
        f"torch.cummax of the {ask_in['vals'].shape[0]} x {ask_in['vals'].shape[1]} rows "
        f"{cummax_ms:.4f} ms; ask_fire max_pool1d (kernel {w_fire}, stride 1) of the masked "
        f"{masked_a.shape[0]} x {masked_a.shape[2]} rows {pool_ms:.4f} ms [{card}]")
    del masked_a
    xk = torch.ones((8, 128), dtype=torch.float32, device=dev)
    ms["seq_probe"] = time_ms(torch, lambda: hp.seq_probe(xk))
    plain_ms["seq_probe"] = time_ms(torch, lambda: hp.seq_probe_plain(xk))
    bounds["seq_probe"] = probe_bound()
    ms["attempt_sum"] = time_ms(torch, lambda: sd.attempt_manchester(
        x, cand, n_valid, vlens, sync, sync_e))
    plain_ms["attempt_sum"] = time_ms(torch, lambda: sd.attempt_manchester_plain(
        x, cand, n_valid, vlens, sync, sync_e))
    bounds["attempt_sum"] = bounds["attempt_manchester"]
    for k_name in ("seq_probe", "xcorr_hits_2s", "attempt_sum"):
        log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms, "
            f"bound {bounds[k_name][0]:.6f} ms ({bounds[k_name][1]}) [{card}]")
    # the tools' kernels whose time is a launch, each beside an empty kernel
    # at its grid: the window probe (#12), the offset add's forms (#14), and
    # the grids of the attempt tiles (#13) and the two streams (#15)
    xo, to = exp_in["offset"]
    n_tiles_13 = -(-et.NV // et.GROUP)
    # (what, call, kernel, its grid, the first design's grid or None)
    launch_calls = (
        ("seq_probe (#12)", lambda: hp.seq_probe(xk), "seq_probe_kernel", epo.PROBE_GRID,
         epo.PROBE_FIRST_GRID),
        *((f"offset_add {form} (#14)", lambda form=form: eo.offset_add(form, xo, to),
           f"offset_add_{form.lower()}_kernel", epo.OFFSET_GRIDS[form],
           epo.OFFSET_FIRST_GRIDS[form]) for form in eo.FORMS),
        ("attempt_tiles noop (#13)", lambda: et.attempt_tiles("noop", *exp_in["tiles"]),
         "attempt_tiles_kernel", (exp_in["tiles"][0].shape[0] * n_tiles_13, 128), None),
        ("xcorr_hits_2s (#15)", lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR, streams=streams_t),
         "xcorr_hits_2s_kernel", (xt.shape[0] * n_tiles_t, 128), None))

    def empty_ms(grid):
        none = device_ms(torch, lambda g=grid[0], n=grid[1]: empty(g, n), "empty_kernel")
        return "not measured" if none is None else f"{none[0]:.4f} ms"

    for what, fn, kernel, grid, first in launch_calls:
        got = device_ms(torch, fn, kernel)
        log(f"phase 4: device time {what}: "
            + ("not measured" if got is None else f"{got[0]:.4f} ms")
            + f"; an empty kernel at its grid ({grid[0]} x {grid[1]}): {empty_ms(grid)}"
            + ("" if first is None else f", at the first design's grid ({first[0]} x "
               f"{first[1]}): {empty_ms(first)}") + f" [{card}]")
    stage_fns = pf.stages(cfg, x, vlens)
    stage_fns["xcorr+extract+attempt (fold on)"] = lambda xx: pf.attempt_sum(cfg, xx, vlens, True)
    for stage, fn in stage_fns.items():
        mn, med = pf.time_stage(fn, x, pf.ITERS)
        log(f"phase 4: profiler manchester_b32 {stage:32s} min {mn:.4f} ms, median {med:.4f} ms "
            f"({pf.ITERS} calls back to back, 3 repeats) [{card}]")

    # the experiments: every attempt-tile variant checked in phase 1 and
    # every offset-add form against its plain version and its bound; beside
    # them, torch.bmm of the attempt tiles' body products and, for offset
    # add, torch.matmul and the sliced add (two calls)
    xt13, *tables13 = exp_in["tiles"]
    for variant in TILE_CHECKS:
        k_ms = time_ms(torch, lambda: et.attempt_tiles(variant, xt13, *tables13), runs=10)
        p_ms = time_ms(torch, lambda: et.attempt_tiles_plain(variant, xt13, *tables13), runs=3)
        got = device_ms(torch, lambda: et.attempt_tiles(variant, xt13, *tables13),
                        "attempt_tiles_kernel")
        bnd = tiles_bound(et, variant, exp_in["tiles"])
        at_f32 = (f", at the f32 rate {tiles_bound(et, variant, exp_in['tiles'], False)[0]:.4f} "
                  "ms" if variant.startswith("bf16b") else "")
        log(f"phase 4: attempt_tiles {variant}: kernel {k_ms:.4f} ms "
            f"({k_ms * 1e3 / (xt13.shape[0] * et.NV):.3f} us a candidate), device "
            + ("not measured" if got is None else f"{got[0]:.4f} ms")
            + f", plain {p_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}){at_f32} [{card}]")
        if variant == "base":
            ms["attempt_tiles"], plain_ms["attempt_tiles"], bounds["attempt_tiles"] = k_ms, p_ms, bnd
    spec13 = et.parse_variant("base")
    best13 = et.sync_plain(spec13, *exp_in["tiles"][:3])[3]
    c13 = torch.arange(et.NV, device=dev)
    rows13 = (9 * (c13 % 8) + c13 % 2)[:, None] + torch.arange(et.BROWS + 1, device=dev)
    lhs = xt13[:, rows13].reshape(-1, et.BROWS + 1, et.DROW)
    o2 = (53 * c13 + best13) % et.DROW
    rhs = tables13[2][(o2 % 8)[..., None], (o2 - o2 % 8)[..., None] + torch.arange(
        et.DROW, device=dev)].reshape(-1, et.DROW, 256)
    bmm_ms = time_ms(torch, lambda: torch.bmm(lhs, rhs), runs=10)
    log(f"phase 4: attempt_tiles yardstick: torch.bmm of the base body products "
        f"({lhs.shape[0]} x [{et.BROWS + 1}, {et.DROW}] @ [{et.DROW}, 256], TF32 off) "
        f"{bmm_ms:.4f} ms [{card}]")
    del lhs, rhs
    xo, to = exp_in["offset"]
    for form in eo.FORMS:
        k_ms = time_ms(torch, lambda: eo.offset_add(form, xo, to))
        p_ms = time_ms(torch, lambda: eo.offset_add_plain(form, xo, to))
        bnd = offset_bound(form)
        log(f"phase 4: offset_add {form}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{bnd[0]:.6f} ms ({bnd[1]}) [{card}]")
        if form == "A":
            ms["offset_add"], plain_ms["offset_add"], bounds["offset_add"] = k_ms, p_ms, bnd

    def matmul_add():
        o = xo @ to
        return o[0:32, :128] + o[1:33, 128:]

    library_ms["offset_add"] = time_ms(torch, matmul_add)
    log(f"phase 4: offset_add A yardstick: torch.matmul + the sliced add (two calls, TF32 off) "
        f"{library_ms['offset_add']:.4f} ms [{card}]")
    # registers and spills last: cuobjdump runs as a child process, and the
    # profiler's sessions after one lose their last launches
    for src in ("sliding_dot", "xcorr_norm", "xcorr_hits", "spec_walk", "attempt_manchester",
                "attempt_4b5b", "ask_walk", "ask_fire", "ask_chain", "attempt_tiles",
                "xcorr_streams", "seq_probe", "offset_add"):
        for fn_name, res in kernel_resources(_build, src).items():
            require(res["LOCAL"] == 0, f"{fn_name} in {src}.cu spills ({res})")
            log(f"phase 4: {src}.cu {fn_name}: {res['REG']} registers, {res['LOCAL']} bytes of "
                f"local memory (spills), {res['SHARED']} bytes of static shared memory, "
                f"{res['STACK']} bytes of stack (cuobjdump -res-usage); in its SASS "
                + ", ".join(f"{res[op]} {op}" for op in SASS_OPS) + " (cuobjdump -sass)")

    replaces = {
        "seq_probe": "bench.py:200",
        "attempt_tiles": "tools/exp_attempt_tiles.py:35",
        "offset_add": "tools/exp_offset_add.py:24/30/41",
        "xcorr_hits_2s": "tools/exp_xcorr_streams.py:50",
        "attempt_sum": "tools/prof_fused.py:123",
        "xcorr_hits": "trackmaker_tpu/sync/pallas_xcorr.py:148",
        "attempt_manchester": "trackmaker_tpu/phy/pallas_decode.py:207",
        "attempt_4b5b": "trackmaker_tpu/phy/pallas_decode.py:409",
        "spec_walk": "trackmaker_tpu/phy/pallas_decode.py:609",
        "sliding_dot": "trackmaker_tpu/sync/pallas_xcorr.py:93",
        "ask_fire": "trackmaker_tpu/phy/ask_spec.py:64",
        "ask_chain": "trackmaker_tpu/phy/ask_spec.py:221",
        "ask_walk": "trackmaker_tpu/phy/ask_spec.py:455",
        "xcorr_rowstats": "trackmaker_tpu/sync/pallas_xcorr.py:640",
        "normalized_xcorr": "trackmaker_tpu/sync/pallas_xcorr.py:93",
        "xcorr_hits_refine": "trackmaker_tpu/sync/pallas_xcorr.py:298",
        "xcorr_hits_batched": "trackmaker_tpu/sync/pallas_xcorr.py:513",
        # the fold_sync branches of the attempt kernels
        "attempt_manchester_fold": "trackmaker_tpu/phy/pallas_decode.py:207",
        "attempt_4b5b_fold": "trackmaker_tpu/phy/pallas_decode.py:409",
        # the shared_x branches (bx = 0 if shared_x else b), legacy and fold
        "attempt_manchester_shared": "trackmaker_tpu/phy/pallas_decode.py:219",
        "attempt_manchester_fold_shared": "trackmaker_tpu/phy/pallas_decode.py:219",
        "attempt_4b5b_shared": "trackmaker_tpu/phy/pallas_decode.py:419",
        "attempt_4b5b_fold_shared": "trackmaker_tpu/phy/pallas_decode.py:419",
    }
    print(json.dumps({"kernels": [
        {"name": k_name, "route": "cuda",
         "source": f"trackmaker_tpu_torch/csrc/{SOURCES.get(k_name, k_name)}.cu",
         "replaces": replaces[k_name], "launches": launches[k_name],
         "max_abs_err": errs[k_name], "ms": ms[k_name], "plain_ms": plain_ms[k_name],
         "bound_ms": bounds[k_name][0], "bound_by": bounds[k_name][1],
         # the sliding dot has one PyTorch call computing the same function
         # (conv1d), the normalized correlation two (conv1d for the dot and
         # for the energy), offset add two (matmul and the sliced add); none
         # computes any of the others
         "library_ms": library_ms.get(k_name)}
        for k_name in ms]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
