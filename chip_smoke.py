#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``trackmaker_tpu_torch``) on one card.

Run from the repository root on a machine with one NVIDIA Hopper card,
PyTorch built for CUDA and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (non-zero exit):

0. setup: TF32 off, the card's name and power limit, the kernels built
   from ``trackmaker_tpu_torch/csrc``;
1. each kernel against its plain PyTorch version on the card, at the
   flagship shapes (32 captures x 433,464 samples, 128 candidates);
2. the flagship decode through ``decode_capture_fast``: 32 noisy captures
   of 64 Manchester frames (128-byte payloads, 200-sample gaps, noise
   sigma 0.05), with a payload gate, every row ``ok``, agreement with the
   exact scan on two rows, and every kernel's launch count raised;
3. the fallback: a capture that overflows the candidate table goes to the
   exact scan on the card, and the merged batch equals the exact scan;
4. timings with CUDA events (median of 30 runs after warm-up) of each
   kernel against its plain version and of ``decode_capture_spec`` end
   to end, each printed beside the card's name and power limit.

The line before the last is a JSON object with the kernels' measurements;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 64
BATCH = 32
PAYLOAD = 128
GAP = 200
NOISE = 0.05
MAX_FRAMES = N_FRAMES + 8
LOCAL_ADDR = 2
CORR_ATOL = 1e-5    # summation order differs between kernel and plain version
RUNS = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def flagship_captures(seed: int):
    """The bench's manchester_b32 input: frames and 32 noisy captures."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    from trackmaker_tpu_torch import PhyConfig

    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i & 0xFF, 1, 2,
                             rng.integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes())
              for i in range(N_FRAMES)]
    wave = PhyEncoder(PhyConfig()).encode_frames(frames, gap_samples=GAP).numpy()
    t = len(wave)
    caps = wave[None] + rng.normal(0, NOISE, (BATCH, t)).astype(np.float32)
    return frames, caps.astype(np.float32)


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
    from trackmaker_tpu_torch.phy import spec_decode as sd
    from trackmaker_tpu_torch.phy.decoder import (
        decode_capture, decode_capture_fast, decode_captures)
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy
    from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits, xcorr_hits_plain

    # --- phase 0: setup ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for path in _build.build_all():
        log(f"built {path.name}")
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s")

    cfg = PhyConfig()
    frames, caps = flagship_captures(args.seed)
    x = torch.from_numpy(caps).to(dev)
    b, t = x.shape
    log(f"flagship input: {b} x {t} samples, {N_FRAMES} frames per capture")
    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    sync_e = preamble_energy(sync)
    vlens = torch.full((b,), t, dtype=torch.int32, device=dev)
    errs = {}

    # --- phase 1: kernels against their plain versions -------------------------
    corr_k, rows_k = xcorr_hits(x, pre, cfg.correlation_threshold, emit_corr=True)
    torch.cuda.synchronize()
    corr_p, rows_p = xcorr_hits_plain(x, pre, cfg.correlation_threshold, emit_corr=True)
    err = (corr_k - corr_p).abs().max().item()
    require(err <= CORR_ATOL, f"xcorr_hits corr differs by {err}")
    _, rows_main = xcorr_hits(x, pre, cfg.correlation_threshold)
    require(torch.equal(rows_main, rows_k), "xcorr_hits rows depend on emit_corr")
    # a lag within CORR_ATOL of the threshold may fall on either side of it;
    # every other lag must give the same hits
    near = (corr_p - cfg.correlation_threshold).abs() < CORR_ATOL
    n_rows = rows_k.shape[1]
    near_rows = torch.nn.functional.pad(near, (0, n_rows * 128 - near.shape[1]))
    near_rows = near_rows.reshape(b, n_rows, 128).any(-1)
    same = (rows_k[..., :5] == rows_p[..., :5]).all(-1) & (rows_k[..., 9:] == rows_p[..., 9:]).all(-1)
    require(bool((same | near_rows).all()), "xcorr_hits hit rows differ away from the threshold")
    hit_vals = rows_k[..., 5:9].contiguous().view(torch.float32)
    hit_vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    val_err = (hit_vals - hit_vals_p)[same].abs().max().item()
    require(val_err <= CORR_ATOL, f"xcorr_hits hit corr differs by {val_err}")
    errs["xcorr_hits"] = max(err, val_err)
    log(f"phase 1: xcorr_hits == plain (corr max |err| {err:.3g}, hit corr "
        f"{val_err:.3g}, {int(near.sum())} lags within {CORR_ATOL} of the threshold, "
        f"{int((~same).sum())} rows differing there)")

    cand, _, n_valid, _ = sd.compact_hit_rows(rows_k, 128)
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

    rng = np.random.default_rng(args.seed + 17)
    walk_err = 0
    tables = []
    for cap in (1, 2, 5, 72, 128, 256):
        pos = np.full((b, 128), 2**30, np.int64)
        for r in range(b):
            k = int(rng.integers(0, 129))
            pos[r, :k] = np.sort(rng.integers(0, 40_000, k))
        fields = np.stack([pos, rng.integers(1, 3000, (b, 128)),
                           rng.random((b, 128)) < 0.25, rng.random((b, 128)) < 0.6],
                          axis=1).astype(np.int32)
        cur0 = rng.integers(0, 30_000, b).astype(np.int32)
        limit = rng.choice([20_000, 41_000, 2**30], b).astype(np.int32)
        tables.append((torch.from_numpy(fields).to(dev), torch.from_numpy(cur0).to(dev),
                       torch.from_numpy(limit).to(dev), cap))
    phase_a = sd.spec_phase_a(cfg, x, LOCAL_ADDR, 128, vlens)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    no_limit = torch.full((b,), 2**30, dtype=torch.int32, device=dev)
    tables.append((phase_a.fields, zeros, no_limit, MAX_FRAMES))
    for fields, cur0, limit, cap in tables:
        got = sd.spec_walk(fields, cur0, limit, cap)
        torch.cuda.synchronize()
        want = sd.spec_walk_plain(fields, cur0, limit, cap)
        for field, g, w in zip(got._fields, got, want):
            require(torch.equal(g, w), f"spec_walk {field} differs (max_frames {cap})")
            walk_err = max(walk_err, (g.long() - w.long()).abs().max().item())
    errs["spec_walk"] = walk_err
    log(f"phase 1: spec_walk == plain on {len(tables)} tables "
        "(random ones with caps 1..256, and the flagship's)")

    # --- phase 2: the flagship main path -------------------------------------
    kernels = (xcorr_hits, sd.attempt_manchester, sd.spec_walk)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = decode_capture_fast(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    log(f"phase 2: decode_capture_fast took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    for k_name, n in launches.items():
        require(n > 0, f"the main path never launched {k_name}")
    counts = res.count.cpu().numpy()
    require(bool((counts == N_FRAMES).all()), f"count gate failed: {sorted(set(counts.tolist()))}")
    fb = res.frame_bytes.cpu().numpy()
    valid = res.valid.cpu().numpy()
    for r in range(b):
        for k, f in zip(np.nonzero(valid[r])[0], frames):
            require(fb[r, k, 7:7 + PAYLOAD].tobytes() == f.data,
                    f"payload gate failed at row {r} slot {k}")
    spec_res, ok = sd.decode_capture_spec(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(bool(ok.all()), "a flagship row overflowed its candidate table")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            "decode_capture_fast differs from decode_capture_spec with every row ok")
    for r in (0, b - 1):
        exact = decode_capture(cfg, x[r], LOCAL_ADDR, MAX_FRAMES)
        require(frame_list(res, r) == frame_list(exact), f"row {r} differs from the exact scan")
        corr_gap = (res.corr[r][res.valid[r]] - exact.corr[exact.valid]).abs().max().item()
        require(corr_gap <= CORR_ATOL, f"row {r} corr differs from the exact scan by {corr_gap}")
    log(f"phase 2: payload gate passed ({b} rows x {N_FRAMES} frames), every row ok, "
        "rows 0 and 31 equal the exact scan")

    # --- phase 3: the fallback ---------------------------------------------
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    enc = PhyEncoder(cfg)
    tail = enc.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 20) for i in range(3)],
                             gap_samples=300)
    crowded = torch.cat([torch.from_numpy(pre).repeat(150), torch.zeros(500), tail])
    clean = torch.cat([tail, torch.zeros(crowded.shape[0] - tail.shape[0])])
    small = torch.stack([crowded, clean]).to(dev)
    _, small_ok = sd.decode_capture_spec(cfg, small, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(small_ok.tolist() == [False, True], f"fallback flags {small_ok.tolist()}")
    merged = decode_capture_fast(cfg, small, LOCAL_ADDR, max_frames=MAX_FRAMES)
    exact = decode_captures(cfg, small, LOCAL_ADDR, MAX_FRAMES, [small.shape[1]] * 2)
    require(all(torch.equal(p[0], q[0]) for p, q in zip(merged, exact)),
            "the fallback row differs from the exact scan")
    require(frame_list(merged, 1) == frame_list(exact, 1), "the clean row differs from the exact scan")
    require(int(merged.count[0]) == 3 and int(merged.count[1]) == 3, "fallback frames lost")
    log(f"phase 3: fallback row (150 back-to-back preambles) re-decoded by the exact "
        f"scan on the card; merged batch equals it ({merged.count.tolist()} frames)")

    # --- phase 4: timings ------------------------------------------------------
    ms = {
        "xcorr_hits": time_ms(torch, lambda: xcorr_hits(x, pre, cfg.correlation_threshold)),
        "attempt_manchester": time_ms(torch, lambda: sd.attempt_manchester(
            x, cand, n_valid, vlens, sync, sync_e)),
        "spec_walk": time_ms(torch, lambda: sd.spec_walk(
            phase_a.fields, zeros, no_limit, MAX_FRAMES)),
    }
    plain_ms = {
        "xcorr_hits": time_ms(torch, lambda: xcorr_hits_plain(
            x, pre, cfg.correlation_threshold)),
        "attempt_manchester": time_ms(torch, lambda: sd.attempt_manchester_plain(
            x, cand, n_valid, vlens, sync, sync_e)),
        "spec_walk": time_ms(torch, lambda: sd.spec_walk_plain(
            phase_a.fields, zeros, no_limit, MAX_FRAMES)),
    }
    for k_name in ms:
        log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms "
            f"[{card}]")
    steps = {
        "compact_hit_rows": time_ms(torch, lambda: sd.compact_hit_rows(rows_main, 128)),
        "spec_phase_a": time_ms(torch, lambda: sd.spec_phase_a(
            cfg, x, LOCAL_ADDR, 128, vlens)),
        "spec_compact": time_ms(torch, lambda: sd.spec_compact(
            phase_a, sd.spec_walk(phase_a.fields, zeros, no_limit, MAX_FRAMES).keep,
            MAX_FRAMES)),
    }
    for step, v in steps.items():
        log(f"phase 4: step {step}: {v:.4f} ms [{card}]")
    e2e = time_ms(torch, lambda: sd.decode_capture_spec(
        cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES))
    rt = b * t / cfg.sample_rate / (e2e / 1e3)
    log(f"phase 4: decode_capture_spec {b} x {t}: {e2e:.4f} ms, {rt:.1f}x real time "
        f"[{card}]")
    torch.cuda.reset_peak_memory_stats()
    sd.decode_capture_spec(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    torch.cuda.synchronize()
    log(f"phase 4: decode_capture_spec peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")

    replaces = {
        "xcorr_hits": "trackmaker_tpu/sync/pallas_xcorr.py:148",
        "attempt_manchester": "trackmaker_tpu/phy/pallas_decode.py:207",
        "spec_walk": "trackmaker_tpu/phy/pallas_decode.py:609",
    }
    print(json.dumps({"kernels": [
        {"name": k_name, "route": "cuda",
         "source": f"trackmaker_tpu_torch/csrc/{k_name}.cu",
         "replaces": replaces[k_name], "launches": launches[k_name],
         "max_abs_err": errs[k_name], "ms": ms[k_name], "plain_ms": plain_ms[k_name]}
        for k_name in ms]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
