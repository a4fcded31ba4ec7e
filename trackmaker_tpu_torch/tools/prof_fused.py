"""The flagship stage profiler (counterpart of ``tools/prof_fused.py``).

It times the speculative decode's stages one cumulative prefix at a time,
on the tool's corpus (``build_corpus``: 64 frames of random 128-byte
payloads, gap 200, 32 captures with noise sigma 0.05):

    xcorr only              the hit rows (kernel #1)
    xcorr+extract           then compact_hit_rows
    xcorr+refine            the hit rows with the fused sync refine (kernel #6)
    phase_a                 spec_phase_a: correlation, compaction, attempt, epilogue
    full spec decode        decode_capture_spec, max_frames 72
    xcorr+extract+attempt   attempt_sum: the attempt kernel alone (Manchester)
    phase_a+walk            then the walk (kernel #4)
    phase_a+walk+compact    then spec_compact

Two of the JAX tool's stages are left out: ``xcorr bf16``, because the
port has no bf16 path (every kernel sums in f32, ROADMAP's hazards), and
``xcorr blk=...``, because the port's kernel #1 has a fixed tile and no
``blk``.

``time_stage`` makes `iters` calls back to back between two CUDA events,
one host sync a repeat.  The JAX tool fed each call ``x + i * 1e-30`` and
summed every output leaf, so that XLA could neither hoist the call out of
its loop nor drop an unused output; eager PyTorch runs every call it is
given, so neither is done here.

    python -m trackmaker_tpu_torch.tools.prof_fused [encoding] [iters]

prints the tool's header line, the stages left out, then one line per
stage (min and median ms a call), beside the card's name and power limit.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import MANCHESTER, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import BIGI, xcorr_hits, xcorr_hits_refine
from trackmaker_tpu_torch.tools.health import card_line, time_calls

N_FRAMES, BATCH, PAYLOAD, GAP, NOISE = 64, 32, 128, 200, 0.05
N_CAND = 128
LOCAL_ADDR = 2
MAX_FRAMES = 72
ITERS = 10
LEFT_OUT = {
    "xcorr bf16": "the port has no bf16 path: every kernel sums in f32",
    "xcorr blk=8192/32768/65536": "the port's kernel #1 has a fixed tile and no blk",
}


def build_corpus(cfg: PhyConfig, device, seed: int = 0, n_frames: int = N_FRAMES,
                 batch: int = BATCH):
    """(frames, captures f32[batch, T] on `device`): the tool's corpus."""
    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i & 0xFF, 1, 2, rng.integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    wave = PhyEncoder(cfg, device=device).encode_frames(frames, gap_samples=GAP)
    t = wave.shape[0]
    noise = np.stack([rng.normal(0, NOISE, t).astype(np.float32) for _ in range(batch)])
    return frames, (wave[None] + torch.from_numpy(noise).to(wave.device)).contiguous()


def _refine_kw(cfg: PhyConfig) -> dict:
    return dict(sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
                n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len, fall_off=cfg.preamble_len)


def attempt_sum(cfg: PhyConfig, x: torch.Tensor, vlens: torch.Tensor, fold: bool):
    """The attempt-only stage: candidate extraction, then the Manchester
    attempt kernel alone, its raw (bytes, fs) kept, with no epilogue, walk
    or compaction.  With the fold off: xcorr_hits, compact_hit_rows,
    attempt_manchester; on: xcorr_hits_refine, compact_hit_rows(with_fs=True),
    attempt_manchester_fold."""
    if cfg.line_coding != MANCHESTER:
        raise ValueError("the attempt-only stage is the Manchester decode's")
    pre = line_coding.preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    if fold:
        rows = xcorr_hits_refine(x, vlens, pre, sync, thr, **_refine_kw(cfg))
        _, _, n_valid, _, fs = sd.compact_hit_rows(rows, N_CAND, with_fs=True)
        return sd.attempt_manchester_fold(x, fs, n_valid)
    _, rows = xcorr_hits(x, pre, thr)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, N_CAND)
    return sd.attempt_manchester(x, cand, n_valid, vlens, sync, preamble_energy(sync))


def stages(cfg: PhyConfig, x: torch.Tensor, vlens: torch.Tensor) -> dict:
    """The tool's stages in its order, name -> function of the captures,
    for captures like x f32[B, T] with valid lengths vlens int32[B]; the
    attempt-only stage (Manchester only) in the fold mode in effect."""
    if not sd.spec_supported_cfg(cfg):
        raise ValueError("the stages are the speculative decode's, for its configurations")
    if x.ndim != 2 or tuple(vlens.shape) != (x.shape[0],) or vlens.device != x.device:
        raise ValueError("x must be f32[B, T] and vlens int32[B] on its device")
    b = x.shape[0]
    pre = line_coding.preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    fold = sd._resolve_fold()
    zeros = torch.zeros(b, dtype=torch.int32, device=x.device)
    no_limit = torch.full((b,), BIGI, dtype=torch.int32, device=x.device)

    def xcorr_only(xx):
        return xcorr_hits(xx, pre, thr)[1]

    def phase_a(xx):
        return sd.spec_phase_a(cfg, xx, LOCAL_ADDR, N_CAND, vlens)

    def phase_a_walk(xx):
        a = phase_a(xx)
        return a, sd.spec_walk(a.fields, zeros, no_limit, MAX_FRAMES).keep

    out = {
        "xcorr only": xcorr_only,
        "xcorr+extract": lambda xx: sd.compact_hit_rows(xcorr_only(xx), N_CAND),
        "xcorr+refine": lambda xx: xcorr_hits_refine(xx, vlens, pre, sync, thr,
                                                     **_refine_kw(cfg)),
        "phase_a": phase_a,
        "full spec decode": lambda xx: sd.decode_capture_spec(cfg, xx, LOCAL_ADDR,
                                                              max_frames=MAX_FRAMES),
    }
    if cfg.line_coding == MANCHESTER:
        out["xcorr+extract+attempt"] = lambda xx: attempt_sum(cfg, xx, vlens, fold)
    out["phase_a+walk"] = lambda xx: phase_a_walk(xx)[1]
    out["phase_a+walk+compact"] = lambda xx: sd.spec_compact(*phase_a_walk(xx), MAX_FRAMES).valid
    return out


def time_stage(fn, x: torch.Tensor, iters: int, repeats: int = 3) -> tuple[float, float]:
    """(min, median) ms a call of fn(x) over `repeats` runs of `iters`
    calls back to back (see the module docstring)."""
    per_call = time_calls(lambda: fn(x), x.device, iters, repeats)
    return min(per_call) * 1e3, statistics.median(per_call) * 1e3


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    enc_name = argv[0] if argv else MANCHESTER
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    if not torch.cuda.is_available():
        raise SystemExit("the profiler needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    cfg = PhyConfig(line_coding=enc_name)
    _, x = build_corpus(cfg, "cuda")
    b, t = x.shape
    vlens = torch.full((b,), t, dtype=torch.int32, device=x.device)
    print(f"enc={enc_name} t={t} batch={b} total={b * t / 1e6:.1f}M iters={iters} [{card}]",
          flush=True)
    for name, why in LEFT_OUT.items():
        print(f"{name:24s} left out: {why}", flush=True)
    for name, fn in stages(cfg, x, vlens).items():
        mn, med = time_stage(fn, x, iters)
        print(f"{name:24s} {mn:8.4f} ms  (med {med:.4f})  [{card}]", flush=True)


if __name__ == "__main__":
    main()
