"""What holds the walks and the attempts back: variants of the consumption
walk (kernel #4, ``csrc/spec_walk.cu``), the Manchester attempt (kernel #3,
``csrc/attempt_manchester.cu``), the 4B5B attempt (kernel #5,
``csrc/attempt_4b5b.cu``) and the ASK frame walk (kernel #11,
``csrc/ask_walk.cu``), built for the run from patched copies of the kept
sources, timed on the card beside the kept designs.

    python -m trackmaker_tpu_torch.tools.exp_walk_attempt [runs]

The variants (:data:`VARIANTS`, each a list of replacements in the kept
source, every anchor required):

* walk ``chase``: one lane chases the successor table over the chain's
  nodes (at most min(max_frames, C) dependent shared loads) in place of
  pointer doubling;
* attempt ``persistent``: the rows of their own too on the persistent
  grid (as many blocks as are resident, each walking the slots) in place
  of a block a slot;
* attempt ``global``: the body decoded straight from device memory with
  six scalar loads a lane at a lane stride of 24 bytes (the first
  design's loads) and no body copy;
* attempt ``scalar``: six scalar shared loads a lane in place of three
  float2 (two-way bank conflicts);
* attempt ``nocopy`` and ``nodecode``, which take out the copies (the
  decode reads a stale stage) and the decode (the bytes are not written):
  what is left of the time without each, their outputs not checked;
* 4B5B attempt ``global``: each lane reads its symbol's 15 samples and the
  level before them straight from device memory (the first design's
  loads, 60 bytes apart from lane to lane) and no body copies;
* 4B5B attempt ``serial``: the body's copies issued only once the refine
  is done, so nothing overlaps the refine;
* 4B5B attempt ``nocopy`` and ``nodecode``, as for the Manchester attempt
  (``nodecode`` still waits for each copy);
* ASK walk ``chase``: one lane steps the step function slot by slot (the
  first design's serial chase, from the staged table) in place of binary
  lifting;
* ASK walk ``stageonly``: the table staged and the step function built,
  then nothing (its outputs not checked);

and ``empty``, an empty kernel at each walk's grid (a block of 128 threads
a capture for the consumption walk, of 256 for the ASK walk): each walk's
practical floor.  On the tool's corpora (``prof_fused.build_corpus``: 32
captures of 64 frames, 128 candidates, Manchester and 4B5B; the ASK walk
on ask_b16's table: 16 tracks of 64 frames, 97 candidate rows, 72 slots),
each variant's outputs must equal the plain version's; then each one's
device time (torch.profiler, median of `runs` launches, default 30, from a
session that traced every launch) prints between two readings of the
kept design's, one before every variant and one after, with the card's
name and power limit.  The variants are built into
``build/trackmaker_tpu_torch/exp/`` and loaded in place of the kept
library for their turn only.  Needs a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.phy import ask, ask_spec, line_coding
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.tools import prof_fused as pf
from trackmaker_tpu_torch.tools.health import card_line

xh = importlib.import_module("trackmaker_tpu_torch.sync.xcorr_hits")   # the module

RUNS = 30
UNCHECKED = {"nocopy", "nodecode", "stageonly"}   # variants whose outputs differ by design
SESSIONS = 3            # profiling sessions a device time may take
EXP_DIR = _build.BUILD_DIR / "exp"
WALK_THREADS = 128      # the walk's block at the corpus's 128 candidates
ASK_WALK_THREADS = 256  # the ASK walk's block
ASK_TRACKS, ASK_FRAMES, ASK_MAX_FRAMES = 16, 64, 72   # chip_smoke.py's ask_b16
SOURCES = ("spec_walk", "attempt_manchester", "attempt_4b5b", "ask_walk")

# (start anchor, end anchor, replacement): the text from the start anchor
# through the end anchor is replaced
VARIANTS = {
    ("spec_walk", "chase"): [(
        "  int src = 0;\n  for (int step = 1; step < reach; step <<= 1) {",
        "    src ^= 1;\n  }\n",
        "  if (tid == 0) {\n"
        "    int ptr = s0;\n"
        "    for (int d = 0; d < reach && ptr < n_cand; ++d) {\n"
        "      dist[ptr] = d;\n"
        "      ptr = jump[ptr];\n"
        "    }\n"
        "  }\n"
        "  __syncthreads();\n")],
    ("attempt_manchester", "persistent"): [(
        "  const int blocks = x_stride == 0 ? min(n_slots, resident) : n_slots;",
        "  const int blocks = x_stride == 0 ? min(n_slots, resident) : n_slots;",
        "  const int blocks = min(n_slots, resident);")],
    ("attempt_manchester", "global"): [
        ("      copy_to_stage(stage + n_head, src + n_head, (n_bulk - n_head) * 4, &bars[1]);",
         "      copy_to_stage(stage + n_head, src + n_head, (n_bulk - n_head) * 4, &bars[1]);",
         "      copy_to_stage(stage + n_head, src + n_head, 0, &bars[1]);"),
        ("        const float* p6 = stage + o + bit * kBitSamples;",
         "a5 = p6[5];\n        }\n",
         "        const int gi = fs + bit * kBitSamples;\n"
         "        const float a0 = gi < t ? xb[gi] : 0.0f, a1 = gi + 1 < t ? xb[gi + 1] : 0.0f,\n"
         "                    a2 = gi + 2 < t ? xb[gi + 2] : 0.0f, a3 = gi + 3 < t ? xb[gi + 3] : 0.0f,\n"
         "                    a4 = gi + 4 < t ? xb[gi + 4] : 0.0f, a5 = gi + 5 < t ? xb[gi + 5] : 0.0f;\n")],
    ("attempt_manchester", "nocopy"): [(
        "      copy_to_stage(stage, src, n_head * 4, &bars[0]);",
        "      copy_to_stage(stage + n_head, src + n_head, (n_bulk - n_head) * 4, &bars[1]);",
        "      copy_to_stage(stage, src, 0, &bars[0]);\n"
        "      copy_to_stage(stage + n_head, src + n_head, 0, &bars[1]);")],
    ("attempt_manchester", "nodecode"): [(
        "    for (int bit0 = warp * 32; bit0 < kFrameBits; bit0 += kThreads) {",
        "    for (int bit0 = warp * 32; bit0 < kFrameBits; bit0 += kThreads) {",
        "    for (int bit0 = warp * 32; bit0 < 0; bit0 += kThreads) {")],
    ("attempt_manchester", "scalar"): [(
        "        if ((o & 1) == 0) {",
        "a5 = p6[5];\n        }\n",
        "        a0 = p6[0]; a1 = p6[1]; a2 = p6[2]; a3 = p6[3]; a4 = p6[4]; a5 = p6[5];\n")],
    ("attempt_4b5b", "global"): [
        ("    copy_to_stage(stage + from, src + from, (to - from) * 4, &bars[1 + s]);",
         "    copy_to_stage(stage + from, src + from, (to - from) * 4, &bars[1 + s]);",
         "    copy_to_stage(stage + from, src + from, 0, &bars[1 + s]);"),
        ("        const float* p = stage + o + m * kSymbolSamples;",
         "        if (lane == 0) prev = m == 0 ? 1.0f : level_at(p - kLevelSamples);\n",
         "        auto gl = [&](int i) {\n"
         "          return __fadd_rn(__fadd_rn(i < t ? xb[i] : 0.0f, i + 1 < t ? xb[i + 1] : 0.0f),\n"
         "                           i + 2 < t ? xb[i + 2] : 0.0f);\n"
         "        };\n"
         "        const int g = fs + m * kSymbolSamples;\n"
         "        float lv[5];\n"
         "        for (int j = 0; j < 5; ++j) lv[j] = gl(g + j * kLevelSamples);\n"
         "        float prev = m == 0 ? 1.0f : gl(g - kLevelSamples);\n")],
    ("attempt_4b5b", "serial"): [
        ("      copy_body<kFold>(stage, src, n_head, n_bulk, lead, bars);\n",
         "      copy_body<kFold>(stage, src, n_head, n_bulk, lead, bars);\n", ""),
        ("    // symbol m of the frame reads", "    // symbol m of the frame reads",
         "    if (tid == 0) copy_body<kFold>(stage, src, n_head, n_bulk, lead, bars);\n"
         "    // symbol m of the frame reads")],
    ("attempt_4b5b", "nocopy"): [
        ("      copy_to_stage(stage, src, n_head * 4, &bars[0]);",
         "      copy_to_stage(stage, src, n_head * 4, &bars[0]);",
         "      copy_to_stage(stage, src, 0, &bars[0]);"),
        ("    copy_to_stage(stage + from, src + from, (to - from) * 4, &bars[1 + s]);",
         "    copy_to_stage(stage + from, src + from, (to - from) * 4, &bars[1 + s]);",
         "    copy_to_stage(stage + from, src + from, 0, &bars[1 + s]);")],
    ("attempt_4b5b", "nodecode"): [(
        "        const int m = m0 + lane;\n",
        "        packed[s] = (nib << 4) | __shfl_down_sync(0xffffffffu, nib, 1);\n",
        "")],
    ("ask_walk", "chase"): [(
        "    int cur = 0;\n    for (int h = 1; h < n; h <<= 1) {",
        "      cur ^= 1;\n      __syncthreads();\n    }\n",
        "    if (tid == 0) {\n"
        "      for (int k = 1; k < n; ++k) {\n"
        "        const int p = pos[k - 1];\n"
        "        pos[k] = p < c1 ? step[p] : p;\n"
        "      }\n"
        "    }\n"
        "    __syncthreads();\n")],
    ("ask_walk", "stageonly"): [(
        "  int* pk = peaks + static_cast<int64_t>(b) * max_frames;",
        "  if (tid == 0) bad[b] = static_cast<uint8_t>(any != 0);\n",
        "  __syncthreads();\n"
        "  if (tid == 0) bad[b] = static_cast<uint8_t>(flags[c1 - 1] + step[0] + peak[0] != 0);\n")],
}

EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int tm_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def patched(src: str, patches) -> str:
    """csrc/<src>.cu with each (start, end, replacement) applied once."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    for start, end, new in patches:
        i = text.find(start)
        j = text.find(end, i) if i >= 0 else -1
        if i < 0 or j < 0 or text.find(start, i + 1) >= 0:
            raise ValueError(f"csrc/{src}.cu no longer holds the anchor {start!r} .. {end!r} once")
        text = text[:i] + new + text[j + len(end):]
    return text


def build_source(name: str, text: str) -> Path:
    """A library built from `text` (nvcc with the port's flags), named by
    its hash under EXP_DIR."""
    digest = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + text).encode()).hexdigest()[:16]
    out = EXP_DIR / f"{name}-{digest}.so"
    if not out.exists():
        EXP_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(text)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                               "-o", str(out), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    return out


def install(src: str, lib: ctypes.CDLL) -> None:
    """Make the wrappers of csrc/<src>.cu launch from `lib`."""
    _build._loaded[src] = lib
    for key in [k for k in _build._entries if k[0] == src]:
        del _build._entries[key]


def device_ms(fn, kernel: str, runs: int) -> float | None:
    """Median device time (ms) of the kernel whose name holds `kernel` over
    `runs` calls of fn, from the first profiling session that traced every
    launch; None when none did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) == runs:
            return statistics.median(times)
    return None


def ask_fields(device) -> torch.Tensor:
    """ask_b16's successor table int32[16, 6, 97] (``chip_smoke.py``'s ASK
    captures through ``phase_b``)."""
    cfg = ask.AskConfig()
    frames = ask.build_frames(b"the quick brown fox", cfg, num_frames=ASK_FRAMES)
    waves = [ask.build_track(cfg, frames, seed=7 + r) for r in range(ASK_TRACKS)]
    caps = np.zeros((ASK_TRACKS, max(len(w) for w in waves)), np.float32)
    for r, w in enumerate(waves):
        caps[r, :len(w)] = w
    x = torch.from_numpy(caps).to(device)
    power, sync, upd_ok = ask.dense_arrays(cfg, x)
    cand, _, _ = ask_spec.extract_candidates(ask_spec.dense_fire_candidates(cfg, sync, upd_ok), 96)
    virt = torch.full((ASK_TRACKS, 1), -(cfg.frame_samples + 1), dtype=torch.int32, device=device)
    return ask_spec.phase_b(cfg, x, power, sync, upd_ok, torch.cat([virt, cand], dim=1))


def corpus_calls(device):
    """The walks and the attempts' legacy and fold forms on the tool's
    corpora, name -> (kernel call, plain call)."""
    calls = {}
    for cfg in (PhyConfig(), PhyConfig(line_coding="4b5b")):
        _, x = pf.build_corpus(cfg, device)
        b, t = x.shape
        vlens = torch.full((b,), t, dtype=torch.int32, device=device)
        pre = line_coding.preamble_waveform(cfg)
        sync = pre[cfg.preamble_len - cfg.sync_len:]
        thr = cfg.correlation_threshold
        cand, _, n_valid, _ = sd.compact_hit_rows(xh.xcorr_hits(x, pre, thr)[1], pf.N_CAND)
        rows = xh.xcorr_hits_refine(x, vlens, pre, sync, thr, **pf._refine_kw(cfg))
        _, _, n_valid_f, _, fs = sd.compact_hit_rows(rows, pf.N_CAND, with_fs=True)
        legacy = (x, cand, n_valid, vlens, sync, preamble_energy(sync))
        fold = (x, fs, n_valid_f)
        name = "attempt_manchester" if cfg.line_coding == "manchester" else "attempt_4b5b"
        kernel, plain = getattr(sd, name), getattr(sd, f"{name}_plain")
        kernel_f, plain_f = getattr(sd, f"{name}_fold"), getattr(sd, f"{name}_fold_plain")
        calls[name] = (lambda k=kernel, a=legacy: k(*a), lambda p=plain, a=legacy: p(*a))
        calls[f"{name}_fold"] = (lambda k=kernel_f, a=fold: k(*a), lambda p=plain_f, a=fold: p(*a))
        if name == "attempt_manchester":
            fields = sd.spec_phase_a(cfg, x, pf.LOCAL_ADDR, pf.N_CAND, vlens).fields
            zeros = torch.zeros(b, dtype=torch.int32, device=device)
            no_limit = torch.full((b,), 2**30, dtype=torch.int32, device=device)
            calls["spec_walk"] = (
                lambda: sd.spec_walk(fields, zeros, no_limit, pf.MAX_FRAMES),
                lambda: sd.spec_walk_plain(fields, zeros, no_limit, pf.MAX_FRAMES))
    table = ask_fields(device)
    calls["ask_walk"] = (lambda: ask_spec.ask_walk(table, ASK_MAX_FRAMES),
                         lambda: ask_spec.ask_walk_plain(table, ASK_MAX_FRAMES))
    return calls


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else RUNS
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    dev = torch.device("cuda", 0)
    calls = corpus_calls(dev)
    kept = {src: _build.load(src) for src in SOURCES}
    # the kept designs first and again last: their two readings show the drift
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc a variant, all at once
        libs = list(pool.map(lambda kv: build_source(f"{kv[0][0]}-{kv[0][1]}",
                                                     patched(kv[0][0], kv[1])), VARIANTS.items()))
    designs = [(src, "kept", kept[src]) for src in kept] + [
        (src, variant, ctypes.CDLL(str(lib))) for (src, variant), lib in zip(VARIANTS, libs)] + [
        (src, "kept", kept[src]) for src in kept]
    for src, variant, lib in designs:
        install(src, lib)
        for name, (kernel, plain) in calls.items():
            if not name.startswith(src):
                continue
            got = kernel()
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, plain()))
            if not same and variant not in UNCHECKED:
                raise SystemExit(f"{name} {variant} differs from its plain version")
            ms = device_ms(kernel, f"{src}_kernel", runs)
            shown = "not measured" if ms is None else f"{ms:.4f} ms"
            print(f"{name} {variant}: device {shown} (median of {runs}), "
                  f"{'== plain' if same else 'outputs not checked'} [{card}]", flush=True)
        install(src, kept[src])
    empty = ctypes.CDLL(str(build_source("empty", EMPTY_SOURCE))).tm_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    grids = (("the walk's", calls["spec_walk"][1]().att.shape[0], WALK_THREADS),
             ("the ASK walk's", ASK_TRACKS, ASK_WALK_THREADS))
    for what, blocks, threads in grids:
        ms = device_ms(lambda g=blocks, n=threads: _build.check(empty(g, n, stream), "empty"),
                       "empty_kernel", runs)
        shown = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"empty kernel at {what} grid ({blocks} x {threads}): device {shown} "
              f"(median of {runs}) [{card}]", flush=True)


if __name__ == "__main__":
    main()
