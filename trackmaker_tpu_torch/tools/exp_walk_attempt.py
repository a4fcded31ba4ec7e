"""What holds the consumption walk (kernel #4, ``csrc/spec_walk.cu``) and the
Manchester attempt (kernel #3, ``csrc/attempt_manchester.cu``) back:
variants of each, built for the run from patched copies of the kept
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

and ``empty``, an empty kernel at the walk's grid (a block of 128 threads a
capture): the walk's practical floor.  On the tool's corpus
(``prof_fused.build_corpus``: 32 captures of 64 frames, 128 candidates),
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
from pathlib import Path

import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.tools import prof_fused as pf
from trackmaker_tpu_torch.tools.health import card_line

xh = importlib.import_module("trackmaker_tpu_torch.sync.xcorr_hits")   # the module

RUNS = 30
UNCHECKED = {"nocopy", "nodecode"}   # variants whose outputs differ by design
SESSIONS = 3            # profiling sessions a device time may take
EXP_DIR = _build.BUILD_DIR / "exp"
WALK_THREADS = 128      # the walk's block at the corpus's 128 candidates

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


def corpus_calls(device):
    """The walk and the two attempt forms on the tool's corpus, name ->
    (kernel call, plain call)."""
    cfg = PhyConfig()
    _, x = pf.build_corpus(cfg, device)
    b, t = x.shape
    vlens = torch.full((b,), t, dtype=torch.int32, device=device)
    pre = line_coding.preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    cand, _, n_valid, _ = sd.compact_hit_rows(xh.xcorr_hits(x, pre, thr)[1], pf.N_CAND)
    rows = xh.xcorr_hits_refine(x, vlens, pre, sync, thr, **pf._refine_kw(cfg))
    _, _, n_valid_f, _, fs = sd.compact_hit_rows(rows, pf.N_CAND, with_fs=True)
    fields = sd.spec_phase_a(cfg, x, pf.LOCAL_ADDR, pf.N_CAND, vlens).fields
    zeros = torch.zeros(b, dtype=torch.int32, device=device)
    no_limit = torch.full((b,), 2**30, dtype=torch.int32, device=device)
    legacy = (x, cand, n_valid, vlens, sync, preamble_energy(sync))
    return {
        "spec_walk": (lambda: sd.spec_walk(fields, zeros, no_limit, pf.MAX_FRAMES),
                      lambda: sd.spec_walk_plain(fields, zeros, no_limit, pf.MAX_FRAMES)),
        "attempt_manchester": (lambda: sd.attempt_manchester(*legacy),
                               lambda: sd.attempt_manchester_plain(*legacy)),
        "attempt_manchester_fold": (lambda: sd.attempt_manchester_fold(x, fs, n_valid_f),
                                    lambda: sd.attempt_manchester_fold_plain(x, fs, n_valid_f)),
    }


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else RUNS
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    dev = torch.device("cuda", 0)
    calls = corpus_calls(dev)
    kept = {src: _build.load(src) for src in ("spec_walk", "attempt_manchester")}
    # the kept designs first and again last: their two readings show the drift
    designs = [(src, "kept", kept[src]) for src in kept] + [
        (src, variant, ctypes.CDLL(str(build_source(f"{src}-{variant}", patched(src, p)))))
        for (src, variant), p in VARIANTS.items()] + [(src, "kept", kept[src]) for src in kept]
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
    b = calls["spec_walk"][1]().att.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = device_ms(lambda: _build.check(empty(b, WALK_THREADS, stream), "empty"),
                   "empty_kernel", runs)
    shown = "not measured" if ms is None else f"{ms:.4f} ms"
    print(f"empty kernel at the walk's grid ({b} x {WALK_THREADS}): device {shown} "
          f"(median of {runs}) [{card}]", flush=True)


if __name__ == "__main__":
    main()
