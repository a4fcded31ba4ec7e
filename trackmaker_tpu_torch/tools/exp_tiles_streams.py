"""What holds the attempt tiles (kernel #13, ``csrc/attempt_tiles.cu``) and
the two-stream correlation (kernel #15, ``csrc/xcorr_streams.cu``) back:
variants built for the run from patched copies of the kept sources, timed
on the card beside the kept designs.

    python -m trackmaker_tpu_torch.tools.exp_tiles_streams [runs]

The variants (:data:`VARIANTS`, each a list of replacements in the kept
source, every anchor required, as in ``tools/exp_walk_attempt.py``):

* tiles ``grid32``: one block a capture, its 65 candidates in a loop (the
  first design's grid), in the new tile;
* tiles ``group1`` and ``group5``: 1 and 5 candidates a block in place of
  2 (2,080 and 416 blocks);
* tiles ``nosync``: best = 0 and dot = 0, no sync (outputs not checked);
* tiles ``nopack``: the body's bits stored as 0/1 floats, no pack
  (outputs not checked);
* tiles ``ring1``: the kept kernel at a ring of one stage, no copy in
  flight (the wrapper's ``pipe=1``, no patch);
* streams ``lagloop``: the first design's loop, a lag of each of the 8
  rows a thread, every tap from shared memory, over the new staging;
* streams ``onestream``: the tile and its halo from the first stream in
  one group, as kernel #1 stages them (zero-filled past the stream);
* streams ``patmem``: the pattern through device memory, copied from the
  host before every launch;

and ``empty``, an empty kernel at the grid of each kernel: #13's, #15's,
and the window probe's (#12) and the offset add's (#14), each at its grid
and at its first design's (``tools/exp_probe_offset.py``), beside the
device time of #12 and #14's forms at their tools' inputs.  The attempt
tiles run the ``base`` variant on the tool's corpus (32 captures), the streams the
tool's input (32 x 433,464, L = 96); each variant's outputs must equal
the plain version's (the tiles) or kernel #1's rows (the streams) where
it computes the function.  Then each one's device time (torch.profiler,
median of `runs` launches, default 30, from a session that traced every
launch) and CUDA-event time (median of `runs` calls) print between two
readings of the kept design's, with kernel #1 at the streams' input and
the card's name and power limit.  The variants are built into
``build/trackmaker_tpu_torch/exp/`` and loaded in place of the kept
library for their turn only.  Needs a card.
"""

from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits
from trackmaker_tpu_torch.tools import exp_attempt_tiles as et
from trackmaker_tpu_torch.tools import exp_probe_offset as epo
from trackmaker_tpu_torch.tools import exp_xcorr_streams as ex
from trackmaker_tpu_torch.tools.exp_probe_offset import event_ms
from trackmaker_tpu_torch.tools.exp_walk_attempt import (
    EMPTY_SOURCE, RUNS, build_source, device_ms, install, patched)
from trackmaker_tpu_torch.tools.health import card_line

UNCHECKED = {"nosync", "nopack"}       # variants whose outputs differ by design
SOURCES = ("attempt_tiles", "xcorr_streams")
KERNEL_FNS = {"attempt_tiles": "attempt_tiles_kernel", "xcorr_streams": "xcorr_hits_2s_kernel"}
CALL_KW = {("attempt_tiles", "ring1"): {"pipe": 1}}   # variants of the kept source's call

_GROUP = "constexpr int kGroup = 2;"
_PACK = ("      // the pack: the bits of all 34 rows",
         "      const float b00 = o[0][0];   // thread 0's: row 0, column 0\n",
         "      const float b00 = 0.0f;\n"
         "      if (a.store) {\n"
         "        float* blk = outb + (static_cast<int64_t>(c) * kBrows + r0) * kLanes + kC * pc;\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < kRg; ++i) {\n"
         "#pragma unroll\n"
         "          for (int j = 0; j < kC; ++j) {\n"
         "            blk[i * kLanes + j] = (mask >> (kC * i + j)) & 1 ? 1.0f : 0.0f;\n"
         "          }\n"
         "        }\n"
         "      }\n"
         "      (void)wm;\n")
_LAGLOOP = """  bool any_hit = false;
  {
    float dot[kRows], energy[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      dot[r] = 0.0f;
      energy[r] = 0.0f;
    }
    for (int j = 0; j < l; ++j) {
      const float pj = ps[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = buf[sx(r * kLanes + tid + j)];
        dot[r] += v * pj;
        energy[r] += v * v;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float denom = sqrtf(fmaxf(energy[r], 0.0f)) * pe;
      const float cr = energy[r] < kEps ? 0.0f : dot[r] / fmaxf(denom, 1e-30f);
      cs[r * kLanes + tid] = cr;
      any_hit |= cr >= threshold && lag0 + r * kLanes + tid < n_lags;
    }
  }
  (void)base;
"""
_ONESTREAM = """  const float* x_tile = x + b * stride + lag0;
  for (int i = tid * kPiece; i < kTile + kHalo; i += kThreads * kPiece) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(buf + sx(i)));
    const int n_bytes = lag0 + i < stride ? 16 : 0;     // zero past the stream
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(dst),
                 "l"(x_tile + (n_bytes ? i : 0)), "r"(n_bytes) : "memory");
  }
  commit_group();
  (void)xs;
"""

# (start anchor, end anchor, replacement): the text from the start anchor
# through the end anchor is replaced
VARIANTS = {
    ("attempt_tiles", "grid32"): [(_GROUP, _GROUP, "constexpr int kGroup = 65;")],
    ("attempt_tiles", "group1"): [(_GROUP, _GROUP, "constexpr int kGroup = 1;")],
    ("attempt_tiles", "group5"): [(_GROUP, _GROUP, "constexpr int kGroup = 5;")],
    ("attempt_tiles", "nosync"): [(
        "    const int lane = tid & 31;\n    if constexpr (kSyncPairs) {\n",
        "        sync_finish(sd, se, &sc.dot0[g], &sc.best[g]);\n      }\n    }\n",
        "    if (tid < n) {\n      sc.dot0[tid] = 0.0f;\n      sc.best[tid] = 0;\n    }\n")],
    ("attempt_tiles", "nopack"): [_PACK],
    ("attempt_tiles", "ring1"): [],
    ("xcorr_streams", "lagloop"): [(
        "  float dot[kK], energy[kK];\n",
        "        make_float4(corr[q], corr[q + 1], corr[q + 2], corr[q + 3]);\n  }\n",
        _LAGLOOP)],
    ("xcorr_streams", "onestream"): [(
        "  // stream 1: the tile of x; stream 2: the 128 samples after it, from xs\n",
        "xs_halo + tid * kPiece);\n  commit_group();\n", _ONESTREAM)],
    ("xcorr_streams", "patmem"): [
        ("struct Taps {", "struct Taps {", "__device__ float g_taps[kTaps];\n\nstruct Taps {"),
        ("  for (int j = tid; j < kTaps; j += kThreads) ps[j] = pat.v[j];",
         "  for (int j = tid; j < kTaps; j += kThreads) ps[j] = pat.v[j];",
         "  for (int j = tid; j < kTaps; j += kThreads) ps[j] = g_taps[j];"),
        ("  Taps taps;\n  memcpy(taps.v, pattern, sizeof taps.v);\n",
         "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n",
         "  Taps taps{};\n  dim3 grid(n_tiles, batch);\n"
         "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
         "  const cudaError_t copied = cudaMemcpyToSymbolAsync(g_taps, pattern, sizeof taps.v, 0,\n"
         "                                                     cudaMemcpyHostToDevice, s);\n"
         "  if (copied != cudaSuccess) return static_cast<int>(copied);\n")],
}


def calls_of(device) -> dict:
    """source -> (kernel call taking its keywords, check of its output) on
    the tool's inputs."""
    tiles = et.tool_input(device)
    want = et.attempt_tiles_plain("base", *tiles)
    xt, pattern = ex.tool_input(device)
    streams = ex.two_streams(xt)
    rows = xcorr_hits(xt, pattern, ex.THR)[1]
    return {
        "attempt_tiles": (lambda **kw: et.attempt_tiles("base", *tiles, **kw),
                          lambda got: torch.equal(got, want)),
        "xcorr_streams": (lambda **kw: ex.xcorr_hits_2s(xt, pattern, ex.THR, streams=streams),
                          lambda got: torch.equal(got, rows)),
        "kernel #1": (lambda: xcorr_hits(xt, pattern, ex.THR)[1], None),
    }


def empty_grids() -> tuple[tuple[str, int, int], ...]:
    """(what, blocks, threads) of each kernel's grid on the tool's inputs,
    and of #12's and #14's (``tools/exp_probe_offset.py``)."""
    n_rows = -(-ex.T // 128)
    n_tiles = -(-n_rows // 8)
    return (("#13 attempt_tiles", et.B * -(-et.NV // et.GROUP), 128),
            ("#15 xcorr_hits_2s", ex.B * n_tiles, 128), *epo.empty_grids())


def launch_calls(device) -> dict:
    """The kernels whose time is a launch, at their tools' inputs: name ->
    (call, kernel function)."""
    return {what: (fn, kernel) for what, (_, fn, kernel, _) in epo.launch_calls(device).items()}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else RUNS
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    dev = torch.device("cuda", 0)
    calls = calls_of(dev)
    kept = {src: _build.load(src) for src in SOURCES}
    built = [key for key, patches in VARIANTS.items() if patches]
    with ThreadPoolExecutor(len(built)) as pool:       # one nvcc a variant, all at once
        libs = dict(zip(built, pool.map(lambda key: build_source(
            f"{key[0]}-{key[1]}", patched(key[0], VARIANTS[key])), built)))
    # the kept designs first and again last: their two readings show the drift
    designs = [(src, "kept", kept[src]) for src in SOURCES] + [
        (src, variant, ctypes.CDLL(str(libs[src, variant])) if (src, variant) in libs
         else kept[src]) for src, variant in VARIANTS] + [
        (src, "kept", kept[src]) for src in SOURCES]
    for src, variant, lib in designs:
        install(src, lib)
        kernel, check = calls[src]
        kw = CALL_KW.get((src, variant), {})
        got = kernel(**kw)
        torch.cuda.synchronize()
        same = check(got)
        if not same and variant not in UNCHECKED:
            raise SystemExit(f"{src} {variant} differs from its reference")
        dev_ms = device_ms(lambda: kernel(**kw), KERNEL_FNS[src], runs)
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"{src} {variant}: device {shown}, events {event_ms(lambda: kernel(**kw), runs):.4f} "
              f"ms (medians of {runs}), {'== reference' if same else 'outputs not checked'} "
              f"[{card}]", flush=True)
        install(src, kept[src])
    one = calls["kernel #1"][0]
    dev_ms = device_ms(one, "xcorr_hits_kernel", runs)
    shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"kernel #1 at the streams' input: device {shown}, events {event_ms(one, runs):.4f} ms "
          f"(medians of {runs}) [{card}]", flush=True)
    for what, (fn, kernel) in launch_calls(dev).items():
        ms = device_ms(fn, kernel, runs)
        shown = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"{what}: device {shown} (median of {runs}) [{card}]", flush=True)
    empty = ctypes.CDLL(str(build_source("empty", EMPTY_SOURCE))).tm_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for what, blocks, threads in empty_grids():
        ms = device_ms(lambda g=blocks, n=threads: _build.check(empty(g, n, stream), "empty"),
                       "empty_kernel", runs)
        shown = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"empty kernel at {what}'s grid ({blocks} x {threads}): device {shown} "
              f"(median of {runs}) [{card}]", flush=True)


if __name__ == "__main__":
    main()
