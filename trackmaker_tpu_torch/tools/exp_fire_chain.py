"""What holds the ASK fire rule (kernel #9, ``csrc/ask_fire.cu``) and the
ASK record chain (kernel #10, ``csrc/ask_chain.cu``) back: variants built
for the run from patched copies of the kept sources, timed on the card
beside the kept designs.

    python -m trackmaker_tpu_torch.tools.exp_fire_chain [runs]

The variants (:data:`VARIANTS`, each a list of replacements in the kept
source, every anchor required, as in ``tools/exp_walk_attempt.py``):

* chain ``chunked``: the first design: the warp walks the row in chunks of
  32 columns, each chunk's load issued only after the previous chunk's two
  warp scans and its ballot (a round trip to memory a chunk);
* fire ``scan``: the first design's window, in the kept tile and loads:
  the staged masked values in place of the prefix maxima, and a position
  with upd set scans its w values until the first larger one;
* fire ``scalar``: the kept kernel with every load and store scalar (its
  path for unaligned arrays);
* fire ``nowindow``: hit = upd, the staging and the scans kept (its
  outputs not checked);
* fire ``loadstore``: the tile's loads and hit = upd stored, without the
  halo, the scans and the window (its outputs not checked);
* fire ``tile2k`` and ``tile8k``: tiles of 2,048 and 8,192 positions in
  place of 4,096 (twice the halo's share, or half of it);
* fire ``minblocks4``: the registers capped for 4 blocks of 256 an SM;

and ``empty``, an empty kernel at each kernel's grid.  On ask_b16's inputs
(``chip_smoke.py``'s ASK captures: 16 tracks of 64 frames), each variant's
outputs must equal the plain version's on the fire rule's 16 x 339,453
samples and on the chain's three shapes: the speculative receiver's
1,552 rows of 1,024 columns, the exact scan's row of 4,096 columns (its
first chain on the first track) and that row's first 512 columns.  Then
each one's device time (torch.profiler, median of `runs` launches,
default 30, from a session that traced every launch) prints between two
readings of the kept design's, with the card's name and power limit.
The variants are built into ``build/trackmaker_tpu_torch/exp/`` and loaded
in place of the kept library for their turn only.  Needs a card.
"""

from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.phy import ask, ask_spec
from trackmaker_tpu_torch.tools.exp_walk_attempt import (
    ASK_FRAMES, ASK_TRACKS, EMPTY_SOURCE, RUNS, build_source, device_ms, install, patched)
from trackmaker_tpu_torch.tools.health import card_line

UNCHECKED = {"nowindow", "loadstore"}      # variants whose outputs differ by design
SOURCES = ("ask_chain", "ask_fire")
CHAIN_WARPS = 4               # the chain's rows a block
FIRE_THREADS, FIRE_TILE = 256, 4096

# the first design's dependent chunk loop, in place of the tiles
_CHUNKED = """  float carry_m = -CUDART_INF_F;
  int carry_rec = kNegB;
  bool done = false;
  int pk = kNegB;
  for (int c0 = 0; c0 < win && !done; c0 += 32) {
    const int j = c0 + lane;
    const bool in = j < win;
    const float x = in ? v[j] : -CUDART_INF_F;
    float incl = x;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl = fmaxf(incl, o);
    }
    const float prev = __shfl_up_sync(kFull, incl, 1);
    const float m = lane == 0 ? carry_m : fmaxf(carry_m, prev);
    const bool upd = in && x > m;
    const int idx = b0 + j;
    int rinc = upd ? idx : kNegB;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, rinc, s);
      if (lane >= s) rinc = max(rinc, o);
    }
    const int rprev = __shfl_up_sync(kFull, rinc, 1);
    const int rec = lane == 0 ? carry_rec : max(carry_rec, rprev);
    const bool fire = in && !upd && idx > rec + guard && m > -CUDART_INF_F;
    const unsigned ballot = __ballot_sync(kFull, fire);
    if (ballot) {
      pk = __shfl_sync(kFull, rec, __ffs(ballot) - 1);
      done = true;
    } else {
      carry_m = fmaxf(carry_m, __shfl_sync(kFull, incl, 31));
      carry_rec = max(carry_rec, __shfl_sync(kFull, rinc, 31));
    }
  }
  if (lane == 0) {
"""
_WINDOW = ("      float mx = fmaxf(sv[q],", "elem(v[k], q) >= mx;\n")

# (start anchor, end anchor, replacement): the text from the start anchor
# through the end anchor is replaced
VARIANTS = {
    ("ask_chain", "chunked"): [("  float next[kSeg];\n", "  if (lane == 0) {\n", _CHUNKED)],
    ("ask_fire", "scan"): [
        ("  reinterpret_cast<float4*>(pre + off)[lane] = p;",
         "  reinterpret_cast<float4*>(pre + off)[lane] = p;",
         "  reinterpret_cast<float4*>(pre + off)[lane] = m;"),
        (*_WINDOW,
         "      bool fires = upd_at(u[k], q);\n"
         "      if (fires) {\n"
         "        const float val = elem(v[k], q);\n"
         "        for (int i = s + q + 1; i <= s + q + w; ++i) {\n"
         "          if (pre[i] > val) {\n"
         "            fires = false;\n"
         "            break;\n"
         "          }\n"
         "        }\n"
         "      }\n")],
    ("ask_fire", "scalar"): [(
        "  const bool vec = reinterpret_cast<uintptr_t>(sync) % 16 == 0 &&",
        "reinterpret_cast<uintptr_t>(hit) % 4 == 0;",
        "  const bool vec = false;")],
    ("ask_fire", "nowindow"): [(*_WINDOW, "      const bool fires = upd_at(u[k], q);\n")],
    ("ask_fire", "loadstore"): [
        ("  for (int j = kTileRows + warp; j < rows; j += kWarps) {", "  __syncthreads();\n",
         "  __syncthreads();\n"),
        (*_WINDOW, "      const bool fires = upd_at(u[k], q);\n")],
    ("ask_fire", "tile2k"): [("constexpr int kTile = 4096;", "constexpr int kTile = 4096;",
                              "constexpr int kTile = 2048;")],
    ("ask_fire", "tile8k"): [("constexpr int kTile = 4096;", "constexpr int kTile = 4096;",
                              "constexpr int kTile = 8192;")],
    ("ask_fire", "minblocks4"): [("__launch_bounds__(kThreads)\nask_fire_kernel",
                                  "__launch_bounds__(kThreads)\nask_fire_kernel",
                                  "__launch_bounds__(kThreads, 4)\nask_fire_kernel")],
}


def ask_inputs(device) -> dict:
    """ask_b16's inputs of the two kernels: the capture's sync and upd, the
    chain rows of its candidates, and the exact scan's first chain row on
    the first track (4,096 columns)."""
    cfg = ask.AskConfig()
    frames = ask.build_frames(b"the quick brown fox", cfg, num_frames=ASK_FRAMES)
    waves = [ask.build_track(cfg, frames, seed=7 + r) for r in range(ASK_TRACKS)]
    caps = np.zeros((ASK_TRACKS, max(len(w) for w in waves)), np.float32)
    for r, w in enumerate(waves):
        caps[r, :len(w)] = w
    x = torch.from_numpy(caps).to(device)
    power, sync, upd_ok = ask.dense_arrays(cfg, x)
    cand, _, _ = ask_spec.extract_candidates(ask_spec.dense_fire_candidates_plain(cfg, sync, upd_ok),
                                             96)
    virt = torch.full((ASK_TRACKS, 1), -(cfg.frame_samples + 1), dtype=torch.int32, device=device)
    vals, base, _ = ask_spec.chain_windows(cfg, x, power, sync, upd_ok, torch.cat([virt, cand], 1))
    return dict(cfg=cfg, sync=sync, upd_ok=upd_ok, vals=vals, base=base,
                scan_row=exact_scan_row(cfg, x[0]))


def exact_scan_row(cfg: ask.AskConfig, rx: torch.Tensor):
    """(vals f32[1, 4096], base int32[1]): the record-chain row the exact
    scan (``phy/ask.py:demodulate``) gives its first frame slot."""
    rows = []
    kept = ask.ask_chain

    def keep(vals, base, guard):     # the row, and the plain version's answer
        rows.append((vals.clone(), base.clone()))
        return ask.ask_chain_plain(vals, base, guard)

    ask.ask_chain = keep
    try:
        ask.demodulate(cfg, rx, max_frames=1)
    finally:
        ask.ask_chain = kept
    return rows[0]


def calls_of(inputs: dict) -> dict:
    """name -> (kernel call, plain call) on the tool's inputs."""
    cfg, sync, upd_ok = inputs["cfg"], inputs["sync"], inputs["upd_ok"]
    row, row_base = inputs["scan_row"]
    chains = {"ask_chain ask_b16": (inputs["vals"], inputs["base"]),
              "ask_chain exact scan row (4096)": (row, row_base),
              "ask_chain exact scan row (512)": (row[:, :512].contiguous(), row_base)}
    calls = {"ask_fire ask_b16": (lambda: (ask_spec.dense_fire_candidates(cfg, sync, upd_ok),),
                                  lambda: (ask_spec.dense_fire_candidates_plain(cfg, sync, upd_ok),))}
    for name, (v, b) in chains.items():
        calls[name] = (lambda v=v, b=b: ask.ask_chain(v, b, cfg.peak_guard),
                       lambda v=v, b=b: ask.ask_chain_plain(v, b, cfg.peak_guard))
    return calls


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else RUNS
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    dev = torch.device("cuda", 0)
    inputs = ask_inputs(dev)
    calls = calls_of(inputs)
    kept = {src: _build.load(src) for src in SOURCES}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc a variant, all at once
        libs = list(pool.map(lambda kv: build_source(f"{kv[0][0]}-{kv[0][1]}",
                                                     patched(kv[0][0], kv[1])), VARIANTS.items()))
    # the kept designs first and again last: their two readings show the drift
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
    b, t = inputs["sync"].shape
    grids = (("the chain's", -(-inputs["vals"].shape[0] // CHAIN_WARPS), 32 * CHAIN_WARPS),
             ("the fire rule's", b * -(-(t + 3) // FIRE_TILE), FIRE_THREADS))
    for what, blocks, threads in grids:
        ms = device_ms(lambda g=blocks, n=threads: _build.check(empty(g, n, stream), "empty"),
                       "empty_kernel", runs)
        shown = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"empty kernel at {what} grid ({blocks} x {threads}): device {shown} "
              f"(median of {runs}) [{card}]", flush=True)


if __name__ == "__main__":
    main()
