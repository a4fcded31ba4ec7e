"""What holds the window probe (kernel #12, ``csrc/seq_probe.cu``) and the
offset add (kernel #14, ``csrc/offset_add.cu``) back: variants built for the
run from patched copies of the kept sources, timed on the card beside the
kept designs.

    python -m trackmaker_tpu_torch.tools.exp_probe_offset [runs]

The variants (:data:`VARIANTS`, each a list of replacements in the kept
source, every anchor required, as in ``tools/exp_walk_attempt.py``):

* probe ``global``: the 128 stores a thread go to device memory (volatile
  float4 stores to its output address, the first design's stores), on the
  new grid, with no shared memory;
* probe ``shared1``: four scalar shared stores a step in place of one
  float4, laid out [4][64] so that no two lanes share a bank;
* offset add ``serial``: the first design, a thread an output with its
  768-term (C: 384) chain, 32 blocks of 128 threads (B: one block);
* offset add ``noreduce``: each slice stores its sums unreduced over one
  another, no partials in shared memory, for timing only (outputs not
  checked);
* offset add ``lanes32``: a block 32 output lanes and 8 slices (96 terms a
  slice of A), the strip the redesign started from: 16 blocks (B: 4);
* offset add ``rows4``: a block 4 output rows in place of 8 (128 blocks
  for A and C);

and ``empty``, an empty kernel at each kernel's grid, the new one and the
first design's (:func:`empty_grids`).  Each variant's outputs must equal
the plain version's (the probe on x of N(0, 100), the offset add's three
forms on the tool's input) unless it is unchecked; then each one's device
time (torch.profiler, median of `runs` launches, default 30, from a session
that traced every launch) and CUDA-event time print between two readings
of the kept design's, with the card's name and power limit.  The variants
are built into ``build/trackmaker_tpu_torch/exp/`` and loaded in place of
the kept library for their turn only.  Needs a card.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.tools import exp_offset_add as eo
from trackmaker_tpu_torch.tools import health
from trackmaker_tpu_torch.tools.exp_walk_attempt import (
    EMPTY_SOURCE, RUNS, build_source, device_ms, install, patched)
from trackmaker_tpu_torch.tools.health import card_line

UNCHECKED = {"noreduce"}        # variants whose outputs differ by design
SOURCES = ("seq_probe", "offset_add")
# (blocks, threads) of each kernel: the kept design's and the first design's
PROBE_GRID, PROBE_FIRST_GRID = (128, 64), (32, 1024)
OFFSET_GRIDS = {"A": (64, 256), "B": (16, 256), "C": (64, 256)}
OFFSET_FIRST_GRIDS = {"A": (32, 128), "B": (1, 128), "C": (32, 128)}

_PROBE_LOOP = ("  const uint32_t slot = ", "  out[q] = o;\n")
_GLOBAL = """  float c = 0.0f;
  for (int i = 0; i < kSteps; ++i) {
    asm volatile("st.volatile.global.v4.f32 [%0], {%1, %2, %3, %4};\\n" ::"l"(out + q),
                 "f"(v.x + c), "f"(v.y + c), "f"(v.z + c), "f"(v.w + c) : "memory");
    c += 1.0f;
  }
  (void)stage;
"""
_SHARED1 = """  // [4][kThreads] floats: lane t's scalar stores on bank t mod 32
  const uint32_t slot =
      static_cast<uint32_t>(__cvta_generic_to_shared(reinterpret_cast<float*>(stage) + threadIdx.x));
  float c = 0.0f;
  for (int i = 0; i < kSteps; ++i) {
    asm volatile("st.shared.f32 [%0], %1;\\n" ::"r"(slot), "f"(v.x + c) : "memory");
    asm volatile("st.shared.f32 [%0], %1;\\n" ::"r"(slot + 4 * kThreads), "f"(v.y + c) : "memory");
    asm volatile("st.shared.f32 [%0], %1;\\n" ::"r"(slot + 8 * kThreads), "f"(v.z + c) : "memory");
    asm volatile("st.shared.f32 [%0], %1;\\n" ::"r"(slot + 12 * kThreads), "f"(v.w + c) : "memory");
    c += 1.0f;
  }
  float4 o;
  asm volatile("ld.shared.f32 %0, [%1];\\n" : "=f"(o.x) : "r"(slot) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\\n" : "=f"(o.y) : "r"(slot + 4 * kThreads) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\\n" : "=f"(o.z) : "r"(slot + 8 * kThreads) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\\n" : "=f"(o.w) : "r"(slot + 12 * kThreads) : "memory");
  out[q] = o;
"""
_SERIAL = """enum Form { kFormA, kFormB, kFormC };

constexpr int kThreads = kLanes;

// sum_j xr[j] * t[j, col], j ascending
__device__ __forceinline__ float dot_col(const float* xr, const float* __restrict__ t, int col) {
  float acc = 0.0f;
  for (int j = 0; j < kK; ++j) acc = fmaf(xr[j], t[j * kN + col], acc);
  return acc;
}

// rows `row` and `row + 1` of x into xs (they are contiguous)
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, int row, float* xs) {
  for (int j = threadIdx.x; j < 2 * kK; j += kThreads) xs[j] = x[row * kK + j];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) offset_add_a_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ t,
                                                                 float* __restrict__ out) {
  __shared__ float xs[2 * kK];
  const int i = blockIdx.x;
  const int k = threadIdx.x;
  stage_rows(x, i, xs);
  out[i * kLanes + k] = dot_col(xs, t, k) + dot_col(xs + kK, t, kLanes + k);
}

__global__ void __launch_bounds__(kThreads) offset_add_b_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ t,
                                                                 float* __restrict__ out) {
  __shared__ float xs[2 * kK];
  const int k = threadIdx.x;
  stage_rows(x, 0, xs);
  const float d = dot_col(xs, t, k) + dot_col(xs + kK, t, kLanes + k);
  for (int i = 0; i < kOutRows; ++i) out[i * kLanes + k] = d;
}

__global__ void __launch_bounds__(kThreads) offset_add_c_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ t,
                                                                 float* __restrict__ out) {
  __shared__ float xs[2 * kK];
  __shared__ int ql;
  const int i = blockIdx.x;
  const int k = threadIdx.x;
  if (k == 0) {
    int s = 0;
    for (int j = 0; j < 8; ++j) s += static_cast<int>(x[j]);
    ql = ((s % kQlMod) + kQlMod) % kQlMod;
  }
  stage_rows(x, i, xs);
  const int m = k + ql;
  out[i * kLanes + k] = m < kLanes ? dot_col(xs, t, m) : dot_col(xs + kK, t, m - kLanes);
}

template <Form F>
int launch(const float* x, const float* t, float* out, void* stream) {
  auto kernel = F == kFormA ? offset_add_a_kernel
                            : (F == kFormB ? offset_add_b_kernel : offset_add_c_kernel);
  kernel<<<F == kFormB ? 1 : kOutRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, t, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
"""
_NOREDUCE = """  // timing only: each slice stores its sums unreduced, over one another
#pragma unroll
  for (int r = 0; r < kR; ++r) out[(i0 + r) * kLanes + k] = acc[r];
  (void)part;
"""

# (start anchor, end anchor, replacement): the text from the start anchor
# through the end anchor is replaced
VARIANTS = {
    ("seq_probe", "global"): [(*_PROBE_LOOP, _GLOBAL)],
    ("seq_probe", "shared1"): [(*_PROBE_LOOP, _SHARED1)],
    ("offset_add", "serial"): [("enum Form { kFormA, kFormB, kFormC };", "}  // namespace\n",
                                _SERIAL)],
    ("offset_add", "noreduce"): [(
        "  // the slice sums, added in ascending slice order\n",
        "    out[(i0 + tid / kBlockLanes) * kLanes + k] = sum;\n  }\n", _NOREDUCE)],
    ("offset_add", "lanes32"): [("constexpr int kBlockLanes = 8;", "constexpr int kBlockLanes = 8;",
                                 "constexpr int kBlockLanes = 32;")],
    ("offset_add", "rows4"): [("constexpr int kRows = 8;", "constexpr int kRows = 8;",
                               "constexpr int kRows = 4;")],
}


def event_ms(fn, runs: int) -> float:
    """Median CUDA-event milliseconds of a call of fn, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_input(device) -> torch.Tensor:
    """The probe's x f32[8, 128] of N(0, 100), from ``default_rng(5)``."""
    x = np.random.default_rng(5).normal(0, 100, health.PROBE_SHAPE).astype(np.float32)
    return torch.from_numpy(x).to(device)


def launch_calls(device) -> dict:
    """name -> (source, call, kernel function, check of its output or None):
    the probe and the offset add's three forms at their tools' inputs."""
    xk = probe_input(device)
    xo, to = eo.tool_input(device)
    want = health.seq_probe_plain(xk)
    calls = {"#12 seq_probe": ("seq_probe", lambda: health.seq_probe(xk), "seq_probe_kernel",
                               lambda got: torch.equal(got, want))}
    for form in eo.FORMS:
        calls[f"#14 offset_add {form}"] = (
            "offset_add", lambda form=form: eo.offset_add(form, xo, to),
            f"offset_add_{form.lower()}_kernel",
            lambda got, want=eo.offset_add_plain(form, xo, to): torch.equal(got, want))
    return calls


def empty_grids() -> tuple[tuple[str, int, int], ...]:
    """(what, blocks, threads) of #12's and #14's grids, the kept designs'
    and the first designs'."""
    grids = [("#12 seq_probe", *PROBE_GRID), ("#12 seq_probe first design", *PROBE_FIRST_GRID)]
    for form in eo.FORMS:
        grids += [(f"#14 offset_add {form}", *OFFSET_GRIDS[form]),
                  (f"#14 offset_add {form} first design", *OFFSET_FIRST_GRIDS[form])]
    return tuple(grids)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else RUNS
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    dev = torch.device("cuda", 0)
    calls = launch_calls(dev)
    kept = {src: _build.load(src) for src in SOURCES}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:       # one nvcc a variant, all at once
        libs = dict(zip(VARIANTS, pool.map(lambda key: build_source(
            f"{key[0]}-{key[1]}", patched(key[0], VARIANTS[key])), VARIANTS)))
    # the kept designs first and again last: their two readings show the drift
    designs = [(src, "kept", kept[src]) for src in SOURCES] + [
        (src, variant, ctypes.CDLL(str(libs[src, variant]))) for src, variant in VARIANTS] + [
        (src, "kept", kept[src]) for src in SOURCES]
    for src, variant, lib in designs:
        install(src, lib)
        for what, (source, fn, kernel, check) in calls.items():
            if source != src:
                continue
            got = fn()
            torch.cuda.synchronize()
            same = check(got)
            if not same and variant not in UNCHECKED:
                raise SystemExit(f"{what} {variant} differs from its plain version")
            dev_ms = device_ms(fn, kernel, runs)
            shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            print(f"{what} {variant}: device {shown}, events {event_ms(fn, runs):.4f} ms "
                  f"(medians of {runs}), {'== plain' if same else 'outputs not checked'} "
                  f"[{card}]", flush=True)
        install(src, kept[src])
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
