// The register tile of the sliding correlations: xcorr_hits.cu (the hit
// rows), xcorr_norm.cu (the normalized correlation at any length and its
// row stats) and sliding_dot.cu (the raw sliding dot).
//
// A block of kThreads threads covers kTile = kThreads * kK consecutive
// lags, staged in shared memory with the samples after them, 4 floats of
// padding after every 32 samples (sx), so that a warp's 16-byte loads,
// kK floats apart from thread to thread, spread evenly over the banks.
// Thread tid sums the kK consecutive lags from base = tid * kK: lag
// base + k at tap j reads staged sample base + k + j.  A step of kChunk
// taps loads a window of kWindow staged samples and the step's taps
// (16-byte loads, the taps a broadcast) into registers, so that one
// shared load feeds 2 * kK of the step's kK * kChunk products and sums;
// a last step of fewer taps keeps the tap order for an L that is not a
// multiple of kChunk.  Every sum takes its taps in order j = 0 .. L-1.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 128;       // lags per row
constexpr int kK = 8;             // consecutive lags a thread sums
constexpr int kRows = kK;         // rows per block: kThreads * kK lags
constexpr int kTile = kRows * kLanes;
constexpr int kChunk = 8;         // taps a step
constexpr int kWindow = kK + kChunk;   // samples a step's kK lags read (one spare)
constexpr int kWarps = kThreads / 32;

static_assert(kThreads == kLanes, "a block of kRows rows of 128 lags");
static_assert(kK % 4 == 0 && kChunk % 4 == 0, "a window starts at a multiple of 4: 16-byte loads");
static_assert(kThreads % 32 == 0, "sx(i + kThreads) = sx(i) + sx(kThreads)");

// the padded shared index of staged sample i: 4 floats after every 32
__host__ __device__ constexpr int sx(int i) { return i + ((i >> 5) << 2); }

// staged samples past the tile that the last step's window reaches:
// round_up(L, kChunk), at least `halo`
__host__ __device__ constexpr int staged_halo(int l, int halo) {
  return halo > (l + kChunk - 1) / kChunk * kChunk ? halo : (l + kChunk - 1) / kChunk * kChunk;
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// The window of staged samples base + j0 .. + kWindow - 1 and the taps
// j0 .. j0 + kChunk - 1 of a step.
__device__ __forceinline__ void load_step(const float* xs, const float* ps, int base, int j0,
                                          float (&w)[kWindow], float (&p)[kChunk]) {
  // sx(s + q) = sx(s) + q + 4 * (((s & 31) + q) >> 5)
  const int s = base + j0;
  const float* ws = xs + sx(s);
  const int s_lo = s & 31;
#pragma unroll
  for (int q = 0; q < kWindow; q += 4) load4(w + q, ws + q + (((s_lo + q) >> 5) << 2));
#pragma unroll
  for (int q = 0; q < kChunk; q += 4) load4(p + q, ps + j0 + q);
}

// The normalized correlation's sums of the kK lags from `base` over the
// taps j0 .. j0 + n - 1, n <= kChunk (all kChunk when kFull), in tap
// order: dot = fma(x, p, dot), energy = fma(x, x, energy).
template <bool kFull>
__device__ __forceinline__ void tap_step(const float* xs, const float* ps, int base, int j0,
                                         int n, float (&dot)[kK], float (&energy)[kK]) {
  float w[kWindow], p[kChunk];
  load_step(xs, ps, base, j0, w, p);
#pragma unroll
  for (int m = 0; m < (kFull ? kChunk : kChunk - 1); ++m) {
    if (!kFull && m >= n) break;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      dot[k] = __fmaf_rn(w[m + k], p[m], dot[k]);
      energy[k] = __fmaf_rn(w[m + k], w[m + k], energy[k]);
    }
  }
}

// The normalized correlation of the kK lags from `base` over all L taps:
// the full steps, then the last taps.
__device__ __forceinline__ void tap_sums(const float* xs, const float* ps, int base, int l,
                                         float (&dot)[kK], float (&energy)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    dot[k] = 0.0f;
    energy[k] = 0.0f;
  }
  int j0 = 0;
#pragma unroll 1
  for (; j0 + kChunk <= l; j0 += kChunk) tap_step<true>(xs, ps, base, j0, kChunk, dot, energy);
  if (j0 < l) tap_step<false>(xs, ps, base, j0, l - j0, dot, energy);   // the last taps
}

}  // namespace
