// Raw sliding dot product times a scale, over zero history.
//
// Replaces: trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_kernel in its raw
// form (normalize=False), as trackmaker_tpu/sync/__init__.py:
// auto_sliding_dot_scaled calls it for the ASK receiver: the 440-tap chirp
// sync (scale 1/200) and the 30-tap dense-demodulation dots (scale 1), one
// launch each a decode.
//
// x f32[B, T], p f32[L], L <= 512:
//   out[b, i] = scale * sum_k x[b, i-L+1+k] * p[k],   x[b, j] = 0 for j < 0
// The taps are added in order k = 0..L-1 from 0, each product and each sum
// rounded on its own (__fmul_rn, __fadd_rn: never fused into an FMA), and
// the scale multiplies last.  The plain version in sync/sliding_dot.py adds
// in the same order, so the two agree exactly.
//
// What bounds it on an H100: operations.  The ASK sync at 16 captures of
// 339,453 samples is 2.4 G taps, a multiply and an add each: 0.0714 ms at
// the card's 67 TFLOP/s of f32 (the bound chip_smoke.py reports), which
// counts a fused multiply-add as two operations.  The rounding above rules
// the FMA out: a tap costs two f32 instructions, FMUL and FADD, at 33.5 T
// instructions a second, so the unfused floor is 0.143 ms.  The samples
// (22 MB in and out) are far below either.  The first design kept four
// sums 256 lags apart a thread, so each tap cost a warp 5 shared loads for
// 8 f32 instructions, and shared loads bound it at about 2.5x the floor.
//
// Design: the register tile of xcorr_tile.cuh.  A block of 128 threads
// computes 1,024 consecutive lags of one capture from shared memory, where
// it stages the samples they read, L - 1 before the tile (zeros before
// sample 0) and round_up(L, 8) + 1,024 in all, and the pattern.  Each
// thread sums 8 consecutive lags: a step of 8 taps loads a window of 16
// samples and the 8 taps (six 16-byte loads) for 64 FMULs and 64 FADDs
// from registers, so FP32 issue, not shared memory, bounds the loop.  The
// pattern comes by value, 512 floats in the launch parameters (no copy to
// the card).  The sums, scaled, go through shared memory so that a warp
// writes 128 consecutive lags at once.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "xcorr_tile.cuh"

namespace {

constexpr int kMaxPattern = 512;
constexpr int kStaged = sx(kTile + kMaxPattern) + 4;

struct Taps {                     // the pattern by value: the taps, then zeros
  float v[kMaxPattern];
};

// The raw sums of the kK lags from `base` over the taps j0 .. j0 + n - 1,
// n <= kChunk (all kChunk when kFull), in tap order, each product and sum
// rounded on its own.
template <bool kFull>
__device__ __forceinline__ void raw_step(const float* xs, const float* ps, int base, int j0,
                                         int n, float (&acc)[kK]) {
  float w[kWindow], p[kChunk];
  load_step(xs, ps, base, j0, w, p);
#pragma unroll
  for (int m = 0; m < (kFull ? kChunk : kChunk - 1); ++m) {
    if (!kFull && m >= n) break;
#pragma unroll
    for (int k = 0; k < kK; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w[m + k], p[m]));
  }
}

__global__ void __launch_bounds__(kThreads)
sliding_dot_kernel(const float* __restrict__ x, const __grid_constant__ Taps pat, int t, int l,
                   float scale, float* __restrict__ out) {
  __shared__ __align__(16) float xs[kStaged];
  __shared__ __align__(16) float ps[kMaxPattern];
  __shared__ __align__(16) float cs[sx(kTile)];

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int base = tid * kK;      // the thread's first lag in the tile
  const float* xb = x + static_cast<int64_t>(b) * t;
  const int n_taps = staged_halo(l, 0);   // the last step reads round_up(l, kChunk) taps
  for (int k = tid; k < n_taps; k += kThreads) ps[k] = pat.v[k];
  // staged sample j is x[i0 - (l-1) + j], zero outside [0, t)
  const int first = i0 - (l - 1);
  const int n = kTile + n_taps;
  for (int j = tid; j < n; j += kThreads) {
    const int src = first + j;
    xs[sx(j)] = (src >= 0 && src < t) ? xb[src] : 0.0f;
  }
  __syncthreads();

  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0.0f;
  int j0 = 0;
#pragma unroll 1
  for (; j0 + kChunk <= l; j0 += kChunk) raw_step<true>(xs, ps, base, j0, kChunk, acc);
  if (j0 < l) raw_step<false>(xs, ps, base, j0, l - j0, acc);   // the last taps
#pragma unroll
  for (int q = 0; q < kK; q += 4) {
    *reinterpret_cast<float4*>(cs + sx(base + q)) =
        make_float4(__fmul_rn(acc[q], scale), __fmul_rn(acc[q + 1], scale),
                    __fmul_rn(acc[q + 2], scale), __fmul_rn(acc[q + 3], scale));
  }
  __syncthreads();
  float* ob = out + static_cast<int64_t>(b) * t;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kLanes + tid;
    if (i < t) ob[i] = cs[sx(r * kLanes + tid)];
  }
}

}  // namespace

// `pattern` is a host pointer to kMaxPattern = 512 floats: the taps, then
// zeros; they go to the kernel by value.
extern "C" int tm_sliding_dot(const float* x, const float* pattern, int batch, int t, int l,
                              float scale, float* out, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || l < 1 || l > kMaxPattern) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  memcpy(taps.v, pattern, sizeof taps.v);
  const dim3 grid((t + kTile - 1) / kTile, batch);
  sliding_dot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, taps, t, l,
                                                                                scale, out);
  return static_cast<int>(cudaGetLastError());
}
