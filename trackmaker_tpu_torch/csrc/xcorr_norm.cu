// Normalized sliding cross-correlation at any pattern length up to 1024,
// written out dense or reduced to one (max, first argmax) per row of 128
// lags.
//
// Replaces: trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_kernel in its
// normalized form (through pallas_normalized_xcorr; tm_normalized_xcorr)
// and :_xcorr_rowstats_kernel (through pallas_xcorr_rowstats;
// tm_xcorr_rowstats).  The port computes in f32 throughout, as the JAX
// package's CPU branch does; the TPU runs the row stats in bf16.
//
// For every capture b and lag i < T-L+1:
//   dot    = fma(x[i+j], p[j], dot)   energy = fma(x[i+j], x[i+j], energy)
//            for j = 0 .. L-1 in order, both from 0
//   corr   = energy < kEps ? 0 : dot / max(sqrtf(energy) * pe, 1e-30)
// the steps and expressions of xcorr_hits.cu (xcorr_tile.cuh's tap_sums),
// so that for L <= 128 both kernels give the same corr bit for bit (the
// file is built without fast math, like the others).
//
// tm_normalized_xcorr writes corr f32[B, T-L+1].  tm_xcorr_rowstats writes,
// for each row r < n_rows of 128 lags,
//   rowmax[b, r]  the largest corr over the row's lags below T-L+1, or
//                 -3.4e38 when the row has none
//   rowpos[b, r]  the absolute lag of its first maximum (128r when none)
// and the dense correlation never goes to device memory.
//
// What bounds it on an H100: the arithmetic, 2*L fused multiply-adds (4*L
// operations) a lag: 0.1425 ms for the ASK chirp (L = 440) on 16 captures
// of 339,453 samples and 0.0795 ms for the equalizer's anchor search
// (L = 96) on 32 of 433,464, against the card's 67 TFLOP/s of f32; the
// samples are read from device memory once (4 bytes a lag, plus a halo a
// block).  The first design gave each thread one lane of 8 rows of 128
// lags: every tap cost a warp 8 shared loads of x and a broadcast of p[j],
// 9 shared-memory wavefronts for 16 multiply-adds, and shared memory bound
// it at about 2.25x the FMA issue time.
//
// Design: the register tile of xcorr_tile.cuh, as in xcorr_hits.cu.  A
// block of 128 threads covers 8 rows of 128 lags; it stages their
// 1,024 + round_up(L, 8) samples (9 KB at L = 1024, with the padding) and
// the pattern in shared memory.  Each thread sums 8 consecutive lags: a
// step of 8 taps loads a window of 16 samples and the 8 taps (six 16-byte
// loads) for 128 multiply-adds from registers, so FFMA issue, not shared
// memory, bounds the loop.  The pattern comes by value, 1,024 floats in
// the launch parameters (CUDA 12.1's 32 KB limit; no copy to the card).
// The dense form writes each thread's 8 corr values through shared memory,
// so that a warp writes 128 consecutive lags at once.  The row stats: a
// row is 16 threads of one warp; each thread keeps the first maximum of
// its 8 lags (ascending, a strictly larger value wins), then the row's 16
// lanes meet by __shfl_xor_sync, carrying the lag and keeping the smaller
// on equal values.  Lags at or past T-L+1 count as -inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "xcorr_tile.cuh"

namespace {

constexpr int kMaxL = 1024;       // longest pattern
constexpr int kRowThreads = kLanes / kK;   // threads a row
constexpr int kStaged = sx(kTile + kMaxL) + 4;
constexpr float kEps = 1e-6f;     // sync/correlate.py:EPS
constexpr float kNoRow = -3.4e38f;

static_assert(32 % kRowThreads == 0, "a row's threads lie in one warp");

struct Taps {                     // the pattern by value: the taps, then zeros
  float v[kMaxL];
};

// corr of the 8 lags from the thread's base in the tile at lag0
__device__ __forceinline__ void block_corr(const float* __restrict__ xb, const Taps& pat, int t,
                                           int l, float pe, int lag0, float* xs, float* ps,
                                           float (&corr)[kK]) {
  const int tid = threadIdx.x;
  const int n_taps = staged_halo(l, 0);   // the last step reads round_up(l, kChunk) taps
  for (int j = tid; j < n_taps; j += kThreads) ps[j] = pat.v[j];
  for (int i = tid; i < kTile + n_taps; i += kThreads) {
    const int idx = lag0 + i;
    xs[sx(i)] = idx < t ? xb[idx] : 0.0f;
  }
  __syncthreads();

  float dot[kK], energy[kK];
  tap_sums(xs, ps, tid * kK, l, dot, energy);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float denom = sqrtf(fmaxf(energy[k], 0.0f)) * pe;
    corr[k] = energy[k] < kEps ? 0.0f : dot[k] / fmaxf(denom, 1e-30f);
  }
}

__global__ void __launch_bounds__(kThreads) normalized_xcorr_kernel(
    const float* __restrict__ x, const __grid_constant__ Taps pat, int t, int l, float pe,
    float* __restrict__ corr_out) {
  __shared__ __align__(16) float xs[kStaged];
  __shared__ __align__(16) float ps[kMaxL];
  __shared__ __align__(16) float cs[sx(kTile)];
  const int b = blockIdx.y;
  const int lag0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int n_lags = t - l + 1;
  float corr[kK];
  block_corr(x + static_cast<int64_t>(b) * t, pat, t, l, pe, lag0, xs, ps, corr);
#pragma unroll
  for (int q = 0; q < kK; q += 4) {
    *reinterpret_cast<float4*>(cs + sx(tid * kK + q)) =
        make_float4(corr[q], corr[q + 1], corr[q + 2], corr[q + 3]);
  }
  __syncthreads();
  float* ob = corr_out + static_cast<int64_t>(b) * n_lags;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lag = lag0 + r * kLanes + tid;
    if (lag < n_lags) ob[lag] = cs[sx(r * kLanes + tid)];
  }
}

// (v, i) becomes the larger of (v, i) and (w, j); of equal values the
// smaller lag
__device__ __forceinline__ void keep_max(float& v, int& i, float w, int j) {
  if (w > v || (w == v && j < i)) {
    v = w;
    i = j;
  }
}

__global__ void __launch_bounds__(kThreads) xcorr_rowstats_kernel(
    const float* __restrict__ x, const __grid_constant__ Taps pat, int t, int l, float pe,
    int n_rows, float* __restrict__ rowmax, int* __restrict__ rowpos) {
  __shared__ __align__(16) float xs[kStaged];
  __shared__ __align__(16) float ps[kMaxL];
  const int b = blockIdx.y;
  const int lag0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int n_lags = t - l + 1;
  float corr[kK];
  block_corr(x + static_cast<int64_t>(b) * t, pat, t, l, pe, lag0, xs, ps, corr);

  // the first maximum of the thread's 8 lags, then of the row's 16 threads
  const int lag_base = lag0 + tid * kK;
  float v = -INFINITY;
  int i = lag_base;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (lag_base + k < n_lags && corr[k] > v) {
      v = corr[k];
      i = lag_base + k;
    }
  }
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, off);
    const int j = __shfl_xor_sync(0xffffffffu, i, off);
    keep_max(v, i, w, j);
  }
  const int row = blockIdx.x * kRows + tid / kRowThreads;
  if (tid % kRowThreads == 0 && row < n_rows) {
    const int64_t out = static_cast<int64_t>(b) * n_rows + row;
    // a row without a valid lag: every lane held -inf, so its first lag won
    rowmax[out] = v == -INFINITY ? kNoRow : v;
    rowpos[out] = i;
  }
}

bool bad_shape(int batch, int t, int l) {
  return l < 1 || l > kMaxL || t < l || batch < 1 || batch > 65535;
}

Taps taps_of(const float* host) {
  Taps taps;
  memcpy(taps.v, host, sizeof taps.v);
  return taps;
}

}  // namespace

// `pattern` is a host pointer to kMaxL = 1024 floats: the taps, then zeros;
// they go to the kernel by value.
extern "C" int tm_normalized_xcorr(const float* x, const float* pattern, int batch, int t,
                                   int l, float pe, float* corr, void* stream) {
  if (bad_shape(batch, t, l)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = (t - l + 1 + kLanes - 1) / kLanes;
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  normalized_xcorr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, taps_of(pattern), t, l, pe, corr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tm_xcorr_rowstats(const float* x, const float* pattern, int batch, int t, int l,
                                 float pe, int n_rows, float* rowmax, int* rowpos,
                                 void* stream) {
  if (bad_shape(batch, t, l) || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_rowstats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, taps_of(pattern), t, l, pe, n_rows, rowmax, rowpos);
  return static_cast<int>(cudaGetLastError());
}
