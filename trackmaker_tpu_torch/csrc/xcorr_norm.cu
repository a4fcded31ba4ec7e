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
//   dot    = sum_j x[i+j] * p[j]      energy = sum_j x[i+j]^2
//   corr   = energy < kEps ? 0 : dot * (1/sqrtf(max(energy, 1e-30))) * inv_pe
// with the taps added in order and the same expressions as xcorr_hits.cu,
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
// What bounds it on an H100: the arithmetic, 2*L fused multiply-adds per
// lag fed from shared memory (4 bytes read per lag, plus an L-1 halo per
// block).  Design: a block of 128 threads covers kRows rows of 128 lags;
// it stages its kRows*128 + L - 1 samples and the pattern in shared
// memory (12 KB at L = 1024), and each thread sums one lane of each of the
// kRows rows, so each pattern tap read from shared memory feeds kRows
// independent dot and energy sums.  The row stats reduce each warp's 32
// lanes with __shfl_xor_sync, carrying the lag and keeping the smaller on
// equal values; the row's four warps meet in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;       // lags per row
constexpr int kRows = 8;          // rows per block
constexpr int kMaxL = 1024;       // longest pattern the block stages
constexpr int kWarps = kLanes / 32;
constexpr float kEps = 1e-6f;     // sync/correlate.py:EPS
constexpr float kNoRow = -3.4e38f;

// corr of the kRows rows of 128 lags starting at lag0, one lane per thread
__device__ __forceinline__ void block_corr(const float* __restrict__ xb,
                                           const float* __restrict__ pattern,
                                           int t, int l, float inv_pe, int lag0,
                                           float* xs, float* ps,
                                           float (&corr)[kRows]) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kRows * kLanes + l - 1; i += kLanes) {
    const int idx = lag0 + i;
    xs[i] = idx < t ? xb[idx] : 0.0f;
  }
  for (int j = tid; j < l; j += kLanes) ps[j] = pattern[j];
  __syncthreads();

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
      const float v = xs[r * kLanes + tid + j];
      dot[r] += v * pj;
      energy[r] += v * v;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = (1.0f / sqrtf(fmaxf(energy[r], 1e-30f))) * inv_pe;
    corr[r] = energy[r] < kEps ? 0.0f : dot[r] * denom;
  }
}

__global__ void normalized_xcorr_kernel(const float* __restrict__ x,
                                        const float* __restrict__ pattern,
                                        int t, int l, float inv_pe,
                                        float* __restrict__ corr_out) {
  __shared__ float xs[kRows * kLanes + kMaxL - 1];
  __shared__ float ps[kMaxL];
  const int b = blockIdx.y;
  const int lag0 = blockIdx.x * kRows * kLanes;
  const int n_lags = t - l + 1;
  float corr[kRows];
  block_corr(x + static_cast<int64_t>(b) * t, pattern, t, l, inv_pe, lag0, xs, ps,
             corr);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lag = lag0 + r * kLanes + threadIdx.x;
    if (lag < n_lags) corr_out[static_cast<int64_t>(b) * n_lags + lag] = corr[r];
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

__global__ void xcorr_rowstats_kernel(const float* __restrict__ x,
                                      const float* __restrict__ pattern,
                                      int t, int l, float inv_pe, int n_rows,
                                      float* __restrict__ rowmax,
                                      int* __restrict__ rowpos) {
  __shared__ float xs[kRows * kLanes + kMaxL - 1];
  __shared__ float ps[kMaxL];
  __shared__ float warp_val[kRows][kWarps];
  __shared__ int warp_lag[kRows][kWarps];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int lag0 = row0 * kLanes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_lags = t - l + 1;
  float corr[kRows];
  block_corr(x + static_cast<int64_t>(b) * t, pattern, t, l, inv_pe, lag0, xs, ps,
             corr);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int i = lag0 + r * kLanes + tid;
    float v = i < n_lags ? corr[r] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, off);
      const int j = __shfl_xor_sync(0xffffffffu, i, off);
      keep_max(v, i, w, j);
    }
    if ((tid & 31) == 0) {
      warp_val[r][warp] = v;
      warp_lag[r][warp] = i;
    }
  }
  __syncthreads();

  if (tid < kRows && row0 + tid < n_rows) {
    const int r = tid;
    float v = warp_val[r][0];
    int i = warp_lag[r][0];
    for (int w = 1; w < kWarps; ++w) keep_max(v, i, warp_val[r][w], warp_lag[r][w]);
    const int64_t out = static_cast<int64_t>(b) * n_rows + row0 + r;
    // a row without a valid lag: every lane held -inf, so lane 0 won
    rowmax[out] = v == -INFINITY ? kNoRow : v;
    rowpos[out] = i;
  }
}

bool bad_shape(int batch, int t, int l) {
  return l < 1 || l > kMaxL || t < l || batch < 1;
}

}  // namespace

extern "C" int tm_normalized_xcorr(const float* x, const float* pattern, int batch,
                                   int t, int l, float inv_pe, float* corr,
                                   void* stream) {
  if (bad_shape(batch, t, l)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = (t - l + 1 + kLanes - 1) / kLanes;
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  normalized_xcorr_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pattern, t, l, inv_pe, corr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tm_xcorr_rowstats(const float* x, const float* pattern, int batch,
                                 int t, int l, float inv_pe, int n_rows,
                                 float* rowmax, int* rowpos, void* stream) {
  if (bad_shape(batch, t, l) || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_rowstats_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pattern, t, l, inv_pe, n_rows, rowmax, rowpos);
  return static_cast<int>(cudaGetLastError());
}
