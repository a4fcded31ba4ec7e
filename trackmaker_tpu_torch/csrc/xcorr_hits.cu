// Normalized preamble cross-correlation with per-row hit extraction.
//
// Replaces: trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_hits_kernel (through
// pallas_xcorr_hits) and the normalized form of _xcorr_kernel (through
// pallas_normalized_xcorr): the `corr` output is that dense correlation.
//
// For every capture b and lag i < T-L+1:
//   dot    = sum_j x[i+j] * p[j]      energy = sum_j x[i+j]^2
//   corr   = energy < kEps ? 0 : dot * (1/sqrtf(max(energy, 1e-30))) * inv_pe
// (1.0f/sqrtf, both IEEE-rounded: the file is built without fast math.)
// Lags are grouped into rows of 128.  Row r of `rows` (int32[B, R, 16]):
//   cols 0..3  the first four lags of the row with corr >= threshold,
//              ascending, padded with 2^30
//   col  4     the row's true hit count
//   cols 5..8  the corr at those hits, bit-cast to int32 (0 when absent)
//   cols 9..15 zero
//
// What bounds it on an H100: the arithmetic, 2*L fused multiply-adds per
// lag, all fed from shared memory.  The input is read from device memory
// once (4 bytes per lag, plus an L-1 halo per block), far below the
// card's bandwidth.  Design: a block of 128 threads covers ROWS rows of
// 128 lags; it stages its ROWS*128 + L - 1 samples and the pattern in
// shared memory, and each thread sums the lags of one lane across the
// ROWS rows, so each pattern tap read from shared memory feeds ROWS
// independent dot and energy sums.  The sums are direct f32 sums in tap
// order; the hit extraction is one warp ballot per row and warp, a popc
// prefix over the row's four warps, and a scatter of the first four hits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;       // lags per row
constexpr int kRows = 8;          // rows per block
constexpr int kMaxL = 128;        // longest pattern the block stages
constexpr int kRowCols = 16;
constexpr int kHitSlots = 4;
constexpr int kBig = 1 << 30;
constexpr float kEps = 1e-6f;   // sync/correlate.py:EPS

__global__ void xcorr_hits_kernel(const float* __restrict__ x,
                                  const float* __restrict__ pattern,
                                  int t, int l, float inv_pe,
                                  float threshold, int n_rows,
                                  int* __restrict__ rows,
                                  float* __restrict__ corr_out) {
  __shared__ float xs[kRows * kLanes + kMaxL - 1];
  __shared__ float ps[kMaxL];
  __shared__ int warp_hits[kRows][kLanes / 32];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int lag0 = row0 * kLanes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_lags = t - l + 1;
  const float* xb = x + static_cast<int64_t>(b) * t;

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

  float corr[kRows];
  unsigned masks[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lag = lag0 + r * kLanes + tid;
    const float denom = (1.0f / sqrtf(fmaxf(energy[r], 1e-30f))) * inv_pe;
    corr[r] = energy[r] < kEps ? 0.0f : dot[r] * denom;
    const bool hit = corr[r] >= threshold && lag < n_lags;
    masks[r] = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[r][warp] = __popc(masks[r]);
    if (corr_out != nullptr && lag < n_lags) {
      corr_out[static_cast<int64_t>(b) * n_lags + lag] = corr[r];
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= n_rows) break;
    int* out = rows + (static_cast<int64_t>(b) * n_rows + row) * kRowCols;
    int before = 0, total = 0;
    for (int w = 0; w < kLanes / 32; ++w) {
      const int n = warp_hits[r][w];
      before += w < warp ? n : 0;
      total += n;
    }
    if ((masks[r] >> lane) & 1u) {
      const int rank = before + __popc(masks[r] & ((1u << lane) - 1u));
      if (rank < kHitSlots) {
        out[rank] = lag0 + r * kLanes + tid;
        out[kHitSlots + 1 + rank] = __float_as_int(corr[r]);
      }
    }
    // the columns no hit wrote: empty slots, the count and the zero tail
    if (tid < kRowCols) {
      const int c = tid;
      if (c < kHitSlots) {
        if (c >= total) out[c] = kBig;
      } else if (c == kHitSlots) {
        out[c] = total;
      } else if (c <= 2 * kHitSlots) {
        if (c - kHitSlots - 1 >= total) out[c] = 0;
      } else {
        out[c] = 0;
      }
    }
  }
}

}  // namespace

extern "C" int tm_xcorr_hits(const float* x, const float* pattern, int batch,
                             int t, int l, float inv_pe,
                             float threshold, int n_rows, int* rows,
                             float* corr, void* stream) {
  if (l < 1 || l > kMaxL || t < l || batch < 1 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_hits_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pattern, t, l, inv_pe, threshold, n_rows, rows, corr);
  return static_cast<int>(cudaGetLastError());
}
