// The two-stream form of the correlation's hit rows: kernel #1's rows
// with its operand delivered as two streams, each staged by its own
// asynchronous copy.
//
// Replaces: tools/exp_xcorr_streams.py:_kernel_2s (launched by the
// pallas_call at :89): kernel #1's hit rows (rpb 4, 16 columns) with the
// k=1 contraction operand arriving as a second input, the captures
// pre-shifted by 128 samples (`xs_rows`, :87), so that every operand is
// an offset-0 block; its `noep` form writes int(corr[:, 0:16]) in place
// of the hit epilogue.
//
// tm_xcorr_hits_2s(x, xs, stride, pattern, ...): x f32[B, stride] holds
// the captures zero-padded to whole tiles of 1,024 lags (stride is the
// padded length), and xs f32[B, stride] the same captures shifted left by
// 128 samples and zero-padded at the end (xs[i] = x[i + 128]).  For every
// lag i < T-L+1, with 2 <= L <= 129:
//   dot = sum_j x[i+j] * p[j]      energy = sum_j x[i+j]^2
//   corr = energy < kEps ? 0 : dot * (1/sqrtf(max(energy, 1e-30))) * inv_pe
// as direct f32 sums in tap order, with the expressions, the rounding and
// the hit epilogue of csrc/xcorr_hits.cu, so its rows int32[B, R, 16],
// R = ceil(T/128), equal kernel #1's bit for bit (see that file's header
// for the columns).  The form without the epilogue (kEpilogue false, the
// tool's `noep`) writes, in row r, column k < 16 = (int)corr[128 r + k]
// (C truncation, as astype(int32)), 0 past the last lag.
//
// Design: a block of 128 threads covers 8 rows, a tile of 1,024 lags, and
// needs the samples of the tile and the L - 1 <= 128 after it.  It stages
// the tile from x and the 128 samples after the tile from xs (the last 128
// of xs's tile: xs[lag0 + 896 + k] = x[lag0 + 1024 + k]) into one shared
// buffer, each stream by its own cp.async: 16-byte cp.async.cg copies
// (two a thread for the tile, one each for 32 threads for the halo),
// committed as two groups, then cp.async.wait_group 0 and a barrier.  No
// thread loads the operand with a plain load, and no copy reaches past its
// own stream's tile: every copy is at an offset of the block's own tile in
// its stream, which is what the TPU experiment's "every operand is an
// offset-0 block" means on this card.  The pattern (at most 516 bytes)
// is read with plain loads, as in kernel #1.  cp.async over a 1-D TMA bulk
// copy: 288 16-byte pieces a block need no mbarrier, and the halo's copy
// is one warp's single instruction.
//
// What bounds it on an H100: the arithmetic, 2L fused multiply-adds per
// lag fed from shared memory, as kernel #1; the operand is read from
// device memory once (the halo: 1/8 more), far below the card's bandwidth.
// The streams save no load instruction that matters there: kernel #1's
// staging is a few loads a thread against 2 x 8 x L multiply-adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;          // lags per row
constexpr int kRows = 8;             // rows per block
constexpr int kTile = kRows * kLanes;
constexpr int kWarps = kLanes / 32;
constexpr int kMaxL = kLanes + 1;    // the halo fits one row of xs
constexpr int kChunk = 4;            // floats per 16-byte copy
constexpr int kRowCols = 16;
constexpr int kHitSlots = 4;
constexpr int kBig = 1 << 30;
constexpr float kEps = 1e-6f;        // sync/correlate.py:EPS

__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all_groups() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool kEpilogue>
__global__ void __launch_bounds__(kLanes) xcorr_hits_2s_kernel(
    const float* __restrict__ x, const float* __restrict__ xs, int64_t stride,
    const float* __restrict__ pattern, int t, int l, float inv_pe, float threshold,
    int n_rows, int* __restrict__ rows) {
  __shared__ __align__(16) float buf[kTile + kLanes];
  __shared__ float ps[kMaxL];
  __shared__ int warp_hits[kRows][kWarps];

  const int row0 = blockIdx.x * kRows;
  const int lag0 = row0 * kLanes;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_lags = t - l + 1;

  // stream 1: the tile of x; stream 2: the 128 samples after it, from xs
  const float* x_tile = x + b * stride + lag0;
  const float* xs_halo = xs + b * stride + lag0 + kTile - kLanes;
  for (int i = tid; i < kTile / kChunk; i += kLanes) copy16(buf + i * kChunk, x_tile + i * kChunk);
  commit_group();
  if (tid < kLanes / kChunk) copy16(buf + kTile + tid * kChunk, xs_halo + tid * kChunk);
  commit_group();
  for (int j = tid; j < l; j += kLanes) ps[j] = pattern[j];
  wait_all_groups();
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
      const float v = buf[r * kLanes + tid + j];
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
    if constexpr (kEpilogue) {
      const bool hit = corr[r] >= threshold && lag < n_lags;
      masks[r] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_hits[r][warp] = __popc(masks[r]);
    }
  }

  if constexpr (!kEpilogue) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= n_rows) break;
      if (tid < kRowCols) {
        const int lag = lag0 + r * kLanes + tid;
        rows[(static_cast<int64_t>(b) * n_rows + row) * kRowCols + tid] =
            lag < n_lags ? static_cast<int>(corr[r]) : 0;
      }
    }
  } else {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= n_rows) break;
      int* out = rows + (static_cast<int64_t>(b) * n_rows + row) * kRowCols;
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
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
}

}  // namespace

// x and xs: f32[batch, stride], 16-byte aligned, stride a multiple of the
// tile covering ceil(t/128) rows; rows: int32[batch, n_rows, 16].
extern "C" int tm_xcorr_hits_2s(const float* x, const float* xs, int64_t stride,
                                const float* pattern, int batch, int t, int l, float inv_pe,
                                float threshold, int n_rows, int epilogue, int* rows,
                                void* stream) {
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  if (l < 2 || l > kMaxL || t < l || batch < 1 || n_rows != (t + kLanes - 1) / kLanes ||
      stride < static_cast<int64_t>(n_tiles) * kTile || stride % kChunk != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(xs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_tiles, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue) {
    xcorr_hits_2s_kernel<true><<<grid, kLanes, 0, s>>>(x, xs, stride, pattern, t, l, inv_pe,
                                                      threshold, n_rows, rows);
  } else {
    xcorr_hits_2s_kernel<false><<<grid, kLanes, 0, s>>>(x, xs, stride, pattern, t, l, inv_pe,
                                                       threshold, n_rows, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
