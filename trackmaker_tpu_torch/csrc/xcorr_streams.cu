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
// 128 samples and zero-padded at the end (xs[i] = x[i + 128]).  `pattern`
// is a host pointer to kTaps = 136 floats, the taps then zeros; they go to
// the kernel by value, so a call copies nothing to the card.  For every
// lag i < T-L+1, with 2 <= L <= 129:
//   dot    = fma(x[i+j], p[j], dot)   energy = fma(x[i+j], x[i+j], energy)
//            for j = 0 .. L-1 in order, both from 0
//   corr   = energy < kEps ? 0 : dot / max(sqrtf(energy) * pe, 1e-30)   (pe = ||p||)
// on the register tile of csrc/xcorr_tile.cuh, with the expressions, the
// rounding and the hit epilogue of csrc/xcorr_hits.cu, so its rows
// int32[B, R, 16], R = ceil(T/128), equal kernel #1's bit for bit (see
// that file's header for the columns).  The form without the epilogue
// (kEpilogue false, the tool's `noep`) writes, in row r, column k < 16 =
// (int)corr[128 r + k] (C truncation, as astype(int32)), 0 past the last
// lag.
//
// What bounds it on an H100: the arithmetic, 2L fused multiply-adds per
// lag, as kernel #1; the operand is read from device memory once (the
// halo: 1/8 more), far below the card's bandwidth.  The first design gave
// each thread one lag of 8 rows, 2 x 8 shared loads a tap for 16
// multiply-adds, and shared memory bound it as it bound kernel #1's first
// design.
//
// Design: kernel #1's register tile.  A block of 128 threads covers 8
// rows, a tile of 1,024 lags, each thread 8 consecutive lags summed from
// windows of kWindow staged samples in registers.  The block stages the
// tile from x and the 128 samples after it from xs (the last 128 of xs's
// tile: xs[lag0 + 896 + k] = x[lag0 + 1024 + k]) into the padded layout
// sx() of the tile, each stream by its own group of 16-byte cp.async.cg
// copies (two a thread for the tile, one each for 32 threads for the
// halo): sx() keeps every piece of 4 samples contiguous and 16-byte
// aligned, so a copy lands where the tile reads it.  No thread loads the
// operand with a plain load, and no copy reaches past its own stream's
// tile, which is what the TPU experiment's "every operand is an offset-0
// block" means on this card.  At L = 129 the last step's window reaches
// round_up(L, 8) = 136 samples past the tile, 8 past the second stream's
// 128: those 8 are zero-filled, read into registers and fed to no tap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "xcorr_tile.cuh"

namespace {

constexpr int kMaxL = kLanes + 1;    // the halo fits one row of xs
constexpr int kHalo = kLanes;        // samples the second stream gives past the tile
constexpr int kTaps = (kMaxL + kChunk - 1) / kChunk * kChunk;   // the last step's taps
constexpr int kZeroTail = kTaps - kHalo;   // staged past the halo, read by no tap
constexpr int kPiece = 4;            // floats per 16-byte copy
constexpr int kStaged = sx(kTile + kTaps);
constexpr int kRowCols = 16;
constexpr int kHitSlots = 4;
constexpr int kBig = 1 << 30;
constexpr float kEps = 1e-6f;        // sync/correlate.py:EPS

static_assert(staged_halo(kMaxL, kMaxL - 1) == kTaps, "the last window ends at the zero tail");
static_assert(kZeroTail % kPiece == 0 && (kTile + kHalo) % 32 + kZeroTail <= 32,
              "the zero tail is whole float4s of one padded run");

struct Taps {                        // a pattern by value: the taps, then zeros
  float v[kTaps];
};

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
__global__ void __launch_bounds__(kThreads) xcorr_hits_2s_kernel(
    const float* __restrict__ x, const float* __restrict__ xs, int64_t stride,
    const __grid_constant__ Taps pat, int t, int l, float pe, float threshold, int n_rows,
    int* __restrict__ rows) {
  __shared__ __align__(16) float buf[kStaged];
  __shared__ __align__(16) float ps[kTaps];
  __shared__ __align__(16) float cs[kTile];
  __shared__ int warp_hits[kRows][kWarps];

  const int row0 = blockIdx.x * kRows;
  const int lag0 = row0 * kLanes;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_lags = t - l + 1;
  const int base = tid * kK;         // the thread's first lag in the tile

  // stream 1: the tile of x; stream 2: the 128 samples after it, from xs
  const float* x_tile = x + b * stride + lag0;
  const float* xs_halo = xs + b * stride + lag0 + kTile - kHalo;
  for (int i = tid * kPiece; i < kTile; i += kThreads * kPiece) copy16(buf + sx(i), x_tile + i);
  commit_group();
  if (tid < kHalo / kPiece) copy16(buf + sx(kTile + tid * kPiece), xs_halo + tid * kPiece);
  commit_group();
  if (tid < kZeroTail / kPiece) {
    *reinterpret_cast<float4*>(buf + sx(kTile + kHalo + tid * kPiece)) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int j = tid; j < kTaps; j += kThreads) ps[j] = pat.v[j];
  wait_all_groups();
  __syncthreads();

  float dot[kK], energy[kK];
  tap_sums(buf, ps, base, l, dot, energy);
  float corr[kK];
  bool any_hit = false;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float denom = sqrtf(fmaxf(energy[k], 0.0f)) * pe;
    corr[k] = energy[k] < kEps ? 0.0f : dot[k] / fmaxf(denom, 1e-30f);
    any_hit |= corr[k] >= threshold && lag0 + base + k < n_lags;
  }
#pragma unroll
  for (int q = 0; q < kK; q += 4) {
    *reinterpret_cast<float4*>(cs + base + q) =
        make_float4(corr[q], corr[q + 1], corr[q + 2], corr[q + 3]);
  }

  if constexpr (!kEpilogue) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= n_rows) break;
      if (tid < kRowCols) {
        const int lag = lag0 + r * kLanes + tid;
        rows[(static_cast<int64_t>(b) * n_rows + row) * kRowCols + tid] =
            lag < n_lags ? static_cast<int>(cs[r * kLanes + tid]) : 0;
      }
    }
    return;
  }

  if (!__syncthreads_or(any_hit)) {
    // most blocks: empty rows, written at once (2^30 in the slots, zero
    // elsewhere)
    for (int i = tid; i < kRows * kRowCols; i += kThreads) {
      const int row = row0 + i / kRowCols;
      const int c = i % kRowCols;
      if (row < n_rows) {
        rows[(static_cast<int64_t>(b) * n_rows + row) * kRowCols + c] = c < kHitSlots ? kBig : 0;
      }
    }
    return;
  }

  // the hit rows: lane tid of each row
  unsigned masks[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lag = lag0 + r * kLanes + tid;
    const bool hit = cs[r * kLanes + tid] >= threshold && lag < n_lags;
    masks[r] = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[r][warp] = __popc(masks[r]);
  }
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
        out[kHitSlots + 1 + rank] = __float_as_int(cs[r * kLanes + tid]);
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

// x and xs: f32[batch, stride], 16-byte aligned, stride a multiple of the
// tile covering ceil(t/128) rows; pattern: a host pointer to kTaps floats,
// the taps then zeros; rows: int32[batch, n_rows, 16].
extern "C" int tm_xcorr_hits_2s(const float* x, const float* xs, int64_t stride,
                                const float* pattern, int batch, int t, int l, float pe,
                                float threshold, int n_rows, int epilogue, int* rows,
                                void* stream) {
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  if (l < 2 || l > kMaxL || t < l || batch < 1 || n_rows != (t + kLanes - 1) / kLanes ||
      stride < static_cast<int64_t>(n_tiles) * kTile || stride % kPiece != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(xs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  memcpy(taps.v, pattern, sizeof taps.v);
  dim3 grid(n_tiles, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue) {
    xcorr_hits_2s_kernel<true><<<grid, kThreads, 0, s>>>(x, xs, stride, taps, t, l, pe,
                                                        threshold, n_rows, rows);
  } else {
    xcorr_hits_2s_kernel<false><<<grid, kThreads, 0, s>>>(x, xs, stride, taps, t, l, pe,
                                                         threshold, n_rows, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
