// Normalized preamble cross-correlation with per-row hit extraction, and
// its two other entry points: the batch-folded grid and the fused per-hit
// sync-word refine.
//
// Replaces: trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_hits_kernel (through
// pallas_xcorr_hits; tm_xcorr_hits) and the normalized form of _xcorr_kernel
// (through pallas_normalized_xcorr): the `corr` output is that dense
// correlation; :_xcorr_hits_kernel_b (through pallas_xcorr_hits_batched;
// tm_xcorr_hits_batched); :_xcorr_hits_refine_kernel (through
// pallas_xcorr_hits_refine; tm_xcorr_hits_refine).  All three run one
// template, so their hit rows are the same bit for bit.
//
// For every capture b and lag i < T-L+1:
//   dot    = fma(x[i+j], p[j], dot)   energy = fma(x[i+j], x[i+j], energy)
//            for j = 0 .. L-1 in order, both from 0
//   corr   = energy < kEps ? 0 : dot / max(sqrtf(energy) * pe, 1e-30)
// with pe the pattern's norm in f32: a division, as the JAX package's
// correlate.normalized_xcorr divides (sqrtf and / are IEEE-rounded: the
// file is built without fast math), so a lag at the threshold falls on the
// reference's side of it.  xcorr_norm.cu runs the same steps
// (xcorr_tile.cuh), and xcorr_streams.cu compiles the same chains from
// `dot += v * p` (contracted to one fused multiply-add a tap), so the three
// give the same corr bit for bit.
// Lags are grouped into rows of 128.  Row r of `rows` (int32[B, R, 16]):
//   cols 0..3  the first four lags of the row with corr >= threshold,
//              ascending, padded with 2^30
//   col  4     the row's true hit count
//   cols 5..8  the corr at those hits, bit-cast to int32 (0 when absent)
//   cols 9..15 zero; with the refine, cols 9..12 hold each hit's refined
//              frame start as a delta from the hit and cols 13..15 zero.
//
// The refine of hit h, with s the sync word (W samples) and sync_e its norm:
//   for k in [0, n_pos) the window at p_k = h + sync_off + k:
//     cc_k = en > 1e-6 ? dot / (sqrtf(en) * sync_e) : 0
//   with the taps added as rounded products and rounded sums, never fused,
//   in tap order, and cc_k = -inf where p_k > vlen[b] - W.  The first
//   maximum wins: delta = max > -1 ? sync_off + best + W : fall_off, which
//   is also the delta of an absent hit.  These are the expressions and the
//   order of the refine in attempt_manchester.cu and attempt_4b5b.cu, so
//   h + delta equals their frame start bit for bit.
// Samples at or past T read as zero.
//
// What bounds it on an H100: the arithmetic, 2*L fused multiply-adds (4*L
// operations) a lag, 0.0795 ms at the flagship's 32 x 433,464 samples and
// L = 96 against the card's 67 TFLOP/s of f32; the input is read from
// device memory once (4 bytes a lag, plus a halo a block), far below the
// card's bandwidth.  The first design gave each thread one lane of 8 rows
// of 128 lags: lags 128 apart share no sample, so every tap cost a warp 8
// shared loads of x and a broadcast of p[j], 9 shared-memory wavefronts
// for 16 multiply-adds, and shared memory bound it at about 2.25x the FMA
// issue time.
//
// Design (the tile and its steps in xcorr_tile.cuh, shared with
// xcorr_norm.cu and sliding_dot.cu): a block of 128 threads covers kK rows
// of 128 lags, staged with their halo in shared memory, 4 floats of padding
// after every 32 samples (sx), so that a warp's 16-byte loads, kK floats
// apart from thread to thread, spread evenly over the banks.  Each thread
// sums kK consecutive lags: a step of kChunk taps loads a window of kK +
// kChunk samples and the step's taps (16-byte loads, the taps a broadcast),
// then does 2 * kK * kChunk multiply-adds from registers, so one shared
// load feeds 2 * kK of them and FFMA issue bounds the loop; a last step of
// fewer taps keeps the order for an L that is not a multiple of kChunk.  The
// pattern and the sync word come by value in the launch parameters (no copy
// to the card).  Then each thread's kK corr values go to shared memory.  A
// block without a hit (most of them) writes its empty rows at once; the
// others run the hit extraction, one lane of each row a thread: a warp
// ballot per row and warp, a popc prefix over the row's four warps and a
// scatter of the first four hits.  The refine compacts the block's live
// (row, slot) pairs in row-then-slot order, spreads the (pair, position)
// windows over all 128 threads and takes the first maximum over a pair's
// positions in one thread; the TPU form's dense sync correlation (two more
// banded products on an idle matrix unit) is not built.  The batch-folded
// entry loops a block over `bc` captures.  kK = 8 keeps a block at 8 rows of
// 128 lags, the first design's block; kK = 16 (90 registers, 16 rows a
// block) timed 1-2% faster on an H100 and kK = 4 13% slower (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "xcorr_tile.cuh"

namespace {

constexpr int kMaxL = 128;        // longest pattern (and sync word)
constexpr int kMaxHalo = 256;     // staged samples past the block's last lag
constexpr int kMaxPositions = 32; // refine positions
constexpr int kRowCols = 16;
constexpr int kHitSlots = 4;
constexpr int kMaxPairs = kRows * kHitSlots;
constexpr int kBig = 1 << 30;
constexpr float kEps = 1e-6f;     // sync/correlate.py:EPS
constexpr float kRefineEps = 1e-6f;

static_assert(kMaxHalo >= kMaxL, "the last step's window reaches round_up(L, kChunk) past the tile");

constexpr int kStaged = sx(kTile + kMaxHalo) + 4;

struct Taps {                     // a pattern by value: the taps, then zeros
  float v[kMaxL];
};

struct Refine {
  const int* vlen;       // int32[B] valid length of each capture
  float sync_e;          // the sync word's norm
  int w, sync_off, n_pos, fall_off;
  Taps sync;             // f32[W] sync word
};

template <bool kRefine>
__global__ void __launch_bounds__(kThreads) xcorr_hits_kernel(
    const float* __restrict__ x, const __grid_constant__ Taps pat, int batch, int bc, int t,
    int l, int staged, float pe, float threshold, int n_rows, int* __restrict__ rows,
    float* __restrict__ corr_out, const __grid_constant__ Refine rf) {
  __shared__ __align__(16) float xs[kStaged];
  __shared__ __align__(16) float ps[kMaxL];
  __shared__ __align__(16) float cs[kTile];
  __shared__ int warp_hits[kRows][kWarps];
  __shared__ float ss[kRefine ? kMaxL : 1];
  __shared__ int hit_at[kRefine ? kRows : 1][kHitSlots];   // tile index of each hit
  __shared__ int row_hits[kRefine ? kRows : 1];
  __shared__ int pair_at[kRefine ? kMaxPairs : 1];         // live pairs, compacted
  __shared__ int pair_col[kRefine ? kMaxPairs : 1];        // their row * 4 + slot
  __shared__ float cc[kRefine ? kMaxPairs : 1][kMaxPositions + 1];
  __shared__ int n_live_s;

  const int row0 = blockIdx.x * kRows;
  const int lag0 = row0 * kLanes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_lags = t - l + 1;
  const int base = tid * kK;      // the thread's first lag in the tile

  for (int j = tid; j < kMaxL; j += kThreads) ps[j] = pat.v[j];
  if constexpr (kRefine) {
    for (int j = tid; j < kMaxL; j += kThreads) ss[j] = rf.sync.v[j];
  }
  const int b_end = min(batch, (blockIdx.y + 1) * bc);
  for (int b = blockIdx.y * bc; b < b_end; ++b) {
    const float* xb = x + static_cast<int64_t>(b) * t;
    __syncthreads();   // the previous capture is done with the shared arrays
    // sample i goes to sx(i), and sx(i + kThreads) = sx(i) + sx(kThreads)
    float* dst = xs + sx(tid);
    for (int i = tid; i < kTile + staged; i += kThreads, dst += sx(kThreads)) {
      const int idx = lag0 + i;
      *dst = idx < t ? xb[idx] : 0.0f;
    }
    __syncthreads();

    float dot[kK], energy[kK];
    tap_sums(xs, ps, base, l, dot, energy);
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
    const bool block_hit = __syncthreads_or(any_hit);
    if (corr_out != nullptr) {   // the dense corr, coalesced
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int lag = lag0 + r * kLanes + tid;
        if (lag < n_lags) corr_out[static_cast<int64_t>(b) * n_lags + lag] = cs[r * kLanes + tid];
      }
    }
    if (!block_hit) {
      // most blocks: empty rows, written at once (2^30 in the slots, the
      // refine's fall_off in its columns, zero elsewhere)
      for (int i = tid; i < kRows * kRowCols; i += kThreads) {
        const int row = row0 + i / kRowCols;
        const int c = i % kRowCols;
        if (row < n_rows) {
          rows[(static_cast<int64_t>(b) * n_rows + row) * kRowCols + c] =
              c < kHitSlots ? kBig
              : kRefine && c > 2 * kHitSlots && c <= 3 * kHitSlots ? rf.fall_off : 0;
        }
      }
      continue;
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
          if constexpr (kRefine) hit_at[r][rank] = r * kLanes + tid;
        }
      }
      // the columns no hit wrote: empty slots, the count, the zero tail
      // and, with the refine, the deltas of absent hits (the live ones are
      // written below)
      if (tid < kRowCols) {
        const int c = tid;
        if (c < kHitSlots) {
          if (c >= total) out[c] = kBig;
        } else if (c == kHitSlots) {
          out[c] = total;
          if constexpr (kRefine) row_hits[r] = min(total, kHitSlots);
        } else if (c <= 2 * kHitSlots) {
          if (c - kHitSlots - 1 >= total) out[c] = 0;
        } else if (kRefine && c <= 3 * kHitSlots) {
          if (c - 2 * kHitSlots - 1 >= total) out[c] = rf.fall_off;
        } else {
          out[c] = 0;
        }
      }
    }

    if constexpr (kRefine) {
      __syncthreads();
      // the block's live (row, slot) pairs, in row-then-slot order
      if (tid < kMaxPairs) {
        const int r = tid / kHitSlots;
        const int slot = tid % kHitSlots;
        int before = 0, n = 0;
        for (int q = 0; q < kRows; ++q) {
          const int h = row0 + q < n_rows ? row_hits[q] : 0;
          before += q < r ? h : 0;
          n += h;
        }
        if (row0 + r < n_rows && slot < row_hits[r]) {
          pair_at[before + slot] = hit_at[r][slot];
          pair_col[before + slot] = tid;
        }
        if (tid == 0) n_live_s = n;
      }
      __syncthreads();
      const int n_live = n_live_s;
      if (n_live > 0) {
        // every (pair, position) window, spread over the block's threads
        const int vlen_b = rf.vlen[b];
        for (int item = tid; item < n_live * rf.n_pos; item += kThreads) {
          const int q = item / rf.n_pos;
          const int k = item - q * rf.n_pos;
          const int p = pair_at[q] + rf.sync_off + k;
          float sdot = 0.0f, sen = 0.0f;
          for (int j = 0; j < rf.w; ++j) {
            const float v = xs[sx(p + j)];
            sdot = __fadd_rn(sdot, __fmul_rn(v, ss[j]));
            sen = __fadd_rn(sen, __fmul_rn(v, v));
          }
          const float val = sen > kRefineEps ? sdot / (sqrtf(sen) * rf.sync_e) : 0.0f;
          cc[q][k] = lag0 + p <= vlen_b - rf.w ? val : -INFINITY;
        }
        __syncthreads();
        if (tid < n_live) {
          // first maximum: the larger value wins, a tie keeps the lower position
          float best_cc = -INFINITY;
          int best = 0;
          for (int k = 0; k < rf.n_pos; ++k) {
            if (cc[tid][k] > best_cc) {
              best_cc = cc[tid][k];
              best = k;
            }
          }
          const int col = pair_col[tid];
          const int row = row0 + col / kHitSlots;
          rows[(static_cast<int64_t>(b) * n_rows + row) * kRowCols + 2 * kHitSlots + 1 +
               col % kHitSlots] = best_cc > -1.0f ? rf.sync_off + best + rf.w : rf.fall_off;
        }
      }
    }
  }
}

int check_args(int batch, int bc, int t, int l, int n_rows) {
  if (l < 1 || l > kMaxL || t < l || batch < 1 || bc < 1 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

Taps taps_of(const float* host) {
  Taps taps;
  memcpy(taps.v, host, sizeof taps.v);
  return taps;
}

}  // namespace

// `pattern` (and `sync`) are host pointers to kMaxL = 128 floats: the taps,
// then zeros; they go to the kernel by value.
extern "C" int tm_xcorr_hits(const float* x, const float* pattern, int batch,
                             int t, int l, float pe,
                             float threshold, int n_rows, int* rows,
                             float* corr, void* stream) {
  if (int err = check_args(batch, 1, t, l, n_rows)) return err;
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_hits_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, taps_of(pattern), batch, 1, t, l, staged_halo(l, l - 1), pe, threshold, n_rows, rows,
      corr, Refine{});
  return static_cast<int>(cudaGetLastError());
}

// The hit rows of `bc` captures per block (no dense corr).
extern "C" int tm_xcorr_hits_batched(const float* x, const float* pattern,
                                     int batch, int bc, int t, int l,
                                     float pe, float threshold, int n_rows,
                                     int* rows, void* stream) {
  if (int err = check_args(batch, bc, t, l, n_rows)) return err;
  dim3 grid((n_rows + kRows - 1) / kRows, (batch + bc - 1) / bc);
  xcorr_hits_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, taps_of(pattern), batch, bc, t, l, staged_halo(l, l - 1), pe, threshold, n_rows,
      rows, nullptr, Refine{});
  return static_cast<int>(cudaGetLastError());
}

// The hit rows with each hit's refined frame start (no dense corr).
extern "C" int tm_xcorr_hits_refine(const float* x, const int* vlen,
                                    const float* pattern, const float* sync,
                                    int batch, int t, int l, int w,
                                    float pe, float sync_e, float threshold,
                                    int sync_off, int n_pos, int fall_off,
                                    int n_rows, int* rows, void* stream) {
  if (int err = check_args(batch, 1, t, l, n_rows)) return err;
  const int halo = max(l - 1, sync_off + n_pos + w - 2);
  if (w < 1 || w > kMaxL || sync_off < 0 || n_pos < 1 || n_pos > kMaxPositions ||
      halo > kMaxHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_hits_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, taps_of(pattern), batch, 1, t, l, staged_halo(l, halo), pe, threshold, n_rows, rows,
      nullptr, Refine{vlen, sync_e, w, sync_off, n_pos, fall_off, taps_of(sync)});
  return static_cast<int>(cudaGetLastError());
}
