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
//   dot    = sum_j x[i+j] * p[j]      energy = sum_j x[i+j]^2
//   corr   = energy < kEps ? 0 : dot * (1/sqrtf(max(energy, 1e-30))) * inv_pe
// (1.0f/sqrtf, both IEEE-rounded: the file is built without fast math.)
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
// What bounds it on an H100: the arithmetic, 2*L fused multiply-adds per
// lag, all fed from shared memory, plus n_pos*W multiply-adds per refined
// hit.  The input is read from device memory once (4 bytes per lag, plus
// a halo per block), far below the card's bandwidth.  Design: a block of
// 128 threads covers ROWS rows of 128 lags; it stages its ROWS*128 lags and
// a halo (L - 1 samples, or the refine's reach past the last lag when that
// is longer: sync_off + n_pos + W - 2) and the pattern in shared memory,
// and each thread sums the lags of one lane across the ROWS rows, so each
// pattern tap read from shared memory feeds ROWS independent dot and
// energy sums.  The sums are direct f32 sums in tap order; the hit
// extraction is one warp ballot per row and warp, a popc prefix over the
// row's four warps, and a scatter of the first four hits.  The refine
// gives each of the block's 32 (row, hit) slots to one warp, one lane per
// position, and takes the first maximum by shuffle; the TPU form's dense
// sync correlation (two more banded products on an idle matrix unit) is
// not built.  The batch-folded entry loops a block over `bc` captures.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;       // lags per row
constexpr int kRows = 8;          // rows per block
constexpr int kWarps = kLanes / 32;
constexpr int kMaxL = 128;        // longest pattern (and sync word) the block stages
constexpr int kMaxHalo = 256;     // staged samples past the block's last lag
constexpr int kMaxPositions = 32; // refine positions, one per lane
constexpr int kRowCols = 16;
constexpr int kHitSlots = 4;
constexpr int kBig = 1 << 30;
constexpr float kEps = 1e-6f;     // sync/correlate.py:EPS
constexpr float kRefineEps = 1e-6f;

struct Refine {
  const int* vlen;       // int32[B] valid length of each capture
  const float* sync;     // f32[W] sync word
  float sync_e;          // its norm
  int w, sync_off, n_pos, fall_off;
};

template <bool kRefine>
__global__ void xcorr_hits_kernel(const float* __restrict__ x,
                                  const float* __restrict__ pattern,
                                  int batch, int bc, int t, int l, int halo,
                                  float inv_pe, float threshold, int n_rows,
                                  int* __restrict__ rows,
                                  float* __restrict__ corr_out, Refine rf) {
  __shared__ float xs[kRows * kLanes + kMaxHalo];
  __shared__ float ps[kMaxL];
  __shared__ int warp_hits[kRows][kWarps];
  __shared__ float ss[kRefine ? kMaxL : 1];
  __shared__ int hit_at[kRefine ? kRows : 1][kHitSlots];   // xs index of each hit
  __shared__ int row_hits[kRefine ? kRows : 1];

  const int row0 = blockIdx.x * kRows;
  const int lag0 = row0 * kLanes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_lags = t - l + 1;

  for (int j = tid; j < l; j += kLanes) ps[j] = pattern[j];
  if constexpr (kRefine) {
    for (int j = tid; j < rf.w; j += kLanes) ss[j] = rf.sync[j];
  }
  const int b_end = min(batch, (blockIdx.y + 1) * bc);
  for (int b = blockIdx.y * bc; b < b_end; ++b) {
    const float* xb = x + static_cast<int64_t>(b) * t;
    __syncthreads();   // the previous capture is done with xs
    for (int i = tid; i < kRows * kLanes + halo; i += kLanes) {
      const int idx = lag0 + i;
      xs[i] = idx < t ? xb[idx] : 0.0f;
    }
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
          if constexpr (kRefine) hit_at[r][rank] = r * kLanes + tid;
        }
      }
      // the columns no hit wrote: empty slots, the count and the zero tail
      // (the refine writes its deltas below)
      if (tid < kRowCols) {
        const int c = tid;
        if (c < kHitSlots) {
          if (c >= total) out[c] = kBig;
        } else if (c == kHitSlots) {
          out[c] = total;
          if constexpr (kRefine) row_hits[r] = min(total, kHitSlots);
        } else if (c <= 2 * kHitSlots) {
          if (c - kHitSlots - 1 >= total) out[c] = 0;
        } else if (!kRefine || c > 3 * kHitSlots) {
          out[c] = 0;
        }
      }
    }

    if constexpr (kRefine) {
      __syncthreads();
      const int vlen_b = rf.vlen[b];
      for (int q = warp; q < kRows * kHitSlots; q += kWarps) {
        const int r = q / kHitSlots;
        const int slot = q % kHitSlots;
        const int row = row0 + r;
        if (row >= n_rows) break;
        int delta = rf.fall_off;
        if (slot < row_hits[r]) {   // the same for the whole warp
          const int at = hit_at[r][slot];
          float cc = -INFINITY;
          if (lane < rf.n_pos) {
            const int p = at + rf.sync_off + lane;
            float sdot = 0.0f, sen = 0.0f;
            for (int j = 0; j < rf.w; ++j) {
              const float v = xs[p + j];
              sdot = __fadd_rn(sdot, __fmul_rn(v, ss[j]));
              sen = __fadd_rn(sen, __fmul_rn(v, v));
            }
            const float val = sen > kRefineEps ? sdot / (sqrtf(sen) * rf.sync_e) : 0.0f;
            cc = lag0 + p <= vlen_b - rf.w ? val : -INFINITY;
          }
          // first maximum: the larger value wins, a tie goes to the lower position
          int best = lane;
          for (int off = 16; off > 0; off >>= 1) {
            const float o_cc = __shfl_down_sync(0xffffffffu, cc, off);
            const int o_best = __shfl_down_sync(0xffffffffu, best, off);
            if (o_cc > cc || (o_cc == cc && o_best < best)) {
              cc = o_cc;
              best = o_best;
            }
          }
          if (cc > -1.0f) delta = rf.sync_off + best + rf.w;
        }
        if (lane == 0) {
          rows[(static_cast<int64_t>(b) * n_rows + row) * kRowCols + 2 * kHitSlots + 1 + slot] =
              delta;
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

}  // namespace

extern "C" int tm_xcorr_hits(const float* x, const float* pattern, int batch,
                             int t, int l, float inv_pe,
                             float threshold, int n_rows, int* rows,
                             float* corr, void* stream) {
  if (int err = check_args(batch, 1, t, l, n_rows)) return err;
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_hits_kernel<false><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pattern, batch, 1, t, l, l - 1, inv_pe, threshold, n_rows, rows, corr, Refine{});
  return static_cast<int>(cudaGetLastError());
}

// The hit rows of `bc` captures per block (no dense corr).
extern "C" int tm_xcorr_hits_batched(const float* x, const float* pattern,
                                     int batch, int bc, int t, int l,
                                     float inv_pe, float threshold, int n_rows,
                                     int* rows, void* stream) {
  if (int err = check_args(batch, bc, t, l, n_rows)) return err;
  dim3 grid((n_rows + kRows - 1) / kRows, (batch + bc - 1) / bc);
  xcorr_hits_kernel<false><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pattern, batch, bc, t, l, l - 1, inv_pe, threshold, n_rows, rows, nullptr,
      Refine{});
  return static_cast<int>(cudaGetLastError());
}

// The hit rows with each hit's refined frame start (no dense corr).
extern "C" int tm_xcorr_hits_refine(const float* x, const int* vlen,
                                    const float* pattern, const float* sync,
                                    int batch, int t, int l, int w,
                                    float inv_pe, float sync_e, float threshold,
                                    int sync_off, int n_pos, int fall_off,
                                    int n_rows, int* rows, void* stream) {
  if (int err = check_args(batch, 1, t, l, n_rows)) return err;
  const int halo = max(l - 1, sync_off + n_pos + w - 2);
  if (w < 1 || w > kMaxL || sync_off < 0 || n_pos < 1 || n_pos > kMaxPositions ||
      halo > kMaxHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((n_rows + kRows - 1) / kRows, batch);
  xcorr_hits_kernel<true><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pattern, batch, 1, t, l, halo, inv_pe, threshold, n_rows, rows, nullptr,
      Refine{vlen, sync, sync_e, w, sync_off, n_pos, fall_off});
  return static_cast<int>(cudaGetLastError());
}
