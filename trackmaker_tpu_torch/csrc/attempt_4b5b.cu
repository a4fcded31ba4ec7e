// Per-candidate 4B5B + NRZI frame attempt: sync-word refine + symbol decode.
//
// Replaces: trackmaker_tpu/phy/pallas_decode.py:_attempt_kernel_4b5b,
// launched from _spec_phase_a: its in-kernel refine branch (tm_attempt_4b5b)
// and its fold_sync branch (tm_attempt_4b5b_fold), which decodes from the
// frame starts fs_in int32[B, C] that the correlation kernel's fused refine
// found (xcorr_hits.cu, tm_xcorr_hits_refine) and skips the refine.
//
// For capture b and candidate slot c < min(n_valid[b], C):
//   i_c  = min(cand[b, c], T),  base = i_c + 15
//   refine: for k in [0, 31) the 30-sample window at base + k against the
//     sync word s (the last 30 preamble samples):
//       cc_k = en > 1e-6 ? dot / (sqrtf(en) * sync_e) : 0
//     with cc_k = -inf where base + k > vlen[b] - 30.  The first maximum
//     wins; fs = (max > -1 ? base + best : i_c + 30) + 30.
//   levels: level j = (x[fs+3j] + x[fs+3j+1]) + x[fs+3j+2], a sum, for the
//     3200 levels of 640 symbols of 5 levels.
//   symbols: bit k of symbol m (MSB first) is the transition
//     prev * level < 0 of level 5m+k, prev being the level just before
//     (+1 before level 0); the 4B5B inverse maps the symbol to a nibble or
//     marks it invalid.  A level is near zero when |level| <= 4e-6.
// Samples at or past T read as zero.  Outputs, absolute positions in int32:
//   bytes      uint8[B, C, 263]  nibble pairs of symbols 0..525, zero from
//                                the first invalid symbol on
//   fs         int32[B, C]  (the fold form copies fs_in)
//   first_bad  int32[B, C]  first invalid symbol of 0..525, else 526
//   first_zero int32[B, C]  first of symbols 0..639 with a near-zero level,
//                           else 640 (the window the JAX epilogue searches)
// Slots c >= min(n_valid[b], C) get zeros everywhere.
//
// Row b of the tables reads x + b * x_stride.  A row stride of 0 is the
// kernel's shared_x branch (the long-capture blocked decode): every row,
// one block of one flat capture of T samples, reads that capture, so a
// frame near a block's end reads the samples that follow it; T is then the
// padded flat length and vlen[b] the capture's true length.
//
// The constants are those of the spl=3 4B5B configuration that the Python
// wrapper admits (preamble 60 samples, sync word 30, margin 15, at most 263
// frame bytes = 526 symbols).  The receiver reads each transition against
// the last level that was not near zero; reading it against the level just
// before is the same wherever no level is near zero, and the epilogue
// sends a capture whose attempted frames hold a near-zero level to the
// exact scan.
//
// Sum order: the refine adds its 30 taps with rounded products and rounded
// sums, never fused, in tap order, and each level as (x0 + x1) + x2; the
// plain version in phy/spec_decode.py adds the same way, so the two agree
// exactly, near ties and near-zero levels included.
//
// What bounds it on an H100: memory.  A candidate reads 9,600 samples
// (38 KB) from one contiguous stretch of its capture and does a few adds
// per sample; the frames of a capture tile it, so one call reads about the
// whole batch once.  Design: one block of 640 threads per candidate slot.
// Warp 0 computes the 31 refine positions, one per lane, and takes the
// first maximum by shuffle; then each thread decodes one symbol from its
// 15 samples and the 3 before them, the block takes the first invalid and
// the first near-zero symbol by shared-memory atomicMin, and pairs of
// neighbouring threads pack their nibbles into a byte.  The fold form is
// the same template without the refine.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSymbols = 640;          // symbols decoded, one per thread
constexpr int kThreads = kSymbols;
constexpr int kFrameSymbols = 526;     // 263 bytes
constexpr int kFrameBytes = kFrameSymbols / 2;
constexpr int kSyncLen = 30;
constexpr int kPositions = 31;         // 2 * margin + 1
constexpr int kBaseOffset = 15;        // preamble - sync - margin
constexpr int kFallback = 30;          // preamble - sync
constexpr int kLevelSamples = 3;
constexpr int kSymbolSamples = 5 * kLevelSamples;
constexpr float kRefineEps = 1e-6f;
constexpr float kNearZero = 4e-6f;     // spec_decode.LEVEL_NEAR_ZERO

// 4B5B inverse, 5-bit symbol -> nibble, -1 where the symbol is invalid.
__constant__ int8_t kDecode[32] = {
    -1, -1, -1, -1, -1, -1, -1, -1, -1, 1,  4,  5,  -1, -1, 6,  7,
    -1, -1, 8,  9,  2,  3,  10, 11, -1, -1, 12, 13, 14, 15, 0,  -1};

__device__ __forceinline__ float sample(const float* xb, int t, int idx) {
  return idx < t ? xb[idx] : 0.0f;
}

__device__ __forceinline__ float level_at(const float* xb, int t, int s) {
  return __fadd_rn(__fadd_rn(sample(xb, t, s), sample(xb, t, s + 1)),
                   sample(xb, t, s + 2));
}

template <bool kFold>
__global__ void attempt_4b5b_kernel(
    const float* __restrict__ x, int64_t x_stride, const int* __restrict__ cand,
    const int* __restrict__ n_valid, const int* __restrict__ vlen,
    const float* __restrict__ sync, int t, int n_cand, float sync_e,
    const int* __restrict__ fs_in, uint8_t* __restrict__ bytes,
    int* __restrict__ fs_out,
    int* __restrict__ first_bad_out, int* __restrict__ first_zero_out) {
  __shared__ int fs_shared;
  __shared__ int first_bad;
  __shared__ int first_zero;

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t slot = static_cast<int64_t>(b) * n_cand + c;
  uint8_t* out = bytes + slot * kFrameBytes;

  if (c >= min(n_valid[b], n_cand)) {
    if (tid < kFrameBytes) out[tid] = 0;
    if (tid == 0) {
      fs_out[slot] = 0;
      first_bad_out[slot] = 0;
      first_zero_out[slot] = 0;
    }
    return;
  }

  const float* xb = x + b * x_stride;
  int fs;
  if constexpr (kFold) {
    if (tid == 0) {
      first_bad = kFrameSymbols;
      first_zero = kSymbols;
    }
    fs = fs_in[slot];
    __syncthreads();
  } else {
    const int i_c = min(cand[slot], t);
    const int base = i_c + kBaseOffset;

    if (tid < 32) {
      float cc = -INFINITY;
      if (tid < kPositions) {
        float dot = 0.0f, en = 0.0f;
        for (int j = 0; j < kSyncLen; ++j) {
          const float v = sample(xb, t, base + tid + j);
          dot = __fadd_rn(dot, __fmul_rn(v, sync[j]));
          en = __fadd_rn(en, __fmul_rn(v, v));
        }
        const float val = en > kRefineEps ? dot / (sqrtf(en) * sync_e) : 0.0f;
        cc = base + tid <= vlen[b] - kSyncLen ? val : -INFINITY;
      }
      // first maximum: the larger value wins, a tie goes to the lower index
      int best = tid;
      for (int off = 16; off > 0; off >>= 1) {
        const float o_cc = __shfl_down_sync(0xffffffffu, cc, off);
        const int o_best = __shfl_down_sync(0xffffffffu, best, off);
        if (o_cc > cc || (o_cc == cc && o_best < best)) {
          cc = o_cc;
          best = o_best;
        }
      }
      if (tid == 0) {
        fs_shared = (cc > -1.0f ? base + best : i_c + kFallback) + kSyncLen;
        first_bad = kFrameSymbols;
        first_zero = kSymbols;
      }
    }
    __syncthreads();
    fs = fs_shared;
  }
  const int s0 = fs + tid * kSymbolSamples;
  float prev = tid == 0 ? 1.0f : level_at(xb, t, s0 - kLevelSamples);
  int sym = 0;
  bool near_zero = false;
  for (int k = 0; k < 5; ++k) {
    const float lv = level_at(xb, t, s0 + k * kLevelSamples);
    sym = (sym << 1) | (prev * lv < 0.0f ? 1 : 0);
    near_zero |= fabsf(lv) <= kNearZero;
    prev = lv;
  }
  const int nib = tid < kFrameSymbols ? kDecode[sym] : 0;
  if (nib < 0) atomicMin(&first_bad, tid);
  if (near_zero) atomicMin(&first_zero, tid);
  __syncthreads();

  const int bad = first_bad;
  const int kept = tid < bad ? nib : 0;
  const int next = __shfl_down_sync(0xffffffffu, kept, 1);   // 640 = 20 warps
  if ((tid & 1) == 0 && tid < kFrameSymbols) {
    out[tid / 2] = static_cast<uint8_t>((kept << 4) | next);
  }
  if (tid == 0) {
    fs_out[slot] = fs;
    first_bad_out[slot] = bad;
    first_zero_out[slot] = first_zero;
  }
}

}  // namespace

extern "C" int tm_attempt_4b5b(const float* x, int64_t x_stride, const int* cand,
                               const int* n_valid, const int* vlen,
                               const float* sync, int batch, int t, int n_cand,
                               float sync_e, uint8_t* bytes, int* fs,
                               int* first_bad, int* first_zero, void* stream) {
  if (batch < 1 || n_cand < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_cand, batch);
  attempt_4b5b_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, cand, n_valid, vlen, sync, t, n_cand, sync_e, nullptr, bytes, fs,
      first_bad, first_zero);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tm_attempt_4b5b_fold(const float* x, int64_t x_stride,
                                    const int* fs_in, const int* n_valid,
                                    int batch, int t, int n_cand, uint8_t* bytes,
                                    int* fs, int* first_bad, int* first_zero,
                                    void* stream) {
  if (batch < 1 || n_cand < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_cand, batch);
  attempt_4b5b_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, nullptr, n_valid, nullptr, nullptr, t, n_cand, 0.0f, fs_in, bytes,
      fs, first_bad, first_zero);
  return static_cast<int>(cudaGetLastError());
}
