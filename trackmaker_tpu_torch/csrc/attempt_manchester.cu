// Per-candidate Manchester frame attempt: sync-word refine + frame decode.
//
// Replaces: trackmaker_tpu/phy/pallas_decode.py:_attempt_kernel, launched
// from _spec_phase_a: its in-kernel refine branch (tm_attempt_manchester)
// and its fold_sync branch (tm_attempt_manchester_fold), which decodes from
// the frame starts fs_in int32[B, C] that the correlation kernel's fused
// refine found (xcorr_hits.cu, tm_xcorr_hits_refine) and skips the refine.
//
// For capture b and candidate slot c < min(n_valid[b], C):
//   i_c  = min(cand[b, c], T),  base = i_c + 42
//   refine: for k in [0, 13) the 48-sample window at base + k against the
//     sync word s (the last 48 preamble samples):
//       cc_k = en > 1e-6 ? dot / (sqrtf(en) * sync_e) : 0
//     with cc_k = -inf where base + k > vlen[b] - 48.  The first maximum
//     wins; fs = (max > -1 ? base + best : i_c + 48) + 48.
//   decode: bit m of the frame is 1 iff
//       (x[fs+6m] + x[fs+6m+1] + x[fs+6m+2])
//         - (x[fs+6m+3] + x[fs+6m+4] + x[fs+6m+5]) <= 0
//     (a silent gap gives exactly 0 and decodes as 1); 263 bytes, MSB first.
// Samples at or past T read as zero.  Slots c >= min(n_valid[b], C) get
// zero bytes and fs = 0.  Outputs: bytes uint8[B, C, 263] and fs int32[B, C],
// an absolute position (the fold form copies fs_in to it).
//
// Row b of the tables reads x + b * x_stride.  A row stride of 0 is the
// kernel's shared_x branch (the long-capture blocked decode): every row,
// one block of one flat capture of T samples, reads that capture, so a
// frame near a block's end reads the samples that follow it; T is then the
// padded flat length and vlen[b] the capture's true length.
//
// The constants are those of the spl=3 Manchester configuration that the
// Python wrapper admits (preamble 96 samples, sync word 48, margin 6,
// header 336, at most 263 frame bytes).
//
// What bounds it on an H100: memory latency.  A candidate reads about 12.7k
// samples (50 KB) from one contiguous stretch of its capture and does a few
// adds per sample, and the flagship batch holds about 2k live candidates.
// Design: one block of 256 threads per candidate slot.  Warp 0 computes the
// 13 refine windows, one lane each, and lane 0 takes the first maximum; then
// each warp decodes 32 consecutive bits per step, one bit per lane, so a
// warp's loads cover 768 contiguous bytes, and packs them with one ballot:
// the ballot, bit-reversed, holds the warp's four bytes MSB first.  The
// fold form is the same template without the refine: every thread reads
// its slot's fs_in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSyncLen = 48;
constexpr int kPositions = 13;     // 2 * margin + 1
constexpr int kBaseOffset = 42;    // preamble - sync - margin
constexpr int kFallback = 48;      // preamble - sync
constexpr int kFrameBytes = 263;   // header 7 + max_frame_bytes 256
constexpr int kFrameBits = kFrameBytes * 8;
constexpr int kBitSamples = 6;     // 2 levels x 3 samples

__device__ __forceinline__ float sample(const float* xb, int t, int idx) {
  return idx < t ? xb[idx] : 0.0f;
}

template <bool kFold>
__global__ void attempt_manchester_kernel(
    const float* __restrict__ x, int64_t x_stride, const int* __restrict__ cand,
    const int* __restrict__ n_valid, const int* __restrict__ vlen,
    const float* __restrict__ sync, int t, int n_cand, float sync_e,
    const int* __restrict__ fs_in, uint8_t* __restrict__ bytes,
    int* __restrict__ fs_out) {
  __shared__ float cc[kPositions];
  __shared__ int fs_shared;

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t slot = static_cast<int64_t>(b) * n_cand + c;
  uint8_t* out = bytes + slot * kFrameBytes;

  if (c >= min(n_valid[b], n_cand)) {
    for (int i = tid; i < kFrameBytes; i += kThreads) out[i] = 0;
    if (tid == 0) fs_out[slot] = 0;
    return;
  }

  const float* xb = x + b * x_stride;
  int fs;
  if constexpr (kFold) {
    fs = fs_in[slot];
    if (tid == 0) fs_out[slot] = fs;
  } else {
    const int i_c = min(cand[slot], t);
    const int base = i_c + kBaseOffset;

    if (warp == 0) {
      if (lane < kPositions) {
        float dot = 0.0f, en = 0.0f;
        // rounded products and sums, never fused, in tap order: the plain
        // version adds the same way, so the first maximum matches it exactly
        for (int j = 0; j < kSyncLen; ++j) {
          const float v = sample(xb, t, base + lane + j);
          dot = __fadd_rn(dot, __fmul_rn(v, sync[j]));
          en = __fadd_rn(en, __fmul_rn(v, v));
        }
        const float val = en > 1e-6f ? dot / (sqrtf(en) * sync_e) : 0.0f;
        cc[lane] = base + lane <= vlen[b] - kSyncLen ? val : -INFINITY;
      }
      __syncwarp();
      if (lane == 0) {
        int best = 0;
        float top = cc[0];
        for (int k = 1; k < kPositions; ++k) {
          if (cc[k] > top) {
            top = cc[k];
            best = k;
          }
        }
        const int start = (top > -1.0f ? base + best : i_c + kFallback) + kSyncLen;
        fs_shared = start;
        fs_out[slot] = start;
      }
    }
    __syncthreads();
    fs = fs_shared;
  }

  for (int bit0 = warp * 32; bit0 < kFrameBits; bit0 += kThreads) {
    const int s = fs + (bit0 + lane) * kBitSamples;
    const float first = sample(xb, t, s) + sample(xb, t, s + 1) +
                        sample(xb, t, s + 2);
    const float second = sample(xb, t, s + 3) + sample(xb, t, s + 4) +
                         sample(xb, t, s + 5);
    const unsigned mask = __ballot_sync(0xffffffffu, first - second <= 0.0f);
    const int byte = bit0 / 8 + lane;
    if (lane < 4 && byte < kFrameBytes) {
      out[byte] = static_cast<uint8_t>((__brev(mask) >> (24 - 8 * lane)) & 0xFFu);
    }
  }
}

}  // namespace

extern "C" int tm_attempt_manchester(const float* x, int64_t x_stride,
                                     const int* cand, const int* n_valid,
                                     const int* vlen, const float* sync,
                                     int batch, int t, int n_cand, float sync_e,
                                     uint8_t* bytes, int* fs, void* stream) {
  if (batch < 1 || n_cand < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_cand, batch);
  attempt_manchester_kernel<false><<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, cand, n_valid, vlen, sync, t, n_cand, sync_e, nullptr, bytes,
      fs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tm_attempt_manchester_fold(const float* x, int64_t x_stride,
                                          const int* fs_in, const int* n_valid,
                                          int batch, int t, int n_cand,
                                          uint8_t* bytes, int* fs,
                                          void* stream) {
  if (batch < 1 || n_cand < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_cand, batch);
  attempt_manchester_kernel<true><<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, nullptr, n_valid, nullptr, nullptr, t, n_cand, 0.0f, fs_in,
      bytes, fs);
  return static_cast<int>(cudaGetLastError());
}
