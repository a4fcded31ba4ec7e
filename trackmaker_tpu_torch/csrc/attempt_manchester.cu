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
// What bounds it on an H100: bytes.  Each live slot reads a window of
// 12,684 samples (50.7 KB: the refine's 60 and the body's 12,624) and does
// a few adds a sample; the flagship holds about 2k live slots in 4k, whose
// windows overlap their neighbours' by about half (about 104 MB through L2
// for a 55 MB capture).  Design: 256-thread blocks, four an SM, take the
// slots column by column (c major, so the live slots come first): a block
// a slot for rows of their own, a persistent grid walking the slots for
// the rows of one shared capture (see launch below).  A live slot's window
// goes to shared memory with the Tensor Memory Accelerator's
// one-dimensional bulk copy, from the 16-byte boundary at or below its
// start, in two copies on two mbarriers: the first 64 floats (the
// refine's samples), then the rest.  Warp 0 refines from shared memory as
// soon as the first lands, its 13 lanes adding in tap order, while the
// rest lands; the kernel itself zero-fills the stage at and past T and
// loads the at most three samples below T that the last 16 bytes of a copy
// cannot take.  Each warp then decodes 32 consecutive bits a step, one bit
// a lane, from shared memory: three float2 reads a lane at a lane stride
// of 24 bytes, free of bank conflicts in each half-warp (an odd frame
// start reads one float, two float2 and one float), and packs them with
// one ballot: the ballot, bit-reversed, holds the warp's four bytes MSB
// first.  A dead slot costs a zero-fill by one warp, in a first pass over
// the slots.  The fold form is the same template without the refine and
// its copy.  The sync word comes by value in the launch parameters: a call
// copies nothing to the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSyncLen = 48;
constexpr int kPositions = 13;     // 2 * margin + 1
constexpr int kBaseOffset = 42;    // preamble - sync - margin
constexpr int kFallback = 48;      // preamble - sync
constexpr int kFrameBytes = 263;   // header 7 + max_frame_bytes 256
constexpr int kFrameBits = kFrameBytes * 8;
constexpr int kBitSamples = 6;     // 2 levels x 3 samples
constexpr int kBody = kFrameBits * kBitSamples;       // 12,624 samples from fs
constexpr int kRefineSpan = kPositions - 1 + kSyncLen;  // 60 samples from base
constexpr int kHead = 64;          // floats of the refine's copy (>= 3 + 60, 16-byte granules)
constexpr int kBlocksPerSm = 4;    // four 50.8 KB stages fit an SM's 228 KB

struct SyncWord {                  // the sync word by value
  float v[kSyncLen];
};

// the window a slot reads, from its start: legacy [base, base + 12,684),
// fold [fs, fs + 12,624); the stage holds it and up to 3 floats before it
template <bool kFold>
constexpr int kWindow = kFold ? kBody : kRefineSpan + kBody;

template <bool kFold>
constexpr int kStageFloats = kWindow<kFold> + 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
}

// one arrival that also expects `bytes` of copies, then the copy itself
// (none when bytes is 0: the phase then completes on the arrival); both
// addresses 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void copy_to_stage(float* dst, const float* src, int bytes,
                                              uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  if (bytes > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
  }
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

template <bool kFold>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attempt_manchester_kernel(
    const float* __restrict__ x, int64_t x_stride, const int* __restrict__ cand,
    const int* __restrict__ n_valid, const int* __restrict__ vlen,
    const __grid_constant__ SyncWord sync, int batch, int t, int n_cand, float sync_e,
    const int* __restrict__ fs_in, uint8_t* __restrict__ bytes,
    int* __restrict__ fs_out) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t bars[2];   // the refine's copy, the rest
  __shared__ float cc[kPositions];
  __shared__ int fs_shared;
  constexpr int kW = kWindow<kFold>;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // slot k of the walks is capture k % batch, candidate k / batch (c major,
  // so the live slots come first); the dead slots first, a warp each,
  // every warp of the grid at once
  const int n_slots = batch * n_cand;
  for (int k = blockIdx.x * kWarps + warp; k < n_slots; k += gridDim.x * kWarps) {
    const int b = k % batch;
    const int c = k / batch;
    if (c < min(n_valid[b], n_cand)) continue;
    const int64_t slot = static_cast<int64_t>(b) * n_cand + c;
    uint8_t* out = bytes + slot * kFrameBytes;
    for (int i = lane; i < kFrameBytes; i += 32) out[i] = 0;
    if (lane == 0) fs_out[slot] = 0;
  }

  // then the live slots, a block each at a time
  uint32_t parity = 0;
  for (int k = blockIdx.x; k < n_slots; k += gridDim.x) {
    const int b = k % batch;
    const int c = k / batch;
    if (c >= min(n_valid[b], n_cand)) continue;
    const int64_t slot = static_cast<int64_t>(b) * n_cand + c;
    const float* xb = x + b * x_stride;
    const int ws = kFold ? fs_in[slot] : min(cand[slot], t) + kBaseOffset;
    // stage index i holds sample ws - lead + i: [0, n_head) the refine's
    // copy, [n_head, n_bulk) the rest's, [n_bulk, end) loads, [end, lead +
    // window) zeros (at or past T)
    const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(xb + ws) >> 2) & 3);
    const int valid = max(0, min(kW, t - ws));
    const int end = valid > 0 ? lead + valid : lead;
    const int n_bulk = end & ~3;
    const int n_head = kFold ? 0 : min(n_bulk, kHead);
    const float* src = xb + ws - lead;

    __syncthreads();   // every thread is done with the previous slot's stage
    if (tid == 0) {
      // the stage was last read (and zero-filled) through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      copy_to_stage(stage, src, n_head * 4, &bars[0]);
      copy_to_stage(stage + n_head, src + n_head, (n_bulk - n_head) * 4, &bars[1]);
    }
    for (int i = max(n_bulk, lead) + tid; i < end; i += kThreads) stage[i] = src[i];
    for (int i = end + tid; i < lead + kW; i += kThreads) stage[i] = 0.0f;
    __syncthreads();

    bar_wait(&bars[0], parity);
    int fs = ws;
    if constexpr (!kFold) {
      if (warp == 0) {
        const int base = ws;
        if (lane < kPositions) {
          const float* w = stage + lead + lane;
          float dot = 0.0f, en = 0.0f;
          // rounded products and sums, never fused, in tap order: the plain
          // version adds the same way, so the first maximum matches it exactly
#pragma unroll
          for (int j = 0; j < kSyncLen; ++j) {
            const float v = w[j];
            dot = __fadd_rn(dot, __fmul_rn(v, sync.v[j]));
            en = __fadd_rn(en, __fmul_rn(v, v));
          }
          const float val = en > 1e-6f ? dot / (sqrtf(en) * sync_e) : 0.0f;
          cc[lane] = base + lane <= vlen[b] - kSyncLen ? val : -INFINITY;
        }
        __syncwarp();
        if (lane == 0) {
          int best = 0;
          float top = cc[0];
          for (int p = 1; p < kPositions; ++p) {
            if (cc[p] > top) {
              top = cc[p];
              best = p;
            }
          }
          const int i_c = base - kBaseOffset;
          const int start = (top > -1.0f ? base + best : i_c + kFallback) + kSyncLen;
          fs_shared = start;
          fs_out[slot] = start;
        }
      }
      __syncthreads();
      fs = fs_shared;
    } else if (tid == 0) {
      fs_out[slot] = fs;
    }

    bar_wait(&bars[1], parity);
    parity ^= 1;

    const int o = fs - ws + lead;   // the stage index of sample fs
    uint8_t* out = bytes + slot * kFrameBytes;
    for (int bit0 = warp * 32; bit0 < kFrameBits; bit0 += kThreads) {
      const int bit = bit0 + lane;
      float first = 0.0f, second = 0.0f;
      if (bit < kFrameBits) {
        const float* p6 = stage + o + bit * kBitSamples;
        float a0, a1, a2, a3, a4, a5;
        if ((o & 1) == 0) {
          const float2 p = *reinterpret_cast<const float2*>(p6);
          const float2 q = *reinterpret_cast<const float2*>(p6 + 2);
          const float2 r = *reinterpret_cast<const float2*>(p6 + 4);
          a0 = p.x; a1 = p.y; a2 = q.x; a3 = q.y; a4 = r.x; a5 = r.y;
        } else {
          const float2 q = *reinterpret_cast<const float2*>(p6 + 1);
          const float2 r = *reinterpret_cast<const float2*>(p6 + 3);
          a0 = p6[0]; a1 = q.x; a2 = q.y; a3 = r.x; a4 = r.y; a5 = p6[5];
        }
        first = a0 + a1 + a2;
        second = a3 + a4 + a5;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, first - second <= 0.0f);
      const int byte = bit0 / 8 + lane;
      if (lane < 4 && byte < kFrameBytes) {
        out[byte] = static_cast<uint8_t>((__brev(mask) >> (24 - 8 * lane)) & 0xFFu);
      }
    }
  }
}

// The blocks of the form's kernel that are resident on the current device
// at once, after the stage's opt-in above 48 KB; cached per device.
template <bool kFold>
int resident_blocks(int* err) {
  static int resident[64];
  int dev = 0;
  *err = static_cast<int>(cudaGetDevice(&dev));
  if (*err != 0 || dev >= 64) {
    *err = *err != 0 ? *err : static_cast<int>(cudaErrorInvalidDevice);
    return 0;
  }
  int& n = resident[dev];
  if (n == 0) {
    const int smem = kStageFloats<kFold> * static_cast<int>(sizeof(float));
    int per_sm = 0, sms = 0;
    *err = static_cast<int>(cudaFuncSetAttribute(attempt_manchester_kernel<kFold>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem));
    if (*err == 0) {
      *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, attempt_manchester_kernel<kFold>, kThreads, smem));
    }
    if (*err == 0) {
      *err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    }
    if (*err != 0) return 0;
    if (per_sm < 1) {
      *err = static_cast<int>(cudaErrorInvalidConfiguration);
      return 0;
    }
    n = per_sm * sms;
  }
  return n;
}

// Rows of their own (x_stride > 0) take a block a slot: about half their
// slots are live (2,080 of 4,096 at the flagship), and the block scheduler
// hands a new slot to each block as it finishes.  The rows of one shared
// capture take a persistent grid, as many blocks as are resident at once:
// few of their slots are live (48 of 8,192 at blocked_600s), and a block a
// slot would be mostly empty blocks.
template <bool kFold>
int launch(const float* x, int64_t x_stride, const int* cand, const int* n_valid,
           const int* vlen, const SyncWord& sync, int batch, int t, int n_cand,
           float sync_e, const int* fs_in, uint8_t* bytes, int* fs, void* stream) {
  if (batch < 1 || n_cand < 1 || t < 1 || static_cast<int64_t>(batch) * n_cand > INT32_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = 0;
  const int resident = resident_blocks<kFold>(&err);
  if (err != 0) return err;
  const int n_slots = batch * n_cand;
  const int blocks = x_stride == 0 ? min(n_slots, resident) : n_slots;
  const size_t smem = kStageFloats<kFold> * sizeof(float);
  attempt_manchester_kernel<kFold><<<blocks, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, cand, n_valid, vlen, sync, batch, t, n_cand, sync_e, fs_in, bytes, fs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `sync` is a host pointer to the 48-float sync word; it goes by value
extern "C" int tm_attempt_manchester(const float* x, int64_t x_stride,
                                     const int* cand, const int* n_valid,
                                     const int* vlen, const float* sync,
                                     int batch, int t, int n_cand, float sync_e,
                                     uint8_t* bytes, int* fs, void* stream) {
  SyncWord word;
  for (int j = 0; j < kSyncLen; ++j) word.v[j] = sync[j];
  return launch<false>(x, x_stride, cand, n_valid, vlen, word, batch, t, n_cand, sync_e,
                       nullptr, bytes, fs, stream);
}

extern "C" int tm_attempt_manchester_fold(const float* x, int64_t x_stride,
                                          const int* fs_in, const int* n_valid,
                                          int batch, int t, int n_cand,
                                          uint8_t* bytes, int* fs,
                                          void* stream) {
  return launch<true>(x, x_stride, nullptr, n_valid, nullptr, SyncWord{}, batch, t, n_cand,
                      0.0f, fs_in, bytes, fs, stream);
}
