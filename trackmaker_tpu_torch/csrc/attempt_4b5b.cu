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
// What bounds it on an H100: bytes.  Each live slot reads a window of
// 9,660 samples (38.6 KB: the refine's 60 and the body's 9,600; the fold
// form 9,600 from fs) and does a few adds a sample; fourb5b_b32 holds about
// 2k live slots whose windows overlap their neighbours' (about 79 MB
// through L2 for a 35 MB capture).  Design, as csrc/attempt_manchester.cu:
// 256-thread blocks, five an SM (40 warps), take the slots column by
// column (c major, so the live slots come first): a block a slot for rows
// of their own, a persistent grid walking the slots for the rows of one
// shared capture.  A live slot's window goes to shared memory with the
// Tensor Memory Accelerator's one-dimensional bulk copy, from the 16-byte
// boundary at or below its start, in copies on mbarriers: the first 64
// floats (the refine's samples), then the body in a copy per decode step
// (3,840 samples).  Warp 0 refines from shared memory as soon as the first
// lands, its 31 lanes adding in tap order, while the rest lands; the
// kernel itself zero-fills the stage at and past T and loads the at most
// three samples below T that the last 16 bytes of a copy cannot take.
// Each warp then decodes 32 consecutive symbols a step, one a lane, each
// step once its own copy has landed: 15 scalar shared reads at a lane
// stride of 15 floats (odd, so free of bank conflicts), the level before a
// symbol from the next-lower lane by a shuffle; the first invalid and the
// first near-zero symbol by ballot and __ffs, one shared atomicMin a
// warp; each even lane packs its nibble and its neighbour's into a byte,
// written once the block knows the first invalid symbol.  The 4B5B
// inverse is four bit masks and a validity mask in registers.  A dead
// slot costs a zero-fill by one warp, while the block's first live slot's
// copies land; a slot's start is read beside n_valid.  Where one slot's
// chain is the kernel's time (the few live slots of a shared capture),
// these overlaps are what it saves.  The fold form is the same template
// without the refine and its copy.  The sync word comes by value in the
// launch parameters: a call copies nothing to the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSymbols = 640;          // symbols decoded from fs
constexpr int kFrameSymbols = 526;     // 263 bytes
constexpr int kFrameBytes = kFrameSymbols / 2;
constexpr int kSyncLen = 30;
constexpr int kPositions = 31;         // 2 * margin + 1
constexpr int kBaseOffset = 15;        // preamble - sync - margin
constexpr int kFallback = 30;          // preamble - sync
constexpr int kLevelSamples = 3;
constexpr int kSymbolSamples = 5 * kLevelSamples;
constexpr int kBody = kSymbols * kSymbolSamples;        // 9,600 samples from fs
constexpr int kRefineSpan = kPositions - 1 + kSyncLen;  // 60 samples from base
constexpr int kHead = 64;              // floats of the refine's copy (>= 3 + 60, 16-byte granules)
constexpr int kSteps = (kSymbols / 32 + kWarps - 1) / kWarps;   // a warp's 32-symbol steps
constexpr int kStepSamples = kThreads * kSymbolSamples;         // 3,840: a step's samples
constexpr int kBlocksPerSm = 5;        // five 38.7 KB stages fit an SM's 228 KB
constexpr float kRefineEps = 1e-6f;
constexpr float kNearZero = 4e-6f;     // spec_decode.LEVEL_NEAR_ZERO

// 4B5B inverse, 5-bit symbol -> nibble, -1 where the symbol is invalid;
// the kernel reads it as the bit masks below
constexpr int8_t kDecode[32] = {
    -1, -1, -1, -1, -1, -1, -1, -1, -1, 1,  4,  5,  -1, -1, 6,  7,
    -1, -1, 8,  9,  2,  3,  10, 11, -1, -1, 12, 13, 14, 15, 0,  -1};

// bit s of the mask: symbol s is valid (bit < 0) or valid with nibble bit
// `bit` set
constexpr uint32_t decode_mask(int bit) {
  uint32_t m = 0;
  for (int s = 0; s < 32; ++s) {
    if (kDecode[s] >= 0 && (bit < 0 || ((kDecode[s] >> bit) & 1) != 0)) m |= 1u << s;
  }
  return m;
}

constexpr uint32_t kValid = decode_mask(-1);
constexpr uint32_t kNib0 = decode_mask(0);
constexpr uint32_t kNib1 = decode_mask(1);
constexpr uint32_t kNib2 = decode_mask(2);
constexpr uint32_t kNib3 = decode_mask(3);
static_assert(kValid == 0x7CFCCE00u, "the 4B5B inverse has 16 valid symbols");

struct SyncWord {                      // the sync word by value
  float v[kSyncLen];
};

// the window a slot reads, from its start: legacy [base, base + 9,660),
// fold [fs, fs + 9,600); the stage holds it and up to 3 floats before it
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

// The body of a slot's window, stage [n_head, n_bulk), in a copy per
// decode step on bars[1 + s]: step s reads stage indices below o + (s + 1)
// * 3,840, the frame start's index o being lead + (fs - ws), at most lead +
// 60 (legacy) or lead (fold)
template <bool kFold>
__device__ __forceinline__ void copy_body(float* stage, const float* src, int n_head,
                                          int n_bulk, int lead, uint64_t* bars) {
  int from = n_head;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int reach = lead + (kFold ? 0 : kRefineSpan) + (s + 1) * kStepSamples;
    const int to = s == kSteps - 1 ? n_bulk : max(from, min(n_bulk, (reach + 3) & ~3));
    copy_to_stage(stage + from, src + from, (to - from) * 4, &bars[1 + s]);
    from = to;
  }
}

__device__ __forceinline__ float level_at(const float* p) {
  return __fadd_rn(__fadd_rn(p[0], p[1]), p[2]);
}

__device__ __forceinline__ int nibble_of(int sym) {
  return static_cast<int>(((kNib0 >> sym) & 1u) | (((kNib1 >> sym) & 1u) << 1) |
                          (((kNib2 >> sym) & 1u) << 2) | (((kNib3 >> sym) & 1u) << 3));
}

// Slot k of the walks is capture k % batch, candidate k / batch (c major,
// so the live slots come first).  Every warp of the grid zero-fills the
// dead slots, a warp each.
__device__ __forceinline__ void zero_dead_slots(const int* __restrict__ n_valid, int batch,
                                                int n_cand, uint8_t* __restrict__ bytes,
                                                int* __restrict__ fs_out,
                                                int* __restrict__ first_bad_out,
                                                int* __restrict__ first_zero_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_slots = batch * n_cand;
  for (int k = blockIdx.x * kWarps + warp; k < n_slots; k += gridDim.x * kWarps) {
    const int b = k % batch;
    const int c = k / batch;
    if (c < min(n_valid[b], n_cand)) continue;
    const int64_t slot = static_cast<int64_t>(b) * n_cand + c;
    uint8_t* out = bytes + slot * kFrameBytes;
    for (int i = lane; i < kFrameBytes; i += 32) out[i] = 0;
    if (lane == 0) {
      fs_out[slot] = 0;
      first_bad_out[slot] = 0;
      first_zero_out[slot] = 0;
    }
  }
}

template <bool kFold>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attempt_4b5b_kernel(
    const float* __restrict__ x, int64_t x_stride, const int* __restrict__ cand,
    const int* __restrict__ n_valid, const int* __restrict__ vlen,
    const __grid_constant__ SyncWord sync, int batch, int t, int n_cand, float sync_e,
    const int* __restrict__ fs_in, uint8_t* __restrict__ bytes,
    int* __restrict__ fs_out, int* __restrict__ first_bad_out,
    int* __restrict__ first_zero_out) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t bars[1 + kSteps];   // the refine's copy, a copy a step
  __shared__ int fs_shared;
  __shared__ int first_bad;
  __shared__ int first_zero;
  constexpr int kW = kWindow<kFold>;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < 1 + kSteps; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the live slots, a block each at a time; the dead slots' zero-fill
  // runs while the block's first live slot's copies land
  const int n_slots = batch * n_cand;
  bool dead_done = false;
  uint32_t parity = 0;
  for (int k = blockIdx.x; k < n_slots; k += gridDim.x) {
    const int b = k % batch;
    const int c = k / batch;
    const int64_t slot = static_cast<int64_t>(b) * n_cand + c;
    const int start = kFold ? fs_in[slot] : cand[slot];   // read beside n_valid, live or not
    if (c >= min(n_valid[b], n_cand)) continue;
    const float* xb = x + b * x_stride;
    const int ws = kFold ? start : min(start, t) + kBaseOffset;
    // stage index i holds sample ws - lead + i: [0, n_head) the refine's
    // copy, [n_head, n_bulk) the body's copies, [n_bulk, end) loads, [end,
    // lead + window) zeros (at or past T)
    const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(xb + ws) >> 2) & 3);
    const int valid = max(0, min(kW, t - ws));
    const int end = valid > 0 ? lead + valid : lead;
    const int n_bulk = end & ~3;
    const int n_head = kFold ? 0 : min(n_bulk, kHead);
    const float* src = xb + ws - lead;

    __syncthreads();   // every thread is done with the previous slot's stage and minima
    if (tid == 0) {
      // the stage was last read (and zero-filled) through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      copy_to_stage(stage, src, n_head * 4, &bars[0]);
      copy_body<kFold>(stage, src, n_head, n_bulk, lead, bars);
      first_bad = kFrameSymbols;
      first_zero = kSymbols;
    }
    for (int i = max(n_bulk, lead) + tid; i < end; i += kThreads) stage[i] = src[i];
    for (int i = end + tid; i < lead + kW; i += kThreads) stage[i] = 0.0f;
    if (!dead_done) {
      zero_dead_slots(n_valid, batch, n_cand, bytes, fs_out, first_bad_out, first_zero_out);
      dead_done = true;
    }
    __syncthreads();

    bar_wait(&bars[0], parity);
    int fs = ws;
    if constexpr (!kFold) {
      if (warp == 0) {
        const int base = ws;
        float cc = -INFINITY;
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
          const float val = en > kRefineEps ? dot / (sqrtf(en) * sync_e) : 0.0f;
          cc = base + lane <= vlen[b] - kSyncLen ? val : -INFINITY;
        }
        // first maximum: the larger value wins, a tie goes to the lower index
        int best = lane;
        for (int off = 16; off > 0; off >>= 1) {
          const float o_cc = __shfl_down_sync(0xffffffffu, cc, off);
          const int o_best = __shfl_down_sync(0xffffffffu, best, off);
          if (o_cc > cc || (o_cc == cc && o_best < best)) {
            cc = o_cc;
            best = o_best;
          }
        }
        if (lane == 0) {
          const int i_c = base - kBaseOffset;
          fs_shared = (cc > -1.0f ? base + best : i_c + kFallback) + kSyncLen;
        }
      }
      __syncthreads();
      fs = fs_shared;
    }

    // symbol m of the frame reads stage[o + 15m, o + 15m + 15); a step
    // waits only for its own copy
    const int o = fs - ws + lead;
    int warp_bad = kFrameSymbols, warp_zero = kSymbols;
    int packed[kSteps];   // an even lane's byte: its nibble, then its neighbour's
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int m0 = (warp + s * kWarps) * 32;
      packed[s] = 0;
      if (m0 < kSymbols) {   // uniform across the warp
        bar_wait(&bars[1 + s], parity);
        const int m = m0 + lane;
        const float* p = stage + o + m * kSymbolSamples;
        float lv[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) lv[j] = level_at(p + j * kLevelSamples);
        float prev = __shfl_up_sync(0xffffffffu, lv[4], 1);
        if (lane == 0) prev = m == 0 ? 1.0f : level_at(p - kLevelSamples);
        int sym = 0;
        bool near_zero = false;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          sym = (sym << 1) | (prev * lv[j] < 0.0f ? 1 : 0);
          near_zero |= fabsf(lv[j]) <= kNearZero;
          prev = lv[j];
        }
        const bool in_frame = m < kFrameSymbols;
        const bool ok = ((kValid >> sym) & 1u) != 0;
        const unsigned bad_mask = __ballot_sync(0xffffffffu, in_frame && !ok);
        const unsigned zero_mask = __ballot_sync(0xffffffffu, near_zero);
        // the steps go up in m: a warp's first hit is its minimum
        if (bad_mask != 0 && warp_bad == kFrameSymbols) warp_bad = m0 + __ffs(bad_mask) - 1;
        if (zero_mask != 0 && warp_zero == kSymbols) warp_zero = m0 + __ffs(zero_mask) - 1;
        const int nib = in_frame && ok ? nibble_of(sym) : 0;
        packed[s] = (nib << 4) | __shfl_down_sync(0xffffffffu, nib, 1);
      }
    }
    parity ^= 1;
    if (lane == 0) {
      if (warp_bad < kFrameSymbols) atomicMin(&first_bad, warp_bad);
      if (warp_zero < kSymbols) atomicMin(&first_zero, warp_zero);
    }
    __syncthreads();

    const int bad = first_bad;
    uint8_t* out = bytes + slot * kFrameBytes;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int m = (warp + s * kWarps) * 32 + lane;
      if ((lane & 1) == 0 && m < kFrameSymbols) {
        // nibbles from the first invalid symbol on are zero
        const int keep = (m < bad ? 0xF0 : 0) | (m + 1 < bad ? 0x0F : 0);
        out[m / 2] = static_cast<uint8_t>(packed[s] & keep);
      }
    }
    if (tid == 0) {
      fs_out[slot] = fs;
      first_bad_out[slot] = bad;
      first_zero_out[slot] = first_zero;
    }
  }
  if (!dead_done) {
    zero_dead_slots(n_valid, batch, n_cand, bytes, fs_out, first_bad_out, first_zero_out);
  }
}

// The blocks of the form's kernel that are resident on the current device
// at once; cached per device.
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
    *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attempt_4b5b_kernel<kFold>, kThreads, smem));
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
// slots are live at fourb5b_b32, and the block scheduler hands a new slot
// to each block as it finishes.  The rows of one shared capture take a
// persistent grid, as many blocks as are resident at once: few of their
// slots are live, and a block a slot would be mostly empty blocks.
template <bool kFold>
int launch(const float* x, int64_t x_stride, const int* cand, const int* n_valid,
           const int* vlen, const SyncWord& sync, int batch, int t, int n_cand,
           float sync_e, const int* fs_in, uint8_t* bytes, int* fs, int* first_bad,
           int* first_zero, void* stream) {
  if (batch < 1 || n_cand < 1 || t < 1 || static_cast<int64_t>(batch) * n_cand > INT32_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = 0;
  const int resident = resident_blocks<kFold>(&err);
  if (err != 0) return err;
  const int n_slots = batch * n_cand;
  const int blocks = x_stride == 0 ? min(n_slots, resident) : n_slots;
  const size_t smem = kStageFloats<kFold> * sizeof(float);
  attempt_4b5b_kernel<kFold><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, cand, n_valid, vlen, sync, batch, t, n_cand, sync_e, fs_in, bytes, fs,
      first_bad, first_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `sync` is a host pointer to the 30-float sync word; it goes by value
extern "C" int tm_attempt_4b5b(const float* x, int64_t x_stride, const int* cand,
                               const int* n_valid, const int* vlen,
                               const float* sync, int batch, int t, int n_cand,
                               float sync_e, uint8_t* bytes, int* fs,
                               int* first_bad, int* first_zero, void* stream) {
  SyncWord word;
  for (int j = 0; j < kSyncLen; ++j) word.v[j] = sync[j];
  return launch<false>(x, x_stride, cand, n_valid, vlen, word, batch, t, n_cand, sync_e,
                       nullptr, bytes, fs, first_bad, first_zero, stream);
}

extern "C" int tm_attempt_4b5b_fold(const float* x, int64_t x_stride,
                                    const int* fs_in, const int* n_valid,
                                    int batch, int t, int n_cand, uint8_t* bytes,
                                    int* fs, int* first_bad, int* first_zero,
                                    void* stream) {
  return launch<true>(x, x_stride, nullptr, n_valid, nullptr, SyncWord{}, batch, t, n_cand,
                      0.0f, fs_in, bytes, fs, first_bad, first_zero, stream);
}
