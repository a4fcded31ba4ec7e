// The attempt-tile experiment: skeletons of the attempt kernel's
// per-candidate products (the sync dot and energy, the body product, the
// bit pack), one capture per block, the candidates in a loop.
//
// Replaces: tools/exp_attempt_tiles.py:make_kernel (:35), launched by the
// pallas_call at :165, in all its variants: base, n128, sync1, both,
// bf16b and noop, with the modifiers _nodma, _nostore and _uN.
//
// tm_attempt_tiles(x, ts, tsc, tb, tbn, w, wn, out, ...): x f32[B, 1200,
// 384], ts and tb f32[8, 768, 256], tsc and tbn f32[8, 768, 128], w
// f32[128, 128], wn f32[64, 128], out f32[B, 65, 34, 128] zero-filled by
// the caller.  Block b loops over the candidates c < n_cand.  Candidate c
// reads the 36 rows x[b, 9 (c % 8) + j], j < 36 (the TPU kernel's slab
// x[b, 8 (c % 8) : +48] from its row c % 8; rowsel's one-hot products are
// row indices here and cost no multiply-adds), then:
//   sync   x01 = rows 0, 1; q = 37 c % 384, v = q % 8, T = ts[v, q - v :]
//          (tsc for the merged sync).  For the lanes l < 13, four sums S_s
//          over k < 384, each as four chunks of 96 terms added in order:
//            base:   S0 = x0.T[:, l]  S1 = x1.T[:, 128+l]
//                    S2 = x0^2.T[:, l]^2  S3 = x1^2.T[:, 128+l]^2
//            merged: S0 = x0.T[:, l]  S1 = x1.T[:, 32+l]
//                    S2 = x0^2.T[:, 64+l]  S3 = x1^2.T[:, 96+l]
//          dot = S0 + S1, en = S2 + S3, cc = dot * (1 / sqrtf(max(en,
//          1e-6))) (the TPU kernel's rsqrt, IEEE-rounded here), best = the
//          first lane of largest cc.
//   body   rows c % 2 .. c % 2 + 34; o2 = (53 c + best) % 384 and
//          U = tb[o2 % 8, o2 - o2 % 8 :] (tbn: N = 128).  With P = N / 2,
//          d[r, k] = xsh[r].U[:, k] + xsh[r+1].U[:, P+k], r < 34, k < P;
//          bits = d <= 0; block = bits @ w (wn) f32[34, 128].  bf16b
//          rounds x and U to bf16 (__float2bfloat16_rn) and sums in f32.
//   noop   acc += sum_{j<8} x01[0, j], nothing else.
// The block goes to out[b, c] (not with _nostore); the accumulator adds
// dot[0] (_nostore: dot[0] + block[0, 0]) and is added to all of out[b, 0]
// at the end.  Every sum runs in k order with one fused multiply-add a
// term.  On the tool's tables (ternary, w and wn 0/1) every product is
// exact, so a fused multiply-add rounds as the plain version's multiply
// then add, and the kernel equals attempt_tiles_plain bit for bit.
//
// Staging (kStage; off for _nodma): the TPU kernel keeps a ring of `pipe`
// (48, 384) slabs in VMEM filled by async copies.  Four such slabs are
// 294,912 B, more than a block's 232,448 B of shared memory, so each stage
// here holds only the 36 rows a candidate reads (55,296 B; four stages
// 221,184 B).  Candidate c + pipe - 1 is copied by 16-byte cp.async while
// c computes; the caller refuses a depth that does not fit.
//
// What bounds it on an H100: operations.  A base candidate is 34 x 128 x
// 768 body multiply-adds (3.34 M), 34 x 128 x 128 for the pack (0.56 M)
// and 13 x 4 x 384 for the sync; 2,080 candidates make 16.3 GFLOP, 0.24 ms
// at 67 TFLOP/s in f32 against 0.011 ms for the 36 MB of output.  Design,
// a first kernel and a plain one: 256 threads a block, every product on
// the FP32 pipes (no tensor cores, also for bf16b), each body thread one
// column pair (k, P + k) over 17 rows (n128: 9), its 34 (18) sums in
// registers, x read as float4 broadcasts from the stage and U from device
// memory and L2 (the tables, 9 MiB, stay in L2); the bits go through
// warp ballots into shared masks; each pack thread one output column over
// 17 rows.  grid = (B,): 32 blocks on 132 SMs, one block an SM, as the
// TPU experiment's one core walks its captures in turn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsX = 1200;
constexpr int kDrow = 384;
constexpr int kNv = 65;
constexpr int kBrows = 34;
constexpr int kStageRows = 36;
constexpr int kStageFloats = kStageRows * kDrow;
constexpr int kTrows = 768;
constexpr int kLanes = 128;
constexpr int kSyncLanes = 13;
constexpr int kSyncSums = 4;
constexpr int kChunks = 4;
constexpr int kChunk = kDrow / kChunks;
constexpr int kThreads = 256;
constexpr int kMaxPipe = 4;
constexpr int kStaticSmem = 2048;      // trackmaker_tpu_torch/tools/exp_attempt_tiles.py:STATIC_SMEM
constexpr int kSmemPerBlock = 232448;

struct Scratch {
  float part[kSyncLanes][kSyncSums][kChunks];
  float cc[kSyncLanes];
  float dot0;
  float acc;
  int best;
  unsigned mask[kBrows][kLanes / 32];
};
static_assert(sizeof(Scratch) <= kStaticSmem, "the fixed scratch outgrew its reserve");
static_assert(kSyncLanes * kSyncSums * kChunks <= kThreads, "one sync chunk a thread");

__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// all but the newest `pending` groups have landed
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: wait_group<0>(); break;
    case 1: wait_group<1>(); break;
    case 2: wait_group<2>(); break;
    default: wait_group<3>(); break;
  }
}

// candidate c's 36 rows of capture xb into dst
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ xb, int c) {
  const float* src = xb + static_cast<int64_t>(9 * (c % 8)) * kDrow;
  for (int i = threadIdx.x; i < kStageFloats / 4; i += kThreads) copy16(dst + 4 * i, src + 4 * i);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The sync of one candidate: sc.cc, sc.dot0 and sc.best.  xs: its rows.
template <bool kMerged>
__device__ __forceinline__ void sync_best(const float* xs, const float* __restrict__ ts,
                                          const float* __restrict__ tsc, int c, Scratch& sc) {
  const int tid = threadIdx.x;
  const int q = (c * 37) % kDrow;
  const int v = q % 8;
  const int idx = q - v;
  if (tid < kSyncLanes * kSyncSums * kChunks) {
    const int lane = tid / (kSyncSums * kChunks);
    const int s = (tid / kChunks) % kSyncSums;
    const int ch = tid % kChunks;
    constexpr int kN = kMerged ? 128 : 256;
    const float* tab = (kMerged ? tsc : ts) + (static_cast<int64_t>(v) * kTrows + idx) * kN;
    const int col = kMerged ? 32 * s + lane : (s & 1) * 128 + lane;
    const float* xr = xs + (s & 1) * kDrow;
    float p = 0.0f;
    for (int k = ch * kChunk; k < (ch + 1) * kChunk; ++k) {
      float xv = xr[k];
      float tv = tab[k * kN + col];
      if (s >= 2) {
        xv = xv * xv;
        if (!kMerged) tv = tv * tv;
      }
      p = fmaf(xv, tv, p);
    }
    sc.part[lane][s][ch] = p;
  }
  __syncthreads();
  if (tid < kSyncLanes) {
    float sum[kSyncSums];
#pragma unroll
    for (int s = 0; s < kSyncSums; ++s) {
      float t = sc.part[tid][s][0];
#pragma unroll
      for (int ch = 1; ch < kChunks; ++ch) t = t + sc.part[tid][s][ch];
      sum[s] = t;
    }
    const float dot = sum[0] + sum[1];
    const float en = sum[2] + sum[3];
    sc.cc[tid] = dot * (1.0f / sqrtf(fmaxf(en, 1e-6f)));
    if (tid == 0) sc.dot0 = dot;
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    float top = sc.cc[0];
    for (int l = 1; l < kSyncLanes; ++l) {
      if (sc.cc[l] > top) {
        top = sc.cc[l];
        best = l;
      }
    }
    sc.best = best;
  }
  __syncthreads();
}

// The body's bits of one candidate into sc.mask.  xsh: its 35 body rows.
template <bool kN128, bool kBf16>
__device__ __forceinline__ void body_bits(const float* xsh, const float* __restrict__ table,
                                          Scratch& sc) {
  constexpr int kN = kN128 ? 128 : 256;
  constexpr int kP = kN / 2;                                // column pairs
  constexpr int kGroups = kThreads / kP;                    // 2 or 4
  constexpr int kRg = (kBrows + kGroups - 1) / kGroups;     // 17 or 9 rows a thread
  const int tid = threadIdx.x;
  const int p = tid % kP;
  const int r0 = (tid / kP) * kRg;
  float acc_a[kRg], acc_b[kRg];
#pragma unroll
  for (int i = 0; i < kRg; ++i) {
    acc_a[i] = 0.0f;
    acc_b[i] = 0.0f;
  }
  for (int k = 0; k < kDrow; k += 4) {
    float ta[4], tb[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ta[kk] = table[(k + kk) * kN + p];
      tb[kk] = table[(k + kk) * kN + kP + p];
      if (kBf16) {
        ta[kk] = bf16r(ta[kk]);
        tb[kk] = bf16r(tb[kk]);
      }
    }
    // row r feeds acc_a of row r and acc_b of row r - 1
    float4 lo = r0 <= kBrows ? *reinterpret_cast<const float4*>(xsh + r0 * kDrow + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    if (kBf16) lo = make_float4(bf16r(lo.x), bf16r(lo.y), bf16r(lo.z), bf16r(lo.w));
#pragma unroll
    for (int i = 0; i < kRg; ++i) {
      const int r = r0 + i + 1;
      float4 hi = r <= kBrows ? *reinterpret_cast<const float4*>(xsh + r * kDrow + k)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      if (kBf16) hi = make_float4(bf16r(hi.x), bf16r(hi.y), bf16r(hi.z), bf16r(hi.w));
      acc_a[i] = fmaf(lo.x, ta[0], acc_a[i]);
      acc_a[i] = fmaf(lo.y, ta[1], acc_a[i]);
      acc_a[i] = fmaf(lo.z, ta[2], acc_a[i]);
      acc_a[i] = fmaf(lo.w, ta[3], acc_a[i]);
      acc_b[i] = fmaf(hi.x, tb[0], acc_b[i]);
      acc_b[i] = fmaf(hi.y, tb[1], acc_b[i]);
      acc_b[i] = fmaf(hi.z, tb[2], acc_b[i]);
      acc_b[i] = fmaf(hi.w, tb[3], acc_b[i]);
      lo = hi;
    }
  }
  // a warp holds 32 neighbouring columns of one row group: one ballot a row
#pragma unroll
  for (int i = 0; i < kRg; ++i) {
    const int r = r0 + i;
    const bool bit = r < kBrows && acc_a[i] + acc_b[i] <= 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, bit);
    if ((tid & 31) == 0 && r < kBrows) sc.mask[r][p / 32] = m;
  }
  __syncthreads();
}

// out rows [row0, row0 + 17) of column j of bits @ wm (kBits bits a row)
template <int kBits>
__device__ __forceinline__ void pack(const Scratch& sc, const float* __restrict__ wm, int j,
                                     int row0, float (&o)[17]) {
#pragma unroll
  for (int i = 0; i < 17; ++i) o[i] = 0.0f;
  for (int word = 0; word < kBits / 32; ++word) {
    unsigned m[17];
#pragma unroll
    for (int i = 0; i < 17; ++i) m[i] = sc.mask[row0 + i][word];
    for (int bit = 0; bit < 32; ++bit) {
      const float wv = wm[(32 * word + bit) * kLanes + j];
#pragma unroll
      for (int i = 0; i < 17; ++i) o[i] = fmaf(((m[i] >> bit) & 1u) ? 1.0f : 0.0f, wv, o[i]);
    }
  }
}

struct Args {
  const float* x;
  const float* ts;
  const float* tsc;
  const float* tb;
  const float* tbn;
  const float* w;
  const float* wn;
  float* out;
  int n_cand, pipe, store;
};

template <bool kMerged, bool kN128, bool kBf16, bool kNoop, bool kStage>
__global__ void __launch_bounds__(kThreads, 1) attempt_tiles_kernel(Args a) {
  extern __shared__ __align__(16) float ring[];
  __shared__ Scratch sc;
  const int tid = threadIdx.x;
  const float* xb = a.x + static_cast<int64_t>(blockIdx.x) * kRowsX * kDrow;
  float* outb = a.out + static_cast<int64_t>(blockIdx.x) * kNv * kBrows * kLanes;
  float acc = 0.0f;   // thread 0's
  if constexpr (kStage) {
    for (int i = 0; i < a.pipe - 1; ++i) {
      if (i < a.n_cand) stage(ring + i * kStageFloats, xb, i);
      commit_group();
    }
  }
  for (int c = 0; c < a.n_cand; ++c) {
    const float* xs;
    if constexpr (kStage) {
      const int next = c + a.pipe - 1;
      if (next < a.n_cand) stage(ring + (next % a.pipe) * kStageFloats, xb, next);
      commit_group();            // one group an iteration, empty past the last candidate
      wait_pending(a.pipe - 1);  // candidate c's group has landed
      __syncthreads();
      xs = ring + (c % a.pipe) * kStageFloats;
    } else {
      xs = xb + static_cast<int64_t>(9 * (c % 8)) * kDrow;
    }
    if constexpr (kNoop) {
      if (tid == 0) {
        float s = 0.0f;
        for (int j = 0; j < 8; ++j) s = s + xs[j];
        acc = acc + s;
      }
    } else {
      sync_best<kMerged>(xs, a.ts, a.tsc, c, sc);
      const int o2 = (c * 53 + sc.best) % kDrow;
      const int v2 = o2 % 8;
      constexpr int kN = kN128 ? 128 : 256;
      const float* table = (kN128 ? a.tbn : a.tb) + (static_cast<int64_t>(v2) * kTrows + o2 - v2) * kN;
      body_bits<kN128, kBf16>(xs + (c % 2) * kDrow, table, sc);
      const int j = tid % kLanes;
      const int row0 = (tid / kLanes) * 17;
      float o[17];
      pack<kN128 ? 64 : 128>(sc, kN128 ? a.wn : a.w, j, row0, o);
      if (a.store) {
        float* blk = outb + static_cast<int64_t>(c) * kBrows * kLanes;
#pragma unroll
        for (int i = 0; i < 17; ++i) blk[(row0 + i) * kLanes + j] = o[i];
        if (tid == 0) acc = acc + sc.dot0;
      } else if (tid == 0) {
        acc = acc + sc.dot0 + o[0];
      }
    }
    __syncthreads();   // the slot, the scratch and the masks are free for the next candidate
  }
  if (tid == 0) sc.acc = acc;
  __syncthreads();     // also orders the block's stores of out[b, 0] before the reads below
  const float add = sc.acc;
  for (int e = tid; e < kBrows * kLanes; e += kThreads) outb[e] = outb[e] + add;
}

template <bool kMerged, bool kN128, bool kBf16, bool kNoop, bool kStage>
int launch(const Args& a, int batch, cudaStream_t s) {
  auto kernel = attempt_tiles_kernel<kMerged, kN128, kBf16, kNoop, kStage>;
  const int dyn = kStage ? a.pipe * kStageFloats * static_cast<int>(sizeof(float)) : 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, dyn, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMerged, bool kN128, bool kBf16, bool kNoop>
int launch_staged(const Args& a, int batch, int staged, cudaStream_t s) {
  return staged ? launch<kMerged, kN128, kBf16, kNoop, true>(a, batch, s)
                : launch<kMerged, kN128, kBf16, kNoop, false>(a, batch, s);
}

}  // namespace

// kind: 0 base, 1 n128, 2 sync1, 3 both, 4 bf16b, 5 noop
// (exp_attempt_tiles.py:KINDS).  staged: the ring (0 for _nodma); store:
// 0 for _nostore; n_cand candidates, 1..65; pipe: the ring's depth.
extern "C" int tm_attempt_tiles(const float* x, const float* ts, const float* tsc,
                                const float* tb, const float* tbn, const float* w,
                                const float* wn, float* out, int batch, int kind, int staged,
                                int store, int n_cand, int pipe, void* stream) {
  const int64_t smem = (staged ? static_cast<int64_t>(pipe) * kStageFloats * 4 : 0) + kStaticSmem;
  if (batch < 1 || n_cand < 1 || n_cand > kNv || (staged && (pipe < 1 || pipe > kMaxPipe)) ||
      smem > kSmemPerBlock || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, ts, tsc, tb, tbn, w, wn, out, n_cand, staged ? pipe : 1, store};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch_staged<false, false, false, false>(a, batch, staged, s);
    case 1: return launch_staged<false, true, false, false>(a, batch, staged, s);
    case 2: return launch_staged<true, false, false, false>(a, batch, staged, s);
    case 3: return launch_staged<true, true, false, false>(a, batch, staged, s);
    case 4: return launch_staged<false, false, true, false>(a, batch, staged, s);
    case 5: return launch_staged<false, false, false, true>(a, batch, staged, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
