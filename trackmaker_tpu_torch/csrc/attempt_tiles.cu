// The attempt-tile experiment: skeletons of the attempt kernel's
// per-candidate products (the sync dot and energy, the body product, the
// bit pack), a block a group of kGroup candidates of one capture.
//
// Replaces: tools/exp_attempt_tiles.py:make_kernel (:35), launched by the
// pallas_call at :165, in all its variants: base, n128, sync1, both,
// bf16b and noop, with the modifiers _nodma, _nostore and _uN.
//
// tm_attempt_tiles(x, ts, tsc, tb, tbn, w, wn, out, part, count, ...): x
// f32[B, 1200, 384], ts and tb f32[8, 768, 256], tsc and tbn f32[8, 768,
// 128], w f32[128, 128], wn f32[64, 128], out f32[B, 65, 34, 128]
// zero-filled by the caller; part f32[B, 65, 2] scratch and count
// int32[B] zero at the launch (the kernel leaves it zero).  Candidate c <
// n_cand reads the 36 rows x[b, 9 (c % 8) + j], j < 36 (the TPU kernel's
// slab x[b, 8 (c % 8) : +48] from its row c % 8; rowsel's one-hot products
// are row indices here and cost no multiply-adds), then:
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
//          d[r, k] = acc_a + acc_b, acc_a = xsh[r].U[:, k] and acc_b =
//          xsh[r+1].U[:, P+k], r < 34, k < P; bits = d <= 0; block = bits @
//          w (wn) f32[34, 128].  bf16b rounds x and U to bf16
//          (__float2bfloat16_rn) and sums in f32.
//   noop   s = sum_{j<8} x01[0, j], nothing else.
// The block goes to out[b, c] (not with _nostore).  The accumulator is
// sum_c dot_c[0] in candidate order (_nostore: adds dot_c[0], then
// block_c[0, 0]; noop: s_c), added to all of out[b, 0] at the end.  Every
// sum runs in k order with one fused multiply-add a term.  On the tool's
// tables (ternary, w and wn 0/1) every product is exact, so a fused
// multiply-add rounds as the plain version's multiply then add, and the
// kernel equals attempt_tiles_plain bit for bit.
//
// What bounds it on an H100: operations.  A base candidate is 34 x 128 x
// 768 body multiply-adds (3.34 M), 34 x 128 x 128 for the pack (0.56 M)
// and 13 x 4 x 384 for the sync; 2,080 candidates make 16.3 GFLOP, 0.24 ms
// at 67 TFLOP/s in f32.  Every product runs on the FP32 pipes, bf16b too:
// a tensor-core product sums in an order no plain version repeats.  The
// first design ran a block a capture (32 blocks on 132 SMs, one an SM, 8
// warps) and read the table U with scalar loads inside its inner loop,
// latency-bound on L2 at 0.055 of the bound.
//
// Design: a block of 128 threads takes kGroup = 2 consecutive candidates
// of one capture, grid (B, ceil(n_cand / kGroup)): 1,056 blocks for the
// tool's 2,080 candidates, 3 blocks (12 warps, 168 registers a thread) an
// SM.
// * The sync first, two warps a candidate: lane (l, h) of a warp, l < 13,
//   h < 2, sums its lane's two products with x row h (dot and energy
//   column), the first warp chunks 0 and 1, the second 2 and 3, each pair
//   in parallel; the chunks are added in order through shared memory, a
//   shuffle gives dot and en, a butterfly of shuffles the first lane of
//   largest cc.  Its two rows come from device memory.  (With more
//   candidates than half the warps, a warp a candidate.)
// * The body on a register tile: a thread holds 17 rows x kC column pairs
//   (base: 2 pairs, two row groups; n128: 1), 68 sums (n128: 34) in
//   registers.  A step of 4 k reads the step's table values from the stage
//   (float2 for base) and each row of x as one float4 broadcast, which
//   feeds 4 kC fused multiply-adds a value.
// * The pack through shared memory: the bits of the 34 rows as 0/1 floats
//   in the stage the body just freed; a thread 17 rows of 2 output
//   columns, 34 sums over k fed by float4 broadcasts of the bits and one
//   float2 load of w a k.
// * The accumulator across blocks: each candidate's dot[0] (and block[0,
//   0]) goes to part; each block then adds one to count[b] after a fence,
//   and the last block of the capture sums part in candidate order, adds
//   it to out[b, 0] (stored by candidate 0's block, which arrived before)
//   and sets count[b] back to 0.
//
// Staging (the ring): `pipe` stages, a stage one candidate's 16 table
// rows U[k0 : k0 + 16, :] (contiguous in the table) and 35 body rows of x
// over the same 16 k (18,624 B), 24 a candidate (noop: one, the x rows of
// its first 16 k from row 0), in the order of the block's candidates.
// Stage s + pipe - 1 is copied by 16-byte cp.async while stage s computes,
// issued after the barrier that shows every thread is past stage s - 1.
// A ring fits when 3 blocks, each with its ring and the fixed scratch,
// share an SM (76,800 B a block): depths 1-4 fit, a deeper ring is
// refused before the launch.  bf16b rounds a stage's x in place once it
// lands, and each table value as a thread reads it from the stage.
// _nodma reads the body rows of x from device memory (a float4 broadcast
// through L1, rounded as read for bf16b), at 2 blocks an SM (its loads in
// flight take more than 168 registers); its table rows still come
// through a ring of two stages, whatever the depth asked for.  The copies
// keep their slot, candidate and k in counters, so a stage costs its
// copies, a wait and a barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsX = 1200;
constexpr int kDrow = 384;
constexpr int kNv = 65;
constexpr int kBrows = 34;
constexpr int kHalfRows = kBrows / 2;          // a row group's rows
constexpr int kStageRows = kBrows + 1;
constexpr int kChunk = 96;                     // a sync chunk
constexpr int kChunks = kDrow / kChunk;
constexpr int kStageK = 16;                    // k a stage
constexpr int kStagesPerCand = kDrow / kStageK;
constexpr int kUFloats = kStageK * 256;        // a stage's table rows (n128: half used)
constexpr int kStageFloats = kUFloats + kStageRows * kStageK;
constexpr int kNodmaPipe = 2;                  // _nodma's ring, for the table alone
constexpr int kTrows = 768;
constexpr int kLanes = 128;
constexpr int kSyncLanes = 13;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 2;                      // candidates a block
constexpr int kBlocksPerSm = 3;
constexpr int kNodmaBlocksPerSm = 2;           // _nodma's loads of x in flight need more registers
constexpr int kStep = 4;                       // k a register step
constexpr int kMaxPipe = 4;
constexpr int kStaticSmem = 1024;      // trackmaker_tpu_torch/tools/exp_attempt_tiles.py:STATIC_SMEM
constexpr int kSmemPerBlock = 233472 / kBlocksPerSm - 1024;   // an SM's share, less the system's

constexpr bool kSyncPairs = 2 * kGroup <= kWarps;   // two warps a candidate's sync

struct Scratch {
  float dot0[kGroup];
  int best[kGroup];
  float t01[kSyncPairs ? kGroup : 1][32][2];     // chunks 0 + 1 of each sum
  float acc;
  int last;
};
static_assert(sizeof(Scratch) <= kStaticSmem, "the fixed scratch outgrew its reserve");
static_assert(kMaxPipe * kStageFloats * 4 + kStaticSmem <= kSmemPerBlock, "four stages fit");
static_assert(kBrows * kLanes <= kStageFloats, "the pack's bits fit a stage");
static_assert(kThreads == kLanes, "a thread an output column in the pack");
static_assert(kStageRows * kStageK / 4 <= 2 * kThreads, "two pieces of x a thread at most");

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

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage q of a candidate into dst: the table rows U[16 q : 16 q + 16, :]
// of `u` (kN floats a row; with kU) and the 35 rows of x from `xr` over
// the same k (with kX), 16 bytes a copy.
template <int kN, bool kU, bool kX>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ u,
                                      const float* __restrict__ xr, int q) {
  if (kU) {
    constexpr int kPieces = kStageK * kN / 4;
    static_assert(kPieces % kThreads == 0, "whole rounds of pieces");
    const float* src = u + static_cast<int64_t>(q) * kStageK * kN + 4 * threadIdx.x;
    float* to = dst + 4 * threadIdx.x;
#pragma unroll
    for (int m = 0; m < kPieces / kThreads; ++m) copy16(to + 4 * kThreads * m, src + 4 * kThreads * m);
  }
  if (kX) {
    constexpr int kRowPieces = kStageK / 4;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = threadIdx.x + m * kThreads;       // piece i: row i / 4, floats 4 (i % 4)
      if (i < kStageRows * kRowPieces) {
        copy16(dst + kUFloats + 4 * i,
               xr + (i / kRowPieces) * kDrow + q * kStageK + 4 * (i % kRowPieces));
      }
    }
  }
}

// The sync's chunks ch0 .. ch0 + kNch - 1 of candidate c in one warp:
// lane (l, h), l < 13, sums x row h against its dot column (pd) and,
// squared, its energy column (pe), the chunks in parallel.
template <bool kMerged, int kNch>
__device__ __forceinline__ void sync_chunks(const float* __restrict__ xb,
                                            const float* __restrict__ ts,
                                            const float* __restrict__ tsc, int c, int ch0,
                                            float (&pd)[kNch], float (&pe)[kNch]) {
  const int lane = threadIdx.x & 31;
  const int l = lane & 15;
  const int h = lane >> 4;                       // x row h; S_h and S_{2+h}
  const int q = (c * 37) % kDrow;
  const int v = q % 8;
  constexpr int kN = kMerged ? 128 : 256;
  const float* tab = (kMerged ? tsc : ts) + (static_cast<int64_t>(v) * kTrows + q - v) * kN;
  const int col_dot = kMerged ? 32 * h + l : 128 * h + l;
  const int col_en = kMerged ? 64 + 32 * h + l : col_dot;
  const float* xr = xb + static_cast<int64_t>(9 * (c % 8) + h) * kDrow + ch0 * kChunk;
  tab += static_cast<int64_t>(ch0) * kChunk * kN;
#pragma unroll
  for (int ch = 0; ch < kNch; ++ch) {
    pd[ch] = 0.0f;
    pe[ch] = 0.0f;
  }
  if (l < kSyncLanes) {
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) {
        const int k = ch * kChunk + kk;
        const float xv = __ldg(xr + k);
        const float td = __ldg(tab + k * kN + col_dot);
        const float te = kMerged ? __ldg(tab + k * kN + col_en) : td * td;
        pd[ch] = fmaf(xv, td, pd[ch]);
        pe[ch] = fmaf(xv * xv, te, pe[ch]);
      }
    }
  }
}

// The sync's end in one warp, given lane (l, h)'s sums sd (S_h) and se
// (S_{2+h}) over all chunks: dot0 and best from lane 0.
__device__ __forceinline__ void sync_finish(float sd, float se, float* dot0, int* best) {
  const int lane = threadIdx.x & 31;
  const int l = lane & 15;
  // lane l (h = 0) holds S0 and S2, lane l + 16 S1 and S3
  const float dot = sd + __shfl_down_sync(0xffffffffu, sd, 16);
  const float en = se + __shfl_down_sync(0xffffffffu, se, 16);
  float top = l < kSyncLanes ? dot * (1.0f / sqrtf(fmaxf(en, 1e-6f))) : -INFINITY;
  int at = l;
  // first lane of largest cc: the larger wins, a tie keeps the lower lane
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, top, off);
    const int oi = __shfl_xor_sync(0xffffffffu, at, off);
    if (o > top || (o == top && oi < at)) {
      top = o;
      at = oi;
    }
  }
  if (lane == 0) {
    *dot0 = dot;
    *best = at;
  }
}

template <bool kRound>
__device__ __forceinline__ float4 ld4(const float* p) {
  float4 v = *reinterpret_cast<const float4*>(p);
  if (kRound) v = make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
  return v;
}

// A step of 4 k of the body: the step's table values from the stage `us`
// (bf16b: rounded as read), then each row of x from `xs` (kRoundX:
// rounded as read) feeds 8 kC sums; row r feeds acc_a of row r and acc_b
// of row r - 1.
template <int kN, int kC, bool kBf16, bool kRoundX, int kPitch>
__device__ __forceinline__ void body_step(const float* us, const float* xs, int kk,
                                          float (&acc_a)[kHalfRows][kC],
                                          float (&acc_b)[kHalfRows][kC]) {
  constexpr int kP = kN / 2;
  float ua[kC][kStep], ub[kC][kStep];
#pragma unroll
  for (int t = 0; t < kStep; ++t) {
    if constexpr (kC == 2) {
      const float2 va = *reinterpret_cast<const float2*>(us + (kk + t) * kN);
      const float2 vb = *reinterpret_cast<const float2*>(us + (kk + t) * kN + kP);
      ua[0][t] = va.x;
      ua[1][t] = va.y;
      ub[0][t] = vb.x;
      ub[1][t] = vb.y;
    } else {
      ua[0][t] = us[(kk + t) * kN];
      ub[0][t] = us[(kk + t) * kN + kP];
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if (kBf16) {
        ua[j][t] = bf16r(ua[j][t]);
        ub[j][t] = bf16r(ub[j][t]);
      }
    }
  }
  float4 lo = ld4<kRoundX>(xs + kk);
#pragma unroll
  for (int i = 0; i < kHalfRows; ++i) {
    const float4 hi = ld4<kRoundX>(xs + (i + 1) * kPitch + kk);
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      acc_a[i][j] = fmaf(lo.x, ua[j][0], acc_a[i][j]);
      acc_a[i][j] = fmaf(lo.y, ua[j][1], acc_a[i][j]);
      acc_a[i][j] = fmaf(lo.z, ua[j][2], acc_a[i][j]);
      acc_a[i][j] = fmaf(lo.w, ua[j][3], acc_a[i][j]);
      acc_b[i][j] = fmaf(hi.x, ub[j][0], acc_b[i][j]);
      acc_b[i][j] = fmaf(hi.y, ub[j][1], acc_b[i][j]);
      acc_b[i][j] = fmaf(hi.z, ub[j][2], acc_b[i][j]);
      acc_b[i][j] = fmaf(hi.w, ub[j][3], acc_b[i][j]);
    }
    lo = hi;
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
  float* part;
  int* count;
  int n_cand, pipe, store;
};

template <bool kMerged, bool kN128, bool kBf16, bool kNoop, bool kStage>
__global__ void __launch_bounds__(kThreads, kStage ? kBlocksPerSm : kNodmaBlocksPerSm)
attempt_tiles_kernel(Args a) {
  extern __shared__ __align__(16) float ring[];
  __shared__ Scratch sc;
  constexpr int kN = kN128 ? 128 : 256;
  constexpr int kP = kN / 2;                     // column pairs
  constexpr int kC = kN128 ? 1 : 2;              // column pairs a thread
  constexpr int kRg = kHalfRows;                 // rows a thread
  constexpr int kCols = kP / kC;                 // threads a row group
  constexpr int kPer = kNoop ? 1 : kStagesPerCand;   // stages a candidate
  constexpr int kPitch = kStage ? kStageK : kDrow;   // x's row pitch where the body reads it
  static_assert(kCols * (kBrows / kRg) == kThreads && kCols % 32 == 0, "whole warps a row group");
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kGroup;
  const int n = min(kGroup, a.n_cand - c0);
  const int n_stages = n * kPer;
  const int pipe = a.pipe;                       // _nodma: kNodmaPipe
  const float* xb = a.x + static_cast<int64_t>(b) * kRowsX * kDrow;
  float* outb = a.out + static_cast<int64_t>(b) * kNv * kBrows * kLanes;
  float* partb = a.part + static_cast<int64_t>(b) * kNv * 2;
  // the first row of x a candidate's stages hold: its body's, noop's row 0
  auto x_rows = [&](int c) {
    return xb + static_cast<int64_t>(9 * (c % 8) + (kNoop ? 0 : c % 2)) * kDrow;
  };
  auto table = [&](int g) {                    // candidate c0 + g's U
    const int o2 = ((c0 + g) * 53 + sc.best[g]) % kDrow;
    const int v2 = o2 % 8;
    return (kN128 ? a.tbn : a.tb) + (static_cast<int64_t>(v2) * kTrows + o2 - v2) * kN;
  };
  // the producer: the next stage to copy, its candidate, k and slot
  int nxt = 0, ng = 0, nq = 0, nslot = 0;
  const float* nu = nullptr;
  const float* nx = x_rows(c0);
  auto issue = [&]() {                         // the next stage into its slot, one group
    if (nxt < n_stages) {
      float* dst = ring + nslot * kStageFloats;
      stage<kN, !kNoop, kStage || kNoop>(dst, nu, nx, nq);
      ++nxt;
      if (++nslot == pipe) nslot = 0;
      if (++nq == kPer) {
        nq = 0;
        if (++ng < n) {
          nx = x_rows(c0 + ng);
          if constexpr (!kNoop) nu = table(ng);
        }
      }
    }
    commit_group();
  };
  // the consumer: stage s landed and every thread past stage s - 1
  int cslot = 0;
  auto acquire = [&]() -> float* {
    if (pipe == 1) {
      __syncthreads();         // the one slot is free
      issue();
      wait_group<0>();
    } else {
      wait_pending(pipe - 2);
    }
    __syncthreads();
    if (pipe > 1) issue();     // stage s + pipe - 1, into stage s - 1's slot
    float* slot = ring + cslot * kStageFloats;
    if (++cslot == pipe) cslot = 0;
    if (kBf16 && kStage) {     // each staged value of x rounded once
      for (int i = tid; i < kStageRows * kStageK; i += kThreads) {
        slot[kUFloats + i] = bf16r(slot[kUFloats + i]);
      }
      __syncthreads();
    }
    return slot;
  };

  if constexpr (kNoop) {
    if constexpr (kStage) {
      for (int s = 0; s < pipe - 1; ++s) issue();
    }
    for (int g = 0; g < n; ++g) {
      const int c = c0 + g;
      const float* xs = kStage ? acquire() + kUFloats : x_rows(c);
      if (tid == 0) {
        float s = 0.0f;
        for (int j = 0; j < 8; ++j) s = s + xs[j];
        partb[2 * c] = s;
        partb[2 * c + 1] = 0.0f;
      }
    }
  } else {
    const int lane = tid & 31;
    if constexpr (kSyncPairs) {
      // two warps a candidate: chunks 0-1 and 2-3, added in order through
      // shared memory
      const int g = tid >> 6;
      const int half = (tid >> 5) & 1;
      float pd[2], pe[2];
      if (g < n) sync_chunks<kMerged, 2>(xb, a.ts, a.tsc, c0 + g, 2 * half, pd, pe);
      if (g < n && half == 0) {
        sc.t01[g][lane][0] = pd[0] + pd[1];
        sc.t01[g][lane][1] = pe[0] + pe[1];
      }
      __syncthreads();
      if (g < n && half == 1) {
        sync_finish((sc.t01[g][lane][0] + pd[0]) + pd[1], (sc.t01[g][lane][1] + pe[0]) + pe[1],
                    &sc.dot0[g], &sc.best[g]);
      }
    } else {
      for (int g = tid >> 5; g < n; g += kWarps) {
        float pd[kChunks], pe[kChunks];
        sync_chunks<kMerged, kChunks>(xb, a.ts, a.tsc, c0 + g, 0, pd, pe);
        float sd = pd[0], se = pe[0];
#pragma unroll
        for (int ch = 1; ch < kChunks; ++ch) {
          sd = sd + pd[ch];
          se = se + pe[ch];
        }
        sync_finish(sd, se, &sc.dot0[g], &sc.best[g]);
      }
    }
    __syncthreads();
    nu = table(0);
    for (int s = 0; s < pipe - 1; ++s) issue();
    const int pc = tid % kCols;                  // the thread's pairs: kC pc .. kC pc + kC - 1
    const int grp = tid / kCols;                 // its rows: 17 grp .. 17 grp + 16
    const int r0 = grp * kRg;
    const float* wm = kN128 ? a.wn : a.w;
    for (int g = 0; g < n; ++g) {
      const int c = c0 + g;
      float acc_a[kRg][kC], acc_b[kRg][kC];
#pragma unroll
      for (int i = 0; i < kRg; ++i) {
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          acc_a[i][j] = 0.0f;
          acc_b[i][j] = 0.0f;
        }
      }
      float* slot = ring;
      for (int q = 0; q < kStagesPerCand; ++q) {
        slot = acquire();
        const float* us = slot + kC * pc;
        const float* xs = kStage ? slot + kUFloats + r0 * kPitch
                                 : x_rows(c) + static_cast<int64_t>(r0) * kDrow + q * kStageK;
        if constexpr (kStage) {
#pragma unroll
          for (int kk = 0; kk < kStageK; kk += kStep) {
            body_step<kN, kC, kBf16, false, kPitch>(us, xs, kk, acc_a, acc_b);
          }
        } else {               // x's loads from device memory: a step at a time
#pragma unroll 1
          for (int kk = 0; kk < kStageK; kk += kStep) {
            body_step<kN, kC, kBf16, kBf16, kPitch>(us, xs, kk, acc_a, acc_b);
          }
        }
      }
      // bit kC i + j: row r0 + i, pair kC pc + j; the sums' registers are free
      uint64_t mask = 0;
#pragma unroll
      for (int i = 0; i < kRg; ++i) {
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          mask |= static_cast<uint64_t>(acc_a[i][j] + acc_b[i][j] <= 0.0f) << (kC * i + j);
        }
      }
      // the pack: the bits of all 34 rows as 0/1 floats in the stage the
      // body just read; a thread 17 rows (ph's half) of 2 output columns
      float* bits = slot;
      __syncthreads();         // every thread is past the stage
#pragma unroll
      for (int i = 0; i < kRg; ++i) {
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          bits[(r0 + i) * kP + kC * pc + j] = (mask >> (kC * i + j)) & 1 ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
      const int ph = tid / (kLanes / 2);
      const int jc = 2 * (tid % (kLanes / 2));
      const float* brow = bits + ph * kRg * kP;
      float o[kRg][2];
#pragma unroll
      for (int i = 0; i < kRg; ++i) {
        o[i][0] = 0.0f;
        o[i][1] = 0.0f;
      }
      float2 wv[4], wn4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = __ldg(reinterpret_cast<const float2*>(wm + i * kLanes + jc));
#pragma unroll 1
      for (int k = 0; k < kP; k += 4) {
        // the next 4 rows of w (past the last: rows 0-3 again, unused)
        const int kn = k + 4 < kP ? k + 4 : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wn4[i] = __ldg(reinterpret_cast<const float2*>(wm + (kn + i) * kLanes + jc));
        }
#pragma unroll
        for (int i = 0; i < kRg; ++i) {
          const float4 bb = *reinterpret_cast<const float4*>(brow + i * kP + k);
          const float bk[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            o[i][0] = fmaf(bk[t], wv[t].x, o[i][0]);
            o[i][1] = fmaf(bk[t], wv[t].y, o[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = wn4[i];
      }
      if (a.store) {
        float* blk = outb + (static_cast<int64_t>(c) * kBrows + ph * kRg) * kLanes + jc;
#pragma unroll
        for (int i = 0; i < kRg; ++i) {
          *reinterpret_cast<float2*>(blk + i * kLanes) = make_float2(o[i][0], o[i][1]);
        }
      }
      const float b00 = o[0][0];   // thread 0's: row 0, column 0
      if (tid == 0) {
        partb[2 * c] = sc.dot0[g];
        partb[2 * c + 1] = b00;
      }
    }
  }

  // the last block of the capture adds the accumulator to out[b, 0]
  __threadfence();             // this block's blocks and partials, device-wide
  __syncthreads();
  if (tid == 0) {
    const int n_blocks = (a.n_cand + kGroup - 1) / kGroup;
    sc.last = atomicAdd(a.count + b, 1) == n_blocks - 1;
    if (sc.last) {
      __threadfence();
      float acc = 0.0f;
      for (int c = 0; c < a.n_cand; ++c) {
        acc = acc + __ldcg(partb + 2 * c);
        if (!kNoop && !a.store) acc = acc + __ldcg(partb + 2 * c + 1);
      }
      sc.acc = acc;
      a.count[b] = 0;          // ready for the next launch
    }
  }
  __syncthreads();
  if (sc.last) {
    const float add = sc.acc;
    for (int e = tid; e < kBrows * kLanes; e += kThreads) outb[e] = __ldcg(outb + e) + add;
  }
}

template <bool kMerged, bool kN128, bool kBf16, bool kNoop, bool kStage>
int launch(const Args& a, int batch, cudaStream_t s) {
  auto kernel = attempt_tiles_kernel<kMerged, kN128, kBf16, kNoop, kStage>;
  const int dyn = a.pipe * kStageFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (a.n_cand + kGroup - 1) / kGroup);
  kernel<<<grid, kThreads, dyn, s>>>(a);
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
// part: f32[batch, 65, 2] scratch; count: int32[batch], zero.
extern "C" int tm_attempt_tiles(const float* x, const float* ts, const float* tsc,
                                const float* tb, const float* tbn, const float* w,
                                const float* wn, float* out, float* part, int* count, int batch,
                                int kind, int staged, int store, int n_cand, int pipe,
                                void* stream) {
  const int64_t smem = static_cast<int64_t>(staged ? pipe : kNodmaPipe) * kStageFloats * 4 + kStaticSmem;
  if (batch < 1 || n_cand < 1 || n_cand > kNv ||
      (staged && (pipe < 1 || pipe > kMaxPipe)) || smem > kSmemPerBlock ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, ts, tsc, tb, tbn, w, wn, out, part, count, n_cand, staged ? pipe : kNodmaPipe,
               store};
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
