// The offset-add experiment: three epilogues of one product o = x @ t,
// for x f32[40, 384] and t f32[384, 256], each writing out f32[32, 128].
//
// Replaces: tools/exp_offset_add.py:kernel_a (:24, tm_offset_add_a),
// :kernel_b (:30, tm_offset_add_b) and :kernel_c (:41, tm_offset_add_c),
// launched by the pallas_call at :60.
//
//   A  out[i, k] = o[i, k] + o[i + 1, 128 + k]
//   B  out[i, k] = o[0, k] + o[1, 128 + k]            (every row i)
//   C  ql = ((s % 64) + 64) % 64, s = sum_{j<8} (int)x[0, j]
//      out[i, k] = k + ql < 128 ? o[i, k + ql] : o[i + 1, k + ql - 128]
//
// with o[r, c] = sum_j x[r, j] * t[j, c].  C's mod is a floor mod, as in
// JAX and NumPy: C++'s % truncates toward zero, and s is negative on the
// tool's own input (s = -5 gives ql = 59).  The TPU kernel C builds its
// shift as a (128, 256) one-hot product on the matrix unit, a gather in
// disguise; here each lane's column is shifted and no product is spent on
// it.  Each kernel computes only the sums its form reads: A and C 32 x 128
// outputs of 768 and 384 terms, B one row of 128 of 768 terms, stored to
// all 32 rows.
//
// The order of the sums.  An output's terms are one sequence: A's and B's
// 768 are row i's 384 (x[i, j] t[j, k], j ascending) then row i + 1's
// (x[i + 1, j] t[j, 128 + k]); C's 384 are one row's at the shifted
// column.  The block cuts that sequence into 32 slices of equal length in
// order.  Each slice sums its terms in ascending order, one fused
// multiply-add a term from 0.0f; then the 32 slice sums are added in
// ascending slice order, one f32 add each.  No atomics.  On the tool's
// inputs (small integers, a 0/1 table) every sum is exact in any order,
// so the kernels equal the plain versions (a product, then the epilogue)
// and the NumPy oracles bit for bit.
//
// What bounds it on an H100: neither bytes nor operations.  The inputs are
// 0.45 MB and the sums 3.1 M multiply-adds at most (A), about 0.1 us of
// either at the card's peaks; a launch costs more.  What the design does:
// the first design gave each thread one output and its 768-term chain
// (3,000 clocks of dependent FMAs) from 32 blocks of 128 threads that each
// read all of t from L2.  Here a block of 256 threads takes 8 output lanes
// of 8 rows (B: of its one row), 64 blocks for A and C, 16 for B; its
// warps split K: thread (slice s, lane l) loads its slice's 24 (C: 12)
// values of t's column into registers, all at once and before the block
// stages its 9 rows of x in shared memory, and reuses each for the 8 rows.
// A warp's load of t is 4 slices x 8 lanes, four full 32-byte sectors.  A
// block reads 24.6 KB of t, so no SM pulls more than that from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 384;         // the product's depth
constexpr int kN = 256;         // t's columns
constexpr int kLanes = 128;     // output lanes
constexpr int kOutRows = 32;
constexpr int kQlMod = 64;

enum Form { kFormA, kFormB, kFormC };

constexpr int kThreads = 256;
constexpr int kBlockLanes = 8;                      // output lanes a block
constexpr int kSlices = kThreads / kBlockLanes;     // slices of K a block
constexpr int kRows = 8;                            // output rows a block (A and C)
// x's rows in shared memory, 400 floats apart: C's lanes past 127 read the
// next row, 16 banks over, clear of the other slices of their warp
constexpr int kXs = 400;

// The block's outputs: lanes [kBlockLanes * blockIdx.x, + kBlockLanes) of
// rows [kR * blockIdx.y, + kR), or (kBroadcast, kR = 1) one row stored to
// all 32.  kTerms: 768 (A, B) or 384 (C, kShift).
template <int kTerms, int kR, bool kShift, bool kBroadcast>
__device__ __forceinline__ void offset_add_block(const float* __restrict__ x,
                                                 const float* __restrict__ t,
                                                 float* __restrict__ out) {
  constexpr int kS = kTerms / kSlices;              // a slice's terms
  constexpr int kRowVecs = kK / 4;
  static_assert(kTerms % kSlices == 0 && kS % 4 == 0 && kK % kS == 0,
                "a slice is whole float4s of one row");
  static_assert(kLanes % kBlockLanes == 0 && kOutRows % kR == 0, "whole blocks");
  __shared__ __align__(16) float xs[(kR + 1) * kXs];
  __shared__ float part[kSlices * kR * kBlockLanes];
  const int tid = threadIdx.x;
  const int lane = tid % kBlockLanes;
  const int slice = tid / kBlockLanes;
  const int k = blockIdx.x * kBlockLanes + lane;
  const int i0 = blockIdx.y * kR;

  int col, row_off, j0;          // t's column, x's row past i0, the slice's first j
  if constexpr (kShift) {
    const float4 h0 = reinterpret_cast<const float4*>(x)[0];
    const float4 h1 = reinterpret_cast<const float4*>(x)[1];
    // truncation toward zero, as astype(int32)
    const int s = static_cast<int>(h0.x) + static_cast<int>(h0.y) + static_cast<int>(h0.z) +
                  static_cast<int>(h0.w) + static_cast<int>(h1.x) + static_cast<int>(h1.y) +
                  static_cast<int>(h1.z) + static_cast<int>(h1.w);
    const int m = k + ((s % kQlMod) + kQlMod) % kQlMod;
    row_off = m < kLanes ? 0 : 1;   // lanes past 127 continue into the next row
    col = m - row_off * kLanes;
    j0 = slice * kS;
  } else {
    const int first = slice * kS;   // the slice's first term of the 768
    row_off = first / kK;           // 0: row i at column k; 1: row i + 1 at 128 + k
    col = row_off * kLanes + k;
    j0 = first - row_off * kK;
  }
  // the slice's column of t, every load in flight before the staging
  float tv[kS];
#pragma unroll
  for (int jj = 0; jj < kS; ++jj) tv[jj] = t[(j0 + jj) * kN + col];
  for (int v = tid; v < (kR + 1) * kRowVecs; v += kThreads) {
    const int rr = v / kRowVecs;
    const int c4 = v - rr * kRowVecs;
    *reinterpret_cast<float4*>(xs + rr * kXs + 4 * c4) =
        reinterpret_cast<const float4*>(x + (i0 + rr) * kK)[c4];
  }
  __syncthreads();

  float acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int jj = 0; jj < kS; jj += 4) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + (row_off + r) * kXs + j0 + jj);
      acc[r] = fmaf(xv.x, tv[jj], acc[r]);
      acc[r] = fmaf(xv.y, tv[jj + 1], acc[r]);
      acc[r] = fmaf(xv.z, tv[jj + 2], acc[r]);
      acc[r] = fmaf(xv.w, tv[jj + 3], acc[r]);
    }
  }

  // the slice sums, added in ascending slice order
#pragma unroll
  for (int r = 0; r < kR; ++r) part[(slice * kR + r) * kBlockLanes + lane] = acc[r];
  __syncthreads();
  if constexpr (kBroadcast) {
    float sum = part[lane];
    for (int s = 1; s < kSlices; ++s) sum += part[s * kBlockLanes + lane];
    for (int row = slice; row < kOutRows; row += kSlices) out[row * kLanes + k] = sum;
  } else if (tid < kR * kBlockLanes) {
    float sum = part[tid];
    for (int s = 1; s < kSlices; ++s) sum += part[s * kR * kBlockLanes + tid];
    out[(i0 + tid / kBlockLanes) * kLanes + k] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) offset_add_a_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ t,
                                                                 float* __restrict__ out) {
  offset_add_block<2 * kK, kRows, false, false>(x, t, out);
}

__global__ void __launch_bounds__(kThreads) offset_add_b_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ t,
                                                                 float* __restrict__ out) {
  offset_add_block<2 * kK, 1, false, true>(x, t, out);
}

__global__ void __launch_bounds__(kThreads) offset_add_c_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ t,
                                                                 float* __restrict__ out) {
  offset_add_block<kK, kRows, true, false>(x, t, out);
}

template <Form F>
int launch(const float* x, const float* t, float* out, void* stream) {
  const dim3 grid(kLanes / kBlockLanes, F == kFormB ? 1 : kOutRows / kRows);
  auto kernel = F == kFormA ? offset_add_a_kernel
                            : (F == kFormB ? offset_add_b_kernel : offset_add_c_kernel);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, t, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[40, 384], t f32[384, 256], out f32[32, 128], all contiguous; x
// 16-byte aligned (the wrapper checks).
extern "C" int tm_offset_add_a(const float* x, const float* t, float* out, void* stream) {
  return launch<kFormA>(x, t, out, stream);
}

extern "C" int tm_offset_add_b(const float* x, const float* t, float* out, void* stream) {
  return launch<kFormB>(x, t, out, stream);
}

extern "C" int tm_offset_add_c(const float* x, const float* t, float* out, void* stream) {
  return launch<kFormC>(x, t, out, stream);
}
