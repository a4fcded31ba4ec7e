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
// with o[r, c] = sum_j x[r, j] * t[j, c], j ascending, one fused
// multiply-add a term.  C's mod is a floor mod, as in JAX and NumPy: C++'s
// % truncates toward zero, and s is negative on the tool's own input
// (s = -5 gives ql = 59).  The TPU kernel C builds its shift as a
// (128, 256) one-hot product on the matrix unit, a gather in disguise;
// here the lane index is shifted and no product is spent on it.
//
// Each kernel computes only the sums its form reads: A and C 32 x 128
// outputs, each from 768 and 384 terms; B one row of 128, stored to all 32
// rows.  No 40 x 256 product is formed and sliced.
//
// What bounds it on an H100: neither bytes nor operations.  The inputs are
// 0.45 MB and the sums 3.1 M multiply-adds at most (A), about 0.1 us of
// either at the card's peaks; a launch costs more.  Design: a block of 128
// threads per output row (B: one block), the block's two rows of x staged
// in shared memory and read as broadcasts, each thread one output lane, its
// column of t read from device memory (neighbouring threads, neighbouring
// addresses).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 384;         // the product's depth
constexpr int kN = 256;         // t's columns
constexpr int kLanes = 128;     // output lanes
constexpr int kOutRows = 32;
constexpr int kQlMod = 64;

// sum_j xr[j] * t[j, col], j ascending
__device__ __forceinline__ float dot_col(const float* xr, const float* __restrict__ t, int col) {
  float acc = 0.0f;
  for (int j = 0; j < kK; ++j) acc = fmaf(xr[j], t[j * kN + col], acc);
  return acc;
}

// rows `row` and `row + 1` of x into xs (they are contiguous)
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, int row, float* xs) {
  for (int j = threadIdx.x; j < 2 * kK; j += kLanes) xs[j] = x[row * kK + j];
  __syncthreads();
}

__global__ void __launch_bounds__(kLanes) offset_add_a_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ t,
                                                               float* __restrict__ out) {
  __shared__ float xs[2 * kK];
  const int i = blockIdx.x;
  const int k = threadIdx.x;
  stage_rows(x, i, xs);
  out[i * kLanes + k] = dot_col(xs, t, k) + dot_col(xs + kK, t, kLanes + k);
}

__global__ void __launch_bounds__(kLanes) offset_add_b_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ t,
                                                               float* __restrict__ out) {
  __shared__ float xs[2 * kK];
  const int k = threadIdx.x;
  stage_rows(x, 0, xs);
  const float d = dot_col(xs, t, k) + dot_col(xs + kK, t, kLanes + k);
  for (int i = 0; i < kOutRows; ++i) out[i * kLanes + k] = d;
}

__global__ void __launch_bounds__(kLanes) offset_add_c_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ t,
                                                               float* __restrict__ out) {
  __shared__ float xs[2 * kK];
  __shared__ int ql;
  const int i = blockIdx.x;
  const int k = threadIdx.x;
  if (k == 0) {
    int s = 0;
    for (int j = 0; j < 8; ++j) s += static_cast<int>(x[j]);   // truncation, as astype(int32)
    ql = ((s % kQlMod) + kQlMod) % kQlMod;
  }
  stage_rows(x, i, xs);      // its barrier also publishes ql
  const int m = k + ql;
  out[i * kLanes + k] = m < kLanes ? dot_col(xs, t, m) : dot_col(xs + kK, t, m - kLanes);
}

int launch(void (*kernel)(const float*, const float*, float*), int blocks, const float* x,
           const float* t, float* out, void* stream) {
  kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(x, t, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[40, 384], t f32[384, 256], out f32[32, 128], all contiguous.
extern "C" int tm_offset_add_a(const float* x, const float* t, float* out, void* stream) {
  return launch(offset_add_a_kernel, kOutRows, x, t, out, stream);
}

extern "C" int tm_offset_add_b(const float* x, const float* t, float* out, void* stream) {
  return launch(offset_add_b_kernel, 1, x, t, out, stream);
}

extern "C" int tm_offset_add_c(const float* x, const float* t, float* out, void* stream) {
  return launch(offset_add_c_kernel, kOutRows, x, t, out, stream);
}
