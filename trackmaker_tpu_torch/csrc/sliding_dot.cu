// Raw sliding dot product times a scale, over zero history.
//
// Replaces: trackmaker_tpu/sync/pallas_xcorr.py:_xcorr_kernel in its raw
// form (normalize=False), as trackmaker_tpu/sync/__init__.py:
// auto_sliding_dot_scaled calls it for the ASK receiver: the 440-tap chirp
// sync (scale 1/200) and the two 30-tap dense-demodulation dots (scale 1).
//
// x f32[B, T], p f32[L], L <= 512:
//   out[b, i] = scale * sum_k x[b, i-L+1+k] * p[k],   x[b, j] = 0 for j < 0
// The taps are added in order k = 0..L-1 from 0, each product and each sum
// rounded on its own (__fmul_rn, __fadd_rn: never fused into an FMA), and
// the scale multiplies last.  The plain version in sync/sliding_dot.py adds
// in the same order, so the two agree exactly.
//
// What bounds it on an H100: operations.  The ASK sync at 16 captures of
// about 339k samples is 2.4 G taps, about 4.8 GFLOP against 22 MB of
// samples; the unfused multiply and add also cost two instructions where
// an FMA would cost one.  Design: a block of 256 threads computes 1024
// consecutive lags of one capture from shared memory, where it stages the
// 1024 + L - 1 samples they read and the pattern once.  Each thread keeps
// four sums 256 lags apart, so one pattern value read from shared memory
// serves four products and neighbouring threads read neighbouring words
// (no bank conflicts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;   // lags per block
constexpr int kMaxPattern = 512;

__global__ void __launch_bounds__(kThreads)
sliding_dot_kernel(const float* __restrict__ x, const float* __restrict__ p,
                   int t, int l, float scale, float* __restrict__ out) {
  __shared__ float ps[kMaxPattern];
  __shared__ float xs[kTile + kMaxPattern - 1];

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const float* xb = x + static_cast<int64_t>(b) * t;
  for (int k = threadIdx.x; k < l; k += kThreads) ps[k] = p[k];
  // xs[j] = x[i0 - (l-1) + j], zero outside [0, t)
  const int n = kTile + l - 1;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int src = i0 - (l - 1) + j;
    xs[j] = (src >= 0 && src < t) ? xb[src] : 0.0f;
  }
  __syncthreads();

  float acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = 0.0f;
  for (int k = 0; k < l; ++k) {
    const float pk = ps[k];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      acc[r] = __fadd_rn(acc[r], __fmul_rn(xs[threadIdx.x + r * kThreads + k], pk));
    }
  }
  float* ob = out + static_cast<int64_t>(b) * t;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = i0 + threadIdx.x + r * kThreads;
    if (i < t) ob[i] = __fmul_rn(acc[r], scale);
  }
}

}  // namespace

extern "C" int tm_sliding_dot(const float* x, const float* p, int batch, int t,
                              int l, float scale, float* out, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || l < 1 || l > kMaxPattern) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((t + kTile - 1) / kTile, batch);
  sliding_dot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, p, t, l, scale, out);
  return static_cast<int>(cudaGetLastError());
}
