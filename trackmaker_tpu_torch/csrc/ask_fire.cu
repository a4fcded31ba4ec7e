// The ASK fire rule: which updates fire if they become the chain's record.
//
// Replaces: trackmaker_tpu/phy/ask_spec.py:_fire_kernel (through
// _fire_kernel_call), and with it the XLA forms of dense_fire_candidates
// for other guard widths: this kernel takes any w.
//
// sync f32[B, T], upd bool[B, T], w = peak_guard + 1:
//   masked[r] = upd[r] ? sync[r] : -inf     (-inf at r >= T)
//   hit[b, r] = upd[r] && masked[r] >= max(masked[r+1 .. r+w])
// Max and compare only, so it equals its plain version (phy/ask_spec.py)
// exactly.
//
// What bounds it on an H100: bytes, about 6 per sample (sync, upd in, hit
// out), 33 MB for 16 captures of about 339k samples.  Design: a block of
// 256 threads covers 1024 positions of one capture; it stages their masked
// values and the w after them in shared memory, reading each sample once.
// A thread scans the window of a position only where upd is set, which is
// a small share of a capture (around the preambles), and stops at the
// first larger value, so the windows cost little beyond the loads.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // positions per block

__global__ void __launch_bounds__(kThreads)
ask_fire_kernel(const float* __restrict__ sync, const uint8_t* __restrict__ upd,
                int t, int w, uint8_t* __restrict__ hit) {
  extern __shared__ float ms[];   // [kTile + w]
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int64_t row = static_cast<int64_t>(b) * t;
  for (int j = threadIdx.x; j < kTile + w; j += kThreads) {
    const int r = r0 + j;
    ms[j] = (r < t && upd[row + r]) ? sync[row + r] : -CUDART_INF_F;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int r = r0 + j;
    if (r >= t) break;
    bool h = upd[row + r] != 0;
    if (h) {
      const float v = ms[j];
      for (int k = 1; k <= w; ++k) {
        if (ms[j + k] > v) {
          h = false;
          break;
        }
      }
    }
    hit[row + r] = h;
  }
}

}  // namespace

extern "C" int tm_ask_fire(const float* sync, const uint8_t* upd, int batch,
                           int t, int w, uint8_t* hit, void* stream) {
  const size_t smem = static_cast<size_t>(kTile + w) * sizeof(float);
  if (batch < 1 || batch > 65535 || t < 1 || w < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((t + kTile - 1) / kTile, batch);
  ask_fire_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sync, upd, t, w, hit);
  return static_cast<int>(cudaGetLastError());
}
