// ASK record-chain fire resolution, one row per candidate window.
//
// Replaces: trackmaker_tpu/phy/ask_spec.py:_chain_kernel (through
// _chain_kernel_call).  The port's exact scan (phy/ask.py:run_chain) runs
// its 4096-sample windows through it too.
//
// vals f32[N, W] (masked sync, -inf where no update may happen), base
// int32[N] (the sample of column 0).  Along each row, with idx = base + j:
//   m[j]   = max(vals[0 .. j-1])              (-inf at j = 0)
//   upd[j] = vals[j] > m[j]                   (strict: an earlier tie wins)
//   rec[j] = max of idx over the updates before j   (-2^30 if none)
//   fire[j] = !upd[j] && idx > rec[j] + guard && m[j] > -inf
// fired = any(fire); peak = rec at the first fire, else the last update
// index (-2^30 if none).  Max, compare and integers only: the result
// equals the plain version (phy/ask.py:ask_chain_plain) exactly.
//
// What bounds it on an H100: bytes (each row's W values read once, 6.4 MB
// for 16 captures x 97 candidates x 1024 columns) and, for rows that fire
// late, the dependent chunk loop.  Design: one warp per row walks it in
// chunks of 32 coalesced values; two warp-shuffle max scans give m and rec
// inside the chunk, the carries from earlier chunks are one register each,
// and a ballot finds the first fire, where the warp stops reading.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kNegB = -(1 << 30);
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ask_chain_kernel(const float* __restrict__ vals, const int* __restrict__ base,
                 int n_rows, int win, int guard, uint8_t* __restrict__ fired,
                 int* __restrict__ peak) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;   // the whole warp leaves together
  const float* v = vals + static_cast<int64_t>(row) * win;
  const int b0 = base[row];

  float carry_m = -CUDART_INF_F;   // max of the values before this chunk
  int carry_rec = kNegB;           // last update index before this chunk
  bool done = false;
  int pk = kNegB;
  for (int c0 = 0; c0 < win && !done; c0 += 32) {
    const int j = c0 + lane;
    const bool in = j < win;
    const float x = in ? v[j] : -CUDART_INF_F;
    float incl = x;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl = fmaxf(incl, o);
    }
    const float prev = __shfl_up_sync(kFull, incl, 1);
    const float m = lane == 0 ? carry_m : fmaxf(carry_m, prev);
    const bool upd = in && x > m;
    const int idx = b0 + j;
    int rinc = upd ? idx : kNegB;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, rinc, s);
      if (lane >= s) rinc = max(rinc, o);
    }
    const int rprev = __shfl_up_sync(kFull, rinc, 1);
    const int rec = lane == 0 ? carry_rec : max(carry_rec, rprev);
    const bool fire = in && !upd && idx > rec + guard && m > -CUDART_INF_F;
    const unsigned ballot = __ballot_sync(kFull, fire);
    if (ballot) {
      pk = __shfl_sync(kFull, rec, __ffs(ballot) - 1);
      done = true;
    } else {
      carry_m = fmaxf(carry_m, __shfl_sync(kFull, incl, 31));
      carry_rec = max(carry_rec, __shfl_sync(kFull, rinc, 31));
    }
  }
  if (lane == 0) {
    fired[row] = done;
    peak[row] = done ? pk : carry_rec;
  }
}

}  // namespace

extern "C" int tm_ask_chain(const float* vals, const int* base, int n_rows,
                            int win, int guard, uint8_t* fired, int* peak,
                            void* stream) {
  if (n_rows < 1 || win < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ask_chain_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(vals, base, n_rows,
                                                          win, guard, fired, peak);
  return static_cast<int>(cudaGetLastError());
}
