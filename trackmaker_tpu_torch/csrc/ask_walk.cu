// The ASK frame loop as a chase through the successor table.
//
// Replaces: trackmaker_tpu/phy/ask_spec.py:_ask_walk_kernel (through
// _walk).  It shares nothing with spec_walk.cu: the fields and rules differ.
//
// fields int32[B, 6, C1], rows has, fired, complete, peak, succ, nonconf.
// For each capture, from candidate i = 0 with done = bad = 0, for each
// slot k < max_frames (statement for statement as the TPU kernel):
//   active = !done;  ok_fire = active && has[i] && fired[i]
//   emit = ok_fire && complete[i];  peaks[k] = peak[i];  fire_ok[k] = emit
//   miss = (emit && succ[i] < 0) || (active && nonconf[i])
//   done = active && (!has || !fired || (ok_fire && !complete) || miss) ? 1 : done
//   i = emit && succ[i] >= 0 ? succ[i] : i;  bad |= miss
// The plain version (phy/ask_spec.py:ask_walk_plain) runs the same steps.
//
// What bounds it on an H100: latency.  The chase is max_frames dependent
// steps; its bytes (the table in, the slots out) are a few KB per capture.
// Design: one block per capture stages the 6*C1 fields in shared memory
// with coalesced loads, so each dependent step reads shared memory, not
// device memory; thread 0 then walks and writes each slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ask_walk_kernel(const int* __restrict__ fields, int c1, int max_frames,
                int* __restrict__ peaks, uint8_t* __restrict__ fire_ok,
                uint8_t* __restrict__ bad) {
  extern __shared__ int f[];   // [6][c1]
  const int b = blockIdx.x;
  const int* fb = fields + static_cast<int64_t>(b) * 6 * c1;
  for (int i = threadIdx.x; i < 6 * c1; i += kThreads) f[i] = fb[i];
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* has = f;
  const int* fired = f + c1;
  const int* complete = f + 2 * c1;
  const int* peak = f + 3 * c1;
  const int* succ = f + 4 * c1;
  const int* nonconf = f + 5 * c1;
  int* pk = peaks + static_cast<int64_t>(b) * max_frames;
  uint8_t* ok = fire_ok + static_cast<int64_t>(b) * max_frames;
  int i = 0;
  bool done = false, bd = false;
  for (int k = 0; k < max_frames; ++k) {
    const bool active = !done;
    const bool ok_fire = active && has[i] > 0 && fired[i] > 0;
    const bool emit = ok_fire && complete[i] > 0;
    pk[k] = peak[i];
    ok[k] = emit;
    const bool miss = (emit && succ[i] < 0) || (active && nonconf[i] > 0);
    if (active && (has[i] == 0 || fired[i] == 0 || (ok_fire && complete[i] == 0) || miss)) {
      done = true;
    }
    if (emit && succ[i] >= 0) i = succ[i];
    bd = bd || miss;
  }
  bad[b] = bd;
}

}  // namespace

extern "C" int tm_ask_walk(const int* fields, int batch, int c1, int max_frames,
                           int* peaks, uint8_t* fire_ok, uint8_t* bad,
                           void* stream) {
  const size_t smem = static_cast<size_t>(6) * c1 * sizeof(int);
  if (batch < 1 || c1 < 1 || max_frames < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ask_walk_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fields, c1, max_frames, peaks, fire_ok, bad);
  return static_cast<int>(cudaGetLastError());
}
