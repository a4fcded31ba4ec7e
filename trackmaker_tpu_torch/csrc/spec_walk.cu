// Sequential consumption walk over the sorted candidate table.
//
// Replaces: trackmaker_tpu/phy/pallas_decode.py:_walk_kernel (through
// _spec_walk_smem); the JAX decode path runs its vectorized twin _spec_walk.
//
// fields int32[B, 4, C]: rows pos (ascending, 2^30 pads), consumed,
// stop-if-attempted, keep-if-attempted.  For each capture b, starting at
// cursor cur0[b] with no attempt made:
//   exists = pos < 2^30 && pos < limit[b]
//   at     = exists && !done && pos >= cur && att < max_frames
//   stop   = at && stop_flag;  adv = at && !stop
//   keep[c] = adv && keep_flag;  attempted[c] = at
//   cur = adv ? pos + consumed : cur;  done |= stop;  att += at
//   pending = stop ? min(pending, pos) : pending   (2^30 when none)
// state int32[B, 4] = [final cursor, done, pending, att], where done is 1
// when the walk stopped or made fewer than max_frames attempts.
//
// What bounds it on an H100: the dependent chain, one step per candidate,
// in one thread; there are only C steps per capture.  Design: one warp per
// capture stages the 4*C fields in shared memory with coalesced loads, lane 0
// walks them there, and the warp writes the keep and attempted flags back
// coalesced.  It replaces about 72 steps of small tensor operations with
// one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;

__global__ void spec_walk_kernel(const int* __restrict__ fields,
                                 const int* __restrict__ cur0,
                                 const int* __restrict__ limit, int n_cand,
                                 int max_frames, uint8_t* __restrict__ keep,
                                 uint8_t* __restrict__ attempted,
                                 int* __restrict__ state) {
  extern __shared__ int smem[];
  int* f = smem;                                              // [4][C]
  uint8_t* flags = reinterpret_cast<uint8_t*>(smem + 4 * n_cand);  // [2][C]

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int* fb = fields + static_cast<int64_t>(b) * 4 * n_cand;
  for (int i = lane; i < 4 * n_cand; i += 32) f[i] = fb[i];
  __syncwarp();

  if (lane == 0) {
    const int lim = limit[b];
    int cur = cur0[b];
    int done = 0, att = 0, pending = kBig;
    for (int c = 0; c < n_cand; ++c) {
      const int pos = f[c];
      const bool exists = pos < kBig && pos < lim;
      const bool at = exists && !done && pos >= cur && att < max_frames;
      const bool stop = at && f[2 * n_cand + c] > 0;
      const bool adv = at && !stop;
      flags[c] = adv && f[3 * n_cand + c] > 0;
      flags[n_cand + c] = at;
      if (adv) cur = pos + f[n_cand + c];
      if (stop) {
        done = 1;
        pending = min(pending, pos);
      }
      att += at;
    }
    int* st = state + static_cast<int64_t>(b) * 4;
    st[0] = cur;
    st[1] = done || att < max_frames;
    st[2] = pending;
    st[3] = att;
  }
  __syncwarp();

  const int64_t row = static_cast<int64_t>(b) * n_cand;
  for (int c = lane; c < n_cand; c += 32) {
    keep[row + c] = flags[c];
    attempted[row + c] = flags[n_cand + c];
  }
}

}  // namespace

extern "C" int tm_spec_walk(const int* fields, const int* cur0,
                            const int* limit, int batch, int n_cand,
                            int max_frames, uint8_t* keep, uint8_t* attempted,
                            int* state, void* stream) {
  const size_t smem = static_cast<size_t>(n_cand) * (4 * sizeof(int) + 2);
  if (batch < 1 || n_cand < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  spec_walk_kernel<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      fields, cur0, limit, n_cand, max_frames, keep, attempted, state);
  return static_cast<int>(cudaGetLastError());
}
