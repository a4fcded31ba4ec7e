// The ASK frame loop as a walk through the successor table, by binary
// lifting.
//
// Replaces: trackmaker_tpu/phy/ask_spec.py:_ask_walk_kernel (through
// _walk).  It shares nothing with spec_walk.cu: the fields and rules differ.
//
// fields int32[B, 6, C1], rows has, fired, complete, peak, succ, nonconf
// (succ < C1).  The TPU kernel walks each capture from candidate i = 0
// with done = bad = 0, for each slot k < max_frames:
//   active = !done;  ok_fire = active && has[i] && fired[i]
//   emit = ok_fire && complete[i];  peaks[k] = peak[i];  fire_ok[k] = emit
//   miss = (emit && succ[i] < 0) || (active && nonconf[i])
//   done = active && (!has || !fired || (ok_fire && !complete) || miss) ? 1 : done
//   i = emit && succ[i] >= 0 ? succ[i] : i;  bad |= miss
// The same walk as a step function on 2 * C1 nodes, node i < C1 the active
// candidate i and node C1 + j the sink of j (done, at candidate j), which
// loops to itself:
//   emit = has > 0 && fired > 0 && complete > 0
//   miss = (emit && succ < 0) || nonconf > 0
//   nxt  = emit && succ >= 0 ? succ : i
//   f(i) = !emit || miss ? C1 + nxt : nxt
// Slot k is at node p_k = f^k(0): at an active node peaks[k] = peak[p_k],
// fire_ok[k] = emit[p_k] and bad |= miss[p_k]; at the sink of j peak[j]
// and 0.  (A walk that neither emits nor stops stays at its node, active,
// with emit and miss 0 on every later slot: the sink gives the same
// outputs.  When nonconf is set and the node emits with succ >= 0, the
// walk advances in the same step that sets done: the sink of nxt.)
// The plain version (phy/ask_spec.py:ask_walk_plain) runs the same
// algorithm in tensor ops.
//
// What bounds it on an H100: latency.  Its bytes (the table in, the slots
// out) are a few KB a capture.  Design: one block of 256 threads a
// capture.  Each thread builds f, peak and the emit and miss flags of its
// candidates in shared memory from coalesced loads; then binary lifting
// finds the slots' nodes: after the round of step h = 2^r the nodes of
// slots k < 2h are known, p_k = J_r(p_(k-h)) with J_r = f^h, and
// J_(r+1) = J_r o J_r; a sink maps to itself, so the tables hold the C1
// active nodes only.  That is ceil(log2 max_frames) rounds of a barrier
// each (7 at 72 slots), a thread a slot and a few nodes a round.  The
// slots go in chunks of 1,024 (the nodes a block holds at once), each
// started one step of f past the last chunk's last node.  Each thread
// then writes its slots' peak and flag, and the block sets bad by
// __syncthreads_or.  Shared memory: 17 bytes a candidate and 4 KB, 38 KB
// at the largest table, C1 = 2,048.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;     // slots whose nodes the block holds at once
constexpr int kMaxC1 = 2048;     // the largest table (its six rows once filled 48 KB)

__global__ void __launch_bounds__(kThreads)
ask_walk_kernel(const int* __restrict__ fields, int c1, int max_frames,
                int* __restrict__ peaks, uint8_t* __restrict__ fire_ok,
                uint8_t* __restrict__ bad) {
  extern __shared__ int smem[];
  int* step = smem;                  // [c1] f on the active nodes
  int* jump = step + c1;             // [2][c1] J_r, two buffers
  int* peak = jump + 2 * c1;         // [c1]
  int* pos = peak + c1;              // [kChunk] the chunk's slots' nodes
  uint8_t* flags = reinterpret_cast<uint8_t*>(pos + kChunk);   // [c1] emit | miss << 1

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* fb = fields + static_cast<int64_t>(b) * 6 * c1;
  for (int i = tid; i < c1; i += kThreads) {
    const int succ = fb[4 * c1 + i];
    const bool emit = fb[i] > 0 && fb[c1 + i] > 0 && fb[2 * c1 + i] > 0;
    const bool miss = (emit && succ < 0) || fb[5 * c1 + i] > 0;
    const int nxt = emit && succ >= 0 ? succ : i;
    step[i] = !emit || miss ? c1 + nxt : nxt;
    peak[i] = fb[3 * c1 + i];
    flags[i] = static_cast<uint8_t>(emit | (miss << 1));
  }

  int* pk = peaks + static_cast<int64_t>(b) * max_frames;
  uint8_t* ok = fire_ok + static_cast<int64_t>(b) * max_frames;
  bool any_miss = false;
  int start = 0;                     // the node of the chunk's first slot
  for (int k0 = 0;; k0 += kChunk) {
    const int n = min(kChunk, max_frames - k0);
    for (int i = tid; i < c1; i += kThreads) jump[i] = step[i];   // J_0 = f
    if (tid == 0) pos[0] = start;
    __syncthreads();
    int cur = 0;
    for (int h = 1; h < n; h <<= 1) {
      const int* j = jump + cur * c1;
      for (int k = h + tid; k < min(2 * h, n); k += kThreads) {
        const int p = pos[k - h];
        pos[k] = p < c1 ? j[p] : p;
      }
      if (2 * h < n) {               // J_(r+1) = J_r o J_r, for the next round
        int* jn = jump + (cur ^ 1) * c1;
        for (int i = tid; i < c1; i += kThreads) {
          const int v = j[i];
          jn[i] = v < c1 ? j[v] : v;
        }
      }
      cur ^= 1;
      __syncthreads();
    }
    for (int k = tid; k < n; k += kThreads) {
      const int p = pos[k];
      const bool active = p < c1;
      const int node = active ? p : p - c1;
      const int fl = active ? flags[node] : 0;
      pk[k0 + k] = peak[node];
      ok[k0 + k] = static_cast<uint8_t>(fl & 1);
      any_miss |= (fl & 2) != 0;
    }
    if (max_frames - k0 <= kChunk) break;
    const int last = pos[n - 1];
    start = last < c1 ? step[last] : last;
    __syncthreads();                 // every thread has read pos before it is rewritten
  }
  const int any = __syncthreads_or(any_miss);
  if (tid == 0) bad[b] = static_cast<uint8_t>(any != 0);
}

}  // namespace

extern "C" int tm_ask_walk(const int* fields, int batch, int c1, int max_frames,
                           int* peaks, uint8_t* fire_ok, uint8_t* bad,
                           void* stream) {
  if (batch < 1 || c1 < 1 || max_frames < 1 || c1 > kMaxC1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(4) * c1 * sizeof(int) + kChunk * sizeof(int) + c1;
  ask_walk_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fields, c1, max_frames, peaks, fire_ok, bad);
  return static_cast<int>(cudaGetLastError());
}
