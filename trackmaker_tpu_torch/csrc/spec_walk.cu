// Consumption walk over the sorted candidate table, as a chase through a
// successor table by pointer doubling.
//
// Replaces: trackmaker_tpu/phy/pallas_decode.py:_walk_kernel (through
// _spec_walk_smem); the JAX decode path runs its vectorized twin _spec_walk.
//
// fields int32[B, 4, C]: rows pos (ascending, 2^30 pads), consumed (>= 1),
// stop-if-attempted, keep-if-attempted.  For each capture b, starting at
// cursor cur0[b] with no attempt made, the sequential walk is
//   exists = pos < 2^30 && pos < limit[b]
//   at     = exists && !done && pos >= cur && att < max_frames
//   stop   = at && stop_flag;  adv = at && !stop
//   keep[c] = adv && keep_flag;  attempted[c] = at
//   cur = adv ? pos + consumed : cur;  done |= stop;  att += at
//   pending = stop ? min(pending, pos) : pending   (2^30 when none)
// Outputs: keep and attempted bool[B, C], done bool[B] (the walk stopped or
// made fewer than max_frames attempts), state int32[3, B] = rows final
// cursor, pending, attempts.
//
// Because positions ascend and consumed >= 1, the walk is a chain: the
// candidate after an attempted c is nxt[c], the first index whose pos is at
// or past pos_c + consumed_c, and a stop candidate or one that does not
// exist ends it (a sink at index C).  "Exists" holds on a prefix [0, E).
// The attempted set is the first max_frames nodes of the chain from s0, the
// first candidate at or past cur0; the state follows by reductions:
//   att = |attempted|, pending = min pos over attempted stops,
//   cur_f = max(cur0, max over attempted non-stops of pos + consumed, -1),
//   done = a stop was attempted || att < max_frames.
//
// What bounds it on an H100: neither bytes nor operations (a capture's
// table is 2 KB at C = 128); the serial chain of dependent steps and the
// launch.  Design: one block per capture, one thread per candidate (up to
// 1,024, each thread taking up to three above that).  The positions go to
// shared memory with coalesced loads, the other rows to the owner's
// registers; each thread builds its candidates' successors by binary search;
// pointer doubling marks the chain in ceil(log2(min(max_frames, E - s0)))
// rounds (round k: every node marked at distance d from s0 marks its
// 2^k-th successor at d + 2^k, then the jump table doubles), one barrier a
// round; warp reductions and shared atomics give the state; the flags go
// back coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCand = 49152 / 18;   // the table sizes the walk takes
constexpr int kPerThread = (kMaxCand + kMaxThreads - 1) / kMaxThreads;
constexpr int kOff = INT_MAX;          // distance of a node off the chain

// the first index in [lo, hi) whose pos is at or past key (hi if none)
__device__ __forceinline__ int lower_bound(const int* pos, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pos[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kMaxThreads) spec_walk_kernel(
    const int* __restrict__ fields, const int* __restrict__ cur0,
    const int* __restrict__ limit, int n_cand, int max_frames,
    bool* __restrict__ keep, bool* __restrict__ attempted, bool* __restrict__ done,
    int* __restrict__ state, int batch) {
  extern __shared__ int smem[];
  int* pos = smem;                          // [C]
  int* jump = smem + n_cand;                // [2][C + 1], index C the sink
  int* dist = jump + 2 * (n_cand + 1);      // [C + 1] distance from s0
  __shared__ int red[3];                    // att, pending, the advanced cursor

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* fb = fields + static_cast<int64_t>(b) * 4 * n_cand;
  int consumed[kPerThread];
  bool stop[kPerThread], keepf[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = tid + k * nt;
    if (v < n_cand) {
      pos[v] = fb[v];
      consumed[k] = fb[n_cand + v];
      stop[k] = fb[2 * n_cand + v] > 0;
      keepf[k] = fb[3 * n_cand + v] > 0;
    }
  }
  if (tid == 0) {
    red[0] = 0;
    red[1] = kBig;
    red[2] = -1;
  }
  __syncthreads();

  const int c0 = cur0[b];
  const int n_exist = lower_bound(pos, 0, n_cand, min(limit[b], kBig));
  const int s0 = lower_bound(pos, 0, n_exist, c0);   // n_exist: no attempt
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = tid + k * nt;
    if (v < n_cand) {
      int nx = n_cand;
      if (v < n_exist && !stop[k]) {
        // a successor at or past E does not exist: the chain ends there
        nx = lower_bound(pos, v + 1, n_exist, pos[v] + consumed[k]);
        nx = nx < n_exist ? nx : n_cand;
      }
      jump[v] = nx;
      dist[v] = v == s0 ? 0 : kOff;
    }
  }
  if (tid == 0) {
    jump[n_cand] = n_cand;
    jump[2 * n_cand + 1] = n_cand;
    dist[n_cand] = kOff;
  }
  __syncthreads();

  // after the round of step 2^k every node of the chain closer than
  // 2^(k+1) to s0 is marked; a node marked during the round may already
  // mark its own successor, at its true distance too
  const int reach = min(max_frames, n_exist - s0);   // nodes that may be attempted
  int src = 0;
  for (int step = 1; step < reach; step <<= 1) {
    const int* jin = jump + src * (n_cand + 1);
    int* jout = jump + (src ^ 1) * (n_cand + 1);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int v = tid + k * nt;
      if (v < n_cand) {
        const int j = jin[v];
        const int d = dist[v];
        if (d != kOff && j < n_cand) dist[j] = d + step;
        jout[v] = jin[j];
      }
    }
    __syncthreads();
    src ^= 1;
  }

  const int64_t row = static_cast<int64_t>(b) * n_cand;
  int att = 0, pend = kBig, adv = -1;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = tid + k * nt;
    if (v < n_cand) {
      const bool at = v < n_exist && dist[v] < max_frames;
      keep[row + v] = at && !stop[k] && keepf[k];
      attempted[row + v] = at;
      if (at) {
        ++att;
        if (stop[k]) {
          pend = min(pend, pos[v]);
        } else {
          adv = max(adv, pos[v] + consumed[k]);
        }
      }
    }
  }
  att = __reduce_add_sync(0xffffffffu, att);
  pend = __reduce_min_sync(0xffffffffu, pend);
  adv = __reduce_max_sync(0xffffffffu, adv);
  if ((tid & 31) == 0) {
    atomicAdd(&red[0], att);
    atomicMin(&red[1], pend);
    atomicMax(&red[2], adv);
  }
  __syncthreads();
  if (tid == 0) {
    state[b] = max(c0, red[2]);
    state[batch + b] = red[1];
    state[2 * batch + b] = red[0];
    done[b] = red[1] < kBig || red[0] < max_frames;
  }
}

}  // namespace

extern "C" int tm_spec_walk(const int* fields, const int* cur0,
                            const int* limit, int batch, int n_cand,
                            int max_frames, bool* keep, bool* attempted,
                            bool* done, int* state, void* stream) {
  if (batch < 1 || n_cand < 1 || n_cand > kMaxCand) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = min(kMaxThreads, (n_cand + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(4 * n_cand + 3) * sizeof(int);
  spec_walk_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      fields, cur0, limit, n_cand, max_frames, keep, attempted, done, state,
      batch);
  return static_cast<int>(cudaGetLastError());
}
