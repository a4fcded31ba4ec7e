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
// What bounds it on an H100: latency.  Its bytes (each row's columns up
// to its first fire, about 4 MB for 16 captures x 97 candidates x 1024
// columns) take about 0.0012 ms at HBM's rate; a design that reads a row
// in dependent steps pays a round trip to memory for each.  Design: one
// warp a row, a tile of kTile = 1024 columns at a time.  The warp issues
// all of a tile's loads at once (32 coalesced loads a lane) and moves them
// through shared memory (a pitch of 33 floats: no bank conflicts either
// way) so that lane l holds the contiguous segment of columns
// 32l .. 32l + 31 in registers.  Then, on registers:
//   1. each lane's segment maximum and its first position; an exclusive
//      warp max-scan gives the segment its carry m (the maximum of every
//      column before it);
//   2. a segment's last update is the first position of its maximum when
//      that maximum exceeds the carry m (strict, so the first of equal
//      values wins across a segment's edge too), and there is none
//      otherwise; an exclusive warp max-scan of those gives the carry rec;
//   3. each lane walks its segment from both carries to its first fire,
//      and a ballot picks the first lane that fires: its rec there is the
//      peak.
// Max is associative and exact in f32, so the scans equal the plain
// version's running maxima.  A row wider than a tile loops with the two
// carries; the next tile's loads are issued before the current tile is
// scanned, and the loop stops after the tile holding the first fire.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kNegB = -(1 << 30);
constexpr int kWarpsPerBlock = 4;
constexpr int kSeg = 32;              // contiguous columns a lane holds
constexpr int kTile = 32 * kSeg;      // columns a warp holds: 1024
constexpr int kPitch = kSeg + 1;      // the shared transpose's row pitch
constexpr unsigned kFull = 0xffffffffu;

// the coalesced loads of the tile from column t0: out[c] is column
// t0 + 32c + lane (-inf past the row's end)
__device__ __forceinline__ void load_tile(const float* __restrict__ v, int t0, int win,
                                          int lane, float (&out)[kSeg]) {
#pragma unroll
  for (int c = 0; c < kSeg; ++c) {
    const int j = t0 + c * 32 + lane;
    out[c] = j < win ? __ldg(v + j) : -CUDART_INF_F;
  }
}

// inclusive warp max-scan of a float; the exclusive scan (-inf at lane 0)
// and the warp's maximum through the references
__device__ __forceinline__ void scan_max(float x, int lane, float& excl, float& total) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float o = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x = fmaxf(x, o);
  }
  const float prev = __shfl_up_sync(kFull, x, 1);
  excl = lane == 0 ? -CUDART_INF_F : prev;
  total = __shfl_sync(kFull, x, 31);
}

__device__ __forceinline__ void scan_max(int x, int lane, int& excl, int& total) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x = max(x, o);
  }
  const int prev = __shfl_up_sync(kFull, x, 1);
  excl = lane == 0 ? kNegB : prev;
  total = __shfl_sync(kFull, x, 31);
}

// one level of the segment's (maximum, first position) tree: pairs of the
// n * 2 entries into the first n, the lower position kept on a tie
template <int N>
__device__ __forceinline__ void tree_level(float (&mv)[kSeg / 2], int (&mi)[kSeg / 2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool hi = mv[2 * k + 1] > mv[2 * k];
    mv[k] = hi ? mv[2 * k + 1] : mv[2 * k];
    mi[k] = hi ? mi[2 * k + 1] : mi[2 * k];
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ask_chain_kernel(const float* __restrict__ vals, const int* __restrict__ base,
                 int n_rows, int win, int guard, uint8_t* __restrict__ fired,
                 int* __restrict__ peak) {
  __shared__ float stage[kWarpsPerBlock][32 * kPitch];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n_rows) return;   // the whole warp leaves together
  const float* v = vals + static_cast<int64_t>(row) * win;
  float* st = stage[warp];
  const int b0 = base[row];

  float next[kSeg];
  load_tile(v, 0, win, lane, next);
  float carry_m = -CUDART_INF_F;   // max of the columns before this tile
  int carry_rec = kNegB;           // last update index before this tile
  bool done = false;
  int pk = kNegB;
  for (int t0 = 0; t0 < win && !done; t0 += kTile) {
    // the tile into shared memory: column t0 + 32c + lane is position
    // lane of segment c
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kSeg; ++c) st[c * kPitch + lane] = next[c];
    __syncwarp();
    if (t0 + kTile < win) load_tile(v, t0 + kTile, win, lane, next);
    float x[kSeg];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) x[k] = st[lane * kPitch + k];

    // 1. the segment's maximum and its first position, by a tree that
    // keeps the lower position on a tie
    float mv[kSeg / 2];
    int mi[kSeg / 2];
#pragma unroll
    for (int k = 0; k < kSeg / 2; ++k) {
      const bool hi = x[2 * k + 1] > x[2 * k];
      mv[k] = hi ? x[2 * k + 1] : x[2 * k];
      mi[k] = 2 * k + hi;
    }
    tree_level<kSeg / 4>(mv, mi);
    tree_level<kSeg / 8>(mv, mi);
    tree_level<kSeg / 16>(mv, mi);
    tree_level<kSeg / 32>(mv, mi);
    float pre_m, tile_m;
    scan_max(mv[0], lane, pre_m, tile_m);
    const float m0 = fmaxf(carry_m, pre_m);
    const int idx0 = b0 + t0 + lane * kSeg;

    // 2. the segment's last update, and the carry rec
    const int last = mv[0] > m0 ? idx0 + mi[0] : kNegB;
    int pre_rec, tile_rec;
    scan_max(last, lane, pre_rec, tile_rec);

    // 3. the walk from both carries to the segment's first fire
    const int lim = win - t0 - lane * kSeg;   // columns of the segment in the row
    float m = m0;
    int rec = max(carry_rec, pre_rec);
    bool hit = false;
    int hit_rec = kNegB;
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const int idx = idx0 + k;
      const bool upd = x[k] > m;
      const bool fire = !upd && k < lim && idx > rec + guard && m > -CUDART_INF_F;
      if (fire && !hit) hit_rec = rec;
      hit = hit || fire;
      if (upd) {
        m = x[k];
        rec = idx;
      }
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (ballot) {
      pk = __shfl_sync(kFull, hit_rec, __ffs(ballot) - 1);
      done = true;
    } else {
      carry_m = fmaxf(carry_m, tile_m);
      carry_rec = max(carry_rec, tile_rec);
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
