// The ASK fire rule: which updates fire if they become the chain's record.
//
// Replaces: trackmaker_tpu/phy/ask_spec.py:_fire_kernel (through
// _fire_kernel_call), and with it the XLA forms of dense_fire_candidates
// for other guard widths: this kernel takes any w up to what a block's
// shared memory holds (53,500 on an H100).
//
// sync f32[B, T], upd bool[B, T], w = peak_guard + 1:
//   masked[r] = upd[r] ? sync[r] : -inf     (-inf at r >= T)
//   hit[b, r] = upd[r] && masked[r] >= max(masked[r+1 .. r+w])
// Max and compare only, so it equals its plain version (phy/ask_spec.py)
// exactly.
//
// What bounds it on an H100: bytes, about 6 per sample (sync, upd in, hit
// out), 33 MB for 16 captures of about 339k samples; the loads and stores
// alone take 0.004 ms when the inputs lie in L2.  Past them, shared-memory
// traffic and the latency of each warp's scans.  Design, as JAX builds its
// window maxima: a block of 256 threads covers a tile of kTile = 4096
// positions of one capture and the w after them, staged as rows of 128
// positions, a lane 4 consecutive ones: sync read as a float4, upd as a
// 4-byte word, each once, hit stored as a 4-byte word.  Each row is cut
// into blocks of bk = 2^kSh, the largest power of two <= w (at most 128);
// an in-lane pass and warp-shuffle scans (unrolled: kSh is a template
// argument) give every position the maximum of its block up to it (pre,
// kept in shared memory with each block's maximum) and from it (suf, kept
// in registers).  The window (r, r+w] spans the end of r+1's block, whole
// blocks and the start of r+w's: its maximum is suf[r+1] (the lane's own
// registers, or the next lane's by a shuffle), the block maxima in between
// and pre[r+w] (one float4 a lane, the rest from the next lane by
// shuffles).  Up to w = 2 bk + 1, which holds for every w <= 257, at most
// one block lies in between; a larger w adds one block maximum per 128
// samples.  How many values a position reads depends on w and on where it
// lies, never on the data.
//
// Tiles start where the flattened index b*T + r is a multiple of 4, so a
// group of 4 positions is one aligned float4, word of upd and word of hit
// when the three arrays are aligned (else every load and store is scalar);
// a group across a row's end or start loads and stores byte by byte.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                   // positions a block decides
constexpr int kTileRows = kTile / 128;        // 32 rows of 128
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kMaxW = 1 << 20;                // before the shared-memory check
constexpr unsigned kFull = 0xffffffffu;

// the rows of 128 a block stages at window w: positions 0 .. kTile - 1 + w
// and the float4 read past the last of them
__host__ __device__ constexpr int staged_rows(int w) { return (kTile + w + 4 + 127) / 128; }

// shared memory at window w and blocks of 2^sh: pre, then the block maxima
__host__ __device__ constexpr size_t smem_bytes(int w, int sh) {
  return (static_cast<size_t>(staged_rows(w)) * 128 +
          ((static_cast<size_t>(staged_rows(w)) * 128) >> sh)) * sizeof(float);
}

// the 4 samples of sync and bytes of upd at positions r .. r+3 of a row
// whose first element is row0; -inf and 0 outside [0, t)
__device__ __forceinline__ void load_group(const float* __restrict__ sync,
                                           const uint8_t* __restrict__ upd, bool vec,
                                           int64_t row0, int r, int t, float4& v, uint32_t& u) {
  if (vec && r >= 0 && r + 4 <= t) {
    v = __ldg(reinterpret_cast<const float4*>(sync + row0 + r));
    u = __ldg(reinterpret_cast<const unsigned int*>(upd + row0 + r));
    return;
  }
  float e[4];
  u = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool in = r + q >= 0 && r + q < t;
    e[q] = in ? __ldg(sync + row0 + r + q) : -CUDART_INF_F;
    u |= static_cast<uint32_t>(in && __ldg(upd + row0 + r + q) != 0) << (8 * q);
  }
  v = make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ bool upd_at(uint32_t u, int q) { return ((u >> (8 * q)) & 0xffu) != 0; }

__device__ __forceinline__ float elem(float4 a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// upd ? sync : -inf, in place
__device__ __forceinline__ void mask_group(float4& v, uint32_t u) {
  v.x = upd_at(u, 0) ? v.x : -CUDART_INF_F;
  v.y = upd_at(u, 1) ? v.y : -CUDART_INF_F;
  v.z = upd_at(u, 2) ? v.z : -CUDART_INF_F;
  v.w = upd_at(u, 3) ? v.w : -CUDART_INF_F;
}

// the block prefix (p) and suffix (s) maxima of the lane's 4 positions of
// a staged row, blocks of 2^kSh
template <int kSh>
__device__ __forceinline__ void block_scans(float4 m, int lane, float4& p, float4& s) {
  const float p1 = fmaxf(m.x, m.y), p3 = fmaxf(m.z, m.w);
  if constexpr (kSh == 0) {
    p = m;
    s = m;
  } else if constexpr (kSh == 1) {
    p = make_float4(m.x, p1, m.z, p3);
    s = make_float4(p1, m.y, p3, m.w);
  } else {
    p = make_float4(m.x, p1, fmaxf(p1, m.z), fmaxf(p1, p3));
    s = make_float4(fmaxf(p1, p3), fmaxf(m.y, p3), p3, m.w);
  }
  if constexpr (kSh >= 3) {   // blocks of lb lanes: warp-shuffle scans each way
    constexpr int lb = 1 << (kSh - 2);
    const int li = lane & (lb - 1);
    float ip = p.w, is = s.x;
#pragma unroll
    for (int step = 1; step < lb; step <<= 1) {
      const float op = __shfl_up_sync(kFull, ip, step);
      const float os = __shfl_down_sync(kFull, is, step);
      if (li >= step) ip = fmaxf(ip, op);
      if (li + step < lb) is = fmaxf(is, os);
    }
    const float ep = __shfl_up_sync(kFull, ip, 1);
    const float es = __shfl_down_sync(kFull, is, 1);
    const float cp = li == 0 ? -CUDART_INF_F : ep;
    const float cs = li == lb - 1 ? -CUDART_INF_F : es;
    p = make_float4(fmaxf(p.x, cp), fmaxf(p.y, cp), fmaxf(p.z, cp), fmaxf(p.w, cp));
    s = make_float4(fmaxf(s.x, cs), fmaxf(s.y, cs), fmaxf(s.z, cs), fmaxf(s.w, cs));
  }
}

// scan the staged row at offset off (lane: positions off + 4 lane ..):
// pre and the maxima of the blocks that start there into shared memory;
// returns the suffix maxima
template <int kSh>
__device__ __forceinline__ float4 scan_row(float4 m, int lane, float* pre, float* bmax, int off) {
  float4 p, s;
  block_scans<kSh>(m, lane, p, s);
  reinterpret_cast<float4*>(pre + off)[lane] = p;
  const int s0 = off + 4 * lane;
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // suf at a block's start is its maximum
    if (((s0 + q) & ((1 << kSh) - 1)) == 0) bmax[(s0 + q) >> kSh] = elem(s, q);
  }
  return s;
}

template <int kSh, bool kOneMid>
__global__ void __launch_bounds__(kThreads)
ask_fire_kernel(const float* __restrict__ sync, const uint8_t* __restrict__ upd, int t, int w,
                bool vec, uint8_t* __restrict__ hit) {
  extern __shared__ float4 smem[];
  const int rows = staged_rows(w);
  float* pre = reinterpret_cast<float*>(smem);
  float* bmax = pre + rows * 128;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * t;
  const int r0 = blockIdx.x * kTile - static_cast<int>(row0 & 3);   // position of staged 0
  if (r0 >= t) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the tile's rows warp, warp + 8, ...: their loads first, kept for the
  // decisions; then the halo rows, loaded and scanned; then the tile's
  float4 v[kRowsPerWarp], sf[kRowsPerWarp];
  uint32_t u[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int s = (warp + k * kWarps) * 128 + 4 * lane;
    load_group(sync, upd, vec, row0, r0 + s, t, v[k], u[k]);
  }
  for (int j = kTileRows + warp; j < rows; j += kWarps) {
    float4 hv;
    uint32_t hu;
    load_group(sync, upd, vec, row0, r0 + j * 128 + 4 * lane, t, hv, hu);
    mask_group(hv, hu);
    scan_row<kSh>(hv, lane, pre, bmax, j * 128);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    mask_group(v[k], u[k]);
    sf[k] = scan_row<kSh>(v[k], lane, pre, bmax, (warp + k * kWarps) * 128);
  }
  __syncthreads();

  // the decisions of positions s .. s+3
  const int wq = w >> 2, wr = w & 3;
  const float4* pre4 = reinterpret_cast<const float4*>(pre);
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int s = (warp + k * kWarps) * 128 + 4 * lane;
    // suf[s+1 .. s+4]: the lane's own, then the next lane's first; past
    // the row, the next row's first block maximum
    float nx = __shfl_down_sync(kFull, sf[k].x, 1);
    if (lane == 31) nx = bmax[(s + 4) >> kSh];
    const float sv[4] = {sf[k].y, sf[k].z, sf[k].w, nx};
    // pre[s+w .. s+w+3]: the float4 at s + 4 wq and the next lane's
    const float4 pa = pre4[s / 4 + wq];
    float4 pb = make_float4(__shfl_down_sync(kFull, pa.x, 1), __shfl_down_sync(kFull, pa.y, 1),
                            __shfl_down_sync(kFull, pa.z, 1), 0.0f);
    if (lane == 31) pb = pre4[s / 4 + wq + 1];
    uint32_t h = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ca = (s + q + 1) >> kSh, ce = (s + q + w) >> kSh;   // the window's end blocks
      float mx = fmaxf(sv[q], q + wr < 4 ? elem(pa, q + wr) : elem(pb, q + wr - 4));
      if (kOneMid) {
        if (ca + 1 < ce) mx = fmaxf(mx, bmax[ca + 1]);
      } else {
        for (int c = ca + 1; c < ce; ++c) mx = fmaxf(mx, bmax[c]);
      }
      const bool fires = upd_at(u[k], q) && elem(v[k], q) >= mx;
      h |= static_cast<uint32_t>(fires) << (8 * q);
    }
    const int r = r0 + s;
    if (vec && r >= 0 && r + 4 <= t) {
      *reinterpret_cast<uint32_t*>(hit + row0 + r) = h;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r + q >= 0 && r + q < t) hit[row0 + r + q] = static_cast<uint8_t>((h >> (8 * q)) & 1u);
      }
    }
  }
}

template <int kSh, bool kOneMid>
int launch(const float* sync, const uint8_t* upd, int batch, int t, int w, bool vec,
           uint8_t* hit, cudaStream_t stream) {
  const size_t smem = smem_bytes(w, kSh);
  const auto kernel = ask_fire_kernel<kSh, kOneMid>;
  if (smem > 48 * 1024) {   // past the default: the card's opt-in limit
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((t + 3 + kTile - 1) / kTile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(sync, upd, t, w, vec, hit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tm_ask_fire(const float* sync, const uint8_t* upd, int batch,
                           int t, int w, uint8_t* hit, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || w < 1 || w > kMaxW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = reinterpret_cast<uintptr_t>(sync) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(hit) % 4 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  int sh = 0;   // blocks of 2^sh <= w positions, at most 128
  while (sh < 7 && (2 << sh) <= w) ++sh;
  // below 128, w < 2^(sh+1): at most one block between a window's ends
  switch (sh) {
    case 0: return launch<0, true>(sync, upd, batch, t, w, vec, hit, st);
    case 1: return launch<1, true>(sync, upd, batch, t, w, vec, hit, st);
    case 2: return launch<2, true>(sync, upd, batch, t, w, vec, hit, st);
    case 3: return launch<3, true>(sync, upd, batch, t, w, vec, hit, st);
    case 4: return launch<4, true>(sync, upd, batch, t, w, vec, hit, st);
    case 5: return launch<5, true>(sync, upd, batch, t, w, vec, hit, st);
    case 6: return launch<6, true>(sync, upd, batch, t, w, vec, hit, st);
    default:
      return w <= 2 * 128 + 1 ? launch<7, true>(sync, upd, batch, t, w, vec, hit, st)
                              : launch<7, false>(sync, upd, batch, t, w, vec, hit, st);
  }
}
