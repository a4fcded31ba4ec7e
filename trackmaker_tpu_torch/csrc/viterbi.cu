// The K=7 (133, 171) Viterbi decoder at radix 4, one code block a row.
//
// Replaces no Pallas kernel: the JAX package decodes with a lax.scan
// (trackmaker_tpu/core/convcode.py:164 _viterbi_jit, radix 4 by default),
// which XLA runs as a loop of small programs.  Written as PyTorch ops, the
// same scan is about ten launches a block of 4 trellis steps and as many
// again for the traceback; here it is one launch for every row.
//
// tm_viterbi(r f32[N, 2*n_steps], N, n_steps, n_bits, hard,
//            choices u8[N, q + rem, 64], bits u8[N, n_bits]):
// q = n_steps / 4 blocks, rem = n_steps % 4 tail steps.  One block of 64
// threads a row, thread s owning state s.  The path metrics live in shared
// memory, two buffers of 64 floats used in turns, so each block of 4 steps
// costs one barrier; the metrics start at 0 for state 0, -1e9 elsewhere.
//
// Each block of 4 steps: thread s walks its 16 paths j = c4*8 + c3*4 +
// c2*2 + c1 (c4 the block's last step, the most significant bit, as the
// JAX scan flattens its choice axes), s4 = s and s_{i-1} = 2 (s_i % 32) +
// c_i, and adds each path's value in trellis order,
// (((m[s0] + bm(s1,c1)) + bm(s2,c2)) + bm(s3,c3)) + bm(s4,c4), with
// bm(s, c) = pout(s,c,0) r0 + pout(s,c,1) r1 and pout(s,c,k) = +1 where
// the register ((s >> 5) << 6) | (2 (s % 32) + c) has odd parity under
// generator k, else -1.  The first maximum wins (strict >).  Every pout is
// +-1, so each product is exact and bm is one rounded sum; the path's four
// additions are __fadd_rn, in that order, so no contraction reorders them
// (and the build has no --use_fast_math).  So the decisions are the JAX
// default's bit for bit, ties made by rounding included: radix 1 would
// differ where a + c and b + c round to one value with a != b.  The tail
// steps take radix 1, choice c1 > c0.  Each block's choice (0..15) and
// each tail step's (0, 1) go to `choices`; then thread 0 traces back from
// state 0, the tail first, bit = s >> 5 and s = 2 (s % 32) + c, writing
// the first n_bits bits.  Hard input (hard != 0) maps to 2r - 1.
//
// What bounds it: not bytes (a row reads 8 bytes a step) nor operations
// (about 1,300 a trellis step), but the chain: ceil(n_steps / 4) block
// steps, each after one barrier, then a traceback of one dependent read a
// block.  A block holds 2 warps, so an SM runs few of them, and at 256
// rows the card holds about 2 a SM: the kernel is latency-bound, and the
// chain is what a later design shortens (the choices in shared memory, the
// received values staged ahead).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kRadix = 4;
constexpr unsigned kG0 = 0133;
constexpr unsigned kG1 = 0171;

__device__ __forceinline__ float branch(int s, int c, float r0, float r1) {
  const unsigned reg = (static_cast<unsigned>(s >> 5) << 6) | static_cast<unsigned>(2 * (s & 31) + c);
  const float a = (__popc(reg & kG0) & 1) ? r0 : -r0;
  const float b = (__popc(reg & kG1) & 1) ? r1 : -r1;
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float input(const float* r, int i, int hard) {
  const float v = r[i];
  return hard ? __fadd_rn(__fmul_rn(2.0f, v), -1.0f) : v;
}

__global__ void __launch_bounds__(kStates) viterbi_kernel(const float* __restrict__ received,
                                                           int n_steps, int n_bits, int hard,
                                                           uint8_t* __restrict__ choices,
                                                           uint8_t* __restrict__ bits) {
  __shared__ float pm[2][kStates];
  const int s = threadIdx.x;
  const int q = n_steps / kRadix;
  const int rem = n_steps - q * kRadix;
  const float* r = received + static_cast<size_t>(blockIdx.x) * 2 * n_steps;
  uint8_t* ch = choices + static_cast<size_t>(blockIdx.x) * (q + rem) * kStates;
  pm[0][s] = s == 0 ? 0.0f : -1e9f;
  __syncthreads();
  int cur = 0;
  for (int blk = 0; blk < q; ++blk) {
    float rv[2 * kRadix];
#pragma unroll
    for (int k = 0; k < 2 * kRadix; ++k) rv[k] = input(r, 2 * kRadix * blk + k, hard);
    float best = 0.0f;
    int best_j = 0;
#pragma unroll
    for (int j = 0; j < 1 << kRadix; ++j) {
      const int c1 = j & 1, c2 = (j >> 1) & 1, c3 = (j >> 2) & 1, c4 = j >> 3;
      const int s3 = 2 * (s & 31) + c4;
      const int s2 = 2 * (s3 & 31) + c3;
      const int s1 = 2 * (s2 & 31) + c2;
      const int s0 = 2 * (s1 & 31) + c1;
      float v = pm[cur][s0];
      v = __fadd_rn(v, branch(s1, c1, rv[0], rv[1]));
      v = __fadd_rn(v, branch(s2, c2, rv[2], rv[3]));
      v = __fadd_rn(v, branch(s3, c3, rv[4], rv[5]));
      v = __fadd_rn(v, branch(s, c4, rv[6], rv[7]));
      if (j == 0 || v > best) {
        best = v;
        best_j = j;
      }
    }
    pm[cur ^ 1][s] = best;
    ch[blk * kStates + s] = static_cast<uint8_t>(best_j);
    __syncthreads();
    cur ^= 1;
  }
  for (int i = 0; i < rem; ++i) {
    const int t = q * kRadix + i;
    const float r0 = input(r, 2 * t, hard), r1 = input(r, 2 * t + 1, hard);
    const float a = __fadd_rn(pm[cur][2 * (s & 31)], branch(s, 0, r0, r1));
    const float b = __fadd_rn(pm[cur][2 * (s & 31) + 1], branch(s, 1, r0, r1));
    const int c = b > a;
    pm[cur ^ 1][s] = c ? b : a;
    ch[(q + i) * kStates + s] = static_cast<uint8_t>(c);
    __syncthreads();
    cur ^= 1;
  }
  if (s != 0) return;
  uint8_t* out = bits + static_cast<size_t>(blockIdx.x) * n_bits;
  int state = 0;
  for (int i = rem - 1; i >= 0; --i) {
    const int t = q * kRadix + i;
    const int c = ch[(q + i) * kStates + state];
    if (t < n_bits) out[t] = static_cast<uint8_t>(state >> 5);
    state = 2 * (state & 31) + c;
  }
  for (int blk = q - 1; blk >= 0; --blk) {
    const int j = ch[blk * kStates + state];
#pragma unroll
    for (int i = 0; i < kRadix; ++i) {
      const int t = kRadix * blk + kRadix - 1 - i;
      if (t < n_bits) out[t] = static_cast<uint8_t>(state >> 5);
      state = 2 * (state & 31) + ((j >> (kRadix - 1 - i)) & 1);
    }
  }
}

}  // namespace

// r, choices and bits contiguous on one card; n_rows >= 1 (the wrapper
// launches nothing for none).
extern "C" int tm_viterbi(const float* r, int n_rows, int n_steps, int n_bits, int hard,
                          uint8_t* choices, uint8_t* bits, void* stream) {
  viterbi_kernel<<<n_rows, kStates, 0, static_cast<cudaStream_t>(stream)>>>(r, n_steps, n_bits,
                                                                           hard, choices, bits);
  return static_cast<int>(cudaGetLastError());
}
