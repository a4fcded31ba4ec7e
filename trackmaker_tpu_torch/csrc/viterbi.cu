// The K=7 (133, 171) Viterbi decoder at radix 4, one code block a row.
//
// Replaces no Pallas kernel: the JAX package decodes with a lax.scan
// (trackmaker_tpu/core/convcode.py:164 _viterbi_jit, radix 4 by default),
// which XLA runs as a loop of small programs.  Written as PyTorch ops, the
// same scan is about ten launches a block of 4 trellis steps and as many
// again for the traceback; here it is one launch for every row.
//
// tm_viterbi(r f32[N, 2*n_steps], N, n_steps, n_bits, hard,
//            choices u8[N, q + rem, 64] or null, bits u8[N, n_bits]):
// q = n_steps / 4 blocks of 4 trellis steps, rem = n_steps % 4 tail steps;
// one block of 64 threads a row, thread h owning state h.  What it decides
// is the JAX default's bit for bit: state s keeps the first maximum (the
// smallest j among equal values) of its 16 paths j = c4*8 + c3*4 + c2*2 +
// c1 (c4 the block's last step), s4 = s and s_{i-1} = 2 (s_i % 32) + c_i,
// so the path leaves state s0 = 16 (s % 4) + j; each path's value is added
// in trellis order, (((m[s0] + bm1) + bm2) + bm3) + bm4, every add
// __fadd_rn (and the build has no --use_fast_math); the tail steps take
// radix 1, choice 1 where strictly larger; the traceback starts at state 0,
// the tail first.  Hard input maps to 2r - 1.  Metrics start at 0 for state
// 0, -1e9 elsewhere.
//
// What bounds it.  Not bytes (8 a trellis step in, one a bit out) and not
// operations (about 1,300 a trellis step: chip_smoke.py's viterbi_bound,
// 0.0025 ms at 256 rows of 518 steps), but the dependent chain: ceil(n_steps
// / 4) block steps (130 at 518 steps, 514 at 2,054), each reading the
// metrics the one before wrote, so each costs the path sums of one thread's
// paths and a pass through shared memory and a barrier; then a traceback of
// q dependent reads.  The first design took 0.52 us a block step on an
// H100 (device memory loads and stores and the branch parities on the
// chain); this one 0.17-0.19 us, of which 0.055-0.072 us is the
// exchange alone (one metric loaded and stored, the barrier: the variant
// `exchange` of tools/exp_viterbi.py) and the rest one warp's instruction
// stream of 146 instructions (64 FADD, the 16-way first maximum, the
// loads).  At 256 rows each SM holds two rows and the time a block step is
// the one-row time: the kernel is latency-bound at every size.  What each
// choice does about it:
//
// 1. The received values are staged in shared memory before the chain, by
//    cp.async (16 bytes a copy where the row is 16-byte aligned, else four
//    of 4 bytes), and turned there into the two sums of each trellis step,
//    P = r0 + r1 and M = r0 - r1 (the hard map applied first).  A row of
//    up to kWindow steps is staged whole; a longer one goes through a ring
//    of two halves: at each half's start, the half is converted (its copies
//    were issued a half before) and the half after it is copied into the
//    half just read, so no load of device memory waits on the chain and the
//    inner loop holds no check.
// 2. Every branch metric is +P, -P, +M or -M: bm = pout0 r0 + pout1 r1
//    with pout = +-1, and round-to-nearest is symmetric under negation, so
//    (-r0) + (-r1) = -P and (-r0) + r1 = -M exactly (up to the sign of an
//    exact zero, which compares equal and adds as nothing to a nonzero
//    value).  Which one is linear over GF(2) in the bits of s and of j: a
//    thread works out, before the loop, the label its state gives each
//    step (path 0's, pinned in registers: else the compiler recomputes it
//    in the loop), and each path's own part is a template constant
//    (computed in the loop, the labels cost 0.9-2.3 us a block step), so
//    each path's add is one FADD with a constant negation and no popc
//    remains.
// 3. The choices stay in shared memory, a byte a state a block step (33 KB
//    at the 2,054 steps of a 263-byte frame), and so does the traceback:
//    thread 0 follows them back from state 0 and writes the state reached
//    at each block's end over that block's first choice byte (read by
//    then); after a barrier every thread expands the bits, bit t = bit 2 +
//    t % 4 of the state at block t / 4's end, with coalesced stores.  Kept
//    in device memory instead (the variant `devchoices`) the kernel takes
//    1.9-2.0x as long at 518 and 2,054 steps.  A row whose choices do not
//    fit (past 12,448 steps, where the staging ring, the metrics and the
//    choices fill kSmemMax) keeps them in the `choices` scratch in device
//    memory: the same schedule, the other instance chosen from n_steps,
//    the same launch.
// 4. A thread keeps a whole state: its 16 paths from 16 consecutive
//    predecessors (four 16-byte shared loads), their first maximum by a
//    tree in which the right one, the higher j, wins only when strictly
//    larger.  Measured against it at 256 rows and at one row of 62, 518
//    and 2,054 steps (tools/exp_viterbi.py's variants; PERF.md), it is the
//    fastest at every shape: splitting a state's paths over T = 2 or 4
//    lanes joined by __shfl_xor_sync adds the shuffles' round trips to the
//    chain, more than its shorter instruction stream saves; two states a
//    thread (s and s + 32, sharing steps 1-3) saves adds but not the
//    first-maximum trees, which with the loads are most of a thread's
//    instructions.  At one row only the chain counts, and it is the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kStates = 64;
constexpr int kRadix = 4;
constexpr unsigned kG0 = 0133;
constexpr unsigned kG1 = 0171;
constexpr int kMetricBytes = 2 * kStates * 4;   // two buffers of 64 metrics, used in turns
constexpr int kWindow = 4096;                   // trellis steps staged: a whole row, or a ring
constexpr int kHalf = kWindow / 2;              // the ring's half, a multiple of 4
constexpr int kSmemMax = 232448;                // Hopper's opt-in shared memory a block
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr unsigned parity(unsigned x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 1u;
}

// The branch metric's label at step i (1..4) of a block for state s and
// path j: bit 0 set for the M family (r0 - r1), bit 1 set for a negated
// value.  bm = (a0 ? r0 : -r0) + (a1 ? r1 : -r1), a_k the parity of the
// register ((s_i >> 5) << 6) | (2 (s_i % 32) + c_i) under generator k.
__host__ __device__ constexpr int label(int s, int j, int i) {
  int st = s;
  for (int k = kRadix; k > i; --k) st = 2 * (st & 31) + ((j >> (k - 1)) & 1);
  const unsigned reg = (static_cast<unsigned>(st >> 5) << 6) |
                       static_cast<unsigned>(2 * (st & 31) + ((j >> (i - 1)) & 1));
  const unsigned a0 = parity(reg & kG0), a1 = parity(reg & kG1);
  return static_cast<int>((a0 ^ a1) | ((a0 ^ 1u) << 1));
}

// The part of a path's label that j itself gives at step i: bit 0 picks
// the other family, bit 1 (j's a0) negates.  With s = 0 the step-i
// register is j >> (i - 1), so the part is a constant of j and i.
__host__ __device__ constexpr int part(int j, int i) {
  const int l = label(0, j, i);
  return (l & 1) | (((l >> 1) ^ 1) << 1);
}

// One add of a path: its value a plus X or Y (the part's bit 0), negated
// or not (bit 1: a FADD's operand modifier).
template <int O>
__device__ __forceinline__ float add_part(float a, float x, float y) {
  constexpr bool other = (O & 1) != 0, negate = (O & 2) != 0;
  const float v = other ? y : x;
  return __fadd_rn(a, negate ? -v : v);
}

// Path J's value from its predecessor's metric m and the thread's values X
// (its state's label) and Y (the other family, the same sign) at the four
// steps, in trellis order.  The parts are template arguments, so nothing of
// the label is computed in the loop.
template <int J>
__device__ __forceinline__ float path_value(float m, const float* x, const float* y) {
  float a = add_part<part(J, 1)>(m, x[0], y[0]);
  a = add_part<part(J, 2)>(a, x[1], y[1]);
  a = add_part<part(J, 3)>(a, x[2], y[2]);
  return add_part<part(J, 4)>(a, x[3], y[3]);
}

template <int... J>
__device__ __forceinline__ void path_values(float* v, const float* m, const float* x,
                                            const float* y, std::integer_sequence<int, J...>) {
  ((v[J] = path_value<J>(m[J], x, y)), ...);
}

// The first maximum of n values by a tree: the right one, the higher j,
// wins only when strictly larger.  Returns the value; j = its index.
template <int N>
__device__ __forceinline__ float first_max(float* v, int& j) {
  int idx[N];
#pragma unroll
  for (int k = 0; k < N; ++k) idx[k] = k;
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < N; k += 2 * w) {
      if (v[k + w] > v[k]) {
        v[k] = v[k + w];
        idx[k] = idx[k + w];
      }
    }
  }
  j = idx[0];
  return v[0];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async the steps [a, e) of a row (a even) into the staging buffer from
// position pos (even): units of 2 steps, 16 bytes, unit u to thread
// u % blockDim.x; a unit past the row's end is zero-filled.
__device__ __forceinline__ void copy_steps(const float* row, float2* stage, int a, int e, int pos,
                                           bool a16) {
  const int units = (e - a + 1) / 2;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int t = a + 2 * u;
    const int valid = 2 * min(2, e - t);          // floats of the unit in the row
    const uint32_t dst = smem_addr(stage + pos + 2 * u);
    const float* src = row + 2 * t;
    if (a16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                   "r"(4 * valid) : "memory");
    } else {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4 * f),
                     "l"(f < valid ? src + f : row), "r"(f < valid ? 4 : 0) : "memory");
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float hard_map(float v, int hard) {
  return hard ? __fadd_rn(__fmul_rn(2.0f, v), -1.0f) : v;
}

// After the copies of [a, e) landed: each thread turns the units it copied
// from (r0, r1) into (P, M) = (r0 + r1, r0 - r1).
__device__ __forceinline__ void convert_steps(float2* stage, int a, int e, int pos, int hard) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  const int units = (e - a + 1) / 2;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float4* p = reinterpret_cast<float4*>(stage + pos + 2 * u);
    const float4 v = *p;
    const float r0 = hard_map(v.x, hard), r1 = hard_map(v.y, hard);
    const float r2 = hard_map(v.z, hard), r3 = hard_map(v.w, hard);
    *p = make_float4(__fadd_rn(r0, r1), __fadd_rn(r0, -r1), __fadd_rn(r2, r3), __fadd_rn(r2, -r3));
  }
}

// Keeps a per-thread constant in a register: the compiler may not recompute
// it from the thread index inside the loop.
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }

// One block of 64 threads a row, thread h owning state h.  The choices
// live in shared memory after the staging buffer, or (past the budget) in
// the device scratch `choices`.
template <bool kSharedChoices>
__global__ void __launch_bounds__(kStates) viterbi_kernel(const float* __restrict__ received,
                                                          int n_steps, int n_bits, int hard,
                                                          int window,
                                                          uint8_t* __restrict__ choices,
                                                          uint8_t* __restrict__ bits) {
  constexpr int kPaths = 16;                      // a state's paths, j = c4 c3 c2 c1
  extern __shared__ __align__(16) unsigned char smem[];
  float* pm = reinterpret_cast<float*>(smem);                     // [2][64]
  float2* stage = reinterpret_cast<float2*>(smem + kMetricBytes);  // [window] (P, M)
  const int h = threadIdx.x;                      // the thread's state
  const int q = n_steps / kRadix;
  const int rem = n_steps - q * kRadix;
  const float* row = received + static_cast<size_t>(blockIdx.x) * 2 * n_steps;
  uint8_t* ch = kSharedChoices
                    ? smem + kMetricBytes + 8 * window
                    : choices + static_cast<size_t>(blockIdx.x) * (q + rem) * kStates;
  const bool a16 = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const bool ring = n_steps > window;             // then window == kWindow

  copy_steps(row, stage, 0, min(n_steps, window), 0, a16);
  for (int k = threadIdx.x; k < kStates; k += blockDim.x) pm[k] = k == 0 ? 0.0f : -1e9f;
  // the thread's labels (its state's, path 0's):
  // X_i = sign_i (sel_i ? M_i : P_i), Y_i = sign_i (sel_i ? P_i : M_i)
  int sel[kRadix];
  float sign[kRadix];
#pragma unroll
  for (int i = 0; i < kRadix; ++i) {
    const int l = label(h, 0, i + 1);
    sel[i] = l & 1;
    sign[i] = (l & 2) ? -1.0f : 1.0f;
    pin(sel[i]);
    pin(sign[i]);
  }
  const int pred = 16 * (h & 3);                  // the thread's first predecessor
  convert_steps(stage, 0, min(n_steps, window), 0, hard);
  __syncthreads();

  for (int b0 = 0; b0 < q;) {
    const int t0 = kRadix * b0;
    const int b1 = ring ? min(q, b0 + kHalf / kRadix) : q;
    if (ring && b0 > 0) {
      // a half of the ring starts: its copies were issued a half ago (the
      // first two halves were staged before the loop); the half after it
      // goes into the half just read
      if (t0 >= kWindow) {
        convert_steps(stage, t0, min(t0 + kHalf, n_steps), t0 & (kWindow - 1), hard);
        __syncthreads();
      }
      if (t0 + kHalf < n_steps) {
        copy_steps(row, stage, t0 + kHalf, min(t0 + 2 * kHalf, n_steps),
                   (t0 + kHalf) & (kWindow - 1), a16);
      }
    }
    const float2* sums = stage + (t0 & (kWindow - 1));
    for (int blk = b0; blk < b1; ++blk, sums += kRadix) {
      const float* cur = pm + (blk & 1) * kStates + pred;
      float m[kPaths];
#pragma unroll
      for (int k = 0; k < kPaths; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cur + k);
        m[k] = v.x;
        m[k + 1] = v.y;
        m[k + 2] = v.z;
        m[k + 3] = v.w;
      }
      const float4 s01 = *reinterpret_cast<const float4*>(sums);
      const float4 s23 = *reinterpret_cast<const float4*>(sums + 2);
      const float pp[kRadix] = {s01.x, s01.z, s23.x, s23.z};
      const float mm[kRadix] = {s01.y, s01.w, s23.y, s23.w};
      float x[kRadix], y[kRadix];
#pragma unroll
      for (int i = 0; i < kRadix; ++i) {
        x[i] = (sel[i] ? mm[i] : pp[i]) * sign[i];
        y[i] = (sel[i] ? pp[i] : mm[i]) * sign[i];
      }
      float v[kPaths];
      path_values(v, m, x, y, std::make_integer_sequence<int, kPaths>{});
      int j;
      const float best = first_max<kPaths>(v, j);
      pm[((blk + 1) & 1) * kStates + h] = best;
      ch[blk * kStates + h] = static_cast<uint8_t>(j);
      __syncthreads();
    }
    b0 = b1;
  }
  const int t_tail = kRadix * q;
  if (ring && rem > 0 && (t_tail & (kHalf - 1)) == 0 && t_tail >= kWindow) {
    convert_steps(stage, t_tail, n_steps, t_tail & (kWindow - 1), hard);
    __syncthreads();
  }
  // the tail at radix 1: the label of a step-4 branch with c4 = c.  Each
  // thread its own state, as in the chain: written as a loop over the
  // block's states, this code (outside the chain) made the compiler slow
  // every block step by half (the variant `tailloop`)
  for (int i = 0; i < rem; ++i) {
    const float2 sm = stage[(t_tail + i) & (ring ? kWindow - 1 : 0x7fffffff)];
    const float* cur = pm + ((q + i) & 1) * kStates;
    float cand[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int l = label(h, c << 3, kRadix);
      const float f = (l & 1) ? sm.y : sm.x;
      cand[c] = __fadd_rn(cur[2 * (h & 31) + c], (l & 2) ? -f : f);
    }
    const int c = cand[1] > cand[0];
    pm[((q + i + 1) & 1) * kStates + h] = c ? cand[1] : cand[0];
    ch[(q + i) * kStates + h] = static_cast<uint8_t>(c);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int state = 0;
    for (int i = rem - 1; i >= 0; --i) state = 2 * (state & 31) + ch[(q + i) * kStates + state];
    for (int blk = q - 1; blk >= 0; --blk) {
      const int j = ch[blk * kStates + state];
      ch[blk * kStates] = static_cast<uint8_t>(state);   // the state at the block's end
      state = 16 * (state & 3) + j;
    }
  }
  __syncthreads();
  uint8_t* out = bits + static_cast<size_t>(blockIdx.x) * n_bits;
  for (int t = threadIdx.x; t < n_bits; t += blockDim.x) {
    out[t] = static_cast<uint8_t>((ch[(t >> 2) * kStates] >> (2 + (t & 3))) & 1);
  }
}

}  // namespace

// r, choices and bits contiguous on one card; n_rows >= 1 (the wrapper
// launches nothing for none).  `choices` may be null unless the row's
// choices exceed the shared memory (tm_viterbi refuses the call then: the
// wrapper's choices_fit decides the same way).
extern "C" int tm_viterbi(const float* r, int n_rows, int n_steps, int n_bits, int hard,
                          uint8_t* choices, uint8_t* bits, void* stream) {
  const int window = n_steps > kWindow ? kWindow : (n_steps + 1) & ~1;
  const size_t staged = kMetricBytes + static_cast<size_t>(8) * window;
  const size_t choice_bytes = static_cast<size_t>(n_steps / kRadix + n_steps % kRadix) * kStates;
  const bool shared_choices = staged + choice_bytes <= kSmemMax;
  if (!shared_choices && choices == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = shared_choices ? viterbi_kernel<true> : viterbi_kernel<false>;
  const size_t smem = staged + (shared_choices ? choice_bytes : 0);
  if (smem > 48 * 1024) {
    // past 48 KB a kernel needs its opt-in, once a device and instance
    static bool opted[kMaxDevices][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    bool* done = &opted[dev % kMaxDevices][shared_choices];
    if (!*done) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      *done = true;
    }
  }
  kernel<<<n_rows, kStates, smem, static_cast<cudaStream_t>(stream)>>>(r, n_steps, n_bits, hard,
                                                                       window, choices, bits);
  return static_cast<int>(cudaGetLastError());
}
