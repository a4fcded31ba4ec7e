// The window health probe's kernel: a launch whose body is a short store
// loop into on-chip memory, so its time is the card's launch and loop floor.
//
// Replaces: bench.py:_probe_window's Pallas kernel `k` (bench.py:200,
// launched by the pallas_call at :207): grid=(32,), each step a 128-step
// fori_loop storing x + c into its (8, 128) output block for c = 0..127.
// That block lives in VMEM (its out_spec), and Pallas writes it back to
// device memory once a grid step.
//
// tm_seq_probe(x f32[8, 128], out f32[256, 128]): 128 blocks of 64
// threads, four consecutive elements (a float4) a thread, so a block holds
// a quarter of one (8, 128) block of the output.  Thread q (q = 64 b + t)
// stages x4[q mod 256] + c in its float4 of shared memory for c = 0, 1,
// ..., 127, one store a step, c counted in f32 as the TPU loop carries it;
// then it reads its float4 back and writes it to out4[q], the output's one
// trip to device memory.  Every (8, 128) block of the output ends as
// x + 127.0f.
//
// The stores are `asm volatile`: the loop exists to be executed, and
// without that nvcc -O3 keeps only the last of 128 stores to one address
// (each overwrites the one before and nothing reads them).  The read back
// is volatile too, so it follows the 128th store.
//
// What bounds it on an H100: the launch, then shared memory's store rate.
// The function reads x once (4 KiB), writes the output once (128 KiB) and
// adds 128 times an element (4.2 M adds): 0.04 us of bytes, 0.06 us of
// adds at the card's peaks.  The stores come to 128 stores of 128 KiB,
// 16 MiB through shared memory; at 128 B a clock an SM on 128 of the 132
// SMs that is 1,024 clocks, about 0.55 us.  The first design stored to
// device memory from 32 blocks of 1,024 threads (32 SMs): 16 MiB through
// L2, 13 empty launches' worth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kXVecs = 8 * 128 / 4;        // x as float4
constexpr int kOutVecs = 256 * 128 / 4;    // the output as float4
constexpr int kThreads = 64;
constexpr int kBlocks = kOutVecs / kThreads;
constexpr int kSteps = 128;

__global__ void __launch_bounds__(kThreads) seq_probe_kernel(const float4* __restrict__ x,
                                                             float4* __restrict__ out) {
  __shared__ float4 stage[kThreads];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float4 v = x[q % kXVecs];
  const uint32_t slot = static_cast<uint32_t>(__cvta_generic_to_shared(stage + threadIdx.x));
  float c = 0.0f;
  for (int i = 0; i < kSteps; ++i) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(slot), "f"(v.x + c),
                 "f"(v.y + c), "f"(v.z + c), "f"(v.w + c) : "memory");
    c += 1.0f;
  }
  float4 o;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(o.x), "=f"(o.y), "=f"(o.z), "=f"(o.w) : "r"(slot) : "memory");
  out[q] = o;
}

}  // namespace

// x and out 16-byte aligned (the wrapper checks).
extern "C" int tm_seq_probe(const float* x, float* out, void* stream) {
  seq_probe_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
