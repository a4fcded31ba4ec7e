// The window health probe's kernel: a launch whose body is a short store
// loop, so its time is the card's launch and loop floor.
//
// Replaces: bench.py:_probe_window's Pallas kernel `k` (bench.py:200,
// launched by the pallas_call at :207): grid=(32,), each step a 128-step
// fori_loop storing x + c into its (8, 128) output block for c = 0..127.
//
// tm_seq_probe(x f32[8, 128], out f32[256, 128]): 32 blocks of 1,024
// threads, one element of the (8, 128) block per thread.  Thread e of
// block b stores x[e] + c to out[1024 b + e] for c = 0, 1, ..., 127, one
// store per step, c counted in f32 as the TPU loop carries it.  Every
// (8, 128) block of the output ends as x + 127.0f.
//
// The store is volatile: the loop exists to be executed, and without it
// nvcc -O3 keeps only the last of 128 stores to one address (each store
// overwrites the one before and nothing reads them).  A volatile store is
// one memory operation per step and leaves the adds in registers, which is
// the probe's point; an asm memory fence would also pin every load of x.
//
// What bounds it on an H100: the launch and the loop, not memory.  The
// stores come to 128 KiB written 128 times, 16 MiB, about 5 us at
// 3.35 TB/s, and they hit one 128 KiB footprint that stays in L2; the
// 32 blocks fill 32 of the 132 SMs.  Its time reads the launch floor
// against which the port's tiny kernels are read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocks = 32;
constexpr int kThreads = 8 * 128;   // one (8, 128) block
constexpr int kSteps = 128;

__global__ void __launch_bounds__(kThreads) seq_probe_kernel(const float* __restrict__ x,
                                                             float* out) {
  const int e = threadIdx.x;
  const float v = x[e];
  volatile float* o = out + static_cast<int64_t>(blockIdx.x) * kThreads + e;
  float c = 0.0f;
  for (int i = 0; i < kSteps; ++i) {
    *o = v + c;
    c += 1.0f;
  }
}

}  // namespace

extern "C" int tm_seq_probe(const float* x, float* out, void* stream) {
  seq_probe_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}
