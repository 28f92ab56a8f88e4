// VAI — Variable Arithmetic Intensity kernel (paper Algorithm 1) for Hopper.
//
// Replaces: src/repro/kernels/vai.py, functions `_vai_kernel` / `vai` (the
// Pallas kernel of the reference package).
//
// What it computes: per element z = c; repeat `loopsize` times z = a*b + z;
// out = z. loopsize == 0 is the stream copy out = b, which reads b only
// (8 bytes per element instead of 16).
//
// What bounds it on this card: bytes for small loopsize (16 B per element
// against 2*loopsize flops; the fp32 FMA pipes overtake the memory at about
// loopsize 160), operations above that. Nothing is reused, so there is
// nothing to keep in shared memory: the design is one pass through
// registers. Each thread loads one float4 of a, b and c with 128-bit loads
// (a warp reads 512 contiguous bytes of each array), runs the dependent FMA
// chain on its four components in registers, and stores one float4.
// `block_rows` is the number of 128-float rows one thread block owns: the
// grid is rows / block_rows blocks of 256 threads, and a block walks its
// block_rows * 32 float4s with a block-stride loop (a multiple of 8 rows
// gives every thread the same number of float4s).
//
// `loopsize` is a runtime argument: the sweep walks 0 .. 8192 and a
// template per value would rebuild for each. The chain is written with
// fmaf() — one rounding per step, never a separate multiply and add — and
// each step depends on the one before, so the compiler cannot fold the loop
// into c + loopsize*a*b. The four components of a float4 are independent
// chains, which is what hides the FMA latency.
//
// SASS (nvcc 12.8, -O3, sm_90a; chip_smoke.py prints the count and PERF.md
// names the run that read it): the loop over `loopsize` is unrolled 16 times
// and its body is 64 FFMA (16 steps x 4 components) and nothing else but the
// counter and the branch; the remainder (loopsize % 16) is a straight run of
// 15 steps x 4 FFMA with an exit after each step. 124 FFMA in the kernel,
// no FMUL or FADD: the chain is not folded.
//
// Measured on an H100 SXM at 700 W: the operations-bound end settles at
// about two thirds of the card's fp32 FMA rate at a steady 1980 MHz. A
// deeper unroll, more float4s a thread, another block size or running the
// four chains one after the other do not raise it; the same loop with two
// distinct register operands an FMA (a*a + z) runs at 95 % of the rate. The
// limit is the register file's operand bandwidth for three-source FFMAs,
// and a*b + z has three by definition (tools/vai_fma_order.py times the
// variants; PERF.md has the numbers).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerRow = 32;  // a row is 128 floats = 32 float4
constexpr int kUnroll = 16;  // steps of the FMA chain per loop trip

__global__ void __launch_bounds__(kThreads)
vai_fma_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
               const float4* __restrict__ c, float4* __restrict__ out,
               long long vec_per_block, int loopsize) {
  const long long base = static_cast<long long>(blockIdx.x) * vec_per_block;
  for (long long i = threadIdx.x; i < vec_per_block; i += kThreads) {
    const float4 x = a[base + i];
    const float4 y = b[base + i];
    float4 z = c[base + i];
#pragma unroll kUnroll
    for (int k = 0; k < loopsize; ++k) {
      z.x = fmaf(x.x, y.x, z.x);
      z.y = fmaf(x.y, y.y, z.y);
      z.z = fmaf(x.z, y.z, z.z);
      z.w = fmaf(x.w, y.w, z.w);
    }
    out[base + i] = z;
  }
}

__global__ void __launch_bounds__(kThreads)
vai_copy_kernel(const float4* __restrict__ b, float4* __restrict__ out,
                long long vec_per_block) {
  const long long base = static_cast<long long>(blockIdx.x) * vec_per_block;
  for (long long i = threadIdx.x; i < vec_per_block; i += kThreads) {
    out[base + i] = b[base + i];
  }
}

}  // namespace

// a, b, c, out: [rows, 128] float32, contiguous, 16-byte aligned, on the
// current device. block_rows divides rows. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int repro_vai_f32(const void* a, const void* b, const void* c,
                             void* out, long long rows, long long block_rows,
                             int loopsize, void* stream) {
  const long long grid = rows / block_rows;
  if (grid <= 0 || grid > 2147483647LL || grid * block_rows != rows ||
      loopsize < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long vec_per_block = block_rows * kVecPerRow;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (loopsize == 0) {
    vai_copy_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const float4*>(b), static_cast<float4*>(out),
        vec_per_block);
  } else {
    vai_fma_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const float4*>(a), static_cast<const float4*>(b),
        static_cast<const float4*>(c), static_cast<float4*>(out),
        vec_per_block, loopsize);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
