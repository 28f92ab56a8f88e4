// The rate of the TF32 tensor-core product that the f32 flash-attention
// kernel (src/repro_torch/kernels/csrc/flash_attention.cu) is built on:
// mma.sync.aligned.m16n8k8 .tf32 with an f32 accumulator. Each warp runs
// `iters` rounds of `chains` independent products (one accumulator a
// chain), so the time shows the issue rate where chains and warps are many
// and the latency of one product where both are one.
// Built and timed by tools/mma_tf32_rate.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CHAINS>
__global__ void mma_tf32_loop(float* out, int iters) {
  float c[CHAINS][4];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;
  }
  // 2^-10 and 2^-12: sums of their products stay exact and finite
  const uint32_t a[4] = {0x3a800000u, 0x3a800000u, 0x3a800000u, 0x3a800000u};
  const uint32_t b = 0x39800000u + (threadIdx.x & 1u) * 0x2000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_tf32(c[j], a, b, b);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// chains in {1, 2, 4, 8}; blocks x threads threads; returns
// cudaGetLastError()
extern "C" int repro_mma_tf32_loop(int chains, int blocks, int threads,
                                   int iters, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: mma_tf32_loop<1><<<blocks, threads, 0, s>>>(out, iters); break;
    case 2: mma_tf32_loop<2><<<blocks, threads, 0, s>>>(out, iters); break;
    case 4: mma_tf32_loop<4><<<blocks, threads, 0, s>>>(out, iters); break;
    case 8: mma_tf32_loop<8><<<blocks, threads, 0, s>>>(out, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
