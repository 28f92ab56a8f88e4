// Three orderings of the VAI FMA chain, to see what holds the
// operations-bound end of src/repro_torch/kernels/csrc/vai.cu below the
// card's fp32 FMA rate. All three do the same arithmetic on every element
// (loopsize dependent fmaf steps), so their outputs are equal bit for bit.
//   A  the four components of a float4 step together (what vai.cu does)
//   B  one component's whole chain after the other
//   C  two steps of a component, then the next component
//   D  order A computing a*a + z: two distinct register operands an FMA
//      instead of three (other arithmetic, so it is timed, not compared)
// Built and timed by tools/vai_fma_order.py.
#include <cuda_runtime.h>

#ifndef CHAIN_UNROLL
#define CHAIN_UNROLL 16
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = CHAIN_UNROLL;

#define STEP(f) z.f = fmaf(x.f, y.f, z.f)

__device__ __forceinline__ float chain(float x, float y, float z, int n) {
#pragma unroll kUnroll
  for (int k = 0; k < n; ++k) z = fmaf(x, y, z);
  return z;
}

template <int kOrder>
__global__ void __launch_bounds__(kThreads)
vai_order_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                 const float4* __restrict__ c, float4* __restrict__ out,
                 long long vec_per_block, int loopsize) {
  const long long base = static_cast<long long>(blockIdx.x) * vec_per_block;
  for (long long i = threadIdx.x; i < vec_per_block; i += kThreads) {
    const float4 x = a[base + i];
    const float4 y = kOrder == 3 ? x : b[base + i];
    float4 z = c[base + i];
    if (kOrder == 0 || kOrder == 3) {
#pragma unroll kUnroll
      for (int k = 0; k < loopsize; ++k) { STEP(x); STEP(y); STEP(z); STEP(w); }
    } else if (kOrder == 1) {
      z.x = chain(x.x, y.x, z.x, loopsize);
      z.y = chain(x.y, y.y, z.y, loopsize);
      z.z = chain(x.z, y.z, z.z, loopsize);
      z.w = chain(x.w, y.w, z.w, loopsize);
    } else {
      int k = 0;
#pragma unroll 8
      for (; k + 1 < loopsize; k += 2) {
        STEP(x); STEP(x); STEP(y); STEP(y); STEP(z); STEP(z); STEP(w); STEP(w);
      }
      if (k < loopsize) { STEP(x); STEP(y); STEP(z); STEP(w); }
    }
    out[base + i] = z;
  }
}

}  // namespace

// a, b, c, out: [rows, 128] float32, contiguous; block_rows divides rows.
extern "C" int vai_order(int order, const void* a, const void* b,
                         const void* c, void* out, long long rows,
                         long long block_rows, int loopsize, void* stream) {
  const unsigned grid = static_cast<unsigned>(rows / block_rows);
  const long long vpb = block_rows * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* pa = static_cast<const float4*>(a);
  const float4* pb = static_cast<const float4*>(b);
  const float4* pc = static_cast<const float4*>(c);
  float4* po = static_cast<float4*>(out);
  if (order == 0) {
    vai_order_kernel<0><<<grid, kThreads, 0, s>>>(pa, pb, pc, po, vpb, loopsize);
  } else if (order == 1) {
    vai_order_kernel<1><<<grid, kThreads, 0, s>>>(pa, pb, pc, po, vpb, loopsize);
  } else if (order == 2) {
    vai_order_kernel<2><<<grid, kThreads, 0, s>>>(pa, pb, pc, po, vpb, loopsize);
  } else {
    vai_order_kernel<3><<<grid, kThreads, 0, s>>>(pa, pb, pc, po, vpb, loopsize);
  }
  return static_cast<int>(cudaGetLastError());
}
