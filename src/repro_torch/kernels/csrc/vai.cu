// VAI — Variable Arithmetic Intensity kernel (paper Algorithm 1) for Hopper.
//
// Replaces: src/repro/kernels/vai.py, functions `_vai_kernel` / `vai` (the
// Pallas kernel of the reference package).
//
// What it computes: per element z = c; repeat `loopsize` times z = a*b + z
// (one fmaf a step, each on the result of the one before, so the chain is
// never folded into c + loopsize*a*b); out = z. loopsize == 0 is the stream
// copy out = b, which reads b only (8 bytes per element, not 16). The
// arithmetic is that of the reference step for step, so the bits are those
// of the plain version on every input.
//
// What bounds it on this card: bytes for small loopsize (16 B per element
// against 2*loopsize flops), operations from loopsize 128 on (at the rate
// the chain reaches, below).
//
// Design. One block takes one tile of `block_rows` rows; each thread loads
// Depth float4s of a, b and c (128-bit loads through the read-only path)
// before it uses the first, runs the chain on them in registers and stores
// Depth float4s; the block walks its tile in steps of Threads * Depth
// float4s. Nothing is reused, so nothing is kept in shared memory. The shape
// depends on what binds. tools/vai_check.py times each design in turns with
// the library call and the PR 11 kernel (256 threads, one float4 each);
// PERF.md names the run. On an H100 SXM at 700 W:
// - the bytes end (loopsize < kOpsFrom) and the copy: 1024-thread blocks,
//   4 float4s of each array in flight a thread (196 KB a block, one block an
//   SM). Fewer, fatter blocks finish each tile sooner, so the tiles in
//   flight at once are fewer and the last, partial wave is shorter. At
//   loopsize 8 it is level with torch.addcmul at 128 and 256 rows a tile
//   (0.1-0.3 % behind) and 2 % faster than the PR 11 kernel; the copy is
//   0.7-1.5 % behind b.clone() (cudaMemcpy) and 1-2 % faster than the PR 11
//   kernel. Both fall behind the library call as the tile grows (2-4 % at
//   1024 rows): a tile is the unit a block takes. Against this design,
//   streaming cache hints (.cs loads and stores) were 3-5 % slower, a
//   persistent wave walking the tiles 2-4 %, TMA bulk-copy rings 1-5 %.
// - the operations end (loopsize >= kOpsFrom): 512-thread blocks with 2
//   float4s a thread (8 independent chains, 32 registers, 2048 threads an
//   SM), the chain unrolled to 64 FFMA a trip: 42.7-43.8 TFLOP/s at
//   loopsize 8192 (by block_rows), 1 % faster than the PR 11 kernel (2-12 %
//   at loopsize 1024). That
//   is two thirds of the fp32 FMA rate, as for every arrangement tried: an
//   FFMA that reads three distinct registers issues at two thirds of the
//   rate whatever their register banks. Placing b's components in the other
//   bank (by index parity, or by aligned register pair) left the rate at
//   43.3 TFLOP/s, while a*a + z (two distinct registers) runs at 63.4
//   (tools/vai_fma_order.py). Only the operand reuse cache could serve a
//   third operand, and no two independent steps of this chain share one.
#include <cuda_runtime.h>

namespace {

constexpr int kVecPerRow = 32;  // a row is 128 floats = 32 float4
constexpr int kOpsFrom = 128;   // loopsize from which operations bind

__device__ __forceinline__ void step(float4& z, const float4& x,
                                     const float4& y) {
  z.x = fmaf(x.x, y.x, z.x);
  z.y = fmaf(x.y, y.y, z.y);
  z.z = fmaf(x.z, y.z, z.z);
  z.w = fmaf(x.w, y.w, z.w);
}

template <int Threads, int Depth>
__global__ void __launch_bounds__(Threads)
vai_fma_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
               const float4* __restrict__ c, float4* __restrict__ out,
               long long tiles, long long vec_per_tile, int loopsize) {
  constexpr long long kSpan = static_cast<long long>(Depth) * Threads;
  constexpr int kUnroll = 16 / Depth;  // 64 FFMA a trip of the chain
  // t runs once (the grid has a block a tile); the body, this loop
  // included, is the one tools/vai_stream.cu times as reg_kernel, so the
  // two compile alike
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * vec_per_tile;
    for (long long i0 = threadIdx.x; i0 < vec_per_tile; i0 += kSpan) {
      float4 x[Depth], y[Depth], z[Depth];
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        if (i < vec_per_tile) {
          x[d] = __ldg(a + base + i);
          y[d] = __ldg(b + base + i);
          z[d] = __ldg(c + base + i);
        } else {
          x[d] = y[d] = z[d] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll kUnroll
      for (int k = 0; k < loopsize; ++k) {
#pragma unroll
        for (int d = 0; d < Depth; ++d) step(z[d], x[d], y[d]);
      }
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        if (i < vec_per_tile) __stwb(out + base + i, z[d]);
      }
    }
  }
}

template <int Threads, int Depth>
__global__ void __launch_bounds__(Threads)
vai_copy_kernel(const float4* __restrict__ b, float4* __restrict__ out,
                long long tiles, long long vec_per_tile) {
  constexpr long long kSpan = static_cast<long long>(Depth) * Threads;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * vec_per_tile;
    for (long long i0 = threadIdx.x; i0 < vec_per_tile; i0 += kSpan) {
      float4 v[Depth];
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        v[d] = i < vec_per_tile ? __ldg(b + base + i)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        if (i < vec_per_tile) __stwb(out + base + i, v[d]);
      }
    }
  }
}

}  // namespace

// a, b, c, out: [rows, 128] float32, contiguous, 16-byte aligned, on the
// current device. block_rows divides rows. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int repro_vai_f32(const void* a, const void* b, const void* c,
                             void* out, long long rows, long long block_rows,
                             int loopsize, void* stream) {
  const long long tiles = block_rows > 0 ? rows / block_rows : 0;
  if (tiles <= 0 || tiles > 2147483647LL || tiles * block_rows != rows ||
      loopsize < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(tiles);
  const long long vpt = block_rows * kVecPerRow;
  const float4* pa = static_cast<const float4*>(a);
  const float4* pb = static_cast<const float4*>(b);
  const float4* pc = static_cast<const float4*>(c);
  float4* po = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (loopsize == 0) {
    vai_copy_kernel<1024, 4><<<grid, 1024, 0, s>>>(pb, po, tiles, vpt);
  } else if (loopsize < kOpsFrom) {
    vai_fma_kernel<1024, 4><<<grid, 1024, 0, s>>>(pa, pb, pc, po, tiles, vpt,
                                                  loopsize);
  } else {
    vai_fma_kernel<512, 2><<<grid, 512, 0, s>>>(pa, pb, pc, po, tiles, vpt,
                                                loopsize);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
