// Orderings and register placements of the VAI FMA chain, to see what holds
// the operations-bound end of the chain below the card's fp32 FMA rate. The
// frame is the PR 11 kernel's: one float4 of a, b and c a thread (128-bit
// loads, so each lands in an aligned register quad), rows / block_rows
// blocks of 256 threads. Every variant but D does the same arithmetic on
// every element (loopsize dependent fmaf steps from z = c, in order), so
// its output equals A's bit for bit.
//   A  the four components of a float4 step together (the PR 11 kernel)
//   B  one component's whole chain after the other          (issue order)
//   C  two steps of a component, then the next component    (issue order)
//   D  order A computing a*a + z: two distinct source registers an FMA
//      instead of three (other arithmetic, so it is timed, not compared)
//   E  ping-pong accumulators, w = a*b + z then z = a*b + w, so that the
//      compiler places each destination
//   Fb b's components moved out of their load quad into scalars (one
//      register move each, before the loop)
//   Fc the same for c, the accumulator
//   P  the first and last steps peeled, so that the accumulator the loop
//      carries is tied to neither the load quad of c nor the store quad
//   R1 b rotated by one component through the thread's own slot of shared
//      memory (a volatile 128-bit store of (b.w, b.x, b.y, b.z) and a
//      volatile 128-bit load, so that ptxas cannot forward the store to the
//      load), so b's component j sits at offset j + 1 of its quad: by index
//      parity in the other register bank from a's component j
//   R2 the same rotated by two components, (b.z, b.w, b.x, b.y): b's
//      component j at offset j + 2, in the other half of its quad from a's
//      (the other bank if a bank is an aligned register pair)
// Built and timed by tools/vai_fma_order.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;

enum Variant { A, B, C, D, E, Fb, Fc, P, R1, R2, kVariants };

#define STEP(f) z.f = fmaf(x.f, y.f, z.f)

__device__ __forceinline__ float chain(float x, float y, float z, int n) {
#pragma unroll kUnroll
  for (int k = 0; k < n; ++k) z = fmaf(x, y, z);
  return z;
}

__device__ __forceinline__ float moved(float v) {
  float r;
  asm volatile("mov.b32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
vai_order_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                 const float4* __restrict__ c, float4* __restrict__ out,
                 long long vec_per_block, int loopsize) {
  __shared__ float4 slot[kThreads];
  const long long base = static_cast<long long>(blockIdx.x) * vec_per_block;
  for (long long i = threadIdx.x; i < vec_per_block; i += kThreads) {
    const float4 x = a[base + i];
    const float4 y = kVariant == D ? x : b[base + i];
    float4 z = c[base + i];
    if (kVariant == A || kVariant == D) {
#pragma unroll kUnroll
      for (int k = 0; k < loopsize; ++k) { STEP(x); STEP(y); STEP(z); STEP(w); }
    } else if (kVariant == B) {
      z.x = chain(x.x, y.x, z.x, loopsize);
      z.y = chain(x.y, y.y, z.y, loopsize);
      z.z = chain(x.z, y.z, z.z, loopsize);
      z.w = chain(x.w, y.w, z.w, loopsize);
    } else if (kVariant == C) {
      int k = 0;
#pragma unroll 8
      for (; k + 1 < loopsize; k += 2) {
        STEP(x); STEP(x); STEP(y); STEP(y); STEP(z); STEP(z); STEP(w); STEP(w);
      }
      if (k < loopsize) { STEP(x); STEP(y); STEP(z); STEP(w); }
    } else if (kVariant == E) {
      float4 w;
      int k = 0;
#pragma unroll 8
      for (; k + 1 < loopsize; k += 2) {
        w.x = fmaf(x.x, y.x, z.x);
        w.y = fmaf(x.y, y.y, z.y);
        w.z = fmaf(x.z, y.z, z.z);
        w.w = fmaf(x.w, y.w, z.w);
        z.x = fmaf(x.x, y.x, w.x);
        z.y = fmaf(x.y, y.y, w.y);
        z.z = fmaf(x.z, y.z, w.z);
        z.w = fmaf(x.w, y.w, w.w);
      }
      if (k < loopsize) { STEP(x); STEP(y); STEP(z); STEP(w); }
    } else if (kVariant == Fb) {
      const float4 ym = make_float4(moved(y.x), moved(y.y), moved(y.z),
                                    moved(y.w));
#pragma unroll kUnroll
      for (int k = 0; k < loopsize; ++k) {
        z.x = fmaf(x.x, ym.x, z.x);
        z.y = fmaf(x.y, ym.y, z.y);
        z.z = fmaf(x.z, ym.z, z.z);
        z.w = fmaf(x.w, ym.w, z.w);
      }
    } else if (kVariant == Fc) {
      float zx = moved(z.x), zy = moved(z.y), zz = moved(z.z),
            zw = moved(z.w);
#pragma unroll kUnroll
      for (int k = 0; k < loopsize; ++k) {
        zx = fmaf(x.x, y.x, zx);
        zy = fmaf(x.y, y.y, zy);
        zz = fmaf(x.z, y.z, zz);
        zw = fmaf(x.w, y.w, zw);
      }
      z = make_float4(zx, zy, zz, zw);
    } else if (kVariant == P) {
      if (loopsize > 0) {
        float zx = fmaf(x.x, y.x, z.x), zy = fmaf(x.y, y.y, z.y),
              zz = fmaf(x.z, y.z, z.z), zw = fmaf(x.w, y.w, z.w);
#pragma unroll kUnroll
        for (int k = 2; k < loopsize; ++k) {
          zx = fmaf(x.x, y.x, zx);
          zy = fmaf(x.y, y.y, zy);
          zz = fmaf(x.z, y.z, zz);
          zw = fmaf(x.w, y.w, zw);
        }
        if (loopsize > 1) {
          zx = fmaf(x.x, y.x, zx);
          zy = fmaf(x.y, y.y, zy);
          zz = fmaf(x.z, y.z, zz);
          zw = fmaf(x.w, y.w, zw);
        }
        z = make_float4(zx, zy, zz, zw);
      }
    } else if (kVariant == R1 || kVariant == R2) {
      const uint32_t addr =
          static_cast<uint32_t>(__cvta_generic_to_shared(&slot[threadIdx.x]));
      if (kVariant == R1) {
        asm volatile("st.volatile.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                         addr),
                     "f"(y.w), "f"(y.x), "f"(y.y), "f"(y.z)
                     : "memory");
      } else {
        asm volatile("st.volatile.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                         addr),
                     "f"(y.z), "f"(y.w), "f"(y.x), "f"(y.y)
                     : "memory");
      }
      float4 r;  // R1: (b.w, b.x, b.y, b.z); R2: (b.z, b.w, b.x, b.y)
      asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
                   : "r"(addr)
                   : "memory");
      const float bx = kVariant == R1 ? r.y : r.z;
      const float by = kVariant == R1 ? r.z : r.w;
      const float bz = kVariant == R1 ? r.w : r.x;
      const float bw = kVariant == R1 ? r.x : r.y;
#pragma unroll kUnroll
      for (int k = 0; k < loopsize; ++k) {
        z.x = fmaf(x.x, bx, z.x);
        z.y = fmaf(x.y, by, z.y);
        z.z = fmaf(x.z, bz, z.z);
        z.w = fmaf(x.w, bw, z.w);
      }
    }
    out[base + i] = z;
  }
}

template <int kVariant>
int launch(const float4* a, const float4* b, const float4* c, float4* out,
           unsigned grid, long long vpb, int loopsize, cudaStream_t s) {
  vai_order_kernel<kVariant><<<grid, kThreads, 0, s>>>(a, b, c, out, vpb,
                                                       loopsize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, c, out: [rows, 128] float32, contiguous; block_rows divides rows.
extern "C" int vai_order(int variant, const void* a, const void* b,
                         const void* c, void* out, long long rows,
                         long long block_rows, int loopsize, void* stream) {
  const unsigned grid = static_cast<unsigned>(rows / block_rows);
  const long long vpb = block_rows * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* pa = static_cast<const float4*>(a);
  const float4* pb = static_cast<const float4*>(b);
  const float4* pc = static_cast<const float4*>(c);
  float4* po = static_cast<float4*>(out);
  switch (variant) {
    case A: return launch<A>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case B: return launch<B>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case C: return launch<C>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case D: return launch<D>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case E: return launch<E>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case Fb: return launch<Fb>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case Fc: return launch<Fc>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case P: return launch<P>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case R1: return launch<R1>(pa, pb, pc, po, grid, vpb, loopsize, s);
    case R2: return launch<R2>(pa, pb, pc, po, grid, vpb, loopsize, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
