// Designs of the VAI kernel's streaming end, for tools/vai_check.py to time
// in turns with the shipped kernel and with the library call. Every design
// does the kernel's arithmetic step for step (loopsize dependent fmaf from
// z = c; out = b at loopsize 0), so its output equals the kernel's bit for
// bit, and every one keeps `block_rows` rows as the unit one block takes.
//
// (i) the register path, `reg_kernel<Threads, Depth, Load, Store>`: each
//     thread has Depth float4s of a, b and c in flight (128-bit loads) before
//     it uses the first, with a cache hint on the loads (ld.global.nc or
//     .cs) and on the stores (st.global.wb or .cs); the grid is one
//     block a tile, or one wave of blocks (SMs x the blocks an SM holds)
//     walking the tiles.
// (ii) TMA bulk copies, `tma_kernel<Stages, Chunk>`: one thread of each block
//     keeps chunks of a, b and c in flight from global to shared memory
//     (cp.async.bulk, completing on one mbarrier a stage), the block computes
//     each chunk into an output ring, and the same thread writes it back with
//     a bulk copy from shared to global memory. At loopsize 0 the whole of
//     shared memory is a ring of b's chunks, each written back from where it
//     landed.
// The table `kDesigns` at the end names them by number.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVecPerRow = 32;  // a row is 128 floats = 32 float4

enum Load { kNc, kCs };
enum Store { kWb, kSc };

template <int H>
__device__ __forceinline__ float4 load(const float4* p) {
  return H == kCs ? __ldcs(p) : __ldg(p);
}

template <int H>
__device__ __forceinline__ void store(float4* p, const float4& v) {
  if (H == kSc) {
    __stcs(p, v);
  } else {
    __stwb(p, v);
  }
}

__device__ __forceinline__ void step(float4& z, const float4& x,
                                     const float4& y) {
  z.x = fmaf(x.x, y.x, z.x);
  z.y = fmaf(x.y, y.y, z.y);
  z.z = fmaf(x.z, y.z, z.z);
  z.w = fmaf(x.w, y.w, z.w);
}

template <int Threads, int Depth, int L, int S>
__global__ void __launch_bounds__(Threads)
reg_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
           const float4* __restrict__ c, float4* __restrict__ out,
           long long tiles, long long vec_per_tile, int loopsize) {
  constexpr long long kSpan = static_cast<long long>(Depth) * Threads;
  constexpr int kUnroll = 16 / Depth;  // 64 FFMA a trip of the chain
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * vec_per_tile;
    for (long long i0 = threadIdx.x; i0 < vec_per_tile; i0 += kSpan) {
      float4 x[Depth], y[Depth], z[Depth];
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        if (i < vec_per_tile) {
          x[d] = load<L>(a + base + i);
          y[d] = load<L>(b + base + i);
          z[d] = load<L>(c + base + i);
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
        if (i < vec_per_tile) store<S>(out + base + i, z[d]);
      }
    }
  }
}

template <int Threads, int Depth, int L, int S>
__global__ void __launch_bounds__(Threads)
reg_copy_kernel(const float4* __restrict__ b, float4* __restrict__ out,
                long long tiles, long long vec_per_tile) {
  constexpr long long kSpan = static_cast<long long>(Depth) * Threads;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * vec_per_tile;
    for (long long i0 = threadIdx.x; i0 < vec_per_tile; i0 += kSpan) {
      float4 v[Depth];
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        v[d] = i < vec_per_tile ? load<L>(b + base + i)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int d = 0; d < Depth; ++d) {
        const long long i = i0 + d * Threads;
        if (i < vec_per_tile) store<S>(out + base + i, v[d]);
      }
    }
  }
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

constexpr int kTmaThreads = 256;

template <int kStages, int kChunk>
__global__ void __launch_bounds__(kTmaThreads)
tma_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
           const float4* __restrict__ c, float4* __restrict__ out,
           long long tiles, long long vec_per_tile, int loopsize) {
  // 4 * kStages chunk buffers: a, b, c and out of each stage, or at
  // loopsize 0 a ring of 4 * kStages chunks of b
  extern __shared__ __align__(128) unsigned char smem[];
  float4* buf = reinterpret_cast<float4*>(smem);
  constexpr int kBufs = 4 * kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + kBufs * kChunk);
  const bool copy = loopsize == 0;
  const int ring = copy ? kBufs : kStages;
  constexpr uint32_t kBytes = kChunk * sizeof(float4);
  const long long per_tile = vec_per_tile / kChunk;
  const long long mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long chunks = mine * per_tile;
  auto offset = [&](long long q) {
    return (blockIdx.x + (q / per_tile) * gridDim.x) * vec_per_tile +
           (q % per_tile) * kChunk;
  };
  float4* sa = buf;
  float4* sb = buf + kStages * kChunk;
  float4* sc = buf + 2 * kStages * kChunk;
  float4* so = buf + 3 * kStages * kChunk;
  auto issue = [&](long long q) {
    const int s = static_cast<int>(q % ring);
    const long long off = offset(q);
    if (copy) {
      expect_bytes(&full[s], kBytes);
      bulk_load(buf + s * kChunk, b + off, kBytes, &full[s]);
    } else {
      expect_bytes(&full[s], 3 * kBytes);
      bulk_load(sa + s * kChunk, a + off, kBytes, &full[s]);
      bulk_load(sb + s * kChunk, b + off, kBytes, &full[s]);
      bulk_load(sc + s * kChunk, c + off, kBytes, &full[s]);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBufs; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&full[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (long long q = 0; q < chunks && q < ring; ++q) issue(q);
  }
  if (copy) {
    if (threadIdx.x == 0) {
      for (long long q = 0; q < chunks; ++q) {
        const int s = static_cast<int>(q % ring);
        mbar_wait(&full[s], static_cast<uint32_t>((q / ring) & 1));
        bulk_store(out + offset(q), buf + s * kChunk, kBytes);
        if (q >= 1) {
          bulk_wait_read<1>();  // the store of chunk q - 1 has left its stage
          if (q - 1 + ring < chunks) issue(q - 1 + ring);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    return;
  }
  for (long long q = 0; q < chunks; ++q) {
    const int s = static_cast<int>(q % kStages);
    // the store of chunk q - kStages has read so[s]
    if (threadIdx.x == 0) bulk_wait_read<kStages - 1>();
    __syncthreads();
    mbar_wait(&full[s], static_cast<uint32_t>((q / kStages) & 1));
    for (int i = threadIdx.x; i < kChunk; i += kTmaThreads) {
      const float4 x = sa[s * kChunk + i];
      const float4 y = sb[s * kChunk + i];
      float4 z = sc[s * kChunk + i];
      for (int k = 0; k < loopsize; ++k) step(z, x, y);
      so[s * kChunk + i] = z;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(out + offset(q), so + s * kChunk, kBytes);
      if (q + kStages < chunks) issue(q + kStages);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One wave of `kernel`: the SMs times the blocks of `threads` threads and
// `smem` bytes of dynamic shared memory an SM holds.
template <typename Kernel>
long long wave(Kernel kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return static_cast<long long>(sms) * per_sm;
}

struct Args {
  const float4 *a, *b, *c;
  float4* out;
  long long tiles, vpt;
  int loopsize;
  cudaStream_t s;
};

template <typename Kernel>
long long grid_of(Kernel kernel, int threads, long long tiles,
                  bool persistent) {
  if (!persistent) return tiles;
  const long long w = wave(kernel, threads, 0);
  return w < tiles ? w : tiles;
}

template <int Threads, int Depth, int L, int S>
int launch_reg(const Args& g, bool persistent) {
  if (g.loopsize == 0) {
    auto kernel = reg_copy_kernel<Threads, Depth, L, S>;
    const long long grid = grid_of(kernel, Threads, g.tiles, persistent);
    if (grid <= 0) return static_cast<int>(cudaGetLastError());
    kernel<<<static_cast<unsigned>(grid), Threads, 0, g.s>>>(g.b, g.out,
                                                            g.tiles, g.vpt);
  } else {
    auto kernel = reg_kernel<Threads, Depth, L, S>;
    const long long grid = grid_of(kernel, Threads, g.tiles, persistent);
    if (grid <= 0) return static_cast<int>(cudaGetLastError());
    kernel<<<static_cast<unsigned>(grid), Threads, 0, g.s>>>(
        g.a, g.b, g.c, g.out, g.tiles, g.vpt, g.loopsize);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kStages, int kChunk>
int launch_tma(const Args& g) {
  if (g.vpt % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tma_kernel<kStages, kChunk>;
  const int smem = 4 * kStages * kChunk * static_cast<int>(sizeof(float4)) +
                   4 * kStages * static_cast<int>(sizeof(uint64_t));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = wave(kernel, kTmaThreads, smem);
  if (grid <= 0) return static_cast<int>(cudaGetLastError());
  if (grid > g.tiles) grid = g.tiles;
  kernel<<<static_cast<unsigned>(grid), kTmaThreads, smem, g.s>>>(
      g.a, g.b, g.c, g.out, g.tiles, g.vpt, g.loopsize);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Args&);

template <int T, int D, int L, int S, bool P>
int reg(const Args& g) {
  return launch_reg<T, D, L, S>(g, P);
}

template <int St, int Ch>
int tma(const Args& g) {
  return launch_tma<St, Ch>(g);
}

// The designs vai_check.py times, by number (its DESIGNS names them).
constexpr Launcher kDesigns[] = {
    reg<256, 1, kNc, kWb, false>,   // 0  the PR 11 kernel's shape
    reg<256, 2, kNc, kWb, false>,   // 1
    reg<512, 2, kNc, kWb, false>,   // 2  the kernel's operations end
    reg<512, 4, kNc, kWb, false>,   // 3
    reg<1024, 1, kNc, kWb, false>,  // 4
    reg<1024, 2, kNc, kWb, false>,  // 5
    reg<1024, 4, kNc, kWb, false>,  // 6  the kernel's bytes end and copy
    reg<1024, 8, kNc, kWb, false>,  // 7  (copy only: the FMAs spill)
    reg<1024, 16, kNc, kWb, false>, // 8  (copy only)
    reg<128, 2, kNc, kWb, false>,   // 9  the shape of PyTorch's own loop
    reg<256, 1, kCs, kSc, false>,   // 10 streaming hints
    reg<256, 4, kNc, kWb, true>,    // 11 one wave walking the tiles
    tma<3, 1024>,                   // 12 192 KB, 1 block an SM
    tma<3, 512>,                    // 13  96 KB, 2 blocks an SM
};

}  // namespace

// Arguments as repro_vai_f32, after the design's number.
extern "C" int vai_stream(int design, const void* a, const void* b,
                          const void* c, void* out, long long rows,
                          long long block_rows, int loopsize, void* stream) {
  const long long tiles = block_rows > 0 ? rows / block_rows : 0;
  if (tiles <= 0 || tiles * block_rows != rows || loopsize < 0 ||
      design < 0 || design >= static_cast<int>(sizeof(kDesigns) /
                                               sizeof(kDesigns[0]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args g{static_cast<const float4*>(a), static_cast<const float4*>(b),
               static_cast<const float4*>(c), static_cast<float4*>(out),
               tiles, block_rows * kVecPerRow, loopsize,
               static_cast<cudaStream_t>(stream)};
  return kDesigns[design](g);
}
