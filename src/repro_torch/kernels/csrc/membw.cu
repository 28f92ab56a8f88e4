// Memory-subsystem bandwidth probe (paper §III-B-b, Fig. 6) for Hopper.
//
// Replaces: src/repro/kernels/membw.py, functions `_membw_kernel` / `membw`
// (the Pallas kernel of the reference package).
//
// What it computes: x is [n_chunks * chunk_rows, 128] float32; output row i
// of n_iters is the column sum (over rows) of chunk i % n_chunks.
//
// What bounds it on this card: bytes. Every iteration reads one whole chunk
// and does one add per float. A working set (n_chunks * chunk bytes) under
// the 50 MB L2 is re-read from the L2 after the first pass, a larger one is
// re-streamed from HBM every time: that boundary is what the probe exists to
// show, so the loads are plain cached loads with no streaming or no-allocate
// hints.
//
// Design. Blocks run in no order and a chunk can be a gigabyte, so nothing
// of the reference's "one sequential grid step holds the whole chunk" is
// kept. One block takes one (iteration, slice of the chunk's rows); blocks
// are numbered iteration by iteration, and the wrapper keeps slices short
// (at most 256 rows), so a large chunk's iterations follow each other
// instead of running side by side and sharing each row in the L2. Its 256
// threads are 8 row lanes x 32 column groups: a thread owns one float4 of
// columns and strides over its slice's rows eight at a time, so a warp reads
// one contiguous 512-byte row per step. The 8 row lanes are then added in
// index order through shared memory, and the block's partial row goes to a
// scratch tensor [n_iters, n_slices, 128] that the wrapper allocates. A
// second small kernel adds the n_slices partial rows of each iteration in
// index order. No atomics anywhere: the order of every sum is fixed by the
// shapes alone, so two runs give the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerRow = 32;                    // 128 floats = 32 float4
constexpr int kRowLanes = kThreads / kVecPerRow;  // 8

__global__ void __launch_bounds__(kThreads)
membw_partial_kernel(const float4* __restrict__ x, float4* __restrict__ partial,
                     long long chunk_rows, long long n_chunks,
                     long long rows_per_slice, long long n_slices) {
  const long long blk = blockIdx.x;
  const long long iter = blk / n_slices;
  const long long slice = blk - iter * n_slices;
  const long long chunk = iter % n_chunks;
  const long long r0 = slice * rows_per_slice;
  const long long r1 = min(r0 + rows_per_slice, chunk_rows);
  const int cg = threadIdx.x % kVecPerRow;
  const int lane = threadIdx.x / kVecPerRow;

  const float4* base = x + chunk * chunk_rows * kVecPerRow + cg;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (long long r = r0 + lane; r < r1; r += kRowLanes) {
    const float4 v = base[r * kVecPerRow];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }

  __shared__ float4 lanes[kRowLanes][kVecPerRow];
  lanes[lane][cg] = acc;
  __syncthreads();
  if (lane == 0) {
    float4 s = lanes[0][cg];
#pragma unroll
    for (int l = 1; l < kRowLanes; ++l) {
      const float4 v = lanes[l][cg];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    partial[blk * kVecPerRow + cg] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
membw_combine_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     long long n_iters, long long n_slices) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_iters * 128) return;
  const long long iter = idx / 128;
  const long long col = idx - iter * 128;
  const float* p = partial + iter * n_slices * 128 + col;
  float s = p[0];
  for (long long k = 1; k < n_slices; ++k) s += p[k * 128];
  out[idx] = s;
}

}  // namespace

// x: [n_chunks * chunk_rows, 128] float32; partial: scratch of
// n_iters * n_slices * 128 floats; out: [n_iters, 128] float32. All
// contiguous, 16-byte aligned, on the current device.
// n_slices * rows_per_slice >= chunk_rows. Launches both kernels on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int repro_membw_f32(const void* x, void* partial, void* out,
                               long long chunk_rows, long long n_chunks,
                               long long n_iters, long long rows_per_slice,
                               long long n_slices, void* stream) {
  const long long blocks = n_iters * n_slices;
  const long long out_blocks = (n_iters * 128 + kThreads - 1) / kThreads;
  if (chunk_rows <= 0 || n_chunks <= 0 || n_iters <= 0 ||
      rows_per_slice <= 0 || n_slices <= 0 ||
      n_slices * rows_per_slice < chunk_rows || blocks > 2147483647LL ||
      out_blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  membw_partial_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float4*>(x), static_cast<float4*>(partial), chunk_rows,
      n_chunks, rows_per_slice, n_slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  membw_combine_kernel<<<static_cast<unsigned>(out_blocks), kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_iters,
      n_slices);
  return static_cast<int>(cudaGetLastError());
}
