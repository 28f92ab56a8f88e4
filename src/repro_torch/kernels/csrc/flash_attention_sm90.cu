// Flash attention, forward, bf16 — tensor cores (wgmma) fed by TMA copies,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, functions `_flash_kernel` /
// `flash_attention`, for bf16 inputs. f32 inputs go to the 3xTF32
// tensor-core kernel (mma.sync) of flash_attention.cu, whose C entry point
// `repro_flash_attention` sends bf16 calls to `repro_flash_attention_sm90`
// below.
//
// What it computes, per (batch, q head) and query row, as the reference, for
// q and k of head dim D and v and out of head dim DV:
//   s = (q . k^T) * scale     (bf16 products, f32 sums, on the tensor cores)
//   s = -1e30 where causal and kpos > qpos  (top-left aligned)
//   online softmax with m, l and acc in f32; acc is rescaled by
//   exp(m_prev - m_new) at every kv tile, acc += bf16(p) . v, l += sum(p)
//   out = acc / max(l, 1e-30), stored as bf16
// l sums the f32 p; p is rounded to bf16 only as the operand of p . v, which
// is the reference's `p.astype(v.dtype)`. GQA: the kv head of q head h is
// h / (Hq / Hkv); K and V are indexed, never repeated.
//
// Design. One thread block owns one (batch, q head, q tile of BQ rows) and
// walks the kv tiles. It has BQ / 64 consumer warpgroups, each owning 64
// query rows (wgmma's M), and one producer warpgroup, one thread of which
// issues every copy:
//   - TMA loads the Q tile once, and the K and V tiles into a ring of three
//     stages (two where three do not fit: D = 160 at 128 x 128, and D =
//     192, DV = 128 at 128-row kv tiles; at D = DV = 256 only 64 x 64 is
//     built, see kBuilt). Each stage
//     has a "full" mbarrier (the producer posts the bytes it expects; the
//     TMA unit completes them) and an "empty" one (every consumer thread
//     arrives once its products on the stage are done), so the next tiles
//     load while the consumers compute;
//   - S = Q K^T is one wgmma per 16 columns of D, both operands in shared
//     memory, K-major; the first of them writes S without reading it, so
//     the previous tile's S holds no registers while P V runs. O += P V
//     takes P from registers: the f32 accumulator fragment of S,
//     exponentiated in place, is the A fragment of P V (two f32 values to one
//     bf16x2 register), with no trip through shared memory. V [BK, DV] is an
//     MN-major B operand, through wgmma's transpose bit; its width DV is
//     the N of P V, so the registers of a consumer (S and O) depend on BK
//     and DV alone, and D = 192 only lengthens Q K^T to 12 steps. At DV =
//     256 (m64n256k16, N at wgmma's largest) O alone is 128 f32 registers a
//     thread, twice DV = 128's, and Q K^T runs 16 steps;
//   - the softmax stays in registers: a thread holds two rows of S, the four
//     threads of a row take its max with __shfl_xor_sync, exp2f has
//     scale * log2(e) folded in, and each thread keeps its share of l, summed
//     over the four at the end;
//   - setmaxnreg moves registers from the producer warpgroup to the two
//     consumer warpgroups of a 128-row tile: the launch bound of 384 threads
//     gives every thread 168, the producer keeps 40 and the consumers take
//     232 (a 64-row tile, 256 threads, has 255 without it: at DV = 256,
//     built at 64 x 64 only, a consumer holds O (128), S (32) and P (16) in
//     them);
//   - the grid runs the heads fastest and the q tiles from the last to the
//     first, so the blocks with the most causal work start first and the
//     short ones fill the tail.
// TMA writes a tile in boxes one swizzle span wide: the 128-byte swizzle (64
// bf16 columns a box) when the tile's head dim is a multiple of 64, else
// the 64-byte one (32 columns; D = 160 is five boxes, as CUTLASS picks for
// such widths), and the wgmma descriptors name the same swizzle. Q and K
// follow D's swizzle, V DV's (D = 192 is three 128-byte boxes, DV = 128
// two, D = DV = 256 four). The tensor maps are 4-D (D, H, S,
// B) with the caller's strides, so a box that runs past the end of a
// sequence is zero-filled rather than read from the next batch row. Those kv
// columns get the weight -inf explicitly (a zero K row would score 0, not
// -inf); query rows past Sq are not stored.
//
// Masks: the kv tiles wholly above the q tile's diagonal are not loaded
// (exact, as in flash_attention.cu); a consumer skips the tiles wholly above
// its own 64 rows and applies the causal mask only to the tiles that cross
// its diagonal.
//
// What bounds it on this card: operations. At the served prefill shape (q
// [1, 1024, 40, 128], k/v [1, 1024, 8, 128], causal) the flops need 0.0109 ms
// at the bf16 tensor peak and the bytes 0.0038 ms at the HBM rate. At MLA's
// prefill (q/k [1, 1024, 128, 192], v [1, 1024, 128, 128]: 128 kv heads)
// bytes bound it, 0.050 ms against 0.043 ms of flops. At RecurrentGemma's
// local-attention prefill (q [1, 1024, 10, 256], k/v [1, 1024, 1, 256]) the
// flops need 0.0054 ms and the bytes 0.0034 ms, but its grid is 10 heads x
// 8 q tiles = 80 blocks on 132 SMs. A consumer warpgroup
// runs its two products and its softmax one after the other; the two
// consumers of a block overlap each other's softmax with their products,
// and the producer overlaps the copies with both.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;         // threads in a warpgroup
constexpr int kRowsPerWG = 64;   // wgmma's M: query rows of a consumer
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most a block can have

// The swizzle of a head dim: TMA box width and the wgmma layout type.
template <int D>
struct Swizzle {
  static constexpr int kBytes = D % 64 == 0 ? 128 : 64;  // one box row
  static constexpr int kCols = kBytes / 2;               // bf16 in a box row
  static constexpr int kBoxes = D / kCols;
  static constexpr uint64_t kLayout = kBytes == 128 ? 1 : 2;  // B128 / B64
  static_assert(D % kCols == 0, "head dim must be a multiple of 32");
};

// Shared memory of one block: the Q tile, kStages K and V tiles (each tile
// stored box by box, a box [rows, kCols] swizzled), 2 kStages + 1 mbarriers,
// and the slack that aligns the tiles to 1024 bytes (the swizzle repeats
// there). The ring has three stages where they fit in 227 KB, else two (D =
// 160 at 128 x 128; D = 192, DV = 128 at BK = 128).
// kernels/flash_attention.py:smem_bytes repeats this formula for bf16.
template <int D, int DV, int BQ, int BK>
struct SmemSm90 {
  static constexpr size_t kQ = 2ull * BQ * D;
  static constexpr size_t kK = 2ull * BK * D;
  static constexpr size_t kV = 2ull * BK * DV;
  static constexpr size_t kAlign = 1024;
  static constexpr size_t bytes(int stages) {
    return kQ + stages * (kK + kV) + 8 * (2 * stages + 1) + kAlign;
  }
  static constexpr int kStages = bytes(3) <= kSmemLimit ? 3 : 2;
  static constexpr size_t kBytes = bytes(kStages);
};

struct Params {
  int hq, hkv, sq, skv;
  long long o_sb, o_ss, o_sh;  // output strides (elements)
  float scale_log2;            // scale * log2(e)
  int causal;
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that outlasts kSpinLimit polls (seconds; a tile takes microseconds)
// means an arrival was lost: trap, so the launch fails instead of hanging.
constexpr uint32_t kSpinLimit = 1u << 26;

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
    if (spins == kSpinLimit) __trap();
  }
}

// One box of a 4-D tensor map, coordinates innermost first, into shared
// memory; the bytes it lands count against the barrier's expected bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N commit groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (Swizzle<D>::kLayout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x N, f32) = A(64 x 16) . B(16 x N): A and B from shared memory, both
// K-major. A thread's accumulator registers d[4i + 2j + c] hold row
// 16 * warp + lane / 4 + 8 j, column 8 i + 2 (lane % 4) + c. The outputs are
// write-only, so the registers of the previous tile's S are free while it
// is not issued.
template <int N>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[N / 2], uint64_t da,
                                               uint64_t db);

// D(64 x N, f32) += A(64 x 16) . B(16 x N), as wgmma_ss_first.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

// D(64 x N, f32) += A(64 x 16, bf16 registers) . B(16 x N): B from shared
// memory, MN-major (transposed). A's registers a[r] hold the bf16 pairs of
// row 16 * warp + lane / 4 + 8 (r % 2), columns 8 (r / 2) + 2 (lane % 4) +
// {0, 1}: the layout of the accumulator above, two columns a register.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss_first<64>(float (&d)[32],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss_first<128>(float (&d)[64],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------------ kernel
// S = Q K^T for the K tile at k_base: one wgmma per 16 columns of D, in one
// commit group. K-major operands: 8-row groups are 8 box rows apart; the 16
// columns of step kk lie in box kk * 16 / kCols, at byte (kk * 16 % kCols) * 2
// of a row.
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_base,
                                        uint32_t k_base) {
  using Sw = Swizzle<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / Sw::kCols;
    const uint32_t off = (kk * 16 % Sw::kCols) * 2;
    const uint64_t da =
        make_desc<D>(q_base + box * BQ * Sw::kBytes + off, 16, 8 * Sw::kBytes);
    const uint64_t db =
        make_desc<D>(k_base + box * BK * Sw::kBytes + off, 16, 8 * Sw::kBytes);
    if (kk == 0) {
      wgmma_ss_first<BK>(s, da, db);
    } else {
      wgmma_ss<BK>(s, da, db);
    }
  }
  wgmma_commit();
}

// O += P V for the V tile at v_base, in one commit group. V is MN-major:
// its boxes of DV columns are BK rows apart (the leading offset), its 8-row
// groups of kv rows 8 box rows apart (the stride offset).
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                        const uint32_t (&a)[BK / 16][4],
                                        uint32_t v_base) {
  using Sw = Swizzle<DV>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<DV>(acc, a[kk],
                 make_desc<DV>(v_base + kk * 16 * Sw::kBytes, BK * Sw::kBytes,
                               8 * Sw::kBytes));
  }
  wgmma_commit();
}

// One tile's online softmax, in place: s holds the scores of kv columns
// k0 .. k0 + BK - 1 for this thread's rows r0 and r0 + 8 and leaves p =
// exp(s * scale - m_new) in f32; m and l (this thread's share) are updated,
// and corr = exp(m_prev - m_new) is returned for the accumulator.
template <int BK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        const Params& p, int k0, int r0,
                                        int col, bool mask_causal) {
  const bool mask_kv = k0 + BK > p.skv;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * i + 2 * j + c] * p.scale_log2;
        const int kpos = k0 + 8 * i + col + c;
        if (mask_kv && kpos >= p.skv) {
          x = -INFINITY;  // past the sequence: no weight
        } else if (mask_causal && kpos > r0 + 8 * j) {
          x = kNegInf;
        }
        s[4 * i + 2 * j + c] = x;
        mx[j] = fmaxf(mx[j], x);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j]);
    corr[j] = exp2f(m[j] - m_new);
    m[j] = m_new;
    l[j] *= corr[j];
  }
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = exp2f(s[4 * i + 2 * j + c] - m[j]);
        s[4 * i + 2 * j + c] = e;
        l[j] += e;
      }
    }
  }
}

// P as the A fragments of P V: the S fragment of columns 16 kk .. 16 kk + 15
// is the A fragment of step kk, rounded to bf16.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
  }
}

template <int DV>
__device__ __forceinline__ void rescale(float (&acc)[DV / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[4 * i + 2 * j] *= corr[j];
      acc[4 * i + 2 * j + 1] *= corr[j];
    }
  }
}

// The kv tiles a consumer warpgroup computes: tiles 0 .. n - 1, those not
// wholly above its diagonal (tile 0 alone for a warpgroup whose rows all lie
// past Sq: it computes it on zero rows and stores nothing).
template <int BK>
__device__ __forceinline__ int active_tiles(const Params& p, int row_lo,
                                           int n_tiles) {
  if (row_lo >= p.sq) return 1;
  const int row_hi = min(row_lo + kRowsPerWG, p.sq) - 1;
  return p.causal ? min(n_tiles, row_hi / BK + 1) : n_tiles;
}

// A consumer warpgroup: 64 query rows from row_lo on. Per active kv tile:
// Q K^T, the softmax, P V, one after the other; the tiles above its diagonal
// are released unread.
template <int D, int DV, int BQ, int BK, int kStages>
__device__ __forceinline__ void consume(uint32_t q_base, const bf16* sK,
                                        const bf16* sV, uint64_t* full,
                                        uint64_t* empty, uint64_t* q_full,
                                        bf16* __restrict__ o, const Params& p,
                                        int row_lo, int h, int b,
                                        int n_tiles) {
  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = row_lo + warp * 16 + lane / 4;  // this thread's rows r0, r0+8
  const int col = 2 * (lane % 4);  // its first column in each group of 8
  const int n_act = active_tiles<BK>(p, row_lo, n_tiles);

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
  float s[BK / 2];
  uint32_t a[BK / 16][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float corr[2];

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_act; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    wgmma_fence();
    issue_qk<D, BQ, BK>(s, q_base, smem_u32(sK + st * BK * D));
    wgmma_wait<0>();
    fence_operands(s);
    softmax<BK>(s, m, l, corr, p, t * BK, r0, col,
                p.causal && (t + 1) * BK - 1 > row_lo);
    rescale<DV>(acc, corr);
    pack_p<BK>(s, a);
    fence_operands(a);
    fence_operands(acc);
    wgmma_fence();
    issue_pv<DV, BK>(acc, a, smem_u32(sV + st * BK * DV));
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty[st]);
  }
  for (int t = n_act; t < n_tiles; ++t) {  // tiles above the diagonal
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    mbar_arrive(&empty[t % kStages]);
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    const int row = r0 + 8 * j;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[j], 1e-30f);
    bf16* orow = o + b * p.o_sb + static_cast<long long>(row) * p.o_ss +
                 h * p.o_sh;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + col) =
          __floats2bfloat162_rn(acc[4 * i + 2 * j] / den,
                                acc[4 * i + 2 * j + 1] / den);
    }
  }
}

// One block: BQ / 64 consumer warpgroups, then the producer warpgroup.
template <int D, int DV, int BQ, int BK>
__global__ void __launch_bounds__((BQ / kRowsPerWG + 1) * kWG, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ o, const Params p) {
  constexpr int kConsumers = BQ / kRowsPerWG;
  using Sw = Swizzle<D>;    // Q and K
  using SwV = Swizzle<DV>;  // V
  using Sm = SmemSm90<D, DV, BQ, BK>;
  constexpr int kStages = Sm::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + ((Sm::kAlign - (raw & (Sm::kAlign - 1))) & (Sm::kAlign - 1));
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + Sm::kQ);
  bf16* sV = reinterpret_cast<bf16*>(smem + Sm::kQ + kStages * Sm::kK);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + Sm::kQ + kStages * (Sm::kK + Sm::kV));
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  // heads vary fastest over the grid, q tiles from the last (the most
  // causal work) to the first: the blocks with the most work start first
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * kWG);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread copies
    if constexpr (kConsumers > 1) setmaxnreg_dec<40>();
    if (threadIdx.x % kWG == 0) {
      const int hk = h / (p.hq / p.hkv);
      mbar_expect_tx(q_full, static_cast<uint32_t>(Sm::kQ));
      for (int c = 0; c < Sw::kBoxes; ++c) {
        tma_load(sQ + c * BQ * Sw::kCols, &tq, q_full, c * Sw::kCols, h, q0,
                 b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[st], static_cast<uint32_t>(Sm::kK + Sm::kV));
        for (int c = 0; c < Sw::kBoxes; ++c) {
          tma_load(sK + st * BK * D + c * BK * Sw::kCols, &tk, &full[st],
                   c * Sw::kCols, hk, t * BK, b);
        }
        for (int c = 0; c < SwV::kBoxes; ++c) {
          tma_load(sV + st * BK * DV + c * BK * SwV::kCols, &tv, &full[st],
                   c * SwV::kCols, hk, t * BK, b);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    // the producer's registers, handed over: 128 x (168 - 40) = 2 x 128 x
    // (232 - 168)
    if constexpr (kConsumers > 1) setmaxnreg_inc<232>();
    consume<D, DV, BQ, BK, kStages>(
        smem_u32(sQ) + wg * kRowsPerWG * Sw::kBytes, sK, sV, full, empty,
        q_full, o, p, q0 + wg * kRowsPerWG, h, b, n_tiles);
  }
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library links no libcuda of its own).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 4-D map (D, H, S, B) over a [B, S, H, D] bf16 tensor with the given
// strides (elements), box [rows, kCols] of one head.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int heads, int seq,
              int batch, long long s_b, long long s_s, long long s_h,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Swizzle<D>::kCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = Swizzle<D>::kBytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Call {
  const void *q, *k, *v;
  void* o;
  int batch;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  Params p;
};

template <int D, int DV, int BQ, int BK>
int launch(const Call& c, cudaStream_t stream) {
  constexpr size_t smem = SmemSm90<D, DV, BQ, BK>::kBytes;
  static_assert(smem <= kSmemLimit, "tile does not fit in shared memory");
  CUtensorMap tq, tk, tv;
  const Params& p = c.p;
  if (!make_map<D>(&tq, c.q, p.hq, p.sq, c.batch, c.q_sb, c.q_ss, c.q_sh,
                   BQ) ||
      !make_map<D>(&tk, c.k, p.hkv, p.skv, c.batch, c.k_sb, c.k_ss, c.k_sh,
                   BK) ||
      !make_map<DV>(&tv, c.v, p.hkv, p.skv, c.batch, c.v_sb, c.v_ss, c.v_sh,
                    BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_kernel<D, DV, BQ, BK>;
  static bool configured = false;  // the attribute outlives the launch
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(p.hq, (p.sq + BQ - 1) / BQ, c.batch);
  const int threads = (BQ / kRowsPerWG + 1) * kWG;
  kernel<<<grid, threads, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(c.o),
                                          p);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of head dims (D, DV) that are instantiated: those that fit in
// a block's shared memory with at least two stages (D = DV = 256 at 128-row
// kv tiles does not), less D = DV = 256 at 128 x 64, which fits but spills
// 216 bytes of registers (a 384-thread block leaves a thread 168 at compile
// time) and ran 2.2x slower than 64 x 64. The wrapper refuses the others
// first (unsupported() in kernels/flash_attention.py).
template <int D, int DV, int BQ, int BK>
constexpr bool kBuilt = SmemSm90<D, DV, BQ, BK>::bytes(2) <= kSmemLimit &&
                        !(D == 256 && DV == 256 && BQ == 128);

template <int D, int DV>
int by_tile(int block_q, int block_k, const Call& c, cudaStream_t s) {
#define REPRO_FLASH_SM90_TILE(BQ, BK)                          \
  if constexpr (kBuilt<D, DV, BQ, BK>) {                       \
    if (block_q == BQ && block_k == BK) {                      \
      return launch<D, DV, BQ, BK>(c, s);                      \
    }                                                          \
  }
  REPRO_FLASH_SM90_TILE(64, 64)
  REPRO_FLASH_SM90_TILE(64, 128)
  REPRO_FLASH_SM90_TILE(128, 64)
  REPRO_FLASH_SM90_TILE(128, 128)
#undef REPRO_FLASH_SM90_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The bf16 path of repro_flash_attention (flash_attention.cu), same
// arguments. Every base pointer is 16-byte aligned and every stride of a
// dim longer than 1 is a multiple of 8 elements (TMA's rule; the wrapper
// checks it). Tiles (block_q, block_k) in {64, 128} x {64, 128}, head dims
// (d, dv) in (64, 64), (128, 128), (160, 160), (192, 128) (MLA prefill:
// qk_nope + qk_rope = 192, v_head_dim = 128) and (256, 256)
// (RecurrentGemma's local attention; 64 x 64 only).
int repro_flash_attention_sm90(const void* q, const void* k, const void* v,
                               void* o, int batch, int hq, int hkv, int sq,
                               int skv, int d, int dv, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, long long o_sb,
                               long long o_ss, long long o_sh, int causal,
                               float scale, int block_q, int block_k,
                               cudaStream_t stream) {
  const Call c{q,    k,    v,    o,    batch, q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb,  v_ss, v_sh,
               Params{hq, hkv, sq, skv, o_sb, o_ss, o_sh, scale * kLog2e,
                      causal != 0}};
  if (d == 64 && dv == 64) return by_tile<64, 64>(block_q, block_k, c, stream);
  if (d == 128 && dv == 128) {
    return by_tile<128, 128>(block_q, block_k, c, stream);
  }
  if (d == 160 && dv == 160) {
    return by_tile<160, 160>(block_q, block_k, c, stream);
  }
  if (d == 192 && dv == 128) {
    return by_tile<192, 128>(block_q, block_k, c, stream);
  }
  if (d == 256 && dv == 256) {
    return by_tile<256, 256>(block_q, block_k, c, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
