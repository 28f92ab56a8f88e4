// Flash attention, forward, bf16 and f16 — tensor cores (wgmma) fed by TMA
// copies, for Hopper (sm_90a): the kernel, included by the files that
// instantiate it: flash_attention_sm90.cu (the 2-byte entry point and bf16
// at the narrow head-dim classes), flash_attention_sm90_wide.cu (bf16 at
// the wide ones), flash_attention_sm90_f16.cu and
// flash_attention_sm90_f16_wide.cu (f16), flash_attention_sm90_chunked.cu
// (head dims above 256, both types); nvcc builds them in parallel.
//
// Replaces: src/repro/kernels/flash_attention.py, functions `_flash_kernel` /
// `flash_attention`, for bf16 and f16 inputs. f32 inputs go to the 3xTF32
// tensor-core kernel (mma.sync) of flash_attention_f32.cuh, whose C entry
// point `repro_flash_attention` (flash_attention.cu) sends 2-byte calls to
// `repro_flash_attention_sm90` (flash_attention_sm90.cu).
//
// The element type E (ElemBf16, ElemF16) is a template parameter: its
// storage type, its TMA data type, the rounding of f32 values to it (one by
// one, or two to a register), and the PTX type name of every wgmma
// (REPRO_SM90_WGMMA). Nothing else differs: both are 2-byte types with the
// same tiles, swizzles and shared memory, and the tensor cores run both at
// one rate.
//
// What it computes, per (batch, q head) and query row, as the reference, for
// q and k of head dim D and v and out of head dim DV:
//   s = (q . k^T) * scale     (E products, f32 sums, on the tensor cores)
//   s = -1e30 where causal and kpos > qpos  (top-left aligned)
//   online softmax with m, l and acc in f32; acc is rescaled by
//   exp(m_prev - m_new) at every kv tile, acc += E(p) . v, l += sum(p)
//   out = acc / max(l, 1e-30), stored as E
// l sums the f32 p; p is rounded to E only as the operand of p . v, which
// is the reference's `p.astype(v.dtype)`. GQA: the kv head of q head h is
// h / (Hq / Hkv); K and V are indexed, never repeated.
//
// Head dims. The reference takes any D and DV; so does this kernel: every
// 1 <= D, DV <= 256 through a few head-dim classes, the template's D and
// DV: (32, 32), (64, 64), (96, 96), (128, 128), (160, 160), (192, 192),
// (256, 256) and (192, 128) (flash_attention.cu:head_dim_class picks the
// least class of each width, and the square class of the larger one where
// that pair is not built). The tensor maps carry the true widths as their
// extents and the class's boxes, and TMA fills a box's columns past the
// extent with zeros: the padded q and k columns add exact zeros to q . k^T,
// the padded v columns give O columns that are never stored, and the
// epilogue stores the first DV columns of the true width only (in bf16
// pairs where DV is its class's, else one by one). The caller's scale is
// that of the true D. Q K^T takes one wgmma per 16 columns of the class, so
// a class only sets its step count; P V's N is DV's class, one wgmma_rs<N>
// for each: 32, 96 and 192 join the built 64, 128, 160 and 256 (widths that
// are multiples of 32 keep the 64- or 128-byte swizzle). A width pays for
// its padded columns: above 32 at most 1.94x (D = 33), above 64 at most
// 1.48x (D = 65). Wider pairs run on the chunked kernel, below.
//
// The chunked kernel (a head dim above 256; flash_fwd_sm90_chunked_kernel,
// kernels/flash_attention.py:wide_split). wgmma's N is at most 256 and a
// consumer's O is 64 x DV f32 (DV / 2 registers a thread), so neither D nor
// DV can be one tile. One block owns a q tile of 64 rows and every column
// of v up to 512 (wider v is cut into slices of at most 512 on the grid's
// x axis, and only there is S computed again): S = Q K^T is computed once a
// kv tile, summed over chunks of kChunk = 128 columns of Q and K, by
// warpgroup 0; P is written once to shared memory in E (wgmma's 128-byte
// swizzle), and each of the two warpgroups adds P V for half of the
// columns, reading P as its A operand: 128 registers of O a thread at 512
// columns, the split FlashMLA makes at DeepSeek-V3's absorbed (576, 512).
// Q is loaded once and held in shared memory for the whole kv walk where
// it fits beside two K stages and the V tile (up to D = 896 at a slice of
// 512, 1152 at 256, 1280 at 128: SmemChunked); wider, each chunk of Q
// streams through the K ring beside its chunk of K, once a kv tile. A
// chunk's products are one commit group, waited for once the next chunk is
// issued, and its stage is refilled as soon as they are done; warpgroup 0's
// P V stays in flight under the next tile's Q K^T, and warpgroup 1's runs
// under warpgroup 0's Q K^T and softmax. PERF.md §6 has its times.
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
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace repro_flash_sm90 {

// The element types, each with what the kernel needs of it: its storage
// type, the TMA data type, and f32 values rounded to it (to nearest even),
// two to a 32-bit register (the A fragment of P V, and the epilogue's
// paired stores) or one by one. wgmma's PTX type name (bf16 / f16) is
// given to REPRO_SM90_WGMMA below.
struct ElemBf16 {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ T one(float x) {
    return __float2bfloat16_rn(x);
  }
};

struct ElemF16 {
  using T = __half;
  using T2 = __half2;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ T one(float x) {
    return __float2half_rn(x);
  }
};

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

// The chunked kernel (a head dim above 256): its shared memory, from the
// 1024-aligned base: Q held (`chunks` stages, where it fits), a ring of
// `stages` stages for the chunks of K (and of Q, where it is not held), the
// V tiles (one stage for each 128-column piece of the slice; two tiles,
// the next loading under this one, where they fit beside three K stages,
// four where Q streams), P (64 x 64 of E, in wgmma's 128-byte swizzle), the
// rows' rescale factors and sums (64 floats each) and 512 bytes of
// mbarriers. A stage is 64 rows x kChunk columns of E.
// kernels/flash_attention.py:wide_layout states the same layout.
constexpr int kChunk = 128;
constexpr size_t kSlot = 2ull * 64 * kChunk;

// Phase probes of the chunked kernel (tools/flash_chunked_phases.py builds
// the sources with -DREPRO_FLASH_PHASES): each warpgroup times phases of its
// kv walk with clock64, in slots 0-6 of its own (REPRO_PHASE), its whole
// walk in slot 7, and its first thread adds them over every block to
// g_phase_cycles[8 * warpgroup + slot], which repro_flash_phases of
// flash_attention_sm90_chunked.cu reads. Without the macro a probe is its
// statement alone.
constexpr int kPhaseSlots = 8;
#ifdef REPRO_FLASH_PHASES
// 2 * kPhaseSlots, as a literal: nvcc's host-side copy of a __device__
// array is declared outside this namespace
static __device__ unsigned long long g_phase_cycles[16];
static_assert(2 * kPhaseSlots == 16, "g_phase_cycles holds both warpgroups");
#define REPRO_PHASES_START \
  long long phase_[kPhaseSlots] = {}; \
  const long long walk_ = clock64()
#define REPRO_PHASE(slot, ...) \
  do { \
    const long long t_ = clock64(); \
    __VA_ARGS__; \
    phase_[slot] += clock64() - t_; \
  } while (0)
#define REPRO_PHASES_FLUSH(first_thread, wg) \
  do { \
    phase_[kPhaseSlots - 1] = clock64() - walk_; \
    for (int i_ = 0; (first_thread) && i_ < kPhaseSlots; ++i_) { \
      atomicAdd(&g_phase_cycles[(wg) * kPhaseSlots + i_], \
                static_cast<unsigned long long>(phase_[i_])); \
    } \
  } while (0)
#else
#define REPRO_PHASES_START
#define REPRO_PHASE(slot, ...) \
  do { \
    __VA_ARGS__; \
  } while (0)
#define REPRO_PHASES_FLUSH(first_thread, wg)
#endif
constexpr int kWideMaxStages = 8;
constexpr size_t kPBytes = 2ull * 64 * 64;

struct SmemChunked {
  int chunks;      // chunks of kChunk columns of Q and K
  int n_v;         // 128-column pieces of V in a tile (the slice / 128)
  bool q_held;     // Q loaded once and held for the whole kv walk
  int n_vb;        // V tiles in shared memory (1 or 2)
  int stages;      // the K ring
  size_t q_bytes;  // of the held Q (0 where it streams)
  size_t bytes;    // the block's dynamic shared memory
  __host__ __device__ static SmemChunked of(int d, int dvs) {
    SmemChunked m;
    m.chunks = (d + kChunk - 1) / kChunk;
    m.n_v = dvs / kChunk;
    const size_t fixed = 1024 + kPBytes + 2 * 64 * 4 + 512;
    const size_t v = kSlot * m.n_v;
    m.q_held = fixed + v + kSlot * (m.chunks + 2) <= kSmemLimit;
    m.q_bytes = m.q_held ? kSlot * m.chunks : 0;
    m.n_vb = fixed + 2 * v + m.q_bytes + kSlot * (m.q_held ? 3 : 4) <=
                     kSmemLimit
                 ? 2
                 : 1;
    const int fit = static_cast<int>(
        (kSmemLimit - fixed - m.n_vb * v - m.q_bytes) / kSlot);
    m.stages = fit < kWideMaxStages ? fit : kWideMaxStages;
    m.bytes = fixed + m.n_vb * v + m.q_bytes + kSlot * m.stages;
    return m;
  }
};

struct Params {
  int hq, hkv, sq, skv;
  int dv;                      // v's true head dim: the columns stored
  long long o_sb, o_ss, o_sh;  // output strides (elements)
  float scale_log2;            // scale * log2(e)
  int causal;
  int d;                       // q's and k's true head dim
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

// The same three, done by the threads where `pred` holds: predicated, not
// branched, so that a warpgroup issuing wgmma between them takes no
// divergent path (ptxas serializes every wgmma of a function whose
// warpgroup arrives on one).
__device__ __forceinline__ void mbar_expect_tx_if(bool pred, uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_if(bool pred, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void tma_load_if(bool pred, void* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(static_cast<int>(pred))
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

template <int P, int N>
__device__ __forceinline__ void fence_operands(float (&d)[P][N]) {
#pragma unroll
  for (int i = 0; i < P; ++i) fence_operands(d[i]);
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

// Two f32 values rounded to E, packed into one register (lo in the low half)
template <class E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  typename E::T2 v = E::pair(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x N, f32) = A(64 x 16) . B(16 x N): A and B from shared memory, both
// K-major. A thread's accumulator registers d[4i + 2j + c] hold row
// 16 * warp + lane / 4 + 8 j, column 8 i + 2 (lane % 4) + c. The outputs are
// write-only, so the registers of the previous tile's S are free while it
// is not issued.
template <int N, class E>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[N / 2], uint64_t da,
                                               uint64_t db);

// D(64 x N, f32) += A(64 x 16) . B(16 x N), as wgmma_ss_first.
template <int N, class E>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

// D(64 x N, f32) += A(64 x 16) . B(16 x N): A from shared memory, K-major
// (P of the chunked kernel), B from shared memory, MN-major (transposed: a
// V tile), the accumulator as wgmma_ss's.
template <int N, class E>
__device__ __forceinline__ void wgmma_ss_vt(float (&d)[N / 2], uint64_t da,
                                            uint64_t db);

// D(64 x N, f32) += A(64 x 16, bf16 registers) . B(16 x N): B from shared
// memory, MN-major (transposed). A's registers a[r] hold the bf16 pairs of
// row 16 * warp + lane / 4 + 8 (r % 2), columns 8 (r / 2) + 2 (lane % 4) +
// {0, 1}: the layout of the accumulator above, two columns a register.
template <int N, class E>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

// Every wgmma of the kernel, for one element type E whose PTX type name
// is AB ("bf16" or "f16"): the f32 accumulator, A and B of type AB.
#define REPRO_SM90_WGMMA(E, AB) \
template <> \
__device__ __forceinline__ void wgmma_ss_first<64, E>(float (&d)[32], \
                                                    uint64_t da, uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), \
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), \
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), \
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), \
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), \
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]) \
      : "l"(da), "l"(db), "r"(0)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_ss_first<128, E>(float (&d)[64], \
                                                    uint64_t da, uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), \
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), \
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), \
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), \
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), \
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), \
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), \
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), \
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), \
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), \
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), \
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), \
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), \
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]) \
      : "l"(da), "l"(db), "r"(0)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_ss<64, E>(float (&d)[32], uint64_t da, \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_ss<128, E>(float (&d)[64], uint64_t da, \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_ss_vt<64, E>(float (&d)[32], \
                                                 uint64_t da, uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_ss_vt<128, E>(float (&d)[64], \
                                                  uint64_t da, uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<32, E>(float (&d)[16], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<64, E>(float (&d)[32], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<96, E>(float (&d)[48], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<128, E>(float (&d)[64], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<160, E>(float (&d)[80], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
      "%72, %73, %74, %75, %76, %77, %78, %79" \
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<192, E>(float (&d)[96], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83," \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
} \
 \
template <> \
__device__ __forceinline__ void wgmma_rs<256, E>(float (&d)[128], \
                                              const uint32_t (&a)[4], \
                                              uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83," \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107," \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119," \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
}

REPRO_SM90_WGMMA(ElemBf16, "bf16")
REPRO_SM90_WGMMA(ElemF16, "f16")
#undef REPRO_SM90_WGMMA

// ------------------------------------------------------------------ kernel
// S = Q K^T for the K tile at k_base: one wgmma per 16 columns of D, in one
// commit group. K-major operands: 8-row groups are 8 box rows apart; the 16
// columns of step kk lie in box kk * 16 / kCols, at byte (kk * 16 % kCols) * 2
// of a row. The first product writes s without reading it.
template <int D, int BQ, int BK, class E>
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
      wgmma_ss_first<BK, E>(s, da, db);
    } else {
      wgmma_ss<BK, E>(s, da, db);
    }
  }
  wgmma_commit();
}

// O += P V for the V tile at v_base, in one commit group. V is MN-major:
// its boxes of DV columns are BK rows apart (the leading offset), its 8-row
// groups of kv rows 8 box rows apart (the stride offset).
template <int DV, int BK, class E>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                        const uint32_t (&a)[BK / 16][4],
                                        uint32_t v_base) {
  using Sw = Swizzle<DV>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<DV, E>(acc, a[kk],
                    make_desc<DV>(v_base + kk * 16 * Sw::kBytes,
                                  BK * Sw::kBytes, 8 * Sw::kBytes));
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
// is the A fragment of step kk, rounded to E.
template <int BK, class E>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack2<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
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

// The epilogue of a consumer thread: its rows r0 and r0 + 8 of acc / l,
// the first `width` of its DV columns, into o (o points at the block's
// first column of head h, batch b): in pairs where `pairs` (the block's
// columns all stored and every row 4-byte aligned), else one by one (a row
// may start odd).
template <int DV, class E>
__device__ __forceinline__ void store_rows(const float (&acc)[DV / 2],
                                           float (&l)[2],
                                           typename E::T* __restrict__ o,
                                           const Params& p, int r0, int col,
                                           int h, int b, int width,
                                           bool pairs) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    const int row = r0 + 8 * j;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[j], 1e-30f);
    typename E::T* orow = o + b * p.o_sb +
                          static_cast<long long>(row) * p.o_ss + h * p.o_sh;
    if (pairs) {
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        *reinterpret_cast<typename E::T2*>(orow + 8 * i + col) =
            E::pair(acc[4 * i + 2 * j] / den, acc[4 * i + 2 * j + 1] / den);
      }
    } else {
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (8 * i + col + c < width) {
            orow[8 * i + col + c] = E::one(acc[4 * i + 2 * j + c] / den);
          }
        }
      }
    }
  }
}

// A consumer warpgroup: 64 query rows from row_lo on. Per active kv tile:
// Q K^T, the softmax, P V, one after the other; the tiles above its diagonal
// are released unread.
template <int D, int DV, int BQ, int BK, int kStages, class E>
__device__ __forceinline__ void consume(uint32_t q_base, uint32_t k_ring,
                                        uint32_t v_ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* q_full,
                                        typename E::T* __restrict__ o,
                                        const Params& p, int row_lo, int h,
                                        int b, int n_tiles) {
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
    issue_qk<D, BQ, BK, E>(s, q_base, k_ring + st * 2 * BK * D);
    wgmma_wait<0>();
    fence_operands(s);
    softmax<BK>(s, m, l, corr, p, t * BK, r0, col,
                p.causal && (t + 1) * BK - 1 > row_lo);
    rescale<DV>(acc, corr);
    pack_p<BK, E>(s, a);
    fence_operands(a);
    fence_operands(acc);
    wgmma_fence();
    issue_pv<DV, BK, E>(acc, a, v_ring + st * 2 * BK * DV);
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty[st]);
  }
  for (int t = n_act; t < n_tiles; ++t) {  // tiles above the diagonal
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    mbar_arrive(&empty[t % kStages]);
  }
  // v as wide as its class: every column, in pairs
  store_rows<DV, E>(acc, l, o, p, r0, col, h, b, p.dv, p.dv == DV);
}

// One block: BQ / 64 consumer warpgroups, then the producer warpgroup.
template <class E, int D, int DV, int BQ, int BK>
__global__ void __launch_bounds__((BQ / kRowsPerWG + 1) * kWG, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          typename E::T* __restrict__ o, const Params p) {
  constexpr int kConsumers = BQ / kRowsPerWG;
  using Sw = Swizzle<D>;    // Q and K
  using SwV = Swizzle<DV>;  // V
  using Sm = SmemSm90<D, DV, BQ, BK>;
  constexpr int kStages = Sm::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + ((Sm::kAlign - (raw & (Sm::kAlign - 1))) & (Sm::kAlign - 1));
  unsigned char* sQ = smem;
  unsigned char* sK = smem + Sm::kQ;
  unsigned char* sV = smem + Sm::kQ + kStages * Sm::kK;
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
        tma_load(sQ + c * BQ * Sw::kBytes, &tq, q_full, c * Sw::kCols, h, q0,
                 b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[st], static_cast<uint32_t>(Sm::kK + Sm::kV));
        for (int c = 0; c < Sw::kBoxes; ++c) {
          tma_load(sK + st * Sm::kK + c * BK * Sw::kBytes, &tk, &full[st],
                   c * Sw::kCols, hk, t * BK, b);
        }
        for (int c = 0; c < SwV::kBoxes; ++c) {
          tma_load(sV + st * Sm::kV + c * BK * SwV::kBytes, &tv, &full[st],
                   c * SwV::kCols, hk, t * BK, b);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    // the producer's registers, handed over: 128 x (168 - 40) = 2 x 128 x
    // (232 - 168)
    if constexpr (kConsumers > 1) setmaxnreg_inc<232>();
    consume<D, DV, BQ, BK, kStages, E>(
        smem_u32(sQ) + wg * kRowsPerWG * Sw::kBytes, smem_u32(sK),
        smem_u32(sV), full, empty, q_full, o, p, q0 + wg * kRowsPerWG, h, b,
        n_tiles);
  }
}

// The chunked kernel's pieces. Named barriers among the two consumer
// warpgroups (256 threads): P written (kBarPFull), P read by warpgroup 1
// (kBarPFree), the rows' sums written (kBarLFull).
constexpr int kBarPFull = 1;
constexpr int kBarPFree = 2;
constexpr int kBarLFull = 3;
constexpr int kBarKFree = 4;  // warpgroup 0 alone (128 threads)

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (the wgmma that reads P).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// This thread's share of P (rows r and r + 8 of the tile, row r = 16 warp +
// lane / 4) into sP, 64 x 64 of E in the 128-byte swizzle that wgmma's
// K-major A descriptor reads (a row's 16-byte chunk i at chunk i ^ (row %
// 8)); the four threads of a row write its 32 four-byte pairs, eight rows
// a store on 32 different banks.
template <class E>
__device__ __forceinline__ void store_p(const float (&s)[32],
                                        unsigned char* sP, int warp,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = 16 * warp + lane / 4 + 8 * j;
    unsigned char* base = sP + row * 128 + (lane % 4) * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<uint32_t*>(base + ((i ^ (row % 8)) * 16)) =
          pack2<E>(s[4 * i + 2 * j], s[4 * i + 2 * j + 1]);
    }
  }
}

// acc += P V for the columns of this warpgroup's piece: P (64 x 64, sP)
// K-major, the V piece MN-major at v_base (N of 64 or 128 columns, boxes
// of 64 columns 64 x 128 bytes apart), one wgmma a 16-row step of kv.
// The descriptors of each step are the first one's plus the step's byte
// offset / 16 (its address field), so each chunk or piece computes one.
template <int N, class E>
__device__ __forceinline__ void issue_pv_ss(float (&acc)[N / 2],
                                           uint64_t p_desc,
                                           uint32_t v_base) {
  const uint64_t v_desc = make_desc<128>(v_base, 64 * 128, 8 * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss_vt<N, E>(acc, p_desc + kk * 32 / 16,
                      v_desc + kk * 16 * 128 / 16);
  }
}

// S (+)= Q K^T over one chunk of kChunk columns, as issue_qk, in one commit
// group.
template <int BQ, int BK, class E>
__device__ __forceinline__ void issue_qk_chunk(float (&s)[BK / 2],
                                               uint32_t q_base,
                                               uint32_t k_base) {
  using Sw = Swizzle<kChunk>;
  const uint64_t da = make_desc<kChunk>(q_base, 16, 8 * Sw::kBytes);
  const uint64_t db = make_desc<kChunk>(k_base, 16, 8 * Sw::kBytes);
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const int box = kk * 16 / Sw::kCols;
    const int off = (kk * 16 % Sw::kCols) * 2;
    wgmma_ss<BK, E>(s, da + (box * BQ * Sw::kBytes + off) / 16,
                    db + (box * BK * Sw::kBytes + off) / 16);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void rescale_rows(float (&acc)[N / 2], float c0,
                                             float c1) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    acc[4 * i] *= c0;
    acc[4 * i + 1] *= c0;
    acc[4 * i + 2] *= c1;
    acc[4 * i + 3] *= c1;
  }
}

// The epilogue of one piece: this thread's rows r0 and r0 + 8 of acc /
// den, the first `width` of the piece's N columns, into o (the piece's
// first column of head h, batch b): in pairs where `pairs`, else one by one.
template <int N, class E>
__device__ __forceinline__ void store_piece(const float (&acc)[N / 2],
                                            const float (&den)[2],
                                            typename E::T* __restrict__ o,
                                            const Params& p, int r0, int col,
                                            int h, int b, int width,
                                            bool pairs) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r0 + 8 * j;
    if (row >= p.sq || width <= 0) continue;
    typename E::T* orow = o + b * p.o_sb +
                          static_cast<long long>(row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float lo = acc[4 * i + 2 * j] / den[j];
      const float hi = acc[4 * i + 2 * j + 1] / den[j];
      const int c = 8 * i + col;
      if (pairs) {
        *reinterpret_cast<typename E::T2*>(orow + c) = E::pair(lo, hi);
      } else {
        if (c < width) orow[c] = E::one(lo);
        if (c + 1 < width) orow[c + 1] = E::one(hi);
      }
    }
  }
}

// The chunked kernel, for head dims above 256 (kernels/flash_attention.py:
// wide_split): one block owns one (batch, q head, slice of up to DVS = 512
// columns of v, q tile of 64 rows) and has two warpgroups, each of which
// issues its own TMA copies (one thread does): warpgroup 0 Q, and each next
// chunk of K into the stage it has just freed; warpgroup 1 the next V tile
// once both are done with this one. Warpgroup 0 computes S = Q K^T once a
// kv tile (one commit group a chunk of kChunk columns, the group before
// waited for once the next is issued, each chunk's stages freed as soon as
// its products are done), the online softmax, and writes P once to shared
// memory; each warpgroup then adds P V for its half of the slice's columns
// (64 rows x DVS / 2 of O: 128 registers a thread at DVS = 512), both
// reading P as wgmma's A operand from shared memory. Warpgroup 0 leaves
// its P V in flight under the next tile's Q K^T, and warpgroup 1's P V
// runs under warpgroup 0's next Q K^T and softmax. No producer warpgroup:
// a 256-thread block leaves a thread 255 registers, where a third
// warpgroup would leave 168 at compile time (setmaxnreg moves registers
// when the block runs, but ptxas compiled the consumers at 168 and spilled
// 928 bytes at DVS = 512).
template <class E, int DVS, int BQ, int BK>
__global__ void __launch_bounds__(2 * kWG, 1)
    flash_fwd_sm90_chunked_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  typename E::T* __restrict__ o,
                                  const Params p) {
  static_assert(BQ == kRowsPerWG && BK == 64,
                "the chunked kernel's tile is 64 x 64");
  static_assert(DVS == 128 || DVS == 256 || DVS == 512, "slice class");
  constexpr int kDVW = DVS / 2;                 // a warpgroup's columns
  constexpr int kN = kDVW < 128 ? kDVW : 128;   // P V's N
  constexpr int kNP = kDVW / kN;                // its pieces
  constexpr uint32_t kBox = 64 * 128;           // 64 rows x 64 columns of E
  const SmemChunked m = SmemChunked::of(p.d, DVS);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sQ = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* sK = sQ + m.q_bytes;
  unsigned char* sV = sK + kSlot * m.stages;
  unsigned char* sP = sV + kSlot * m.n_v * m.n_vb;
  float* sCorr = reinterpret_cast<float*>(sP + kPBytes);
  float* sL = sCorr + 64;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sL + 64);
  uint64_t* v_full = k_full + m.stages;  // a V tile's pieces, tile t in
  uint64_t* v_empty = v_full + m.n_v * m.n_vb;  // buffer t % n_vb
  uint64_t* q_full = v_empty + m.n_v * m.n_vb;

  const int h = blockIdx.x % p.hq;
  const int slice = blockIdx.x / p.hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / kWG;
  const int per_chunk = m.q_held ? 1 : 2;  // K ring items a chunk

  // The K ring's items are the chunks of each kv tile in order, each its
  // chunk of Q (where Q streams) and then of K; item i lies in stage i %
  // stages. Every index below advances by one step (no division by the
  // run-time ring size: with two warps an SM sub-partition, a division's
  // latency is paid in full). A cursor (tile, chunk, part) walks the items;
  // issue_k copies its item into stage `st`, on the threads where `lead`.
  struct Cursor {
    int t, c, part;
  };
  auto advance = [&](Cursor& x) {
    if (++x.part == per_chunk) {
      x.part = 0;
      if (++x.c == m.chunks) {
        x.c = 0;
        ++x.t;
      }
    }
  };
  auto issue_k = [&](bool lead, int st, const Cursor& x) {
    if (x.t >= n_tiles) return;
    const bool is_q = per_chunk == 2 && x.part == 0;
    mbar_expect_tx_if(lead, &k_full[st], static_cast<uint32_t>(kSlot));
    for (int i = 0; i < 2; ++i) {
      tma_load_if(lead, sK + st * kSlot + i * kBox, is_q ? &tq : &tk,
                  &k_full[st], x.c * kChunk + i * 64, is_q ? h : hk,
                  is_q ? q0 : x.t * BK, b);
    }
  };
  // a kv tile's V buffer (t % n_vb, n_vb 1 or 2) and its fill's parity
  auto v_at = [&](int t) { return (m.n_vb == 2 ? t & 1 : 0) * m.n_v; };
  auto v_parity = [&](int t) {
    return static_cast<uint32_t>((m.n_vb == 2 ? t >> 1 : t) & 1);
  };
  auto issue_v = [&](bool lead, int t) {
    for (int i = 0; i < m.n_v; ++i) {
      const int at = v_at(t) + i;
      mbar_expect_tx_if(lead, &v_full[at], static_cast<uint32_t>(kSlot));
      for (int x = 0; x < 2; ++x) {
        tma_load_if(lead, sV + at * kSlot + x * kBox, &tv, &v_full[at],
                    slice * DVS + i * kChunk + x * 64, hk, t * BK, b);
      }
    }
  };
  // the item the next refill copies: `stages` on from the first
  Cursor refill = {0, 0, 0};
  for (int i = 0; i < m.stages; ++i) advance(refill);

  if (threadIdx.x == 0) {
    for (int st = 0; st < m.stages; ++st) mbar_init(&k_full[st], 1);
    for (int i = 0; i < m.n_v * m.n_vb; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 2 * kWG / 32);  // one arrival a warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (m.q_held) {
      mbar_expect_tx(q_full, static_cast<uint32_t>(m.q_bytes));
      for (int c = 0; c < m.chunks; ++c) {
        for (int x = 0; x < 2; ++x) {
          tma_load(sQ + c * kSlot + x * kBox, &tq, q_full,
                   c * kChunk + x * 64, h, q0, b);
        }
      }
    }
    Cursor x = {0, 0, 0};
    for (int st = 0; st < m.stages; ++st, advance(x)) issue_k(true, st, x);
    for (int t = 0; t < m.n_vb && t < n_tiles; ++t) issue_v(true, t);
  }
  __syncthreads();

  // a consumer warpgroup: the block's 64 rows, its half of the columns
  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = q0 + warp * 16 + lane / 4;  // this thread's rows r0, r0+8
  const int col = 2 * (lane % 4);
  const int lr = warp * 16 + lane / 4;       // r0's row in the tile
  const uint64_t p_desc = make_desc<64>(smem_u32(sP), 16, 8 * 128);
  float acc[kNP][kN / 2];
#pragma unroll
  for (int pp = 0; pp < kNP; ++pp) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[pp][i] = 0.0f;
  }
  // the V piece and 64-column box of each of this warpgroup's pieces, in
  // the V tile of buffer 0 (buffer 1 lies n_v stages on)
  uint32_t v_piece[kNP];
#pragma unroll
  for (int pp = 0; pp < kNP; ++pp) {
    const int c0 = wg * kDVW + pp * kN;
    v_piece[pp] = smem_u32(sV) + (c0 / kChunk) * kSlot +
                  (c0 % kChunk) / 64 * kBox;
  }
  float den[2];

  if (wg == 0) {
    // the K ring's next item to wait for: its stage and phase's parity
    int st = 0;
    uint32_t phase = 0;
    auto next_stage = [&]() {
      if (++st == m.stages) {
        st = 0;
        phase ^= 1;
      }
    };
    // a chunk's stages done with: once every warp of the warpgroup is past
    // its products, thread 0 refills each with the item `stages` on (the
    // barrier also keeps the four warps in step for the next wgmma: without
    // it the kernel ran about 14 % slower at (512, 512))
    int freed[2] = {0, 0};  // the stages of the chunk before
    auto free_k = [&]() {
      named_sync_wg(kBarKFree);
      for (int i = 0; i < per_chunk; ++i) {
        issue_k(tid == 0, freed[i], refill);
        advance(refill);
      }
    };
    float s[BK / 2];
    float m_row[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    float corr[2];
    if (m.q_held) mbar_wait(q_full, 0);
    REPRO_PHASES_START;
    for (int t = 0; t < n_tiles; ++t) {
      // S = Q K^T, one commit group a chunk, each waited for once the next
      // is issued (the first wait finds the previous tile's P V done). S is
      // zeroed and every product accumulates: no branch between two kinds
      // of wgmma, which ptxas would serialize
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
      for (int c = 0; c < m.chunks; ++c) {
        // this chunk's stages: Q's (where Q streams), then K's
        int now[2] = {0, 0};
        REPRO_PHASE(0, for (int i = 0; i < per_chunk; ++i) {
          mbar_wait(&k_full[st], phase);
          now[i] = st;
          next_stage();
        });
        const uint32_t q_base = smem_u32(m.q_held ? sQ + c * kSlot
                                                  : sK + now[0] * kSlot);
        wgmma_fence();
        issue_qk_chunk<BQ, BK, E>(s, q_base,
                                  smem_u32(sK + now[per_chunk - 1] * kSlot));
        // the group before this chunk's is done
        REPRO_PHASE(1, wgmma_wait<1>());
        if (c > 0) {
          REPRO_PHASE(2, free_k());
        } else if (t > 0) {  // the previous tile's P V: its V tile
          for (int i = 0; i < m.n_v; ++i) {
            mbar_arrive_if(lane == 0, &v_empty[v_at(t - 1) + i]);
          }
        }
        freed[0] = now[0];
        freed[1] = now[1];
      }
      REPRO_PHASE(3, wgmma_wait<0>());
      fence_operands(s);
      free_k();
      REPRO_PHASE(4, softmax<BK>(s, m_row, l, corr, p, t * BK, r0, col,
                                 p.causal && (t + 1) * BK - 1 > q0));
      // warpgroup 1 is done with P
      REPRO_PHASE(5, if (t > 0) named_sync(kBarPFree));
      store_p<E>(s, sP, warp, lane);
      sCorr[lr] = corr[0];  // the four threads of a row store the same
      sCorr[lr + 8] = corr[1];
      fence_proxy_async();
      named_arrive(kBarPFull);
      fence_operands(acc);
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp) {
        rescale_rows<kN>(acc[pp], corr[0], corr[1]);
      }
      REPRO_PHASE(6, for (int i = 0; i < m.n_v; ++i) {
        mbar_wait(&v_full[v_at(t) + i], v_parity(t));
      });
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp) {
        issue_pv_ss<kN, E>(acc[pp], p_desc,
                           v_piece[pp] + v_at(t) * kSlot);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      den[j] = fmaxf(l[j], 1e-30f);
    }
    sL[lr] = den[0];
    sL[lr + 8] = den[1];
    REPRO_PHASES_FLUSH(tid == 0, 0);
    named_arrive(kBarLFull);
  } else {
    REPRO_PHASES_START;
    for (int t = 0; t < n_tiles; ++t) {
      REPRO_PHASE(0, named_sync(kBarPFull));
      const float c0 = sCorr[lr];
      const float c1 = sCorr[lr + 8];
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp) rescale_rows<kN>(acc[pp], c0, c1);
      REPRO_PHASE(1, for (int i = 0; i < m.n_v; ++i) {
        mbar_wait(&v_full[v_at(t) + i], v_parity(t));
      });
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp) {
        issue_pv_ss<kN, E>(acc[pp], p_desc,
                           v_piece[pp] + v_at(t) * kSlot);
      }
      wgmma_commit();
      REPRO_PHASE(2, wgmma_wait<0>());
      fence_operands(acc);
      for (int i = 0; i < m.n_v; ++i) {
        mbar_arrive_if(lane == 0, &v_empty[v_at(t) + i]);
      }
      // once both warpgroups are done with this V tile (warpgroup 0 is,
      // early in the next tile's Q K^T), the tile n_vb on into its buffer
      REPRO_PHASE(3, if (t + m.n_vb < n_tiles) {
        for (int i = 0; i < m.n_v; ++i) {
          mbar_wait(&v_empty[v_at(t) + i], v_parity(t));
        }
        issue_v(tid == 0, t + m.n_vb);
      });
      if (t + 1 < n_tiles) named_arrive(kBarPFree);
    }
    REPRO_PHASES_FLUSH(tid == 0, 1);
    named_sync(kBarLFull);
    den[0] = sL[lr];
    den[1] = sL[lr + 8];
  }
  // each warpgroup's columns of the slice, the first `width` of them
  const int width = min(DVS, p.dv - slice * DVS);
#pragma unroll
  for (int pp = 0; pp < kNP; ++pp) {
    const int c0 = wg * kDVW + pp * kN;
    store_piece<kN, E>(acc[pp], den, o + slice * DVS + c0, p, r0, col, h, b,
                       width - c0, width - c0 >= kN && p.dv % 2 == 0);
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
inline EncodeTiled encode_tiled() {
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

// A 4-D map (width, H, S, B) over a [B, S, H, width] tensor of E with the
// given strides (elements), box [rows, kCols] of one head; the swizzle and
// the box are those of the class D (of a chunk or a slice of the width, in
// the chunked kernel), and the columns of a box past `width` are
// zero-filled.
template <int D, class E>
bool make_map(CUtensorMap* map, const void* base, int width, int heads,
              int seq, int batch, long long s_b, long long s_s,
              long long s_h, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
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
  return encode(map, E::kTma, 4, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Call {
  const void *q, *k, *v;
  void* o;
  int batch;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  Params p;  // p.d, p.dv: the true head dims
};

template <class E, int D, int DV, int BQ, int BK>
int launch(const Call& c, cudaStream_t stream) {
  constexpr size_t smem = SmemSm90<D, DV, BQ, BK>::kBytes;
  static_assert(smem <= kSmemLimit, "tile does not fit in shared memory");
  CUtensorMap tq, tk, tv;
  const Params& p = c.p;
  if (!make_map<D, E>(&tq, c.q, p.d, p.hq, p.sq, c.batch, c.q_sb, c.q_ss,
                      c.q_sh, BQ) ||
      !make_map<D, E>(&tk, c.k, p.d, p.hkv, p.skv, c.batch, c.k_sb, c.k_ss,
                      c.k_sh, BK) ||
      !make_map<DV, E>(&tv, c.v, p.dv, p.hkv, p.skv, c.batch, c.v_sb, c.v_ss,
                       c.v_sh, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_kernel<E, D, DV, BQ, BK>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(p.hq, (p.sq + BQ - 1) / BQ, c.batch);
  const int threads = (BQ / kRowsPerWG + 1) * kWG;
  kernel<<<grid, threads, smem, stream>>>(
      tq, tk, tv, static_cast<typename E::T*>(c.o), p);
  return static_cast<int>(cudaGetLastError());
}

// The chunked kernel at slice class DVS: Q, K and V mapped in boxes of 64
// columns (the 128-byte swizzle), 64 rows; one block a (head, slice) on x.
template <class E, int DVS, int BQ, int BK>
int launch_chunked(const Call& c, cudaStream_t stream) {
  const Params& p = c.p;
  const SmemChunked m = SmemChunked::of(p.d, DVS);
  if (m.bytes > kSmemLimit || m.stages < (m.q_held ? 2 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!make_map<kChunk, E>(&tq, c.q, p.d, p.hq, p.sq, c.batch, c.q_sb,
                           c.q_ss, c.q_sh, BQ) ||
      !make_map<kChunk, E>(&tk, c.k, p.d, p.hkv, p.skv, c.batch, c.k_sb,
                           c.k_ss, c.k_sh, BK) ||
      !make_map<kChunk, E>(&tv, c.v, p.dv, p.hkv, p.skv, c.batch, c.v_sb,
                           c.v_ss, c.v_sh, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // set at every launch: a function-local static flag would be one symbol
  // for every library that instantiates this template in the process (an
  // earlier build's, loaded beside this one), so one library's flag would
  // skip another's setting
  auto kernel = flash_fwd_sm90_chunked_kernel<E, DVS, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slices = (p.dv + DVS - 1) / DVS;
  if (slices * p.hq > 0x7fffffffLL || (p.sq + BQ - 1) / BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(slices * p.hq), (p.sq + BQ - 1) / BQ,
                  c.batch);
  kernel<<<grid, 2 * kWG, m.bytes, stream>>>(
      tq, tk, tv, static_cast<typename E::T*>(c.o), p);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of a head-dim class (D, DV) that are instantiated: those that
// fit in a block's shared memory with at least two stages (D = DV = 256 at
// 128-row kv tiles does not, nor D = DV = 192 at 128 x 128), less D = DV =
// 256 at 128 x 64, which fits but spills 216 bytes of registers (a
// 384-thread block leaves a thread 168 at compile time) and ran 2.2x slower
// than 64 x 64. The wrapper refuses the others first (unsupported() in
// kernels/flash_attention.py).
template <int D, int DV, int BQ, int BK>
constexpr bool kBuilt = SmemSm90<D, DV, BQ, BK>::bytes(2) <= kSmemLimit &&
                        !(D == 256 && DV == 256 && BQ == 128);

template <class E, int D, int DV>
int by_tile(int block_q, int block_k, const Call& c, cudaStream_t s) {
#define REPRO_FLASH_SM90_TILE(BQ, BK)                          \
  if constexpr (kBuilt<D, DV, BQ, BK>) {                       \
    if (block_q == BQ && block_k == BK) {                      \
      return launch<E, D, DV, BQ, BK>(c, s);                   \
    }                                                          \
  }
  REPRO_FLASH_SM90_TILE(64, 64)
  REPRO_FLASH_SM90_TILE(64, 128)
  REPRO_FLASH_SM90_TILE(128, 64)
  REPRO_FLASH_SM90_TILE(128, 128)
#undef REPRO_FLASH_SM90_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The head-dim classes of one element type, in two halves: by_class_narrow
// the squares 32 to 160, by_class_wide 192, (192, 128) and 256. Each is
// instantiated in a .cu file of its own (the extern declarations below keep
// every other file from instantiating it), so that nvcc builds them in
// parallel: bf16 in flash_attention_sm90.cu and flash_attention_sm90_wide.cu,
// f16 in flash_attention_sm90_f16.cu and flash_attention_sm90_f16_wide.cu.
// Each returns cudaErrorInvalidValue for a class or tile it does not build.
#define REPRO_FLASH_SM90_CLASS(D, DV) \
  if (dc == D && dvc == DV) return by_tile<E, D, DV>(block_q, block_k, c, s);

template <class E>
int by_class_narrow(int dc, int dvc, int block_q, int block_k, const Call& c,
                    cudaStream_t s) {
  REPRO_FLASH_SM90_CLASS(32, 32)
  REPRO_FLASH_SM90_CLASS(64, 64)
  REPRO_FLASH_SM90_CLASS(96, 96)
  REPRO_FLASH_SM90_CLASS(128, 128)
  REPRO_FLASH_SM90_CLASS(160, 160)
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class E>
int by_class_wide(int dc, int dvc, int block_q, int block_k, const Call& c,
                  cudaStream_t s) {
  REPRO_FLASH_SM90_CLASS(192, 192)
  REPRO_FLASH_SM90_CLASS(192, 128)
  REPRO_FLASH_SM90_CLASS(256, 256)
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef REPRO_FLASH_SM90_CLASS

// The chunked kernel at its one tile, 64 x 64, for slice class dvs (128,
// 256 or 512, kernels/flash_attention.py:wide_split), both element types in
// flash_attention_sm90_chunked.cu.
template <class E>
int by_slice_chunked(int dvs, int block_q, int block_k, const Call& c,
                     cudaStream_t s) {
  if (block_q != 64 || block_k != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dvs == 128) return launch_chunked<E, 128, 64, 64>(c, s);
  if (dvs == 256) return launch_chunked<E, 256, 64, 64>(c, s);
  if (dvs == 512) return launch_chunked<E, 512, 64, 64>(c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#define REPRO_FLASH_SM90_EXTERN(E)                                          \
  extern template int by_class_narrow<E>(int, int, int, int, const Call&,   \
                                         cudaStream_t);                     \
  extern template int by_class_wide<E>(int, int, int, int, const Call&,     \
                                       cudaStream_t);                       \
  extern template int by_slice_chunked<E>(int, int, int, const Call&,       \
                                          cudaStream_t);
REPRO_FLASH_SM90_EXTERN(ElemBf16)
REPRO_FLASH_SM90_EXTERN(ElemF16)
#undef REPRO_FLASH_SM90_EXTERN

}  // namespace repro_flash_sm90
