// Flash attention, forward — blocked online-softmax attention for Hopper,
// f32 inputs on the tensor cores (3xTF32 mma.sync): the kernel, included by
// flash_attention.cu (the C entry point of both paths, and the narrow
// head-dim classes), flash_attention_f32_mid.cu and
// flash_attention_f32_wide.cu (the wider ones), and
// flash_attention_f32_chunked.cu (head dims above 256), files that nvcc
// builds in parallel.
//
// Replaces: src/repro/kernels/flash_attention.py, functions `_flash_kernel` /
// `flash_attention` (the Pallas kernel of the reference package), and the
// GQA expansion of its wrapper `ops.flash_attention_op`. bf16 and f16 inputs
// go to the wgmma kernel of flash_attention_sm90.cu
// (`repro_flash_attention_sm90`); this file holds the f32 kernel.
//
// What it computes, per (batch, q head) and query row:
//   s = (q . k^T) * scale            (f32 operands, f32 sums)
//   s = -1e30 where causal and kpos > qpos   (positions counted from 0 in
//                                     both q and kv: top-left aligned)
//   out = softmax(s) . v             (f32 accumulate, stored as f32)
// with the reference's online softmax: a running max m, a running sum l and
// an f32 accumulator, rescaled by exp(m_prev - m_new) at every kv tile, and
// out = acc / max(l, 1e-30) at the end. GQA: the kv head of q head h is
// h / (Hq / Hkv); K and V are indexed, never repeated.
//
// Numerics: 3xTF32. The tensor cores multiply TF32 (10 explicit mantissa
// bits) exactly and sum in f32. Each f32 operand x is split into big =
// tf32(x) and small = tf32(x - big), both rounded to nearest with ties away
// from zero (cvt.rna), and a . b is summed as a_small . b_big + a_big .
// b_small + a_big . b_big into one f32 accumulator, small terms first.
// small . small (about 2^-22 of the product) is dropped. The rounding of big
// is explicit: the tensor core would truncate the low 13 bits itself, and
// small is the exact remainder only against a rounded big. A single TF32
// product errs by about 2^-11 of each operand, outside the f32 contract of
// 2e-5 (tests/test_torch_flash_attention.py shows both); 3xTF32 keeps it,
// at three products for one.
//
// Why mma.sync (m16n8k8 .tf32) and not wgmma: TF32 wgmma takes its B
// operand only K-major from shared memory. In O += P V the B operand is V,
// [kv, D] in memory, MN-major, and wgmma's transpose bit exists only for
// 16-bit types. mma.sync takes both operands from registers, so V's B
// fragment is read straight from a [kv, D] tile, and P stays in registers:
// the S accumulator holds columns (2t, 2t + 1) of each 8-column slice where
// the A fragment wants (t, t + 4), so the k8 step reads V's rows in the
// same permuted order (logical k index t is kv row 2t, t + 4 is 2t + 1).
// Within a k8 step the order of the kv terms does not change the sum's
// meaning. Q K^T permutes its k (head-dim) index the same way within each
// 16 columns, so one 16-byte load of a K row gives a thread its B operands
// of two k8 steps.
//
// Design. A thread block of 8 warps walks the kv tiles of one (batch, head,
// q tile of BQ rows). Its warps form BQ / 16 row groups of 16 query rows
// (the mma's M) and 128 / BQ kv splits: each warp takes BK * BQ / 128
// columns of every kv tile, so all 8 warps work on a q tile of 32 rows and
// no warp walks the kv axis alone. Each warp keeps its own (m, l, acc) for
// its 16 rows and its columns; at the end the partials of a row merge
// through shared memory: M = max m_j, out = sum_j exp(m_j - M) acc_j /
// max(sum_j exp(m_j - M) l_j, 1e-30). That merge sums in another order than
// the reference's one online pass; the result is held to 2e-5 like
// everything else.
//   - Causal balance: the blocks run in clusters of two, and cluster c
//     takes q tiles c and n_q - 1 - c, a light and a heavy one whose kv
//     tiles sum to about the same for every c. Rank 0 walks the first half
//     of that sum (the heavy tile's first kv tiles), rank 1 the light tile
//     and then the rest of the heavy one; the heavy tile's partials of both
//     blocks merge through distributed shared memory, each block storing
//     half of its rows. Every block then has the same work, where one block
//     a q tile would leave the grid waiting on the heaviest tile (at the
//     tuning space's shape, 128 blocks of 32 rows: one wave, the last tile
//     walking 16 kv tiles of 64 where the mean walks 8.5). Without the mask
//     every q tile has the same work, and each block takes one.
//   - Q is split into Q_big and Q_small once per walk, while it is staged
//     in shared memory as the mma's A fragments (every kv tile reads it
//     again, with one 16-byte load a fragment). K and V are split as their
//     fragments are loaded.
//   - K and V pass through a two-slot ring of cp.async 16-byte copies, one
//     slot for K and one for V, issued so that each copy is in flight while
//     the other product runs: V(t) loads under Q K^T(t) and the softmax,
//     K(t + 1) under P V(t). The two block barriers a tile has are the
//     ring's (a slot has landed and the other is free). Two full K/V stages
//     would not fit a 128-column f32 tile at D = 128 in 227 KB.
//   - Bank conflicts: K rows have a pitch of D + 16 floats, so the 8
//     threads of a 16-byte load phase hit 32 different banks; V rows have
//     D + 4, so the four kv rows 2t (and 2t + 1) of a B fragment fall 8
//     banks apart; the merge rows D + 8 (8-byte stores).
//   - The softmax stays in registers: a thread holds rows g and g + 8 of
//     S; a row's max and sum take two __shfl_xor_sync across its quad,
//     exp2f has scale * log2(e) folded in, and S never goes to shared
//     memory.
//   - The TF32 rounding is two integer operations (ptxas makes cvt.rna a
//     test for inf and NaN, an add and a select, and leaves the low bits).
//
// Masks: the kv tiles wholly above the q tile's diagonal are not loaded
// (every score in them is masked, so they would add exp(-1e30 - m) = 0 and
// rescale by 1: skipping is exact); a warp skips the products of a tile
// whose columns lie wholly above its 16 rows or past Skv, and masks only
// the tiles that cross its diagonal or Skv. kv columns past Skv get -inf
// (no weight; K and V rows past Skv are zero-filled), query rows past Sq
// are not stored; m starts at -1e30, so m stays finite and exp(-inf - m)
// is 0.
//
// What bounds it on this card: operations. At the tuning space's shape (q,
// k, v [4, 1024, 128], causal) the flops need 0.0161 ms at the fp32 FMA
// rate, 3 x 0.0022 ms at the TF32 tensor-core rate (3xTF32; mma.sync
// reaches about 320 of the 495 TFLOP/s on an NVIDIA H100 80GB HBM3 at
// 700 W, tools/mma_tf32_rate.py), and the bytes 0.0025 ms at the HBM rate. Beside its three mma, a pair of
// fragments costs the split of each K or V element by each warp that reads
// it (four integer and float operations) and its shared-memory load; a
// 256-thread block needs 200-255 registers a thread, so an SM holds one
// block, two warps a sub-partition, to hide those latencies.
//
// Head dims. The reference takes any D and DV; so does this kernel: for 1
// <= D, DV <= 256 through head-dim classes (head_dim_class, below; the
// bf16 kernel uses the same): D and DV are separate template parameters,
// the class widths (32, 32), (64, 64), (96, 96), (128, 128), (160, 160),
// (192, 192), (256, 256) and (192, 128), and Params carries the true d and
// dv. Columns past the true width load as zeros: K and V through the
// zero-fill form of cp.async (src-size 4 (width - c) bytes of the 16, 0 past
// the width), Q by plain loads of the row's last partial chunk. The padded
// q and k columns add exact zeros to q . k^T, the padded v columns give
// accumulator columns that the merge does not store, and the scale is the
// caller's, that of the true D. Output rows are stored in 16-byte chunks
// where dv is a multiple of 4 (every row then starts 16-byte aligned), else
// one column at a time. At (256, 256) only 32 x 64 fits in 227 KB (201728
// B), at (192, 192) 32 x 64 and 64 x 64, at (192, 128) those and 32 x 128;
// the accumulator of a thread is DV / 2 registers (128 at 256).
//
// Head dims above 256 run on the chunked kernel (flash_fwd_f32_chunked_kernel,
// kernels/flash_attention.py:wide_split, below): one block owns a q tile and
// every column of v up to 512; its 8 warps compute S once a kv tile
// together, summed over chunks of kChunk = 128 columns of q and k, each
// chunk's products summed on their own and then added to S (a chain of 1024
// columns' products in one f32 accumulator missed the 2e-5 contract at
// (1024, 1024)); P goes once through shared memory, split into its TF32
// parts, and each warp adds P V for its eighth of O's columns over every
// row of the tile. Q is held in shared memory for the whole kv walk where
// it fits (WideLayout), K chunks and V pieces stream through one cp.async
// ring. No instantiation spills.
//
// block_q and block_k are template parameters: every (block_q, block_k)
// pair in {32, 64, 128} x {64, 128} whose shared memory fits in 227 KB is
// instantiated, at every head-dim class; the others return
// cudaErrorInvalidValue. The wrapper's `unsupported` states the same rules
// and refuses anything else before it launches.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace repro_flash_f32 {


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most a block can have

// The shape of one block's work at head-dim class (D, DV), and its shared
// memory: Q_big and Q_small (BQ x D each, stored as the mma's A fragments:
// one 16-byte load gives a thread its fragment of a k8 step), the K slot
// [BK, D + 16] and the V slot [BK, DV + 4], in f32. After the kv walk the
// same bytes hold the merge (struct Merge). kernels/flash_attention.py:
// smem_bytes repeats this formula.
template <int D, int DV, int BQ, int BK>
struct TilesF32 {
  static constexpr int kGroups = BQ / 16;           // row groups
  static constexpr int kSplits = kWarps / kGroups;  // kv splits of a group
  static constexpr int kCols = BK / kSplits;  // kv columns a warp takes
  static constexpr int kNT = kCols / 8;       // its n8 slices of S
  static constexpr int kPitch = D + 16;       // K rows (floats)
  static constexpr int kVPitch = DV + 4;      // V rows
  static constexpr int kOPitch = DV + 8;      // merge rows
  static constexpr size_t kBytes =
      4ull * (2 * BQ * D + BK * kPitch + BK * kVPitch);
  static constexpr size_t kMergeBytes =
      4ull * (kWarps * 16 * (kOPitch + 4) + BQ);
  // the block's shared memory: the tiles, or the merge where it is larger
  static constexpr size_t kSmem = kBytes > kMergeBytes ? kBytes : kMergeBytes;
  static_assert(BQ % 16 == 0 && kWarps % kGroups == 0 && kCols % 8 == 0,
                "tiles must give every warp 16 rows and 8k columns");
  static_assert(D % 16 == 0 && DV % 16 == 0,
                "head-dim classes must be multiples of 16");
};

struct Params {
  int hq, hkv, sq, skv;
  int d, dv;  // the true head dims of q / k and of v / o (<= the class's)
  long long q_sb, q_ss, q_sh;  // strides (elements) of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // scale * log2(e)
  int causal;
  int o_vec4;  // o's rows start 16-byte aligned: stored in 16-byte chunks
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously: the first src_bytes read from
// src, the rest zero-filled (src is not read when src_bytes is 0)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32, to nearest with ties away from zero, low 13 bits
// zero: what cvt.rna.tf32.f32 computes for a finite x, written out in two
// integer operations (ptxas makes cvt.rna a test for inf and NaN, an add and
// a select, and leaves the low bits as they were)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (small is tf32(x - big))
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a . b, m16n8k8, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: small terms first, small . small dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// rows [row0, row0 + ROWS) of a [*, width] f32 matrix (row stride
// `stride`) into shared rows of PITCH floats, D of them (the class's) by
// cp.async; rows at or past n_rows and columns at or past width are
// zero-filled
template <int D, int ROWS, int PITCH>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long stride, int row0,
                                          int n_rows, int width, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % kThreads == 0, "whole passes");
#pragma unroll
  for (int pass = 0; pass < ROWS * kChunks / kThreads; ++pass) {
    const int i = pass * kThreads + tid;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool in = row0 + r < n_rows && c < width;
    const float* s =
        in ? src + static_cast<long long>(row0 + r) * stride + c : src;
    cp_async16(dst + r * PITCH + c, s, in ? 4 * min(4, width - c) : 0);
  }
}

// Q rows [q0, q0 + BQ) at columns [0, D) from qc (a row's column 0 of this
// chunk; rows q_ss apart), split into Q_big and Q_small and stored as A
// fragments: the fragment of row group rg, columns 16 kk .. 16 kk + 15, k8
// step st (columns 4t + 2st and 4t + 2st + 1 of each 16) and lane 4g + t is
// the 4 floats at (((rg * D / 16 + kk) * 2 + st) * 32 + lane) * 4: rows g
// and g + 8 at the first column, then at the second. Rows past sq and
// columns past `width` are zero.
template <int D, int BQ>
__device__ __forceinline__ void stage_q(float* sQb, float* sQs,
                                        const float* __restrict__ qc,
                                        long long q_ss, int q0, int sq,
                                        int width, int tid) {
  static_assert(BQ * D / 4 % kThreads == 0, "whole passes");
#pragma unroll
  for (int pass = 0; pass < BQ * D / 4 / kThreads; ++pass) {
    const int i = pass * kThreads + tid;
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < sq && c < width) {
      const float* src = qc + static_cast<long long>(q0 + r) * q_ss + c;
      if (c + 4 <= width) {
        x = *reinterpret_cast<const float4*>(src);
      } else {  // the row's last, partial chunk
        x.x = src[0];
        if (c + 1 < width) x.y = src[1];
        if (c + 2 < width) x.z = src[2];
      }
    }
    const int half = (r % 16) / 8;  // row g (0) or g + 8 (1)
    const int lane_of = 4 * (r % 8) + (c % 16) / 4;
    const int f0 = (((r / 16) * (D / 16) + c / 16) * 2 * 32 + lane_of) * 4;
    const int f1 = f0 + 32 * 4;  // the second k8 step
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const int at[4] = {f0 + half, f0 + 2 + half, f1 + half, f1 + 2 + half};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t big, small;
      split(xs[e], big, small);
      reinterpret_cast<uint32_t*>(sQb)[at[e]] = big;
      reinterpret_cast<uint32_t*>(sQs)[at[e]] = small;
    }
  }
}

// sa += this warp's Q K^T over the D staged columns. Each product waits for
// the one before it on the same accumulator (about 30 cycles): the k8 steps
// rotate over kAcc accumulators a slice, so that a warp has at least 4
// chains in flight, summed by the caller
template <int D, int kNT, int kAcc, int kPitch>
__device__ __forceinline__ void qk_products(float (&sa)[kAcc][kNT][4],
                                            const uint4* qb_frag,
                                            const uint4* qs_frag,
                                            const float* k_row) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // A fragments (rows g, g + 8; logical columns t, t + 4) of the two
    // k8 steps
    const uint4 qb0 = qb_frag[kk * 64];
    const uint4 qb1 = qb_frag[kk * 64 + 32];
    const uint4 qs0 = qs_frag[kk * 64];
    const uint4 qs1 = qs_frag[kk * 64 + 32];
    const uint32_t ab0[4] = {qb0.x, qb0.y, qb0.z, qb0.w};
    const uint32_t as0[4] = {qs0.x, qs0.y, qs0.z, qs0.w};
    const uint32_t ab1[4] = {qb1.x, qb1.y, qb1.z, qb1.w};
    const uint32_t as1[4] = {qs1.x, qs1.y, qs1.z, qs1.w};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float4 kx =
          *reinterpret_cast<const float4*>(k_row + 8 * j * kPitch + 16 * kk);
      uint32_t kbig[4], ksmall[4];
      split(kx.x, kbig[0], ksmall[0]);
      split(kx.y, kbig[1], ksmall[1]);
      split(kx.z, kbig[2], ksmall[2]);
      split(kx.w, kbig[3], ksmall[3]);
      mma_3xtf32(sa[(2 * kk) % kAcc][j], ab0, as0, kbig[0], kbig[1],
                 ksmall[0], ksmall[1]);
      mma_3xtf32(sa[(2 * kk + 1) % kAcc][j], ab1, as1, kbig[2], kbig[3],
                 ksmall[2], ksmall[3]);
    }
  }
}

// One walk over kv tiles [t_begin, t_end) of the q tile at q0: Q staged and
// split, then for each kv tile S = Q K^T, the online softmax and acc += P V
// for this warp's 16 rows and kv columns. Leaves this thread's share of the
// warp's (acc, m, l) in registers; no kv tile is in flight at the end.
template <int D, int DV, int BQ, int BK>
__device__ __forceinline__ void walk_kv(
    const float* __restrict__ qb, const float* __restrict__ kb,
    const float* __restrict__ vb, const Params& p, float* smem, int q0,
    int t_begin, int t_end, float (&acc)[DV / 8][4], float (&m)[2],
    float (&l)[2]) {
  using T = TilesF32<D, DV, BQ, BK>;
  constexpr int kPitch = T::kPitch;
  constexpr int kVPitch = T::kVPitch;
  constexpr int kNT = T::kNT;
  constexpr int kNO = DV / 8;  // n8 slices of the output
  float* sQb = smem;
  float* sQs = sQb + BQ * D;
  float* sK = sQs + BQ * D;
  float* sV = sK + BK * kPitch;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // the mma's group: rows g, g + 8; column g of B
  const int t = lane % 4;  // its thread in the group
  const int sp = warp / T::kGroups;             // this warp's kv split
  const int row_lo = (warp % T::kGroups) * 16;  // and its rows in the tile
  const int col0 = sp * T::kCols;  // its first column of a kv tile

#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  }
  m[0] = m[1] = kNegInf;  // rows g and g + 8, log2 units
  l[0] = l[1] = 0.0f;     // this thread's share of the row sums
  if (t_begin >= t_end) return;

  copy_tile<D, BK, kPitch>(sK, kb, p.k_ss, t_begin * BK, p.skv, p.d, tid);
  cp_async_commit();
  stage_q<D, BQ>(sQb, sQs, qb, p.q_ss, q0, p.sq, p.d, tid);

  const int row_a = q0 + row_lo + g;  // this thread's rows: row_a, row_a + 8
  // this thread's operands: its A fragments of Q; 4 consecutive floats of K
  // row g at columns 16 kk + 4t (two k8 steps: 4t, 4t + 1 and 4t + 2,
  // 4t + 3); V rows 2t and 2t + 1 of each 8-row slice, column 8n + g
  const uint4* qb_frag =
      reinterpret_cast<const uint4*>(sQb) + row_lo / 16 * D / 16 * 64 + lane;
  const uint4* qs_frag =
      reinterpret_cast<const uint4*>(sQs) + row_lo / 16 * D / 16 * 64 + lane;
  const float* k_row = sK + (col0 + g) * kPitch + 4 * t;
  const float* v_row = sV + (col0 + 2 * t) * kVPitch + g;
  constexpr int kAcc = kNT >= 4 ? 1 : 4 / kNT;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    const int c_lo = k0 + col0;  // this warp's first kv column
    // its columns hold a score that counts for one of its rows
    const bool active =
        c_lo < p.skv && !(p.causal && c_lo > row_a + 15 - g);
    // and some of them are masked for one of its rows
    const bool masked = c_lo + T::kCols > p.skv ||
                        (p.causal && c_lo + T::kCols - 1 > row_a - g);

    cp_async_wait_all();  // K(tile) has landed (and Q is written) ...
    __syncthreads();      // ... for every thread; the V slot is free
    copy_tile<DV, BK, kVPitch>(sV, vb, p.v_ss, k0, p.skv, p.dv, tid);
    cp_async_commit();

    // S = Q K^T over this warp's columns, its products over kAcc chains
    float s[kNT][4];
    if (active) {
      float sa[kAcc][kNT][4];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sa[a][j][i] = 0.0f;
        }
      }
      qk_products<D, kNT, kAcc, kPitch>(sa, qb_frag, qs_frag, k_row);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = sa[0][j][i];
#pragma unroll
          for (int a = 1; a < kAcc; ++a) x += sa[a][j][i];
          s[j][i] = x;
        }
      }
    }

    if (active) {
      // online softmax in registers: s[j][2r + c] is row g + 8r, column
      // c_lo + 8j + 2t + c
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[j][2 * r + c] * p.scale_log2;
            if (masked) {
              const int kpos = c_lo + 8 * j + 2 * t + c;
              if (kpos >= p.skv) {
                x = -INFINITY;  // past the sequence: no weight
              } else if (p.causal && kpos > row_a + 8 * r) {
                x = kNegInf;
              }
            }
            s[j][2 * r + c] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float e = exp2f(s[j][2 * r + c] - m[r]);
            s[j][2 * r + c] = e;
            l[r] += e;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    cp_async_wait_all();  // V(tile) has landed ...
    __syncthreads();      // ... for every thread; the K slot is free
    if (tile + 1 < t_end) {
      copy_tile<D, BK, kPitch>(sK, kb, p.k_ss, k0 + BK, p.skv, p.d, tid);
    }
    cp_async_commit();

    if (active) {
      // acc += P V: the S fragment of slice j is the A fragment of k8 step
      // j, with logical column t = kv column 2t and t + 4 = 2t + 1
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t pbig[4], psmall[4];
        split(s[j][0], pbig[0], psmall[0]);
        split(s[j][2], pbig[1], psmall[1]);
        split(s[j][1], pbig[2], psmall[2]);
        split(s[j][3], pbig[3], psmall[3]);
        const float* vr = v_row + 8 * j * kVPitch;
#pragma unroll
        for (int n = 0; n < kNO; ++n) {
          uint32_t vb0, vs0, vb1, vs1;
          split(vr[8 * n], vb0, vs0);
          split(vr[kVPitch + 8 * n], vb1, vs1);
          mma_3xtf32(acc[n], pbig, psmall, vb0, vb1, vs0, vs1);
        }
      }
    }
  }
}

// Shared memory of the merge, over the tiles once every warp is done with
// them: each warp's partial acc rows in sO [kSplits * BQ, DV + 8] (split j,
// tile row r at row j * BQ + r), m and l in sM and sL, then per row the
// weight of each partial in sW and the denominator in sDen.
template <int D, int DV, int BQ, int BK>
struct Merge {
  using T = TilesF32<D, DV, BQ, BK>;
  static constexpr int kParts = kWarps * 16;  // = kSplits * BQ
  float* sO;
  float* sM;
  float* sL;
  float* sW;    // [2 * kSplits][BQ]: the partials of both blocks of a pair
  float* sDen;  // [BQ]
  __device__ explicit Merge(float* smem)
      : sO(smem),
        sM(smem + kParts * T::kOPitch),
        sL(sM + kParts),
        sW(sL + kParts),
        sDen(sW + 2 * kParts) {}

  // this warp's (acc, m, l), l summed over the quad; the caller makes sure
  // every warp is done with the tiles first
  __device__ void store(const float (&acc)[DV / 8][4], const float (&m)[2],
                        float (&l)[2]) const {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int part = (warp / T::kGroups) * BQ + (warp % T::kGroups) * 16 + g;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<float2*>(sO + part * T::kOPitch + 8 * n + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(sO + (part + 8) * T::kOPitch + 8 * n +
                                 2 * t) = make_float2(acc[n][2], acc[n][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (t == 0) {
        sM[part + 8 * r] = m[r];
        sL[part + 8 * r] = l[r];
      }
    }
  }

  // rows [r_begin, r_begin + rows) of the q tile at q0 from the partials of
  // n_src blocks (src[c]: the c-th block's Merge, this one's or read from
  // the other block of the cluster): M = max m_j, out = sum_j exp(m_j - M)
  // acc_j / max(sum_j exp(m_j - M) l_j, 1e-30), over the first p.dv columns
  __device__ void combine(const Merge (&src)[2], int n_src, int r_begin,
                          int rows, int q0, float* ob,
                          const Params& p) const {
    const int tid = threadIdx.x;
    for (int r = r_begin + tid; r < r_begin + rows; r += kThreads) {
      float mmax = kNegInf;
      for (int c = 0; c < n_src; ++c) {
#pragma unroll
        for (int j = 0; j < T::kSplits; ++j) {
          mmax = fmaxf(mmax, src[c].sM[j * BQ + r]);
        }
      }
      float den = 0.0f;
      for (int c = 0; c < n_src; ++c) {
#pragma unroll
        for (int j = 0; j < T::kSplits; ++j) {
          const float w = exp2f(src[c].sM[j * BQ + r] - mmax);
          sW[(c * T::kSplits + j) * BQ + r] = w;
          den += w * src[c].sL[j * BQ + r];
        }
      }
      sDen[r] = fmaxf(den, 1e-30f);
    }
    __syncthreads();
    for (int i = tid; i < rows * DV / 4; i += kThreads) {
      const int r = r_begin + i / (DV / 4);
      const int c4 = (i % (DV / 4)) * 4;
      if (q0 + r >= p.sq || c4 >= p.dv) continue;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c = 0; c < n_src; ++c) {
#pragma unroll
        for (int j = 0; j < T::kSplits; ++j) {
          const float w = sW[(c * T::kSplits + j) * BQ + r];
          const float4 a = *reinterpret_cast<const float4*>(
              src[c].sO + (j * BQ + r) * T::kOPitch + c4);
          sum.x += w * a.x;
          sum.y += w * a.y;
          sum.z += w * a.z;
          sum.w += w * a.w;
        }
      }
      const float den = sDen[r];
      float* dst = ob + static_cast<long long>(q0 + r) * p.o_ss + c4;
      if (p.o_vec4) {  // whole 16-byte chunks of 16-byte aligned rows
        *reinterpret_cast<float4*>(dst) =
            make_float4(sum.x / den, sum.y / den, sum.z / den, sum.w / den);
      } else {  // the first dv columns, one by one
        const float out[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c4 + e < p.dv) dst[e] = out[e] / den;
        }
      }
    }
  }
};

// kv tiles a q tile walks: causal attention stops at the tile that holds
// its last row's diagonal (the tiles past it are wholly masked, so skipping
// them is exact)
template <int BQ, int BK>
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  const int k_end = p.causal ? min(p.skv, min(q0 + BQ, p.sq)) : p.skv;
  return (k_end + BK - 1) / BK;
}

// One block's work, the q tiles of cluster `pair` as its block `rank`.
// Causal: cluster c takes the light q tile c and the heavy q tile n_q - 1 -
// c, whose kv tiles sum to about the same for every c; rank 0 walks the
// first half of that sum (the heavy tile's first kv tiles), rank 1 the light
// tile and then the rest of the heavy one, and the two merge the heavy
// tile's partials through distributed shared memory, each storing half of
// its rows. A middle tile (odd n_q) is its own pair and is split the same
// way. Not causal: every q tile has the same work; each block takes one.
template <int D, int DV, int BQ, int BK>
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ o, const Params& p,
                                       int pair, int rank) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;
  float* ob = o + b * p.o_sb + h * p.o_sh;
  const int n_q = (p.sq + BQ - 1) / BQ;

  // this block's walks: (q tile, first kv tile, end kv tile, merged with
  // the other block of the cluster)
  int seg_q[2], seg_begin[2], seg_end[2];
  bool seg_pair[2];
  int n_seg = 0;
  if (!p.causal) {
    const int qt = 2 * pair + rank;
    if (qt >= n_q) return;  // the spare block of an odd n_q
    seg_q[0] = qt;
    seg_begin[0] = 0;
    seg_end[0] = kv_tiles<BQ, BK>(p, qt * BQ);
    seg_pair[0] = false;
    n_seg = 1;
  } else {
    const int light = pair;
    const int heavy = n_q - 1 - pair;
    const int n_heavy = kv_tiles<BQ, BK>(p, heavy * BQ);
    const int n_light = light < heavy ? kv_tiles<BQ, BK>(p, light * BQ) : 0;
    const int cut = min(n_heavy, (n_heavy + n_light + 1) / 2);
    if (rank == 1 && light < heavy) {
      seg_q[n_seg] = light;
      seg_begin[n_seg] = 0;
      seg_end[n_seg] = n_light;
      seg_pair[n_seg++] = false;
    }
    seg_q[n_seg] = heavy;
    seg_begin[n_seg] = rank == 0 ? 0 : cut;
    seg_end[n_seg] = rank == 0 ? cut : n_heavy;
    seg_pair[n_seg++] = true;
  }

  const Merge<D, DV, BQ, BK> mine(smem);
  for (int sg = 0; sg < n_seg; ++sg) {
    const int q0 = seg_q[sg] * BQ;
    float acc[DV / 8][4];
    float m[2], l[2];
    if (sg > 0) __syncthreads();  // the last merge is done with the tiles
    walk_kv<D, DV, BQ, BK>(qb, kb, vb, p, smem, q0, seg_begin[sg],
                           seg_end[sg], acc, m, l);
    __syncthreads();  // every warp is done with the tiles
    mine.store(acc, m, l);
    if (!seg_pair[sg]) {
      __syncthreads();
      const Merge<D, DV, BQ, BK> alone[2] = {mine, mine};
      mine.combine(alone, 1, 0, BQ, q0, ob, p);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // both blocks' partials of the tile are written
      const Merge<D, DV, BQ, BK> other(
          cluster.map_shared_rank(smem, rank ^ 1));
      const Merge<D, DV, BQ, BK> both[2] = {rank == 0 ? mine : other,
                                            rank == 0 ? other : mine};
      mine.combine(both, 2, rank * (BQ / 2), BQ / 2, q0, ob, p);
      cluster.sync();  // the other block is done reading these partials
    }
  }
}

// Blocks an SM the compiler leaves registers for: two at the narrowest
// class's smallest tile, 32 x 64 at (32, 32), whose thread fits in 128
// registers (two 256-thread blocks fill the register file; at 134 it ran
// one block an SM and 1.55x slower), one elsewhere.
template <int D, int DV, int BQ, int BK>
constexpr int kMinBlocks = D <= 32 && DV <= 32 && BQ == 32 && BK == 64 ? 2 : 1;

// The grid is (2 * ceil(n_q / 2), Hq, B) blocks in clusters of two along x
// (attend: cluster x / 2, rank x % 2).
template <int D, int DV, int BQ, int BK>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(kThreads, (kMinBlocks<D, DV, BQ, BK>))
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         const Params p) {
  attend<D, DV, BQ, BK>(q, k, v, o, p, blockIdx.x / 2, blockIdx.x % 2);
}

// ------------------------------------------------------ the chunked kernel
// Head dims above 256 (kernels/flash_attention.py:wide_split, wide_layout).
// q and k in chunks of kChunk columns, v in slices of DVS (128, 256 or 512)
// columns, one slice a block (one slice up to DV = 512).
constexpr int kChunk = 128;
constexpr int kWidePitch = kChunk + 16;  // rows of Q and K chunks (floats)
constexpr int kPiecePitch = kChunk + 4;  // rows of V pieces

// The shape of one block's work at tiles BQ x BK. S: 8 warps in kGroups row
// groups of 16 rows x kColGroups column groups of kCols kv columns; P V:
// each warp a range of DVS / 8 columns of O for all BQ rows. Bytes of a
// ring stage (BK rows of a K chunk, or of a 128-column V piece), a Q chunk
// (BQ rows), P (its two TF32 parts as the mma's A fragments) and the
// softmax's row statistics (each column group's max and sum, the rescale
// factor and the running sum of every row).
template <int BQ, int BK>
struct WideF32 {
  static constexpr int kGroups = BQ / 16;
  static constexpr int kColGroups = kWarps / kGroups;
  static constexpr int kCols = BK / kColGroups;
  static constexpr int kNT = kCols / 8;
  static constexpr size_t kSlot = 4ull * BK * kWidePitch;
  static constexpr size_t kQChunk = 4ull * BQ * kWidePitch;
  static constexpr size_t kP = 4ull * 2 * BQ * BK;
  static constexpr size_t kStats = 4ull * (2 * kColGroups + 2) * BQ;
  static_assert(BQ % 16 == 0 && kWarps % kGroups == 0 && kCols % 8 == 0,
                "tiles must give every warp 16 rows and 8k columns");
};

// A block's shared memory at (d, DVS): the ring of n_v + 2 stages (a tile
// holds n_v V pieces), P and the statistics; Q's chunks held for the whole
// walk where they fit in 227 KB, else two chunk buffers that Q streams
// through beside K. kernels/flash_attention.py:wide_layout states the same.
struct WideLayout {
  int chunks, n_v, stages;
  bool q_held;
  size_t bytes;
  template <int BQ, int BK>
  __host__ __device__ static WideLayout of(int d, int dvs) {
    using W = WideF32<BQ, BK>;
    WideLayout m;
    m.chunks = (d + kChunk - 1) / kChunk;
    m.n_v = dvs / kChunk;
    m.stages = m.n_v + 2;
    const size_t rest = W::kSlot * m.stages + W::kP + W::kStats;
    m.q_held = rest + W::kQChunk * m.chunks <= kSmemLimit;
    m.bytes = rest + W::kQChunk * (m.q_held ? m.chunks : 2);
    return m;
  }
};

// Wait until at most n of this thread's cp.async groups are in flight (n
// above 6 waits for 6).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// The chunked kernel, for head dims above 256. One block owns one (batch,
// q head, slice of DVS columns of v, q tile of BQ rows) and walks the kv
// tiles of BK rows: for each, S = Q K^T once, by all 8 warps together
// (each chunk's products summed on their own over kAcc chains, then added
// to S in chunk order: one chain over 1024 columns missed 2e-5), the
// online softmax across the warps of a row group through the row
// statistics, P split once into its TF32 parts and stored as the mma's A
// fragments, then acc += P V, each warp its DVS / 8 columns of O for all BQ
// rows (64 registers a thread at 32 x 32 and DVS = 512). K chunks and V
// pieces stream through one ring of cp.async copies, issued as far ahead
// as the ring has free stages; Q's chunks are copied once and held where
// they fit (WideLayout), else each is copied again beside its chunk of K,
// one chunk ahead. The grid runs heads and slices fastest and the q tiles
// from the last (the most causal work) to the first.
template <int DVS, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_chunked_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ o, const Params p) {
  using W = WideF32<BQ, BK>;
  constexpr int kNT = W::kNT;
  constexpr int kAcc = kNT >= 4 ? 1 : 4 / kNT;
  constexpr int kCw = DVS / kWarps;   // O columns a warp
  constexpr int kNO = kCw / 8;        // their n8 slices
  constexpr int kNH = kNO < 4 ? kNO : 4;
  constexpr int kCG = W::kColGroups;
  const WideLayout m = WideLayout::of<BQ, BK>(p.d, DVS);
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sRing = sQ + (m.q_held ? m.chunks : 2) * BQ * kWidePitch;
  uint4* sPb = reinterpret_cast<uint4*>(sRing + m.stages * BK * kWidePitch);
  uint4* sPs = sPb + BQ * BK / 4;
  float* sMax = reinterpret_cast<float*>(sPs + BQ * BK / 4);
  float* sSum = sMax + kCG * BQ;
  float* sCorr = sSum + kCG * BQ;
  float* sL = sCorr + BQ;

  const int h = blockIdx.x % p.hq;
  const int slice = blockIdx.x / p.hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh + slice * DVS;
  float* ob = o + b * p.o_sb + h * p.o_sh + slice * DVS;
  const int width_v = p.dv - slice * DVS;  // this slice's columns of v
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int per_tile = m.chunks + m.n_v;  // ring items a kv tile
  const int n_items = n_tiles * per_tile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // the mma's group: rows g, g + 8; column g of B
  const int tq = lane % 4;  // its thread in the group
  const int rg = warp % W::kGroups;  // S: this warp's row group ...
  const int cg = warp / W::kGroups;  // ... and column group

  // the ring: item i (K chunk c of tile t, or V piece) in stage i % stages;
  // every thread issues its share of every item as one commit group. A
  // cursor walks the items by steps (no division by the run-time counts)
  struct Cursor {
    int t, j, st;  // kv tile, item of the tile, stage
  };
  auto step = [&](Cursor& x) {
    if (++x.j == per_tile) {
      x.j = 0;
      ++x.t;
    }
    if (++x.st == m.stages) x.st = 0;
  };
  auto issue = [&](const Cursor& x) {
    float* slot = sRing + x.st * BK * kWidePitch;
    if (x.j < m.chunks) {
      copy_tile<kChunk, BK, kWidePitch>(slot, kb + x.j * kChunk, p.k_ss,
                                        x.t * BK, p.skv, p.d - x.j * kChunk,
                                        tid);
      if (!m.q_held) {
        copy_tile<kChunk, BQ, kWidePitch>(
            sQ + ((x.t * m.chunks + x.j) & 1) * BQ * kWidePitch,
            qb + x.j * kChunk, p.q_ss, q0, p.sq, p.d - x.j * kChunk, tid);
      }
    } else {
      const int c0 = (x.j - m.chunks) * kChunk;
      copy_tile<kChunk, BK, kPiecePitch>(slot, vb + c0, p.v_ss, x.t * BK,
                                         p.skv, width_v - c0, tid);
    }
    cp_async_commit();
  };
  // issue items while a stage is free (every item before `consumed` is
  // done with) and, where Q streams, its chunk buffer is free (the chunk
  // two before it is done with)
  int issued = 0;
  Cursor next = {0, 0, 0};
  auto fill = [&](int consumed, int chunks_done) {
    while (issued < n_items && issued < consumed + m.stages) {
      if (!m.q_held && next.j < m.chunks &&
          next.t * m.chunks + next.j > chunks_done + 1) {
        break;
      }
      issue(next);
      step(next);
      ++issued;
    }
  };

  if (m.q_held) {
    for (int c = 0; c < m.chunks; ++c) {
      copy_tile<kChunk, BQ, kWidePitch>(sQ + c * BQ * kWidePitch,
                                        qb + c * kChunk, p.q_ss, q0, p.sq,
                                        p.d - c * kChunk, tid);
    }
    cp_async_commit();
  }
  if (tid < BQ) sL[tid] = 0.0f;
  fill(0, 0);

  float acc[W::kGroups][kNO][4];
#pragma unroll
  for (int r = 0; r < W::kGroups; ++r) {
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][n][i] = 0.0f;
    }
  }
  float m_row[2] = {kNegInf, kNegInf};  // rows g, g + 8 of rg, log2 units
  const int row_a = rg * 16 + g;        // this thread's S rows in the tile
  // P V: this warp's O columns, their V piece and column in it
  const int piece = warp * kCw / kChunk;
  const int col_in = warp * kCw % kChunk;

  int st = 0;  // the stage of the next item to consume
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int item0 = t * per_tile;
    float s[kNT][4];
    for (int c = 0; c < m.chunks; ++c) {
      cp_async_wait_pending(issued - 1 - (item0 + c));
      __syncthreads();  // chunk c has landed; every warp is done before it
      fill(item0 + c, t * m.chunks + c);
      const float* qc = m.q_held
                            ? sQ + c * BQ * kWidePitch
                            : sQ + ((t * m.chunks + c) & 1) * BQ * kWidePitch;
      const float* q_a = qc + row_a * kWidePitch + 4 * tq;
      const float* k_row = sRing + st * BK * kWidePitch +
                           (cg * W::kCols + g) * kWidePitch + 4 * tq;
      if (++st == m.stages) st = 0;
      float sa[kAcc][kNT][4];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sa[a][j][i] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        // A fragments of the two k8 steps (rows g, g + 8; logical columns
        // t, t + 4 = columns 4t, 4t + 1, then 4t + 2, 4t + 3 of the 16)
        const float4 xa = *reinterpret_cast<const float4*>(q_a + 16 * kk);
        const float4 xb = *reinterpret_cast<const float4*>(
            q_a + 8 * kWidePitch + 16 * kk);
        uint32_t ab0[4], as0[4], ab1[4], as1[4];
        split(xa.x, ab0[0], as0[0]);
        split(xb.x, ab0[1], as0[1]);
        split(xa.y, ab0[2], as0[2]);
        split(xb.y, ab0[3], as0[3]);
        split(xa.z, ab1[0], as1[0]);
        split(xb.z, ab1[1], as1[1]);
        split(xa.w, ab1[2], as1[2]);
        split(xb.w, ab1[3], as1[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float4 kx = *reinterpret_cast<const float4*>(
              k_row + 8 * j * kWidePitch + 16 * kk);
          uint32_t kbig[4], ksmall[4];
          split(kx.x, kbig[0], ksmall[0]);
          split(kx.y, kbig[1], ksmall[1]);
          split(kx.z, kbig[2], ksmall[2]);
          split(kx.w, kbig[3], ksmall[3]);
          mma_3xtf32(sa[(2 * kk) % kAcc][j], ab0, as0, kbig[0], kbig[1],
                     ksmall[0], ksmall[1]);
          mma_3xtf32(sa[(2 * kk + 1) % kAcc][j], ab1, as1, kbig[2], kbig[3],
                     ksmall[2], ksmall[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = sa[0][j][i];
#pragma unroll
          for (int a = 1; a < kAcc; ++a) x += sa[a][j][i];
          s[j][i] = c == 0 ? x : s[j][i] + x;
        }
      }
    }

    // the online softmax: s[j][2r + c] is row row_a + 8r, kv column
    // k0 + cg kCols + 8j + 2t + c; a row's max over this warp's columns,
    // then over the row group's column groups through sMax
    const bool masked = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[j][2 * r + c] * p.scale_log2;
          if (masked) {
            const int kpos = k0 + cg * W::kCols + 8 * j + 2 * tq + c;
            if (kpos >= p.skv) {
              x = -INFINITY;  // past the sequence: no weight
            } else if (p.causal && kpos > q0 + row_a + 8 * r) {
              x = kNegInf;
            }
          }
          s[j][2 * r + c] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (tq == 0) sMax[cg * BQ + row_a + 8 * r] = mx[r];
    }
    __syncthreads();  // every column group's max is written; every K chunk
                      // of this tile is done with
    fill(item0 + m.chunks, (t + 1) * m.chunks);
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = m_row[r];
#pragma unroll
      for (int x = 0; x < kCG; ++x) {
        m_new = fmaxf(m_new, sMax[x * BQ + row_a + 8 * r]);
      }
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = exp2f(s[j][2 * r + c] - m_row[r]);
          s[j][2 * r + c] = e;
          sum[r] += e;
        }
      }
      // P's A fragment of kv step cg kNT + j for row group rg: rows g, g +
      // 8 at logical columns t, t + 4 = kv columns 2t, 2t + 1
      uint4 pb, ps;
      split(s[j][0], pb.x, ps.x);
      split(s[j][2], pb.y, ps.y);
      split(s[j][1], pb.z, ps.z);
      split(s[j][3], pb.w, ps.w);
      const int at = (rg * (BK / 8) + cg * kNT + j) * 32 + lane;
      sPb[at] = pb;
      sPs[at] = ps;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      if (tq == 0) {
        sSum[cg * BQ + row_a + 8 * r] = sum[r];
        if (cg == 0) sCorr[row_a + 8 * r] = corr[r];
      }
    }
    cp_async_wait_pending(issued - per_tile - item0);  // this tile's V
    __syncthreads();  // P, the statistics and the V pieces are written
    if (tid < BQ) {
      float l = sL[tid] * sCorr[tid];
#pragma unroll
      for (int x = 0; x < kCG; ++x) l += sSum[x * BQ + tid];
      sL[tid] = l;
    }

    // acc += P V over this warp's columns: V rows 2t and 2t + 1 of each
    // 8-row step, column 8n + g, split once for every row group
    const int v_st = st + piece < m.stages ? st + piece
                                           : st + piece - m.stages;
    const float* v_row = sRing + v_st * BK * kWidePitch +
                         2 * tq * kPiecePitch + col_in + g;
    st = st + m.n_v < m.stages ? st + m.n_v : st + m.n_v - m.stages;
#pragma unroll
    for (int r = 0; r < W::kGroups; ++r) {
      const float c0 = sCorr[r * 16 + g];
      const float c1 = sCorr[r * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        acc[r][n][0] *= c0;
        acc[r][n][1] *= c0;
        acc[r][n][2] *= c1;
        acc[r][n][3] *= c1;
      }
    }
    // one 8-row step at a time (unrolled, the steps' loads are hoisted
    // ahead of their products and spill at 64 x 32 and DVS = 512)
#pragma unroll 1
    for (int ks = 0; ks < BK / 8; ++ks) {
      const float* vr = v_row + 8 * ks * kPiecePitch;
      // V's fragments of kNH n8 slices at a time, each used by every row
      // group (at 64 x 32 and DVS = 512 all eight at once would spill)
#pragma unroll
      for (int n0 = 0; n0 < kNO; n0 += kNH) {
        uint32_t vb0[kNH], vs0[kNH], vb1[kNH], vs1[kNH];
#pragma unroll
        for (int n = 0; n < kNH; ++n) {
          split(vr[8 * (n0 + n)], vb0[n], vs0[n]);
          split(vr[kPiecePitch + 8 * (n0 + n)], vb1[n], vs1[n]);
        }
#pragma unroll
        for (int r = 0; r < W::kGroups; ++r) {
          const uint4 pb = sPb[(r * (BK / 8) + ks) * 32 + lane];
          const uint4 ps = sPs[(r * (BK / 8) + ks) * 32 + lane];
          const uint32_t a_big[4] = {pb.x, pb.y, pb.z, pb.w};
          const uint32_t a_small[4] = {ps.x, ps.y, ps.z, ps.w};
#pragma unroll
          for (int n = 0; n < kNH; ++n) {
            mma_3xtf32(acc[r][n0 + n], a_big, a_small, vb0[n], vb1[n],
                       vs0[n], vs1[n]);
          }
        }
      }
    }
  }
  __syncthreads();  // every row's sum is final

  // this warp's columns of every row: acc / l
#pragma unroll
  for (int r = 0; r < W::kGroups; ++r) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r * 16 + g + 8 * half;
      if (q0 + row >= p.sq) continue;
      const float den = fmaxf(sL[row], 1e-30f);
      float* orow = ob + static_cast<long long>(q0 + row) * p.o_ss;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        const int c = warp * kCw + 8 * n + 2 * tq;
        const float x0 = acc[r][n][2 * half] / den;
        const float x1 = acc[r][n][2 * half + 1] / den;
        if (p.o_vec4 && c + 1 < width_v) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(x0, x1);
        } else {
          if (c < width_v) orow[c] = x0;
          if (c + 1 < width_v) orow[c + 1] = x1;
        }
      }
    }
  }
}

template <int D, int DV, int BQ, int BK>
int launch(const float* q, const float* k, const float* v, float* o,
           const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = TilesF32<D, DV, BQ, BK>::kSmem;
  if constexpr (smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kernel = flash_fwd_f32_kernel<D, DV, BQ, BK>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_q = (p.sq + BQ - 1) / BQ;
    const dim3 grid(2 * ((n_q + 1) / 2), p.hq, batch);
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int DVS, int BQ, int BK>
int launch_chunked(const float* q, const float* k, const float* v, float* o,
                   const Params& p, int batch, cudaStream_t stream) {
  const WideLayout m = WideLayout::of<BQ, BK>(p.d, DVS);
  if (m.bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // set at every launch, as launch() does
  auto kernel = flash_fwd_f32_chunked_kernel<DVS, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long x = static_cast<long long>(p.hq) * ((p.dv + DVS - 1) / DVS);
  const int n_q = (p.sq + BQ - 1) / BQ;
  if (x > 0x7fffffffLL || n_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(x), n_q, batch);
  kernel<<<grid, kThreads, m.bytes, stream>>>(q, k, v, o, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int by_tile(int block_q, int block_k, const float* q, const float* k,
            const float* v, float* o, const Params& p, int batch,
            cudaStream_t s) {
#define REPRO_FLASH_TILE(BQ, BK)              \
  if (block_q == BQ && block_k == BK)         \
    return launch<D, DV, BQ, BK>(q, k, v, o, p, batch, s);
  REPRO_FLASH_TILE(32, 64)
  REPRO_FLASH_TILE(32, 128)
  REPRO_FLASH_TILE(64, 64)
  REPRO_FLASH_TILE(64, 128)
  REPRO_FLASH_TILE(128, 64)
  REPRO_FLASH_TILE(128, 128)
#undef REPRO_FLASH_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The head-dim classes, split over three files of about equal build time:
// by_class_narrow (flash_attention.cu) takes the squares 32 and 64,
// by_class_mid (flash_attention_f32_mid.cu) 96 and 128, by_class_wide
// (flash_attention_f32_wide.cu) 160, 192, (192, 128) and 256. Each returns
// cudaErrorInvalidValue for a class or tile it does not build.
using ByClass = int (*)(int dc, int dvc, int block_q, int block_k,
                        const float* q, const float* k, const float* v,
                        float* o, const Params& p, int batch, cudaStream_t s);
int by_class_narrow(int dc, int dvc, int block_q, int block_k,
                    const float* q, const float* k, const float* v, float* o,
                    const Params& p, int batch, cudaStream_t s);
int by_class_mid(int dc, int dvc, int block_q, int block_k, const float* q,
                 const float* k, const float* v, float* o, const Params& p,
                 int batch, cudaStream_t s);
int by_class_wide(int dc, int dvc, int block_q, int block_k, const float* q,
                  const float* k, const float* v, float* o, const Params& p,
                  int batch, cudaStream_t s);
// The chunked kernel (flash_attention_f32_chunked.cu) at slice class dvs
// (128, 256 or 512, kernels/flash_attention.py:wide_split), tiles 32 x 32
// and 64 x 32.
int by_slice_chunked(int dvs, int block_q, int block_k, const float* q,
                     const float* k, const float* v, float* o,
                     const Params& p, int batch, cudaStream_t s);

}  // namespace repro_flash_f32
