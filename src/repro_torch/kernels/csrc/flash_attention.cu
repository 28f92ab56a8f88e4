// Flash attention, forward — blocked online-softmax attention for Hopper,
// f32 inputs on the CUDA cores; the C entry point of both paths.
//
// Replaces: src/repro/kernels/flash_attention.py, functions `_flash_kernel` /
// `flash_attention` (the Pallas kernel of the reference package), and the
// GQA expansion of its wrapper `ops.flash_attention_op`. bf16 inputs go to
// the tensor-core kernel of flash_attention_sm90.cu
// (`repro_flash_attention_sm90`); this file holds the f32 kernel.
//
// What it computes, per (batch, q head) and query row:
//   s = (q . k^T) * scale            (f32 products and sums)
//   s = -1e30 where causal and kpos > qpos   (positions counted from 0 in
//                                     both q and kv: top-left aligned)
//   out = softmax(s) . v             (f32 accumulate, stored in q's type)
// with the reference's online softmax: a running max m, a running sum l and
// an f32 accumulator, rescaled by exp(m_prev - m_new) at every kv tile, and
// out = acc / max(l, 1e-30) at the end. GQA: the kv head of q head h is
// h / (Hq / Hkv); K and V are indexed, never repeated.
//
// Design. On the TPU the kv axis is the innermost, sequential grid axis and
// (m, l, acc) carry across grid steps in VMEM scratch. Here one thread block
// owns one (batch, head, q tile) and walks the kv tiles itself: the Q tile
// stays in shared memory for the whole walk, each K/V tile is copied in
// once, m and l live in shared memory (one entry per row), the accumulator
// in registers (a 256-thread block is a 16 x 16 grid; thread (ty, tx) owns
// rows ty + 16i and columns tx + 16j of S and of the output tile). Rows are
// padded by one 32-bit word so that the 16 threads of a half-warp that read
// 16 different K rows at one column hit 16 different banks. Tiles past the
// end of the sequence are masked (rows past Sq are not stored, kv columns
// past Skv get no weight), so a tile larger than the sequence, or a ragged
// last tile, runs the same arithmetic as a smaller block would.
//
// Causal attention skips the kv tiles that lie wholly above the diagonal of
// the q tile. Every score in them is masked, so they would add
// exp(-1e30 - m) = 0 to l and acc and rescale by exp(0) = 1: skipping is
// exact, and it halves the work at Sq == Skv. The reference evaluates them.
//
// Numerics: f32 inputs are multiplied and summed in f32 on the CUDA cores
// (fmaf; no TF32, no tensor cores), which the f32 contract of 2e-5 needs.
//
// What bounds it on this card: operations. At head dim 128 a (64 x 64) tile
// pair does 2 * 64 * 64 * 256 flops on 2 * 64 * 128 elements of K and V, so
// device memory is far from the limit; the CUDA cores are, and within them
// the shared-memory reads of the inner products (one Q and one K value read
// per four to sixteen FMAs, by tile). Larger tiles read shared memory less
// often per FMA; the f32 (128 x 128) tile does not fit in 227 KB.
//
// block_q and block_k are template parameters: every (block_q, block_k)
// pair in {32, 64, 128} x {64, 128} is instantiated, for head dims 64, 128
// and 160; a tile whose shared memory exceeds 227 KB fails at launch. The
// wrapper's `unsupported` states the same rules and refuses anything else
// before it launches.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;  // threads along a tile's columns
constexpr int kTY = 16;  // threads along a tile's rows
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most a block can have

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Shared memory of one block: Q and K tiles with padded rows, the V tile,
// S / P as f32 with padded rows, and m, l and the rescale factor per row.
// kernels/flash_attention.py:smem_bytes repeats this formula.
template <typename T, int D, int BQ, int BK>
struct Smem {
  static constexpr int kPitch = D + 4 / static_cast<int>(sizeof(T));
  static constexpr int kPPitch = BK + 1;
  static constexpr size_t kBytes =
      sizeof(T) * (static_cast<size_t>(BQ) * kPitch +
                   static_cast<size_t>(BK) * kPitch +
                   static_cast<size_t>(BK) * D) +
      sizeof(float) * (static_cast<size_t>(BQ) * kPPitch + 3 * BQ);
};

struct Params {
  int hq, hkv, sq, skv;
  long long q_sb, q_ss, q_sh;  // strides (elements) of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int RQ = BQ / kTY;  // rows a thread owns
  constexpr int CK = BK / kTX;  // S columns a thread owns
  constexpr int CD = D / kTX;   // output columns a thread owns
  constexpr int kPitch = Smem<T, D, BQ, BK>::kPitch;
  constexpr int kPPitch = Smem<T, D, BQ, BK>::kPPitch;
  static_assert(BQ % kTY == 0 && BK % kTX == 0 && D % kTX == 0,
                "tiles must be multiples of the 16 x 16 thread grid");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * kPitch;
  T* sV = sK + BK * kPitch;
  float* sP = reinterpret_cast<float*>(sV + BK * D);
  float* sM = sP + BQ * kPPitch;
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + hk * p.k_sh;
  const T* vb = v + b * p.v_sb + hk * p.v_sh;
  T* ob = o + b * p.o_sb + h * p.o_sh;
  const T zero = from_f32<T>(0.0f);

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    sQ[r * kPitch + c] =
        (q0 + r < p.sq) ? qb[static_cast<long long>(q0 + r) * p.q_ss + c]
                        : zero;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }
  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.0f;
  }

  // causal: the kv tiles past the q tile's last row are wholly masked
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of sK, sV and sP are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < p.skv;
      const long long row = static_cast<long long>(k0 + r);
      sK[r * kPitch + c] = in ? kb[row * p.k_ss + c] : zero;
      sV[r * D + c] = in ? vb[row * p.v_ss + c] : zero;
    }
    __syncthreads();

    // S = Q K^T * scale for this thread's RQ x CK entries
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ];
      float kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = to_f32(sQ[(ty + i * kTY) * kPitch + d]);
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = to_f32(sK[(tx + j * kTX) * kPitch + d]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + i * kTY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + j * kTX;
        const int kpos = k0 + c;
        float x = s[i][j] * p.scale;
        if (kpos >= p.skv) {
          x = __int_as_float(0xff800000);  // past the sequence: -inf, no weight
        } else if (p.causal && kpos > q0 + r) {
          x = kNegInf;
        }
        sP[r * kPPitch + c] = x;
      }
    }
    __syncthreads();

    // online softmax, one warp per row: m_new, p = exp(s - m_new), l, corr
    for (int r = warp; r < BQ; r += kWarps) {
      float* row = sP + r * kPPitch;
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float corr = sC[ty + i * kTY];
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ];
      float vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = sP[(ty + i * kTY) * kPPitch + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = to_f32(sV[c * D + tx + j * kTX]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // the last row statistics are written

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + i * kTY;
    if (q0 + r >= p.sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = ob + static_cast<long long>(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < CD; ++j) orow[tx + j * kTX] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D, BQ, BK>::kBytes;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_tile(int block_q, int block_k, const void* q, const void* k,
            const void* v, void* o, const Params& p, int batch,
            cudaStream_t s) {
#define REPRO_FLASH_TILE(BQ, BK)                                 \
  if (block_q == BQ && block_k == BK)                            \
    return launch<T, D, BQ, BK>(q, k, v, o, p, batch, s);
  REPRO_FLASH_TILE(32, 64)
  REPRO_FLASH_TILE(32, 128)
  REPRO_FLASH_TILE(64, 64)
  REPRO_FLASH_TILE(64, 128)
  REPRO_FLASH_TILE(128, 64)
  REPRO_FLASH_TILE(128, 128)
#undef REPRO_FLASH_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_head_dim(int d, int block_q, int block_k, const void* q,
                const void* k, const void* v, void* o, const Params& p,
                int batch, cudaStream_t s) {
  if (d == 64) return by_tile<T, 64>(block_q, block_k, q, k, v, o, p, batch, s);
  if (d == 128) return by_tile<T, 128>(block_q, block_k, q, k, v, o, p, batch, s);
  if (d == 160) return by_tile<T, 160>(block_q, block_k, q, k, v, o, p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// flash_attention_sm90.cu: the bf16 path, same arguments
int repro_flash_attention_sm90(const void* q, const void* k, const void* v,
                               void* o, int batch, int hq, int hkv, int sq,
                               int skv, int d, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, long long o_sb, long long o_ss,
                               long long o_sh, int causal, float scale,
                               int block_q, int block_k, cudaStream_t stream);

// q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], o [B, Sq, Hq, D], each given
// by its base pointer and its (batch, seq, head) strides in elements; the
// last dim is contiguous. dtype 0 = float32 (this file's kernel), 1 =
// bfloat16 (the tensor-core kernel). Hq is a multiple of Hkv. Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes, tiles or types that are not
// instantiated).
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int batch, int hq, int hkv, int sq, int skv, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, float scale, int block_q, int block_k, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || batch > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return repro_flash_attention_sm90(
        q, k, v, o, batch, hq, hkv, sq, skv, d, q_sb, q_ss, q_sh, k_sb, k_ss,
        k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, scale, block_q,
        block_k, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{hq, hkv, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal != 0};
  return by_head_dim<float>(d, block_q, block_k, q, k, v, o, p, batch, s);
}
