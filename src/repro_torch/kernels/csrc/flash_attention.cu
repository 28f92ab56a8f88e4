// Flash attention, forward, f32 (3xTF32 on the tensor cores): the C entry
// point of both flash paths, and the f32 kernel at the narrow head-dim
// classes (the squares 32 and 64). The kernel, its design and what it
// replaces are in flash_attention_f32.cuh; the wider classes are built by
// flash_attention_f32_mid.cu and flash_attention_f32_wide.cu, head dims
// above 256 by flash_attention_f32_chunked.cu, and bf16 and f16 inputs go
// to the wgmma kernel of flash_attention_sm90.cu.
#include "flash_attention_f32.cuh"

namespace repro_flash_f32 {

int by_class_narrow(int dc, int dvc, int block_q, int block_k, const float* q,
                    const float* k, const float* v, float* o, const Params& p,
                    int batch, cudaStream_t s) {
#define REPRO_FLASH_CLASS(D, DV)                                      \
  if (dc == D && dvc == DV)                                           \
    return by_tile<D, DV>(block_q, block_k, q, k, v, o, p, batch, s);
  REPRO_FLASH_CLASS(32, 32)
  REPRO_FLASH_CLASS(64, 64)
#undef REPRO_FLASH_CLASS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_flash_f32

namespace {

// The head-dim classes both kernels are built for: every width up to 256
// rounds up to the least of these; a (D, DV) pair to its two classes where
// that pair is built (the squares and (192, 128)), else to the square class
// of the larger. kernels/flash_attention.py:head_dim_class states the same
// rule.
constexpr int kClasses[] = {32, 64, 96, 128, 160, 192, 256};
constexpr int kMaxClass = 256;

int width_class(int x) {
  for (int c : kClasses) {
    if (x <= c) return c;
  }
  return 0;
}

void head_dim_class(int d, int dv, int* dc, int* dvc) {
  *dc = width_class(d);
  *dvc = width_class(dv);
  if (*dc != *dvc && !(*dc == 192 && *dvc == 128)) {
    *dc = *dvc = *dc > *dvc ? *dc : *dvc;
  }
}

// A pair with a width above 256 runs on the chunked kernels: q and k in
// chunks (of 128 columns), v in n = ceil(DV / 512) slices, each at the
// least slice class of 128, 256 and 512 that holds ceil(DV / n) columns (a
// block holds every column of its slice). kernels/flash_attention.py:
// wide_split states the same rule.
constexpr int kMaxSlice = 512;

int wide_slice_class(int dv) {
  const int n = (dv + kMaxSlice - 1) / kMaxSlice;
  const int width = (dv + n - 1) / n;
  return width <= 128 ? 128 : width <= 256 ? 256 : 512;
}

}  // namespace

using repro_flash_f32::by_class_mid;
using repro_flash_f32::by_class_narrow;
using repro_flash_f32::by_class_wide;
using repro_flash_f32::by_slice_chunked;
using repro_flash_f32::ByClass;
using repro_flash_f32::kLog2e;
using repro_flash_f32::Params;

// flash_attention_sm90.cu: the bf16 and f16 path, same arguments, the
// element type, and the class or (for a width above 256) the slice class
int repro_flash_attention_sm90(int dtype, const void* q, const void* k,
                               const void* v, void* o, int batch, int hq,
                               int hkv, int sq, int skv, int d, int dv,
                               int dc, int dvc, int dvs, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, long long o_sb,
                               long long o_ss, long long o_sh, int causal,
                               float scale, int block_q, int block_k,
                               cudaStream_t stream);

// q [B, Sq, Hq, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, DV], o [B, Sq, Hq,
// DV], each given by its base pointer and its (batch, seq, head) strides in
// elements; the last dim is contiguous, bases are 16-byte aligned and
// strides multiples of 16 bytes (the wrapper copies a tensor that is not);
// o is contiguous. Any D, DV >= 1: up to 256 each computed at its head-dim
// class (head_dim_class), wider on the chunked kernels (wide_slice_class).
// dtype 0 = float32 (the 3xTF32 kernel), 1 = bfloat16 and 2 = float16 (the
// wgmma kernel). Hq is a multiple of Hkv. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (or cudaErrorInvalidValue for
// shapes, tiles or types that are not instantiated).
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int batch, int hq, int hkv, int sq, int skv, int d, int dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, float scale, int block_q, int block_k, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || batch > 65535 || hq > 65535 || d < 1 || dv < 1 ||
      dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = d > kMaxClass || dv > kMaxClass;
  int dc = 0, dvc = 0, dvs = 0;
  if (wide) {
    dvs = wide_slice_class(dv);
  } else {
    head_dim_class(d, dv, &dc, &dvc);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) {
    return repro_flash_attention_sm90(
        dtype, q, k, v, o, batch, hq, hkv, sq, skv, d, dv, dc, dvc, dvs,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
        o_sh, causal, scale, block_q, block_k, s);
  }
  const Params p{hq,   hkv,  sq,   skv,  d,    dv,   q_sb,
                 q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                 v_sh, o_sb, o_ss, o_sh, scale * kLog2e,
                 causal != 0, dv % 4 == 0};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (wide) {
    return by_slice_chunked(dvs, block_q, block_k, qf, kf, vf, of, p, batch,
                            s);
  }
  const int widest = dc > dvc ? dc : dvc;
  const ByClass by_class = widest <= 64    ? by_class_narrow
                           : widest <= 128 ? by_class_mid
                                           : by_class_wide;
  return by_class(dc, dvc, block_q, block_k, qf, kf, vf, of, p, batch, s);
}
