// Flash attention, forward, bf16 (wgmma fed by TMA): the bf16 path of the C
// entry point repro_flash_attention (flash_attention.cu), and the kernel at
// the narrow head-dim classes (the squares 32, 64, 96, 128 and 160). The
// kernel, its design and what it replaces are in flash_attention_sm90.cuh;
// the wide classes are built by flash_attention_sm90_wide.cu.
#include "flash_attention_sm90.cuh"

namespace repro_flash_sm90 {

int by_class_narrow(int dc, int dvc, int block_q, int block_k, const Call& c,
                    cudaStream_t s) {
#define REPRO_FLASH_SM90_CLASS(D, DV) \
  if (dc == D && dvc == DV) return by_tile<D, DV>(block_q, block_k, c, s);
  REPRO_FLASH_SM90_CLASS(32, 32)
  REPRO_FLASH_SM90_CLASS(64, 64)
  REPRO_FLASH_SM90_CLASS(96, 96)
  REPRO_FLASH_SM90_CLASS(128, 128)
  REPRO_FLASH_SM90_CLASS(160, 160)
#undef REPRO_FLASH_SM90_CLASS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_flash_sm90

using repro_flash_sm90::by_class_narrow;
using repro_flash_sm90::by_class_wide;
using repro_flash_sm90::Call;
using repro_flash_sm90::kLog2e;
using repro_flash_sm90::Params;

// The bf16 path of repro_flash_attention (flash_attention.cu), same
// arguments, plus the head-dim class (dc, dvc) that flash_attention.cu's
// head_dim_class picked for the true head dims (d, dv). Every base pointer
// is 16-byte aligned and every stride of a dim longer than 1 is a multiple
// of 8 elements (TMA's rule; the wrapper copies a tensor that breaks it).
// Tiles (block_q, block_k) in {64, 128} x {64, 128} where kBuilt; classes
// (32, 32), (64, 64), (96, 96), (128, 128), (160, 160), (192, 192),
// (256, 256) (64 x 64 only) and (192, 128) (MLA prefill: qk_nope +
// qk_rope = 192, v_head_dim = 128).
int repro_flash_attention_sm90(const void* q, const void* k, const void* v,
                               void* o, int batch, int hq, int hkv, int sq,
                               int skv, int d, int dv, int dc, int dvc,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long o_sb, long long o_ss, long long o_sh,
                               int causal, float scale, int block_q,
                               int block_k, cudaStream_t stream) {
  const Call c{q,    k,    v,    o,    batch, d,    q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb,  v_ss, v_sh,
               Params{hq, hkv, sq, skv, dv, o_sb, o_ss, o_sh, scale * kLog2e,
                      causal != 0}};
  return (dc <= 160 && dvc <= 160 ? by_class_narrow : by_class_wide)(
      dc, dvc, block_q, block_k, c, stream);
}
