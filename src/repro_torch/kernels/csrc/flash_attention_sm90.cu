// Flash attention, forward, bf16 and f16 (wgmma fed by TMA): the path of the
// C entry point repro_flash_attention (flash_attention.cu) for 2-byte
// inputs, and the bf16 kernel at the narrow head-dim classes (the squares
// 32, 64, 96, 128 and 160). The kernel, its design and what it replaces are
// in flash_attention_sm90.cuh; the other instantiations are built by
// flash_attention_sm90_wide.cu (bf16 at the wide classes),
// flash_attention_sm90_f16.cu and flash_attention_sm90_f16_wide.cu (f16),
// and flash_attention_sm90_chunked.cu (head dims above 256).
#include "flash_attention_sm90.cuh"

namespace repro_flash_sm90 {

template int by_class_narrow<ElemBf16>(int, int, int, int, const Call&,
                                       cudaStream_t);

}  // namespace repro_flash_sm90

using repro_flash_sm90::by_class_narrow;
using repro_flash_sm90::by_class_wide;
using repro_flash_sm90::by_slice_chunked;
using repro_flash_sm90::Call;
using repro_flash_sm90::ElemBf16;
using repro_flash_sm90::ElemF16;
using repro_flash_sm90::kLog2e;
using repro_flash_sm90::Params;

// The 2-byte path of repro_flash_attention (flash_attention.cu), same
// arguments, plus the element type (dtype 1 = bf16, 2 = f16) and what
// flash_attention.cu picked for the true head dims (d, dv): the head-dim
// class (dc, dvc), or for a head dim above 256 the chunked kernel's slice
// class dvs (64, 128 or 256; 0 for a narrow call). Every base pointer is
// 16-byte aligned and every stride of a dim longer than 1 is a multiple of
// 8 elements (TMA's rule; the wrapper copies a tensor that breaks it).
// Tiles (block_q, block_k) in {64, 128} x {64, 128} where kBuilt; classes
// (32, 32), (64, 64), (96, 96), (128, 128), (160, 160), (192, 192),
// (256, 256) (64 x 64 only) and (192, 128) (MLA prefill: qk_nope +
// qk_rope = 192, v_head_dim = 128); the chunked kernel at 64 x 64.
int repro_flash_attention_sm90(int dtype, const void* q, const void* k,
                               const void* v, void* o, int batch, int hq,
                               int hkv, int sq, int skv, int d, int dv,
                               int dc, int dvc, int dvs, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, long long o_sb,
                               long long o_ss, long long o_sh, int causal,
                               float scale, int block_q, int block_k,
                               cudaStream_t stream) {
  const Call c{q,    k,    v,    o,    batch, q_sb, q_ss, q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss,  v_sh,
               Params{hq, hkv, sq, skv, dv, o_sb, o_ss, o_sh, scale * kLog2e,
                      causal != 0, d}};
  const bool f16 = dtype == 2;
  if (dvs != 0) {
    return (f16 ? by_slice_chunked<ElemF16> : by_slice_chunked<ElemBf16>)(
        dvs, block_q, block_k, c, stream);
  }
  const bool narrow = dc <= 160 && dvc <= 160;
  if (f16) {
    return (narrow ? by_class_narrow<ElemF16> : by_class_wide<ElemF16>)(
        dc, dvc, block_q, block_k, c, stream);
  }
  return (narrow ? by_class_narrow<ElemBf16> : by_class_wide<ElemBf16>)(
      dc, dvc, block_q, block_k, c, stream);
}
