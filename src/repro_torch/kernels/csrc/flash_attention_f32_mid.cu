// Flash attention, forward, f32 (3xTF32 on the tensor cores) at the middle
// head-dim classes: (96, 96) and (128, 128). The kernel is in
// flash_attention_f32.cuh; its entry point and the narrow classes are in
// flash_attention.cu, the wide ones in flash_attention_f32_wide.cu. A file
// of its own so that nvcc builds a third of the instantiations in parallel
// with the others.
#include "flash_attention_f32.cuh"

namespace repro_flash_f32 {

int by_class_mid(int dc, int dvc, int block_q, int block_k, const float* q,
                 const float* k, const float* v, float* o, const Params& p,
                 int batch, cudaStream_t s) {
#define REPRO_FLASH_CLASS(D, DV)                                      \
  if (dc == D && dvc == DV)                                           \
    return by_tile<D, DV>(block_q, block_k, q, k, v, o, p, batch, s);
  REPRO_FLASH_CLASS(96, 96)
  REPRO_FLASH_CLASS(128, 128)
#undef REPRO_FLASH_CLASS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_flash_f32
