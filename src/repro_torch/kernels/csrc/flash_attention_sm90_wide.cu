// Flash attention, forward, bf16 (wgmma fed by TMA) at the wide head-dim
// classes: (192, 192), (192, 128) and (256, 256). The kernel is in
// flash_attention_sm90.cuh; its entry point and the narrow classes are in
// flash_attention_sm90.cu. A file of its own so that nvcc builds the two
// halves of the instantiations in parallel.
#include "flash_attention_sm90.cuh"

namespace repro_flash_sm90 {

int by_class_wide(int dc, int dvc, int block_q, int block_k, const Call& c,
                  cudaStream_t s) {
#define REPRO_FLASH_SM90_CLASS(D, DV) \
  if (dc == D && dvc == DV) return by_tile<D, DV>(block_q, block_k, c, s);
  REPRO_FLASH_SM90_CLASS(192, 192)
  REPRO_FLASH_SM90_CLASS(192, 128)
  REPRO_FLASH_SM90_CLASS(256, 256)
#undef REPRO_FLASH_SM90_CLASS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_flash_sm90
