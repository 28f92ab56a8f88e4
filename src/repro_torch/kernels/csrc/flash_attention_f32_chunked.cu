// Flash attention, forward, f32 (3xTF32 on the tensor cores) at head dims
// above 256: the chunked kernel of flash_attention_f32.cuh at its slice
// classes 128, 256 and 512, tiles 32 x 32 and 64 x 32. Its entry point is
// in flash_attention.cu. A file of its own so that nvcc builds these
// instantiations in parallel with the others.
#include "flash_attention_f32.cuh"

namespace repro_flash_f32 {

int by_slice_chunked(int dvs, int block_q, int block_k, const float* q,
                     const float* k, const float* v, float* o,
                     const Params& p, int batch, cudaStream_t s) {
#define REPRO_FLASH_SLICE(DVS, BQ, BK)                                  \
  if (dvs == DVS && block_q == BQ && block_k == BK)                     \
    return launch_chunked<DVS, BQ, BK>(q, k, v, o, p, batch, s);
  REPRO_FLASH_SLICE(128, 32, 32)
  REPRO_FLASH_SLICE(128, 64, 32)
  REPRO_FLASH_SLICE(256, 32, 32)
  REPRO_FLASH_SLICE(256, 64, 32)
  REPRO_FLASH_SLICE(512, 32, 32)
  REPRO_FLASH_SLICE(512, 64, 32)
#undef REPRO_FLASH_SLICE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_flash_f32
