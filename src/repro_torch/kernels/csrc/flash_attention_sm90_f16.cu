// Flash attention, forward, f16 (wgmma fed by TMA) at the narrow head-dim
// classes: the squares 32, 64, 96, 128 and 160, at every tile bf16 has. The
// kernel is in flash_attention_sm90.cuh, its entry point in
// flash_attention_sm90.cu. A file of its own so that nvcc builds these
// instantiations in parallel with the others.
#include "flash_attention_sm90.cuh"

namespace repro_flash_sm90 {

template int by_class_narrow<ElemF16>(int, int, int, int, const Call&,
                                      cudaStream_t);

}  // namespace repro_flash_sm90
