// Flash attention, forward, bf16 and f16 (wgmma fed by TMA) at head dims
// above 256: the chunked kernel of flash_attention_sm90.cuh at its slice
// classes 64, 128 and 256, 64 x 64 tiles, both element types. Its entry
// point is in flash_attention_sm90.cu. A file of its own so that nvcc
// builds these instantiations in parallel with the others.
#include "flash_attention_sm90.cuh"

namespace repro_flash_sm90 {

template int by_slice_chunked<ElemBf16>(int, int, int, const Call&,
                                        cudaStream_t);
template int by_slice_chunked<ElemF16>(int, int, int, const Call&,
                                       cudaStream_t);

}  // namespace repro_flash_sm90
