// Flash attention, forward, bf16 and f16 (wgmma fed by TMA) at head dims
// above 256: the chunked kernel of flash_attention_sm90.cuh at its slice
// classes 128, 256 and 512, 64 x 64 tiles, both element types. Its entry
// point is in flash_attention_sm90.cu. A file of its own so that nvcc
// builds these instantiations in parallel with the others.
#include "flash_attention_sm90.cuh"

namespace repro_flash_sm90 {

template int by_slice_chunked<ElemBf16>(int, int, int, const Call&,
                                        cudaStream_t);
template int by_slice_chunked<ElemF16>(int, int, int, const Call&,
                                       cudaStream_t);

}  // namespace repro_flash_sm90

#ifdef REPRO_FLASH_PHASES
// The phase probes' sums (flash_attention_sm90.cuh, kPhaseSlots): copied
// into `out` (16 values), or set to 0 where `reset`.
extern "C" int repro_flash_phases(unsigned long long* out, int reset) {
  constexpr size_t kBytes =
      sizeof(unsigned long long) * 2 * repro_flash_sm90::kPhaseSlots;
  if (reset) {
    unsigned long long zero[2 * repro_flash_sm90::kPhaseSlots] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(repro_flash_sm90::g_phase_cycles, zero, kBytes));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, repro_flash_sm90::g_phase_cycles, kBytes));
}
#endif
