// The decode kernel's instantiations at head dim 112 (flash_decode.cuh,
// namespace wide), a translation unit of their own, linked into the
// flash_decode library.
#include "flash_decode.cuh"

namespace repro_decode {
REPRO_DECODE_DIM_WIDE(112)
}  // namespace repro_decode
