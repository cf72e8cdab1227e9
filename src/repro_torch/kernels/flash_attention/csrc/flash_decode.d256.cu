// The decode kernel's instantiations at head dim 256 (flash_decode.cuh),
// a translation unit of their own, linked into the flash_decode library.
#include "flash_decode.cuh"

namespace repro_decode {
REPRO_DECODE_DIM(256)
}  // namespace repro_decode
