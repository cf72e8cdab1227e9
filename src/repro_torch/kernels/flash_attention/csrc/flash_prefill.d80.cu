// The prefill kernels' instantiations at head dim 80 (flash_prefill.cuh):
// the bf16 route's warp-specialised kernel (kv tiles of 64 rows in a ring
// of 4 stages, 2 blocks an SM) and the fp32 route, a translation unit of
// their own, linked into the flash_prefill library.
#include "flash_prefill.cuh"

namespace repro_prefill {
REPRO_PREFILL_DIM(80, 64, 4, 2)
}  // namespace repro_prefill
