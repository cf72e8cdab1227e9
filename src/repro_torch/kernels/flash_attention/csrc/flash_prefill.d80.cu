// The prefill kernels' instantiations at head dim 80 (flash_prefill.cuh):
// the bf16 route (kv tiles of 128 rows, 1 block an SM) and the fp32 route,
// a translation unit of their own, linked into the flash_prefill library.
#include "flash_prefill.cuh"

namespace repro_prefill {
REPRO_PREFILL_DIM(80, 128, 1)
}  // namespace repro_prefill
