"""RG-LRU linear recurrence: CUDA kernel, plain version and the
recurrence under autograd."""
from repro_torch.kernels.rglru.kernel import LAUNCHES, rglru_scan_kernel
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.rglru.autograd import RglruScanFn

__all__ = ["LAUNCHES", "RglruScanFn", "rglru_scan", "rglru_scan_bwd_ref",
           "rglru_scan_kernel", "rglru_scan_ref"]
