"""RG-LRU linear recurrence: CUDA kernel and plain version."""
from repro_torch.kernels.rglru.kernel import LAUNCHES, rglru_scan_kernel
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref

__all__ = ["LAUNCHES", "rglru_scan", "rglru_scan_kernel", "rglru_scan_ref"]
