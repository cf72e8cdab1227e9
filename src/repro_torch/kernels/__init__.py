"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart: ``repro/kernels``)."""
from typing import Dict, List


def launch_counters() -> List[Dict[str, int]]:
    """The ``LAUNCHES`` counter of every kernel module (kernel name ->
    launches)."""
    from repro_torch.kernels.flash_attention.kernel import LAUNCHES as attn
    from repro_torch.kernels.narrow_value.kernel import LAUNCHES as nv
    from repro_torch.kernels.quant_matmul.kernel import LAUNCHES as qmm
    from repro_torch.kernels.rglru.kernel import LAUNCHES as rglru
    return [attn, rglru, nv, qmm]
