"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart: ``repro/kernels``)."""
from typing import Dict, List

# counters that count launches already counted under another name: the
# fp32 prefill route's (under flash_attention_fwd), the bh adapter's calls
# (their launches are the prefill kernel's) and the RG-LRU backward's
# (under rglru_scan). A kernel entry reports once a launch under the other
# name (kernels/accounting.py).
SUBCOUNTS = {"flash_attention_fwd_fp32": "flash_attention_fwd",
             "flash_attention_bh": "flash_attention_fwd",
             "rglru_scan_bwd": "rglru_scan"}


def launch_counters() -> List[Dict[str, int]]:
    """The ``LAUNCHES`` counter of every kernel module (kernel name ->
    launches)."""
    from repro_torch.kernels.flash_attention.kernel import LAUNCHES as attn
    from repro_torch.kernels.narrow_value.kernel import LAUNCHES as nv
    from repro_torch.kernels.quant_matmul.kernel import LAUNCHES as qmm
    from repro_torch.kernels.rglru.kernel import LAUNCHES as rglru
    return [attn, rglru, nv, qmm]
