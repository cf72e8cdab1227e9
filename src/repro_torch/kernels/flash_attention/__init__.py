from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES, flash_attention_bh, flash_attention_fwd, flash_decode_fwd,
    flash_decode_paged_fwd, flash_decode_paged_quant_fwd,
    flash_decode_quant_fwd)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_gqa_fwd, flash_decode, flash_decode_paged,
    flash_decode_paged_quant, flash_decode_quant)
from repro_torch.kernels.flash_attention.ref import attention_ref_bh

__all__ = ["LAUNCHES", "flash_attention_fwd", "flash_decode_fwd",
           "flash_decode_quant_fwd", "flash_decode_paged_fwd",
           "flash_decode_paged_quant_fwd", "flash_attention_bh",
           "flash_attention_gqa_fwd", "flash_decode", "flash_decode_quant",
           "flash_decode_paged", "flash_decode_paged_quant",
           "attention_ref_bh"]
