from repro_torch.kernels.flash_attention.kernel import (LAUNCHES,
                                                        flash_attention_fwd,
                                                        flash_decode_fwd)
from repro_torch.kernels.flash_attention.ops import (flash_attention_gqa_fwd,
                                                     flash_decode)

__all__ = ["LAUNCHES", "flash_attention_fwd", "flash_decode_fwd",
           "flash_attention_gqa_fwd", "flash_decode"]
