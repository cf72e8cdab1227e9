"""Block-scaled int8 matmul (Proteus arithmetic engine): CUDA kernel and
plain version."""
from repro_torch.kernels.quant_matmul.kernel import (LAUNCHES, plan,
                                                     quant_matmul_kernel)
from repro_torch.kernels.quant_matmul.ops import quant_matmul, quantize_weights
from repro_torch.kernels.quant_matmul.ref import (dequantize_ref,
                                                  quant_matmul_ref,
                                                  quantize_weights_ref)

__all__ = ["LAUNCHES", "plan", "quant_matmul", "quantize_weights",
           "quant_matmul_kernel", "quant_matmul_ref", "quantize_weights_ref",
           "dequantize_ref"]
