"""Narrow-value detection and int4 nibble packing: CUDA kernels and plain
versions."""
from repro_torch.kernels.narrow_value.kernel import (LAUNCHES,
                                                     pack_int4_kernel,
                                                     required_bits_kernel,
                                                     unpack_int4_kernel)
from repro_torch.kernels.narrow_value.ops import (pack_int4, required_bits,
                                                  unpack_int4)
from repro_torch.kernels.narrow_value.ref import (magnitude_width,
                                                  pack_int4_ref,
                                                  required_bits_ref,
                                                  unpack_int4_ref)

__all__ = ["LAUNCHES", "required_bits", "pack_int4", "unpack_int4",
           "required_bits_kernel", "pack_int4_kernel", "unpack_int4_kernel",
           "required_bits_ref", "pack_int4_ref", "unpack_int4_ref",
           "magnitude_width"]
