"""The paper's contributions in the port (counterpart: ``repro/core``):

- :mod:`repro_torch.core.damov`   -- workload characterization of a step
- :mod:`repro_torch.core.mimdram` -- fine-grained mesh-resource allocation
- :mod:`repro_torch.core.proteus` -- data-aware dynamic-precision runtime
  (its host half)
- :mod:`repro_torch.core.dappa`   -- data-parallel pattern framework
"""
from repro_torch.core import damov, dappa, mimdram, proteus

__all__ = ["damov", "dappa", "mimdram", "proteus"]
