from repro_torch.models.bridge import load_jax_params, reference_tree
from repro_torch.models.model import TransformerLM, build_model
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.recurrent_lm import GriffinLM, XLSTMLM
from repro_torch.models.module import (count_params, init_params,
                                      init_params_, param_specs)

__all__ = ["TransformerLM", "GriffinLM", "XLSTMLM", "EncDecLM", "build_model", "init_params",
           "init_params_", "param_specs", "count_params", "load_jax_params",
           "reference_tree"]
