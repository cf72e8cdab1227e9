from repro_torch.models.bridge import load_jax_params
from repro_torch.models.model import TransformerLM, build_model
from repro_torch.models.module import count_params, init_params, param_specs

__all__ = ["TransformerLM", "build_model", "init_params", "param_specs",
           "count_params", "load_jax_params"]
