from repro_torch.configs.base import ModelConfig, ShapeConfig, param_count
from repro_torch.configs.registry import ALL_IDS, get_config

__all__ = ["ModelConfig", "ShapeConfig", "param_count", "ALL_IDS",
           "get_config"]
