from repro_torch.configs.base import (TRAIN_4K, ModelConfig, RunConfig,
                                     ShapeConfig, param_count)
from repro_torch.configs.registry import ALL_IDS, get_config

__all__ = ["ModelConfig", "ShapeConfig", "RunConfig", "TRAIN_4K",
           "param_count", "ALL_IDS", "get_config"]
