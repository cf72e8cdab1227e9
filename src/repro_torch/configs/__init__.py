from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                     SHAPES, SHAPES_BY_NAME, TRAIN_4K,
                                     ModelConfig, RunConfig, ShapeConfig,
                                     param_count)
from repro_torch.configs.registry import ALL_IDS, get_config

__all__ = ["ModelConfig", "ShapeConfig", "RunConfig", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "SHAPES",
           "SHAPES_BY_NAME", "param_count", "ALL_IDS", "get_config"]
