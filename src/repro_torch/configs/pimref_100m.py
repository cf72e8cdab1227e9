"""pimref-100m, the framework's own ~100M-param reference LM
(counterpart: ``repro/configs/pimref_100m.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pimref-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32768,
    source="this work",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256
)
