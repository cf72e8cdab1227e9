"""internlm2-1.8b — dense 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

Counterpart: ``repro/configs/internlm2_1_8b.py``.

GQA [arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    source="arXiv:2403.17297; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256
)
