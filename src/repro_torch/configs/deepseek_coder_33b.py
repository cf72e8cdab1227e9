"""deepseek-coder-33b — dense 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.

Counterpart: ``repro/configs/deepseek_coder_33b.py``.

llama-arch [arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    source="arXiv:2401.14196; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, d_ff=160, vocab_size=256
)
