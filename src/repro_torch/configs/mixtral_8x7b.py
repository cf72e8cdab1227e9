"""mixtral-8x7b — MoE 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Counterpart: ``repro/configs/mixtral_8x7b.py``.

MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    attention_kind="sliding",
    sliding_window=4096,
    microbatches_hint=8,   # MoE backward working set; see EXPERIMENTS §Dry-run
    source="arXiv:2401.04088; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    sliding_window=64,
)
