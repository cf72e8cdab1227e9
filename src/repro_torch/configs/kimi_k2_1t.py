"""kimi-k2-1t-a32b — MoE 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840.

Counterpart: ``repro/configs/kimi_k2_1t.py``.

MoE 384 experts top-8 — trillion-param (paper-table) [arXiv:2501.kimi2; unverified]

Memory budget note (see EXPERIMENTS.md §Dry-run): ~1T parameters cannot hold
12 B/param Adam state in 512 x 16 GB HBM; config therefore selects bf16 params +
Adafactor (factored second moment), fully sharded over (pod, data, model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    capacity_factor=1.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
    source="arXiv:2501.kimi2; unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    param_dtype="float32",
    optimizer="adamw",
)
