"""pixtral-12b — vlm 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

Counterpart: ``repro/configs/pixtral_12b.py``.

pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409; unverified]
ViT frontend is a STUB: ``input_specs()`` provides precomputed patch embeddings
(batch, num_patches, d_model) prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    num_patches=1024,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_patches=8,
)
