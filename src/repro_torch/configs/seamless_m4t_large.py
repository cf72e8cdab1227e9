"""seamless-m4t-large-v2 — enc-dec 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 (counterpart: ``repro/configs/seamless_m4t_large.py``).

Encoder-decoder, multimodal (audio) [arXiv:2308.11596; hf]
Modality frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (batch, src_len, d_model) as encoder input; the text decoder decodes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,                # decoder layers
    num_encoder_layers=24,        # encoder layers
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    src_len_ratio=1.0,
    source="arXiv:2308.11596; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
)
