"""recurrentgemma-2b, the hybrid Griffin model: 26 layers, d_model 2560, 10 q
heads over 1 kv head, d_ff 7680, vocab 256000 (counterpart:
``repro/configs/recurrentgemma_2b.py``).

RG-LRU recurrence plus local attention, two recurrent layers to one
attention layer [arXiv:2402.19427; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    attention_kind="hybrid_local",
    local_window=2048,
    conv_width=4,
    logit_softcap=30.0,
    source="arXiv:2402.19427; hf",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=5,  # pattern (r, r, a) + 2 trailing recurrent
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    local_window=32,
)
