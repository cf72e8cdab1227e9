"""xlstm-125m — ssm 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304
(counterpart: ``repro/configs/xlstm_125m.py``).

sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]
d_ff=0: projections live inside the mLSTM/sLSTM blocks (no separate FFN).
Recurrent state is O(1) in sequence length.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,                 # layers 3, 7, 11 are sLSTM; rest mLSTM
    microbatches_hint=8,           # sLSTM time-scan residuals scale with B_loc
    scan_layers=False,             # heterogeneous blocks; 12 layers unrolled
    source="arXiv:2405.04517; unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256,
    slstm_every=4,
)
