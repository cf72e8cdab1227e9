"""Model / shape configuration dataclasses (counterpart: ``repro/configs/base.py``).

A copy, not an import: the port imports nothing of ``repro``. Field names,
defaults and meanings are those of the reference, so a config built here and
one built there describe the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters."""

    name: str
    family: str                      # dense | moe | hybrid | audio | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1
    # --- attention ---
    attention_kind: str = "full"     # full | sliding | hybrid_local
    sliding_window: int = 0
    rope_theta: float = 10_000.0
    # --- hybrid / ssm ---
    local_window: int = 2048
    conv_width: int = 4
    rglru_c: float = 8.0
    slstm_every: int = 0
    # --- enc-dec ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    src_len_ratio: float = 1.0
    # --- vlm ---
    num_patches: int = 0
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # --- distribution defaults ---
    remat: str = "block"
    optimizer: str = "adamw"
    scan_layers: bool = True
    microbatches_hint: int = 0
    # --- perf knobs ---
    attn_block_skip: bool = False
    tp_pad_heads: int = 0
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    def replace(self, **kw: Any) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count of a dense decoder (embedding + blocks +
    head), as the reference counts it: the final norm's scale is left out."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
    blk = attn + 3 * d * cfg.d_ff + 2 * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return cfg.vocab_size * d + head + cfg.num_layers * blk
