"""Model / shape configuration dataclasses (counterpart: ``repro/configs/base.py``).

A copy, not an import: the port imports nothing of ``repro``. Field names,
defaults and meanings are those of the reference, so a config built here and
one built there describe the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple


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
    def is_subquadratic(self) -> bool:
        """Whether the arch can decode 500k tokens: a bounded state
        (hybrid, ssm) or a sliding window."""
        return (self.family in ("hybrid", "ssm")
                or (self.attention_kind == "sliding"
                    and self.sliding_window > 0))

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


# the reference's four LM shape cells
TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, mode="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, mode="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, mode="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, mode="decode")
SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class RunConfig:
    """Training / serving run options (launcher-level)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    # distribution
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    microbatches: int = 0            # 0 = auto; >1 grad accumulation / PP chunks
    pipeline_stages: int = 0         # >0 enables PP over the 'pod' axis
    # proteus runtime
    proteus_enabled: bool = False
    proteus_grad_bits: int = 8       # quantized all-reduce payload width
    proteus_block: int = 256         # per-block scale granularity
    # checkpointing
    checkpoint_dir: str = ""
    checkpoint_every: int = 200
    keep_checkpoints: int = 3

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding + blocks + head), as the
    reference counts it: an ``ssm`` (xLSTM) layer as ``4 d^2 + 2 d``; every
    other layer as an attention block with a gated MLP (the hybrid family's
    too), or with ``num_experts`` of them and the router (MoE); an
    encoder-decoder adds its encoder layers (attention + gated MLP) and a
    cross-attention per decoder layer. The head is counted unless
    ``tie_embeddings`` (xLSTM's too, though its logits read the embedding);
    final norms and the decoder's cross-attention norms are left out."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
    if cfg.family == "ssm":
        total_blocks = cfg.num_layers * (4 * d * d + 2 * d)
    else:
        if cfg.num_experts > 0:
            ffn = 3 * d * cfg.d_ff * cfg.num_experts + d * cfg.num_experts
        else:
            ffn = 3 * d * cfg.d_ff
        total_blocks = cfg.num_layers * (attn + ffn + 2 * d)
        if cfg.is_encoder_decoder:
            total_blocks += cfg.num_encoder_layers * (
                attn + 3 * d * cfg.d_ff + 2 * d)
            total_blocks += cfg.num_layers * attn
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return cfg.vocab_size * d + head + total_blocks
