"""The shapes of a model's inputs (counterpart: ``repro/launch/specs.py``,
``input_specs``).

Only the batch template is ported: the inputs a prefill or training batch
of one shape cell holds, which ``serve()``, ``ServeEngine`` and the data
pipeline build their batches from. A ``vlm`` batch reserves a patch prefix
of ``P = min(num_patches, S // 2)`` positions inside the sequence:
``tokens`` (B, S - P) and ``patch_embeds`` (B, P, d_model); an
``audio`` batch adds the encoder's frames ``src_embeds`` (B,
``int(S * src_len_ratio)``, d_model). The
reference's decode template and dry-run helpers (partition specs, cache
stand-ins) are not ported.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, InputSpec]:
    """The batch template of one (arch x shape) cell of mode ``prefill`` or
    ``train``."""
    if shape.mode not in ("prefill", "train"):
        raise ValueError(f"mode {shape.mode!r}: only the prefill and train "
                         "templates are ported")
    B, S = shape.global_batch, shape.seq_len

    def tok(*s):
        return InputSpec(tuple(s), torch.int32)

    batch = {"tokens": tok(B, S)}
    if shape.mode == "train":
        batch["labels"] = tok(B, S)
    if cfg.family == "vlm":
        P = min(cfg.num_patches, S // 2)
        batch["tokens"] = tok(B, S - P)
        if shape.mode == "train":
            batch["labels"] = tok(B, S - P)
        batch["patch_embeds"] = InputSpec((B, P, cfg.d_model), torch.float32)
    if cfg.family == "audio":
        batch["src_embeds"] = InputSpec(
            (B, int(S * cfg.src_len_ratio), cfg.d_model), torch.float32)
    return batch
