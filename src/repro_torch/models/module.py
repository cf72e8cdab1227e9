"""Parameter specs and initialisation of the dense decoder (counterpart:
``repro/models/module.py`` and the spec functions of ``repro/models/model.py``).

Names follow the reference's parameter keys, flattened with dots and with
the stacked ``blocks`` axis unrolled: ``embed``, ``final_norm``, ``head``,
``blocks.<i>.ln1``, ``blocks.<i>.attn.w_q``, ``blocks.<i>.mlp.wi_gate``, ...

``init_params`` is the port's own initialisation (it does not reproduce
``jax.random``): norm scales are ones, every other weight is
``normal / sqrt(fan_in)`` with fan-in read off the axis the reference names
for it (``w_o``: the heads axis, all others: axis 0) of the per-layer shape.
The reference applies the same axis to its layer-stacked shape, where axis 0
is the layer axis; weights for parity tests come through ``bridge.py``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Tuple = ("normal",)      # ("normal"[, fan_in_axis]) | ("ones",)


def attn_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d, hq, hkv, dh = (cfg.d_model, cfg.tp_pad_heads or cfg.num_heads,
                      cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "w_q": ParamSpec((d, hq, dh), dtype),
        "w_k": ParamSpec((d, hkv, dh), dtype),
        "w_v": ParamSpec((d, hkv, dh), dtype),
        "w_o": ParamSpec((hq, dh, d), dtype, ("normal", 0)),
    }


def mlp_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), dtype),
        "wi_up": ParamSpec((d, f), dtype),
        "wo": ParamSpec((f, d), dtype),
    }


def block_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    dtype = torch_dtype(cfg.param_dtype)
    specs = {
        "ln1": ParamSpec((cfg.d_model,), torch.float32, ("ones",)),
        "ln2": ParamSpec((cfg.d_model,), torch.float32, ("ones",)),
    }
    specs.update({f"attn.{k}": s for k, s in attn_param_specs(cfg, dtype).items()})
    specs.update({f"mlp.{k}": s for k, s in mlp_param_specs(cfg, dtype).items()})
    return specs


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Flat ``name -> ParamSpec`` of a dense decoder, in a fixed order."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is ported in a later slice")
    dtype = torch_dtype(cfg.param_dtype)
    specs = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model), dtype),
             "final_norm": ParamSpec((cfg.d_model,), torch.float32, ("ones",))}
    for i in range(cfg.num_layers):
        specs.update({f"blocks.{i}.{k}": s for k, s in block_specs(cfg).items()})
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype)
    return specs


def init_tensor(s: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One parameter, drawn on the generator's device."""
    dev = generator.device
    if s.init[0] == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=dev)
    if s.init[0] == "normal":
        fan_axis = s.init[1] if len(s.init) > 1 else 0
        scale = 1.0 / math.sqrt(max(s.shape[fan_axis], 1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * scale).to(s.dtype)
    raise ValueError(f"unknown init {s.init!r}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """A state dict for ``TransformerLM(cfg)``, drawn in spec order from
    ``generator`` and placed on ``device``."""
    return {name: init_tensor(s, generator).to(device)
            for name, s in param_specs(cfg).items()}


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for s in param_specs(cfg).values())
