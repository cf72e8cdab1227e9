"""Parameter specs and initialisation (counterpart: ``repro/models/module.py``
and the spec functions of ``repro/models/model.py``).

Names follow the reference's parameter keys, flattened with dots, with the
stacked ``blocks`` / ``groups`` axis unrolled and list indices spelled out:
``embed``, ``final_norm``, ``head``, ``blocks.<i>.attn.w_q``, ... (dense,
MoE and VLM; an MoE block holds ``moe.router`` and the stacked experts
``moe.wi_gate`` ... in place of ``mlp.*``);
``groups.<g>.rec1.rec.w_x``, ``groups.<g>.attn.attn.w_q``,
``tail.<i>.mlp.wo``, ... (hybrid, specs in ``recurrent_lm.py``);
``blocks.<i>.ln``, ``blocks.<i>.mlstm.w_q``, ``blocks.<i>.slstm.w_z``, ...
(ssm, the reference's list of unlike blocks; specs in ``recurrent_lm.py``
and ``xlstm.py``); ``enc_blocks.<i>.attn.w_q``, ``enc_norm``,
``dec_blocks.<i>.self_attn.w_q``, ``dec_blocks.<i>.cross_attn.w_q``, ...
(audio, both stacks unrolled; specs in ``encdec.py``).

``init_params`` is the port's own initialisation (it does not reproduce
``jax.random``) with the reference's init kinds: ``ones``, ``zeros``,
``rglru_lambda`` (``logit(u)``, ``u ~ U[0.9, 0.999]``, so that the RG-LRU's
decay ``sigmoid(lam)`` starts where Griffin starts it) and
``normal / sqrt(fan_in)`` with fan-in read off the axis the reference names
for it (``w_o``: the heads axis; the stacked experts of an MoE block: axis
1; all others: axis 0) of the per-layer shape.
The reference applies the same axis to its layer-stacked shape, where axis 0
is the layer axis; weights for parity tests come through ``bridge.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a "normal" leaf of more elements is drawn this many at a time, so that its
# fp32 draw never takes more than 1 GB beside the leaf (kimi-k2's expert
# leaves: 5.6 G elements, 22.5 GB as one fp32 draw). Such a leaf's values
# are those of its parts' draws, not those of one draw of its shape: with
# a CUDA generator they need not agree (Philox offsets advance per call),
# with a CPU one they agree only where every part is a multiple of 16 long
INIT_CHUNK = 1 << 28


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class ParamSpec(NamedTuple):
    """One parameter: its per-layer shape and dtype, the reference's
    logical axis name of each dim (``None``: never sharded; the MIMDRAM
    planner maps names to mesh axes, ``core/mimdram.py``) and its init
    recipe."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical_axes: Tuple[Optional[str], ...]
    init: Tuple = ("normal",)      # ("normal"[, fan_in_axis]) | ("ones",) |
    #                                ("zeros",) | ("rglru_lambda",)


def norm_spec(cfg: ModelConfig) -> ParamSpec:
    """An RMSNorm scale: (d_model,) fp32 ones, never sharded."""
    return ParamSpec((cfg.d_model,), torch.float32, (None,), ("ones",))


def embed_spec(cfg: ModelConfig, dtype) -> ParamSpec:
    return ParamSpec((cfg.vocab_size, cfg.d_model), dtype, ("vocab", "embed"))


def head_spec(cfg: ModelConfig, dtype) -> ParamSpec:
    return ParamSpec((cfg.d_model, cfg.vocab_size), dtype, ("embed", "vocab"))


def attn_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d, hq, hkv, dh = (cfg.d_model, cfg.tp_pad_heads or cfg.num_heads,
                      cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "w_q": ParamSpec((d, hq, dh), dtype, ("embed", "heads", "head_dim")),
        "w_k": ParamSpec((d, hkv, dh), dtype, ("embed", "kv", "head_dim")),
        "w_v": ParamSpec((d, hkv, dh), dtype, ("embed", "kv", "head_dim")),
        "w_o": ParamSpec((hq, dh, d), dtype, ("heads", "head_dim", "embed"),
                         ("normal", 0)),
    }


def mlp_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), dtype, ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), dtype, ("embed", "mlp")),
        "wo": ParamSpec((f, d), dtype, ("mlp", "embed")),
    }


def moe_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    """``router`` (D, E) and the stacked experts ``wi_gate`` / ``wi_up``
    (E, D, F) and ``wo`` (E, F, D), fan-in on axis 1 of the expert
    weights."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), dtype, ("embed", "expert")),
        "wi_gate": ParamSpec((e, d, f), dtype, ("expert", "embed", "mlp"),
                             ("normal", 1)),
        "wi_up": ParamSpec((e, d, f), dtype, ("expert", "embed", "mlp"),
                           ("normal", 1)),
        "wo": ParamSpec((e, f, d), dtype, ("expert", "mlp", "embed"),
                        ("normal", 1)),
    }


def block_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    dtype = torch_dtype(cfg.param_dtype)
    specs = {"ln1": norm_spec(cfg), "ln2": norm_spec(cfg)}
    specs.update({f"attn.{k}": s for k, s in attn_param_specs(cfg, dtype).items()})
    if cfg.num_experts > 0:
        specs.update({f"moe.{k}": s
                      for k, s in moe_param_specs(cfg, dtype).items()})
    else:
        specs.update({f"mlp.{k}": s
                      for k, s in mlp_param_specs(cfg, dtype).items()})
    return specs


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Flat ``name -> ParamSpec`` of the model of ``cfg``, in a fixed
    order."""
    # the other families' modules import this one
    if cfg.family == "hybrid":
        from repro_torch.models.recurrent_lm import griffin_param_specs
        return griffin_param_specs(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.recurrent_lm import xlstm_param_specs
        return xlstm_param_specs(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_param_specs
        return encdec_param_specs(cfg)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown model family {cfg.family!r}")
    dtype = torch_dtype(cfg.param_dtype)
    specs = {"embed": embed_spec(cfg, dtype), "final_norm": norm_spec(cfg)}
    for i in range(cfg.num_layers):
        specs.update({f"blocks.{i}.{k}": s for k, s in block_specs(cfg).items()})
    if not cfg.tie_embeddings:
        specs["head"] = head_spec(cfg, dtype)
    return specs


def init_tensor(s: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One parameter, drawn on the generator's device."""
    dev = generator.device
    if s.init[0] == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=dev)
    if s.init[0] == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)
    if s.init[0] == "rglru_lambda":
        # RG-LRU lambda: a = sigmoid(lam) uniform in [0.9, 0.999] (Griffin
        # section 2.4), stored as logit(u)
        u = 0.9 + 0.099 * torch.rand(s.shape, generator=generator,
                                     dtype=torch.float32, device=dev)
        return (torch.log(u) - torch.log1p(-u)).to(s.dtype)
    if s.init[0] == "normal":
        fan_axis = s.init[1] if len(s.init) > 1 else 0
        scale = 1.0 / math.sqrt(max(s.shape[fan_axis], 1))
        # a leaf of at most INIT_CHUNK elements: the values of one draw of
        # its shape; a larger one: those of its parts' draws (INIT_CHUNK)
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
        for part in out.view(-1).split(INIT_CHUNK):
            part.copy_(torch.randn(part.numel(), generator=generator,
                                   dtype=torch.float32, device=dev) * scale)
        return out
    raise ValueError(f"unknown init {s.init!r}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """A state dict for ``build_model(cfg)``, drawn in spec order from
    ``generator`` and placed on ``device``."""
    return {name: init_tensor(s, generator).to(device)
            for name, s in param_specs(cfg).items()}


def param_pspecs(specs: Any, plan) -> Any:
    """``specs`` (a dict or tree of :class:`ParamSpec`) with each leaf
    replaced by its sharding under ``plan`` (a ``core.mimdram.Plan``):
    ``plan.spec(*logical_axes, dims=shape)``, per dim ``None``, a mesh axis
    name or a tuple of them (counterpart: the reference's
    ``module.param_pspecs``). The port's specs are per layer; a stacked
    leaf of the reference has the same spec after a leading ``None``."""
    return tree_map(lambda s: plan.spec(*s.logical_axes, dims=s.shape),
                    specs, is_leaf=lambda x: isinstance(x, ParamSpec))


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for s in param_specs(cfg).values())


@torch.no_grad()
def init_params_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw the parameters of ``model`` in place, in spec order from
    ``generator``: the values of ``init_params(model.cfg, generator, ...)``,
    one tensor at a time, so the peak memory is the model's plus its largest
    parameter rather than two copies of the model."""
    own = dict(model.named_parameters())
    specs = param_specs(model.cfg)
    if set(own) != set(specs):
        raise KeyError(f"parameters differ from the specs: "
                       f"{sorted(set(own) ^ set(specs))}")
    for name, s in specs.items():
        own[name].copy_(init_tensor(s, generator))
