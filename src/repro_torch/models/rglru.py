"""RG-LRU recurrent temporal-mixing block of Griffin / RecurrentGemma
(counterpart: ``repro/models/rglru.py``).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * sigmoid(r_t))

Prefill and training run the recurrence through
``kernels.rglru.autograd.RglruScanFn`` (the CUDA kernel on the card, its
plain version on the CPU; the backward is the same op run backwards in
time); a one-token decode step is the elementwise update, as in the
reference. ``p`` maps parameter
names to weights in compute dtype, except ``lam``, which stays fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru.autograd import RglruScanFn
from repro_torch.models.layers import dense
from repro_torch.models.module import ParamSpec

State = Dict[str, torch.Tensor]


def rglru_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d, w = cfg.d_model, cfg.conv_width
    return {
        # gated two-branch temporal block (Griffin recurrent block)
        "w_gate": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_x": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "conv_w": ParamSpec((w, d), dtype, ("conv", "mlp")),
        "conv_b": ParamSpec((d,), dtype, ("mlp",), ("zeros",)),
        "lam": ParamSpec((d,), torch.float32, ("mlp",), ("rglru_lambda",)),
        "w_input_gate": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_rec_gate": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_out": ParamSpec((d, d), dtype, ("mlp", "embed")),
    }


def _gates(cfg: ModelConfig, p, xb: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log a_t and the gated input branch, both fp32. xb: (B, S, D)."""
    r = dense(xb, p["w_rec_gate"], "bsd,de->bse").float()
    i = dense(xb, p["w_input_gate"], "bsd,de->bse").float()
    lam = p["lam"].float()
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus switches to x
    # above a threshold of 20, which lam (logit of [0.9, 0.999], about 2.2
    # to 6.9) never reaches, but logaddexp keeps the reference's formula
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -cfg.rglru_c * softplus * torch.sigmoid(r)
    a2 = torch.exp(2.0 * log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * torch.sigmoid(i)
             * xb.float())
    return log_a, gated


def rglru_scan(cfg: ModelConfig, p, xb: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a whole block. xb: (B, S, D) -> (out in xb's
    dtype, h_last (B, D) fp32). ``h0`` (serving from a cached state, never
    under autograd) folds into ``b[:, 0]`` in place."""
    log_a, b = _gates(cfg, p, xb)
    a = torch.exp(log_a)
    if h0 is not None:
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    h = RglruScanFn.apply(a, b)
    return h.to(xb.dtype), h[:, -1].contiguous()


def rglru_step(cfg: ModelConfig, p, xb: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode step. xb: (B, 1, D), h: (B, D) fp32 state."""
    log_a, b = _gates(cfg, p, xb)
    h_new = torch.exp(log_a[:, 0]) * h + b[:, 0]
    return h_new[:, None, :].to(xb.dtype), h_new


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W in x's dtype, taps summed in order
    0..W-1, then the bias. x: (B, S, D); state: (B, W-1, D)."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+W-1, D)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    out = out + b.to(x.dtype)
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return out, new_state


def recurrent_block(cfg: ModelConfig, p, x: torch.Tensor,
                    state: Optional[State] = None
                    ) -> Tuple[torch.Tensor, State]:
    """Griffin recurrent temporal-mixing block (gated two-branch).

    x: (B, S, D). state: {"h": (B, D) fp32, "conv": (B, W-1, D)} or None.
    """
    gate = F.gelu(dense(x, p["w_gate"], "bsd,de->bse"), approximate="tanh")
    xb = dense(x, p["w_x"], "bsd,de->bse")
    conv_state = None if state is None else state["conv"]
    xb, new_conv = causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    if state is None:
        y, h_last = rglru_scan(cfg, p, xb, None)
    elif x.shape[1] == 1:
        y, h_last = rglru_step(cfg, p, xb, state["h"])
    else:
        y, h_last = rglru_scan(cfg, p, xb, state["h"])
    out = dense(gate * y, p["w_out"], "bse,ed->bsd")
    return out, {"h": h_last, "conv": new_conv}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> State:
    d, w = cfg.d_model, cfg.conv_width
    return {
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, w - 1, d), dtype=dtype, device=device),
    }
