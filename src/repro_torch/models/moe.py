"""Mixture-of-Experts FFN (counterpart: ``repro/models/moe.py``), the
thesis's MIMDRAM MIMD-segment showcase: experts are independent programs
over their own slice of the tokens.

Dispatch is the reference's capacity-bounded scatter / gather: top-k
routing, each (token, choice) given its position in its expert's buffer by
a cumulative count over the ``T * k`` choices in token order, choices past
the capacity ``C`` dropped. There is one dispatch group, as the reference
has off a mesh (its ``_dispatch_plan`` returns ``(1, (), None)``); capacity
is shared by all ``B * S`` tokens of a call, pads and free engine slots
included.

Two choices keep it the reference's on every device and inside a captured
CUDA graph (no host sync):

* top-k by a stable descending sort, so equal probabilities pick the lower
  expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises no order
  among ties);
* the scatter writes kept choices at ``(expert, pos)``, which are distinct,
  and every dropped one at a trash slot ``C`` that is sliced off. The
  reference adds dropped tokens' zeros onto slot ``C - 1``; kept rows come
  out the same, and no write is an accumulation.

The three expert products are batched matmuls in the compute dtype with
fp32 accumulation, as the reference's einsums are.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            // cfg.num_experts)
    return max(c, cfg.experts_per_token)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """Routing of ``xt`` (T, D): (probs (T, E) fp32, gate (T, K) fp32, idx
    (T, K), pos (T, K) int64, keep (T, K) bool). ``pos`` counts the earlier
    choices of the same expert in token-major, choice-minor order."""
    E, K = cfg.num_experts, cfg.experts_per_token
    T = xt.shape[0]
    logits = dense(xt, router, "td,de->te").float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    oh = F.one_hot(idx.reshape(T * K), num_classes=E)
    pos = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(-1).reshape(T, K)
    return probs, gate, idx, pos, pos < _capacity(cfg, T)


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): dropped-token, capacity-bounded top-k MoE.
    ``p`` maps ``router``, ``wi_gate``, ``wi_up``, ``wo`` to weights (cast
    to x's dtype here)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    xt = x.reshape(T, D)
    _, gate, idx, pos, keep = route(cfg, p["router"], xt)
    slot = torch.where(keep, pos, C)            # dropped: the trash slot C
    buf = x.new_zeros((E, C + 1, D))
    buf[idx, slot] = xt[:, None, :].expand(T, K, D)
    buf = buf[:, :C]
    w = {n: p[n].to(x.dtype) for n in ("wi_gate", "wi_up", "wo")}
    g = torch.bmm(buf, w["wi_gate"])
    u = torch.bmm(buf, w["wi_up"])
    y_buf = torch.bmm(F.silu(g) * u, w["wo"])                  # (E, C, D)
    y = y_buf[idx, torch.clamp(pos, max=C - 1)]                # (T, K, D)
    y = (y * gate[..., None].to(x.dtype)) * keep[..., None].to(x.dtype)
    return y.sum(dim=1).reshape(B, S, D)


def moe_ffn_ref(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor, respect_capacity: bool = True
                ) -> torch.Tensor:
    """Dense oracle in fp32: every token through every expert, the outputs
    combined by the routing's gates and kept choices (tests)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D).float()
    _, gate, idx, _, keep = route(cfg, p["router"].float(), xt)
    if not respect_capacity:
        keep = torch.ones_like(keep)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        g = F.silu(xt @ p["wi_gate"][e].float())
        ye = (g * (xt @ p["wi_up"][e].float())) @ p["wo"][e].float()
        w = ((idx == e) & keep).float().mul(gate).sum(-1)
        y = y + ye * w[:, None]
    return y.reshape(B, S, D).to(x.dtype)


def load_balance_loss(router_probs: torch.Tensor, idx: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum(mean probability x fraction of
    choices routed), per expert."""
    me = router_probs.float().mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=idx.device)
    ce = ce.index_add_(0, idx.reshape(-1).long(),
                       torch.ones(idx.numel(), dtype=torch.float32,
                                  device=idx.device))
    ce = ce / max(idx.numel(), 1)
    return E * torch.sum(me * ce)
