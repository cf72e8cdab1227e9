"""Optimizers: AdamW, Adafactor (factored 2nd moment), SGD (counterpart:
``repro/optim/optimizers.py``).

Functional updates over a parameter tree in the reference's layout (nested
dicts, blocks stacked on a leading layer axis): ``init(params) -> state``
and ``update(grads, state, params) -> (params', state')`` return new
tensors and read nothing back to the host. State is fp32 (``step`` an
int32 scalar on the parameters' device); the order of operations is the
reference's: clip by the global norm, then the moments and their bias
correction, then the decoupled weight decay inside ``delta``. Adafactor's
factored moments, its update RMS and its parameter scale are taken over
the stacked leaf, as the reference takes them. ``torch.optim`` is not used:
its arithmetic differs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.tree import leaves, tree_map


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    """lr(step) for an int32 step tensor: linear warm-up, then a cosine down
    to ``final_frac`` of ``base_lr``, in fp32 on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    s = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree))
    return torch.sqrt(s)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), n


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]                          # params -> state
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (g, s, p) -> (p', s')


def _step0(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _unzip(out: Any, n: int) -> list:
    """A tree of ``n``-tuples -> ``n`` trees."""
    return [tree_map(lambda o: o[i], out, is_leaf=lambda x: isinstance(x, tuple))
            for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(run: RunConfig) -> Optimizer:
    lr_fn = cosine_schedule(run.learning_rate, run.warmup_steps, run.total_steps)
    b1, b2, wd, eps = run.b1, run.b2, run.weight_decay, 1e-8

    def init(params):
        return {"step": _step0(params), "mu": tree_map(_f32_zeros, params),
                "nu": tree_map(_f32_zeros, params)}

    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, run.grad_clip)
        step = state["step"] + 1
        lr = lr_fn(step)
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            mh = m / bc1
            vh = v / bc2
            pf = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + eps) + wd * pf
            return (pf - lr * delta).to(p.dtype), m, v

        new_p, mu, nu = _unzip(
            tree_map(upd, grads, state["mu"], state["nu"], params), 3)
        return new_p, {"step": step, "mu": mu, "nu": nu}

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored second moment
# ---------------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(run: RunConfig) -> Optimizer:
    lr_fn = cosine_schedule(run.learning_rate, run.warmup_steps, run.total_steps)
    eps1, eps2, clip_d = 1e-30, 1e-3, 1.0
    wd = run.weight_decay

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": _f32_zeros(p[..., 0]),
                        "vc": _f32_zeros(p[..., 0, :])}
            return {"v": _f32_zeros(p)}
        return {"step": _step0(params), "v": tree_map(st, params)}

    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, run.grad_clip)
        step = state["step"] + 1
        t = step.to(torch.float32)
        lr = lr_fn(step)
        b2 = 1.0 - t ** -0.8

        def upd(g, p, s):
            gf = g.to(torch.float32)
            g2 = gf * gf + eps1
            if _factored(p.shape):
                vr = b2 * s["vr"] + (1 - b2) * g2.mean(dim=-1)
                vc = b2 * s["vc"] + (1 - b2) * g2.mean(dim=-2)
                denom = vr.sum(dim=-1, keepdim=True)
                vhat = (vr[..., None] * vc[..., None, :]
                        / torch.clamp(denom[..., None], min=eps1))
                u = gf * torch.rsqrt(torch.clamp(vhat, min=eps1))
                ns = {"vr": vr, "vc": vc}
            else:
                v = b2 * s["v"] + (1 - b2) * g2
                u = gf * torch.rsqrt(torch.clamp(v, min=eps1))
                ns = {"v": v}
            rms_u = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp(rms_u / clip_d, min=1.0)
            pf = p.to(torch.float32)
            scale = torch.clamp(torch.sqrt(torch.mean(pf * pf)), min=eps2)
            new_p = pf - lr * scale * u - lr * wd * pf
            return new_p.to(p.dtype), ns

        # the moments are a dict per parameter: the walk follows the
        # gradients, so each call gets its parameter's dict whole
        new_p, v = _unzip(tree_map(upd, grads, params, state["v"]), 2)
        return new_p, {"step": step, "v": v}

    return Optimizer("adafactor", init, update)


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------
def sgd(run: RunConfig, momentum: float = 0.9) -> Optimizer:
    lr_fn = cosine_schedule(run.learning_rate, run.warmup_steps, run.total_steps)

    def init(params):
        return {"step": _step0(params), "mu": tree_map(_f32_zeros, params)}

    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, run.grad_clip)
        step = state["step"] + 1
        lr = lr_fn(step)

        def upd(g, m, p):
            m = momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr * m).to(p.dtype), m

        new_p, mu = _unzip(tree_map(upd, grads, state["mu"], params), 2)
        return new_p, {"step": step, "mu": mu}

    return Optimizer("sgd", init, update)


def make_optimizer(name: str, run: RunConfig) -> Optimizer:
    if name == "adamw":
        return adamw(run)
    if name == "adafactor":
        return adafactor(run)
    if name == "sgd":
        return sgd(run)
    raise ValueError(f"unknown optimizer {name!r}")
