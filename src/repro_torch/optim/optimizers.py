"""Optimizers: AdamW, Adafactor (factored 2nd moment), SGD (counterpart:
``repro/optim/optimizers.py``).

Updates over a parameter tree in the reference's layout (nested dicts,
blocks stacked on a leading layer axis): ``init(params) -> state`` and
``update_(grads, state, params, keep)``, which writes the update into
``state`` and ``params`` in place where ``keep`` holds (a bool device
scalar, the train step's guard, or None for always) and reads nothing back
to the host. That is the counterpart of the reference's train step, which
donates its parameter and optimizer buffers: a step holds the weights, the
moments and the gradients once (AdamW and SGD a piece of a leaf at a time,
Adafactor a leaf at a time). ``update(grads, state, params) -> (params',
state')`` is the same update on copies. State is fp32 (``step`` an int32
scalar on the parameters' device); the order of operations is the
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


def _clip_scale(n: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that clips a tree of global norm ``n`` to ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    n = global_norm(tree)
    scale = _clip_scale(n, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), n


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]                          # params -> state
    # (g, s, p, keep) -> None: the update written into s and p in place,
    # where ``keep`` (a bool device scalar, or None for always) holds
    update_: Callable[[Any, Any, Any, Any], None]

    def update(self, grads: Any, state: Any, params: Any
               ) -> Tuple[Any, Any]:
        """(params', state'): the update on copies; the inputs are left
        as they were."""
        params, state = (tree_map(lambda t: t.clone(
            memory_format=torch.contiguous_format), x)
            for x in (params, state))
        self.update_(grads, state, params, None)
        return params, state


def _step0(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# elements of a leaf an in-place elementwise update takes at a time (256 MB
# of fp32): its temporaries are a few pieces, not a few leaves
PIECE = 1 << 26


def _write(dst: torch.Tensor, new: torch.Tensor, keep) -> None:
    """``dst`` := ``new`` where ``keep`` holds (everywhere for None), in
    place."""
    dst.copy_(new if keep is None else torch.where(keep, new, dst))


def _pieces(g: torch.Tensor, *ts: torch.Tensor):
    """Matching flat slices of a gradient (read) and of the contiguous
    tensors of its size that the update writes (views)."""
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("an in-place update needs contiguous leaves")
    flat = [g.reshape(-1)] + [t.view(-1) for t in ts]
    for i in range(0, max(g.numel(), 1), PIECE):
        yield [f[i:i + PIECE] for f in flat]


def _elementwise(leaf_fn: Callable, begin: Callable,
                 moments: Tuple[str, ...]) -> Callable:
    """``update_`` of an optimizer whose per-leaf update is elementwise:
    ``leaf_fn(c, g, *moments, p) -> (p', *moments')`` with the step's
    constants ``c`` from ``begin(grads, state) -> (c, step)``, run on each
    leaf piece by piece (every element's arithmetic is that of the whole
    leaf)."""
    def update_(grads, state, params, keep):
        c, step = begin(grads, state)
        for ts in zip(leaves(grads), *(leaves(state[k]) for k in moments),
                      leaves(params)):
            for g, *rest in _pieces(*ts):
                new = leaf_fn(c, g, *rest)
                # leaf_fn returns (p', *moments'); rest is (*moments, p)
                for dst, n in zip(rest[-1:] + rest[:-1], new):
                    _write(dst, n, keep)
        _write(state["step"], step, keep)
    return update_


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(run: RunConfig) -> Optimizer:
    lr_fn = cosine_schedule(run.learning_rate, run.warmup_steps, run.total_steps)
    b1, b2, wd, eps = run.b1, run.b2, run.weight_decay, 1e-8

    def init(params):
        return {"step": _step0(params), "mu": tree_map(_f32_zeros, params),
                "nu": tree_map(_f32_zeros, params)}

    def begin(grads, state):
        step = state["step"] + 1
        t = step.to(torch.float32)
        scale = _clip_scale(global_norm(grads), run.grad_clip)
        return (scale, lr_fn(step), 1 - b1 ** t, 1 - b2 ** t), step

    def upd(c, g, m, v, p):
        scale, lr, bc1, bc2 = c
        gf = (g * scale.to(g.dtype)).to(torch.float32)
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        mh = m / bc1
        vh = v / bc2
        pf = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + eps) + wd * pf
        return (pf - lr * delta).to(p.dtype), m, v

    return Optimizer("adamw", init, _elementwise(upd, begin, ("mu", "nu")))


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

    def begin(grads, state):
        step = state["step"] + 1
        t = step.to(torch.float32)
        scale = _clip_scale(global_norm(grads), run.grad_clip)
        return (scale, lr_fn(step), 1.0 - t ** -0.8), step

    def upd(c, g, p, s):
        scale, lr, b2 = c
        gf = (g * scale.to(g.dtype)).to(torch.float32)
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

    def update_(grads, state, params, keep):
        # the update RMS and the parameter scale are means over the whole
        # leaf: one leaf at a time. The moments are a dict per parameter:
        # the walk follows the gradients, so each leaf gets its dict whole
        c, step = begin(grads, state)
        per_leaf = []
        tree_map(lambda g, p, s: per_leaf.append((g, p, s)), grads, params,
                 state["v"])
        for g, p, s in per_leaf:
            new_p, ns = upd(c, g, p, s)
            _write(p, new_p, keep)
            for k, t in ns.items():
                _write(s[k], t, keep)
        _write(state["step"], step, keep)

    return Optimizer("adafactor", init, update_)


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------
def sgd(run: RunConfig, momentum: float = 0.9) -> Optimizer:
    lr_fn = cosine_schedule(run.learning_rate, run.warmup_steps, run.total_steps)

    def init(params):
        return {"step": _step0(params), "mu": tree_map(_f32_zeros, params)}

    def begin(grads, state):
        step = state["step"] + 1
        scale = _clip_scale(global_norm(grads), run.grad_clip)
        return (scale, lr_fn(step)), step

    def upd(c, g, m, p):
        scale, lr = c
        m = momentum * m + (g * scale.to(g.dtype)).to(torch.float32)
        return (p.to(torch.float32) - lr * m).to(p.dtype), m

    return Optimizer("sgd", init, _elementwise(upd, begin, ("mu",)))


def make_optimizer(name: str, run: RunConfig) -> Optimizer:
    if name == "adamw":
        return adamw(run)
    if name == "adafactor":
        return adafactor(run)
    if name == "sgd":
        return sgd(run)
    raise ValueError(f"unknown optimizer {name!r}")
