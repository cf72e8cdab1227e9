"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM (counterpart:
``repro/models/xlstm.py``; arXiv:2405.04517).

mLSTM: matrix memory ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, run chunkwise
(a quadratic part inside a chunk of ``c = min(chunk, S)`` positions and a
recurrent state across chunks), stabilised in log space. sLSTM: scalar
memory, a loop over time steps as the reference's ``lax.scan`` is.
There is no separate FFN (``d_ff = 0``): the projections live inside the
blocks.

Plain PyTorch, as the reference's jnp is (no Pallas kernel there, so no
CUDA kernel here), with fp32 where the reference keeps it: the gates, q / k
/ v inside a chunk, the states, the ``-1e30`` initial stabiliser and the
``max(|den|, exp(-m))`` denominator; a chunk's output is cast back to the
input's dtype. ``log sigmoid`` is ``F.logsigmoid``, the stable form of the
reference's ``-softplus(-x)`` (``F.softplus`` switches to ``x`` above its
threshold, jax's does not). ``p`` maps parameter names to weights in
compute dtype, except the fp32 biases, recurrent weights and norms.
Training differentiates these ops with autograd, as the reference
differentiates its jnp; the stabilisers' maxima split their gradient at
ties as ``jnp.maximum`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, rms_norm
from repro_torch.models.module import ParamSpec

State = Dict[str, torch.Tensor]

# the stabiliser of an empty mLSTM state
M_INIT = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {
        "w_q": ParamSpec((d, h, dh), dtype, ("embed", "heads", "head_dim")),
        "w_k": ParamSpec((d, h, dh), dtype, ("embed", "heads", "head_dim")),
        "w_v": ParamSpec((d, h, dh), dtype, ("embed", "heads", "head_dim")),
        "w_i": ParamSpec((d, h), dtype, ("embed", "heads")),
        "w_f": ParamSpec((d, h), dtype, ("embed", "heads")),
        "b_i": ParamSpec((h,), torch.float32, ("heads",), ("zeros",)),
        "b_f": ParamSpec((h,), torch.float32, ("heads",), ("ones",)),
        "w_gate": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_out": ParamSpec((d, d), dtype, ("mlp", "embed")),
        "norm": ParamSpec((d,), torch.float32, (None,), ("ones",)),
    }


def _mlstm_gates(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """i, f gate pre-activations in fp32: (B, S, D) -> (B, S, H) each."""
    i = dense(x, p["w_i"], "bsd,dh->bsh").float() + p["b_i"]
    f = dense(x, p["w_f"], "bsd,dh->bsh").float() + p["b_f"]
    return i, f


def _mlstm_out(p, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The block's output gate, norm and projection of the cell's y."""
    gate = F.silu(dense(x, p["w_gate"], "bsd,de->bse"))
    y = rms_norm(y, p["norm"], 1e-6) * gate
    return dense(y, p["w_out"], "bse,ed->bsd")


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H = cfg.num_heads
    dh = cfg.d_model // H
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), M_INIT, dtype=torch.float32,
                        device=device),
    }


def mlstm_chunked(cfg: ModelConfig, p, x: torch.Tensor,
                  state: Optional[State] = None,
                  chunk: int = 256) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM: x (B, S, D) -> (out, state), the state C
    (B, H, Dk, Dv), n (B, H, Dk), m (B, H). S must be a multiple of
    ``min(chunk, S)``."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"mlstm_chunked: sequence {S} is not a multiple of "
                         f"the chunk {c}")
    nchunk = S // c

    q = dense(x, p["w_q"], "bsd,dhe->bshe") / (dh ** 0.5)
    k = dense(x, p["w_k"], "bsd,dhe->bshe")
    v = dense(x, p["w_v"], "bsd,dhe->bshe")
    i_pre, f_pre = _mlstm_gates(p, x)                        # (B, S, H)
    log_f = F.logsigmoid(f_pre)
    log_i = i_pre                                            # i = exp(i_pre)

    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    C, n, m = state["C"], state["n"], state["m"]
    above = torch.ones((c, c), dtype=torch.bool, device=x.device).triu(1)
    ys = []
    for j in range(nchunk):
        sl = slice(j * c, (j + 1) * c)
        qc, kc, vc = (t[:, sl].float() for t in (q, k, v))   # (B, c, H, dh)
        lf, li = log_f[:, sl], log_i[:, sl]                  # (B, c, H)
        csum = torch.cumsum(lf, dim=1)                       # inclusive
        total = csum[:, -1]                                  # (B, H)
        # intra-chunk log weights w[t, s] = csum_t - csum_s + li_s (s <= t)
        logw = csum[:, :, None, :] - csum[:, None, :, :] + li[:, None, :, :]
        logw = logw.masked_fill(above[None, :, :, None], M_INIT)  # (B,t,s,H)
        # inter-chunk: q_t reads the state decayed by csum_t, stabilised
        m_inter = csum + m[:, None, :]                       # (B, t, H)
        m_t = torch.maximum(m_inter, logw.amax(dim=2))
        w = torch.exp(logw - m_t[:, :, None, :])
        sw = torch.einsum("bthe,bshe->btsh", qc, kc) * w     # scores * w
        num_intra = torch.einsum("btsh,bshe->bthe", sw, vc)
        den_intra = sw.sum(dim=2)
        inter_scale = torch.exp(m_inter - m_t)               # (B, t, H)
        num_inter = torch.einsum("bthe,bhef->bthf", qc, C) \
            * inter_scale[..., None]
        den_inter = torch.einsum("bthe,bhe->bth", qc, n) * inter_scale
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
        ys.append(((num_intra + num_inter) / den[..., None]).to(x.dtype))
        # state: C' = exp(total + m - m') C
        #             + sum_s exp(total - csum_s + li_s - m') k_s v_s^T
        m_new = torch.maximum(total + m, (total[:, None] - csum + li).amax(1))
        sk = torch.exp(total[:, None] - csum + li - m_new[:, None])  # (B,s,H)
        decay = torch.exp(total + m - m_new)
        C = decay[:, :, None, None] * C + torch.einsum(
            "bshe,bshf->bhef", kc * sk[..., None], vc)
        n = decay[:, :, None] * n + torch.einsum("bsh,bshe->bhe", sk, kc)
        m = m_new
    y = torch.cat(ys, dim=1).reshape(B, S, D)
    return _mlstm_out(p, x, y), {"C": C, "n": n, "m": m}


def mlstm_step(cfg: ModelConfig, p, x: torch.Tensor,
               state: State) -> Tuple[torch.Tensor, State]:
    """One decode step (B, 1, D) with the O(1) matrix-memory update."""
    B, _, D = x.shape
    H = cfg.num_heads
    dh = D // H
    q = dense(x, p["w_q"], "bsd,dhe->bshe")[:, 0].float() / (dh ** 0.5)
    k = dense(x, p["w_k"], "bsd,dhe->bshe")[:, 0].float()
    v = dense(x, p["w_v"], "bsd,dhe->bshe")[:, 0].float()
    i_pre, f_pre = _mlstm_gates(p, x)
    li = i_pre[:, 0]                                         # (B, H)
    lf = F.logsigmoid(f_pre[:, 0])
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    decay, inp = torch.exp(lf + m - m_new), torch.exp(li - m_new)
    C = decay[..., None, None] * C + inp[..., None, None] * torch.einsum(
        "bhe,bhf->bhef", k, v)
    n = decay[..., None] * n + inp[..., None] * k
    num = torch.einsum("bhe,bhef->bhf", q, C)
    den = torch.maximum(torch.einsum("bhe,bhe->bh", q, n).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, D).to(x.dtype)
    return _mlstm_out(p, x, y), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_param_specs(cfg: ModelConfig, dtype) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {
        "w_z": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_i": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_f": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "w_o": ParamSpec((d, d), dtype, ("embed", "mlp")),
        "r_z": ParamSpec((d,), torch.float32, ("mlp",), ("zeros",)),
        "r_i": ParamSpec((d,), torch.float32, ("mlp",), ("zeros",)),
        "r_f": ParamSpec((d,), torch.float32, ("mlp",), ("zeros",)),
        "r_o": ParamSpec((d,), torch.float32, ("mlp",), ("zeros",)),
        "w_out": ParamSpec((d, d), dtype, ("mlp", "embed")),
        "norm": ParamSpec((d,), torch.float32, (None,), ("ones",)),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> State:
    return {name: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                              device=device) for name in ("c", "n", "m", "h")}


def _slstm_cell(p, zi, ii, fi, oi, state):
    """One time step: pre-activations (B, D) fp32, state (c, n, m, h)."""
    c, n, m, h = state
    z = torch.tanh(zi + p["r_z"] * h)
    o = torch.sigmoid(oi + p["r_o"] * h)
    log_i = ii + p["r_i"] * h
    log_f = F.logsigmoid(fi + p["r_f"] * h)
    m_new = torch.maximum(log_f + m, log_i)
    decay, inp = torch.exp(log_f + m - m_new), torch.exp(log_i - m_new)
    c_new = decay * c + inp * z
    n_new = decay * n + inp
    # maximum, not clamp: at n_new == 1 (the first step's normaliser)
    # the gradient splits in half, as jnp.maximum's does
    h_new = o * c_new / torch.maximum(n_new, torch.ones_like(n_new))
    return c_new, n_new, m_new, h_new


def slstm_scan(cfg: ModelConfig, p, x: torch.Tensor,
               state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """The sLSTM over time, one step at a time: x (B, S, D)."""
    B, S, _ = x.shape
    pre = [dense(x, p[w], "bsd,de->bse").float()
           for w in ("w_z", "w_i", "w_f", "w_o")]
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    st = (state["c"], state["n"], state["m"], state["h"])
    hs = []
    for t in range(S):
        st = _slstm_cell(p, *(a[:, t] for a in pre), st)
        hs.append(st[3])
    y = rms_norm(torch.stack(hs, dim=1).to(x.dtype), p["norm"], 1e-6)
    out = dense(y, p["w_out"], "bse,ed->bsd")
    return out, dict(zip(("c", "n", "m", "h"), st))
