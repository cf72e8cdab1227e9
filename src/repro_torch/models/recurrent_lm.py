"""Griffin / RecurrentGemma LM, the hybrid family (counterpart:
``repro/models/recurrent_lm.py``, ``GriffinLM``).

Layers follow the pattern (recurrent, recurrent, local attention) over
``num_layers // 3`` groups, then the remaining layers as trailing recurrent
layers. A recurrent layer is the RG-LRU block of ``rglru.py`` plus a gated
MLP; an attention layer is local MQA over a window of ``local_window``
positions plus a gated MLP. Logits come from the tied embedding, soft-capped
at ``logit_softcap``. Parameter names carry the reference's keys with the
stacked group axis unrolled: ``groups.<g>.rec1.rec.w_x``,
``groups.<g>.attn.attn.w_q``, ``tail.<i>.mlp.wo``, ...

Training is functional over the reference's tree (``groups`` stacked on a
leading axis, ``tail`` a list): ``forward(tokens, params)`` and
``loss(params, batch)``, each group recomputed in the backward as the
reference checkpoints its ``group_body``; the recurrences run the RG-LRU
kernel under autograd, the attention layers the prefill kernel.

Serving keeps a cache with an O(1) recurrent state per layer and a ring KV
cache of ``min(max_len, local_window)`` slots per attention layer:

    rec1 / rec2  {"h": (G, B, D) fp32, "conv": (G, B, W-1, D)}
    k / v        (G, B, T, Hkv, D) in the model's KV layout
    tail         [{"h": (B, D) fp32, "conv": (B, W-1, D)}, ...]
    pos_ids      (B, T) int32, -1 = empty slot
    pos          (B,) int32

``k`` / ``v`` follow ``kv_quant`` and ``page_size`` as the dense family's
do (``models/model.py``): compute-dtype tensors, a ``QKVCache`` of int8
codes and fp32 scales, or a ``PagedKVCache`` whose pools ``(G, P, ps, Hkv,
D)`` and tables ``(G, B, NP)`` keep the group axis first; ``T`` is rounded
up to whole pages. Prefill runs each recurrence through the RG-LRU kernel
and each attention layer through the flash prefill kernel, and stores the
ring through the layout; a one-token decode step updates the recurrent
states elementwise and reads the ring through the layout's decode kernel.

``XLSTMLM`` is the ssm family (``xlstm-125m``): interleaved mLSTM and
sLSTM blocks (``xlstm.py``), layer i an sLSTM block when ``(i + 1) %
slstm_every == 0``, each ``x + block(rms_norm(x))``, logits from the tied
embedding. Its parameters are ``blocks.<i>.ln`` and
``blocks.<i>.mlstm.*`` / ``blocks.<i>.slstm.*``: the reference keeps the
unlike blocks in a list (``scan_layers=False``), not a stack. It trains
as the reference does, each block recomputed in the backward. Its cache
holds every block's recurrent state, O(1) in the sequence length:

    blocks  [{"C": (B, H, Dk, Dv), "n": (B, H, Dk), "m": (B, H)}  (mLSTM)
             or {"c", "n", "m", "h": (B, D)}, ...]                (sLSTM)
    pos     (B,) int32

all fp32. As in the reference, ``prefill`` takes no ``full_logits``, so
the reference's serving programs (``serve()``, ``ServeEngine``) cannot be
built for it; its path is ``prefill`` and the fused decode chunk.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (aligned_cache_len, chunked_attention,
                                       dense, gated_mlp, kv_cache_axes,
                                       kv_cache_init, kv_cache_len,
                                       kv_cache_store, kv_cache_update,
                                       kv_cast, ring_cache_update,
                                       ring_position_ids, rms_norm,
                                       softmax_xent, stack_kv)
from repro_torch.models.model import (Block, ServingLM, _add_params, _Group,
                                      attn_out, layer_trees, qkv, remat_call)
from repro_torch.models.module import (ParamSpec, block_specs, embed_spec,
                                       mlp_param_specs, norm_spec,
                                       torch_dtype)
from repro_torch.models.rglru import (init_rglru_state, recurrent_block,
                                      rglru_param_specs)
from repro_torch.models.xlstm import (init_mlstm_state, init_slstm_state,
                                      mlstm_chunked, mlstm_param_specs,
                                      mlstm_step, slstm_param_specs,
                                      slstm_scan)

Cache = Dict[str, Any]


def rec_layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    dtype = torch_dtype(cfg.param_dtype)
    norm = norm_spec(cfg)
    specs = {"ln1": norm}
    specs.update({f"rec.{k}": s
                  for k, s in rglru_param_specs(cfg, dtype).items()})
    specs["ln2"] = norm
    specs.update({f"mlp.{k}": s
                  for k, s in mlp_param_specs(cfg, dtype).items()})
    return specs


def griffin_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Flat ``name -> ParamSpec`` of ``GriffinLM(cfg)``, in a fixed order."""
    dtype = torch_dtype(cfg.param_dtype)
    n_groups = cfg.num_layers // 3
    specs = {"embed": embed_spec(cfg, dtype)}
    layer = {"rec1": rec_layer_specs(cfg), "rec2": rec_layer_specs(cfg),
             "attn": block_specs(cfg)}
    for g in range(n_groups):
        for name, sub in layer.items():
            specs.update({f"groups.{g}.{name}.{k}": s for k, s in sub.items()})
    for i in range(cfg.num_layers - 3 * n_groups):
        specs.update({f"tail.{i}.{k}": s
                      for k, s in rec_layer_specs(cfg).items()})
    specs["final_norm"] = norm_spec(cfg)
    return specs


class RecLayer(nn.Module):
    """ln1, rec.{w_gate, w_x, conv_w, conv_b, lam, w_input_gate,
    w_rec_gate, w_out}, ln2, mlp.{wi_gate, wi_up, wo}."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        specs = rec_layer_specs(cfg)
        _add_params(self, {k: specs[k] for k in ("ln1", "ln2")}, device)
        self.rec = _Group(rglru_param_specs(cfg, dtype), device)
        self.mlp = _Group(mlp_param_specs(cfg, dtype), device)


class GriffinGroup(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.rec1 = RecLayer(cfg, device)
        self.rec2 = RecLayer(cfg, device)
        self.attn = Block(cfg, device)


class GriffinLM(ServingLM):
    """Hybrid RG-LRU / local-attention LM on one device (``"cuda"`` by
    default), serving from a KV cache laid out as ``kv_quant`` and
    ``page_size`` say."""

    LISTS = ("tail",)

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kv_quant: str = "off", page_size: int = 0):
        if cfg.family != "hybrid":
            raise ValueError(f"GriffinLM is the hybrid family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg, device, kv_quant=kv_quant, page_size=page_size)
        self.n_groups = cfg.num_layers // 3
        self.n_tail = cfg.num_layers - 3 * self.n_groups
        self.groups = nn.ModuleList(GriffinGroup(cfg, self.device)
                                    for _ in range(self.n_groups))
        self.tail = nn.ModuleList(RecLayer(cfg, self.device)
                                  for _ in range(self.n_tail))

    # -- layers --------------------------------------------------------------
    def _rec_params(self, layer: RecLayer) -> Dict[str, torch.Tensor]:
        """The RG-LRU weights in compute dtype; ``lam`` stays fp32, as the
        reference reads it."""
        return {n: t if n == "lam" else self._w(t)
                for n, t in layer.rec.named_parameters(recurse=False)}

    def _rec_layer(self, layer: RecLayer, x: torch.Tensor, state=None):
        cfg = self.cfg
        y, new_state = recurrent_block(cfg, self._rec_params(layer),
                                       rms_norm(x, layer.ln1, cfg.norm_eps),
                                       state)
        return self._mlp_residual(layer, x + y), new_state

    def _attn_qkv(self, blk: Block, x: torch.Tensor, positions: torch.Tensor):
        xn = rms_norm(x, blk.ln1, self.cfg.norm_eps)
        return qkv(self.cfg, self._ws(blk.attn), xn, positions)

    def _attn_finish(self, blk: Block, x: torch.Tensor,
                     o: torch.Tensor) -> torch.Tensor:
        return self._mlp_residual(blk, x + attn_out(self._ws(blk.attn), o))

    def _capped(self, logits: torch.Tensor) -> torch.Tensor:
        """Soft-capped as the reference caps logits: tanh in fp32, cast
        back, then scaled in the logits' dtype."""
        cap = self.cfg.logit_softcap
        if cap > 0:
            logits = cap * torch.tanh(logits.float() / cap).to(logits.dtype)
        return logits

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits, soft-capped."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._capped(dense(x, self._w(self.embed).T, "bsd,dv->bsv"))

    # -- full-sequence forward and loss (counterpart: forward / loss) ----------
    def forward(self, tokens: torch.Tensor,
                params: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """(B, S) tokens -> (B, S, V) logits, differentiable in ``params``
        (a tree in the reference's layout); without ``params``, from the
        module's own weights under ``no_grad``."""
        if params is None:
            with torch.no_grad():
                return self._tree_forward(self.own_tree(), tokens)
        return self._tree_forward(params, tokens)

    def _tree_rec(self, x: torch.Tensor, p) -> torch.Tensor:
        """A recurrent layer (the reference's ``_rec_layer`` from zero
        state) from weights in any dtype."""
        cfg = self.cfg
        y, _ = recurrent_block(cfg, p["rec"], rms_norm(x, p["ln1"],
                                                       cfg.norm_eps))
        x = x + y
        m = p["mlp"]
        return x + gated_mlp(rms_norm(x, p["ln2"], cfg.norm_eps),
                             m["wi_gate"], m["wi_up"], m["wo"])

    def _tree_group(self, x: torch.Tensor, gp, positions) -> torch.Tensor:
        """(rec1, rec2, local attention): the reference's ``group_body``."""
        cfg = self.cfg
        x = self._tree_rec(x, gp["rec1"])
        x = self._tree_rec(x, gp["rec2"])
        p = gp["attn"]
        q, k, v = qkv(cfg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                      positions)
        o = chunked_attention(q, k, v, causal=True, window=cfg.local_window)
        x = x + attn_out(p["attn"], o)
        m = p["mlp"]
        return x + gated_mlp(rms_norm(x, p["ln2"], cfg.norm_eps),
                             m["wi_gate"], m["wi_up"], m["wo"])

    def _tree_forward(self, params: Dict[str, Any],
                      tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens.long(), params["embed"].to(self.cdtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for gp in layer_trees(params["groups"], self.n_groups):
            x = remat_call(cfg, self._tree_group, x, gp, positions)
        for tp in params["tail"]:
            x = self._tree_rec(x, tp)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._capped(dense(x, params["embed"].T, "bsd,dv->bsv"))

    def loss(self, params: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy under ``params``. ``loss_mask``
        is passed unsliced, as the reference passes it (ROADMAP §C: a
        (B, S) mask does not match the (B, S - 1) losses)."""
        logits = self.forward(batch["tokens"], params)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                            batch.get("loss_mask"))

    # -- serving ---------------------------------------------------------------
    def cache_len(self, max_len: int) -> int:
        """Ring slots per sequence: the local window bounds the KV cache,
        rounded up to whole pages when paged."""
        return aligned_cache_len(min(max_len, self.cfg.local_window),
                                 self.page_size)

    def _rec_state_zero(self, batch: int, lead=()) -> Dict[str, torch.Tensor]:
        st = init_rglru_state(self.cfg, batch, self.cdtype, self.device)
        return {k: v.expand(lead + v.shape).contiguous()
                for k, v in st.items()}

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        T = self.cache_len(max_len)
        G, dev = self.n_groups, self.device
        kv = (G, batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)

        def leaf():
            return kv_cache_init(kv, self.cdtype, self.kv_quant,
                                 self.page_size, dev)
        return {
            "rec1": self._rec_state_zero(batch, (G,)),
            "rec2": self._rec_state_zero(batch, (G,)),
            "k": leaf(), "v": leaf(),
            "tail": [self._rec_state_zero(batch) for _ in range(self.n_tail)],
            "pos_ids": torch.full((batch, T), -1, dtype=torch.int32,
                                  device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    def cache_logical_axes(self) -> Cache:
        """The logical axes of every leaf of ``init_cache``'s tree (the
        reference's ``cache_logical_axes``), in this model's KV layout."""
        rec = {"h": ("layers", "act_batch", "act_embed"),
               "conv": ("layers", "act_batch", None, "act_embed")}
        kv = kv_cache_axes(("layers", "act_batch", "cache_seq", "cache_kv",
                            "cache_hd"), self.kv_quant, self.page_size)
        return {"rec1": rec, "rec2": rec, "k": kv, "v": kv,
                "tail": [{"h": ("act_batch", "act_embed"),
                          "conv": ("act_batch", None, "act_embed")}
                         for _ in range(self.n_tail)],
                "pos_ids": ("act_batch", "cache_seq"), "pos": ("act_batch",)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                full_logits: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, S) from zero state; return last-token logits
        (B, 1, V) (every position with ``full_logits``) and the cache sized
        for ``max_len`` positions: the recurrent states after the prompt
        and the last ``cache_len(max_len)`` positions of K/V in the ring."""
        x = self._embed(tokens)
        B, S, _ = x.shape
        T = self.cache_len(max(max_len or S, S))
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        window = self.cfg.local_window
        s1, s2, ks, vs = [], [], [], []

        def store(t):           # the ring in the layout: codes, pages
            return kv_cache_store(t.to(self.cdtype), S, T, self.kv_quant,
                                  self.page_size)
        for g in self.groups:
            x, st = self._rec_layer(g.rec1, x)
            s1.append(st)
            x, st = self._rec_layer(g.rec2, x)
            s2.append(st)
            q, k, v = self._attn_qkv(g.attn, x, positions)
            o = chunked_attention(q, k, v, causal=True, window=window)
            x = self._attn_finish(g.attn, x, o)
            ks.append(store(k))
            vs.append(store(v))
        tail = []
        for layer in self.tail:
            x, st = self._rec_layer(layer, x)
            tail.append({n: t.contiguous() for n, t in st.items()})
        logits = self._logits(x if full_logits else x[:, -1:])

        def stack(states):
            return {n: torch.stack([st[n] for st in states]) for n in ("h", "conv")}
        cache = {
            "rec1": stack(s1), "rec2": stack(s2),
            "k": stack_kv(ks), "v": stack_kv(vs), "tail": tail,
            "pos_ids": ring_position_ids(B, S, T, x.device),
            "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
        }
        return logits, cache

    def _rec_step(self, layer: RecLayer, x: torch.Tensor,
                  state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One recurrent layer from ``state`` (views into the cache), which
        is overwritten with the new state."""
        x, new = self._rec_layer(layer, x, state)
        for n in ("h", "conv"):
            state[n].copy_(new[n])
        return x

    @torch.no_grad()
    def decode_step(self, cache: Cache,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S): append S tokens per row at per-slot positions
        ``cache["pos"]`` and return their logits (B, S, V). S == 1 steps the
        recurrences elementwise; S > 1 runs them through the RG-LRU kernel
        from the cached state. Updates ``cache`` in place: every tensor
        stays the same object (``pos`` advances by S)."""
        S = tokens.shape[1]
        x = self._embed(tokens)
        pos = cache["pos"]
        T = kv_cache_len(cache["k"])
        block_pos = pos[:, None] + torch.arange(S, dtype=pos.dtype,
                                                device=pos.device)
        slot = block_pos % T
        ring_cache_update(cache["pos_ids"], block_pos, slot)
        window = self.cfg.local_window
        for i, g in enumerate(self.groups):
            x = self._rec_step(g.rec1, x, {n: t[i] for n, t in
                                           cache["rec1"].items()})
            x = self._rec_step(g.rec2, x, {n: t[i] for n, t in
                                           cache["rec2"].items()})
            q, k, v = self._attn_qkv(g.attn, x, block_pos)
            ck = kv_cache_update(cache["k"][i], k, slot, self.kv_quant)
            cv = kv_cache_update(cache["v"][i], v, slot, self.kv_quant)
            o = chunked_attention(q, kv_cast(ck, x.dtype), kv_cast(cv, x.dtype),
                                  causal=True, window=window, q_offset=pos,
                                  kv_positions=cache["pos_ids"])
            x = self._attn_finish(g.attn, x, o)
        for layer, st in zip(self.tail, cache["tail"]):
            x = self._rec_step(layer, x, st)
        pos.add_(S)
        return self._logits(x), cache


# ===========================================================================
# XLSTMLM: interleaved mLSTM / sLSTM blocks, unrolled
# ===========================================================================
def is_slstm(cfg: ModelConfig, i: int) -> bool:
    k = cfg.slstm_every
    return k > 0 and (i + 1) % k == 0


def xlstm_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Flat ``name -> ParamSpec`` of ``XLSTMLM(cfg)``, in a fixed order."""
    dtype = torch_dtype(cfg.param_dtype)
    norm = norm_spec(cfg)
    specs = {"embed": embed_spec(cfg, dtype)}
    for i in range(cfg.num_layers):
        kind, sub = (("slstm", slstm_param_specs(cfg, dtype))
                     if is_slstm(cfg, i)
                     else ("mlstm", mlstm_param_specs(cfg, dtype)))
        specs[f"blocks.{i}.ln"] = norm
        specs.update({f"blocks.{i}.{kind}.{k}": s for k, s in sub.items()})
    specs["final_norm"] = norm
    return specs


class XBlock(nn.Module):
    """ln, and mlstm.{w_q, w_k, w_v, w_i, w_f, b_i, b_f, w_gate, w_out,
    norm} or slstm.{w_z, w_i, w_f, w_o, r_z, r_i, r_f, r_o, w_out, norm}."""

    def __init__(self, cfg: ModelConfig, slstm: bool, device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        _add_params(self, {"ln": norm_spec(cfg)}, device)
        self.kind = "slstm" if slstm else "mlstm"
        specs = (slstm_param_specs if slstm else mlstm_param_specs)(cfg, dtype)
        setattr(self, self.kind, _Group(specs, device))


class XLSTMLM(ServingLM):
    """The xLSTM LM on one device (``"cuda"`` by default). It holds no KV
    cache, so it takes no KV layout."""

    LISTS = ("blocks",)

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kv_quant: str = "off", page_size: int = 0):
        if cfg.family != "ssm":
            raise ValueError(f"XLSTMLM is the ssm family, not {cfg.family!r}")
        self._check_layout(kv_quant, page_size)
        super().__init__(cfg, device)
        self.blocks = nn.ModuleList(XBlock(cfg, is_slstm(cfg, i), self.device)
                                    for i in range(cfg.num_layers))

    @staticmethod
    def _check_layout(kv_quant: str, page_size: int) -> None:
        if kv_quant != "off" or page_size != 0:
            raise ValueError(
                f"XLSTMLM with kv_quant={kv_quant!r}, page_size={page_size}: "
                "the xLSTM model holds recurrent states, no KV cache")

    def with_kv_layout(self, kv_quant: str = "off",
                       page_size: int = 0) -> "XLSTMLM":
        self._check_layout(kv_quant, page_size)
        return self

    def _block_params(self, blk: XBlock) -> Dict[str, torch.Tensor]:
        """The block's weights in compute dtype; its fp32 vectors (biases,
        recurrent weights, norm) stay fp32, as the reference reads them."""
        return {n: t if t.ndim == 1 else self._w(t)
                for n, t in getattr(blk, blk.kind).named_parameters(
                    recurse=False)}

    def _apply_block(self, blk: XBlock, x: torch.Tensor, state=None):
        cfg = self.cfg
        p = self._block_params(blk)
        xn = rms_norm(x, blk.ln, cfg.norm_eps)
        if blk.kind == "slstm":
            y, st = slstm_scan(cfg, p, xn, state)
        elif x.shape[1] == 1 and state is not None:
            y, st = mlstm_step(cfg, p, xn, state)
        else:
            y, st = mlstm_chunked(cfg, p, xn, state,
                                  chunk=min(256, x.shape[1]))
        return x + y, st

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return dense(x, self._w(self.embed).T, "bsd,dv->bsv")

    def _state_zero(self, blk: XBlock, batch: int) -> Dict[str, torch.Tensor]:
        init = init_slstm_state if blk.kind == "slstm" else init_mlstm_state
        return init(self.cfg, batch, self.device)

    def forward(self, tokens: torch.Tensor,
                params: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """(B, S) tokens -> (B, S, V) logits, every block from zero state
        (S a multiple of ``min(256, S)``), differentiable in ``params`` (a
        tree in the reference's layout, ``blocks`` a list); without
        ``params``, from the module's own weights under ``no_grad``."""
        if params is None:
            with torch.no_grad():
                return self._tree_forward(self.own_tree(), tokens)
        return self._tree_forward(params, tokens)

    def _tree_block(self, x: torch.Tensor, p, i: int) -> torch.Tensor:
        """Block ``i`` from zero state (the reference's ``_apply_block``)
        from weights in any dtype."""
        cfg = self.cfg
        xn = rms_norm(x, p["ln"], cfg.norm_eps)
        if is_slstm(cfg, i):
            y, _ = slstm_scan(cfg, p["slstm"], xn)
        else:
            y, _ = mlstm_chunked(cfg, p["mlstm"], xn,
                                 chunk=min(256, x.shape[1]))
        return x + y

    def _tree_forward(self, params: Dict[str, Any],
                      tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens.long(), params["embed"].to(self.cdtype))
        for i, p in enumerate(params["blocks"]):
            x = remat_call(cfg, self._tree_block, x, p, i)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["embed"].T, "bsd,dv->bsv")

    def loss(self, params: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy under ``params``; ``loss_mask``
        unsliced, as the reference passes it (ROADMAP §C)."""
        logits = self.forward(batch["tokens"], params)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                            batch.get("loss_mask"))

    def init_cache(self, batch: int, max_len: int = 0) -> Cache:
        """Zero states; the state is O(1) in the sequence: ``max_len`` is
        not used."""
        return {"blocks": [self._state_zero(blk, batch) for blk in self.blocks],
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    def cache_logical_axes(self) -> Cache:
        """The logical axes of every leaf of ``init_cache``'s tree (the
        reference's ``cache_logical_axes``)."""
        mlstm = {"C": ("act_batch", "act_heads", "act_hd", None),
                 "n": ("act_batch", "act_heads", "act_hd"),
                 "m": ("act_batch", "act_heads")}
        slstm = dict.fromkeys(("c", "n", "m", "h"), ("act_batch", "act_embed"))
        return {"blocks": [dict(slstm if blk.kind == "slstm" else mlstm)
                           for blk in self.blocks], "pos": ("act_batch",)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, S) from zero states; return the last
        position's logits (B, 1, V) and the states after the prompt.
        ``max_len`` is not used (the state does not grow)."""
        x = self._embed(tokens)
        B, S = tokens.shape
        states = []
        for blk in self.blocks:
            x, st = self._apply_block(blk, x, self._state_zero(blk, B))
            states.append(st)
        return self._logits(x[:, -1:]), {
            "blocks": states,
            "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}

    @torch.no_grad()
    def decode_step(self, cache: Cache,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) from the cached states (S == 1: the mLSTM's O(1)
        step); returns their logits (B, S, V). Updates ``cache`` in place:
        each new state is copied into the cache's tensors, which stay the
        same objects (``pos`` advances by S)."""
        x = self._embed(tokens)
        for blk, state in zip(self.blocks, cache["blocks"]):
            x, new = self._apply_block(blk, x, state)
            for n, t in new.items():
                state[n].copy_(t)
        cache["pos"].add_(tokens.shape[1])
        return self._logits(x), cache
