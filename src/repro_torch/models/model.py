"""Decoder-only transformer LM (counterpart: ``repro/models/model.py``,
``TransformerLM``): the ``dense``, ``moe`` and ``vlm`` families.

One block stack for all three: an MoE block (``num_experts > 0``) holds a
``moe`` group (``models/moe.py``: router and stacked experts) in place of
the gated MLP, in every layer (the reference ignores ``moe_every``, and so
does the port); a VLM model takes precomputed ``patch_embeds`` (B, P, D),
cast to the compute dtype and prepended to the embedded tokens.

An ``nn.Module`` whose parameters carry the reference's keys
(``blocks.<i>.attn.w_q`` ...), held in ``param_dtype`` and applied in
``compute_dtype`` (the compute-dtype copies are cast once and cached).
Training is functional over a parameter tree in the reference's layout
(``bridge.reference_tree``: nested dicts, blocks stacked on a leading layer
axis), as the reference's ``forward(params, tokens)`` / ``loss(params,
batch)`` are:

    forward(tokens, params, patch_embeds) -> logits   # differentiable
    loss(params, batch) -> scalar            # mean next-token xent, fp32

The compute-dtype casts happen inside the autograd graph, each block is
recomputed in the backward (``remat="block"``, as ``jax.checkpoint`` does;
the attention kernel too), and attention runs the prefill kernel under
autograd (``kernels/flash_attention/autograd.py``). Serving uses a
pre-sized ring KV cache:

    prefill(tokens, max_len, patch_embeds=...) -> (last_logits, cache)
    decode_step(cache, tokens) -> (logits, cache)   # cache updated in place
    init_cache(batch, max_len) -> cache

The cache is a dict: ``k``/``v`` ``(L, B, T, Hkv, D)``, ``pos_ids``
``(B, T)`` int32 (-1 = empty slot) and ``pos`` ``(B,)`` int32. The model's
``kv_quant`` (``off|int8|int4|auto``) and ``page_size`` (0 = contiguous)
choose how ``k``/``v`` are held: compute-dtype tensors, a ``QKVCache`` of
int8 codes and fp32 scales, or a ``PagedKVCache`` (pools ``(L, P, ps, Hkv,
D)`` of either kind and tables ``(L, B, NP)``; the reference's
``REPRO_KV_QUANT`` / ``REPRO_KV_PAGES`` knobs).

``ServingLM`` holds what every family shares (device, KV layout, the
top-level parameters, the cached weight casts, the embedding and the
gated-MLP residual); ``qkv`` and ``attn_out`` are the attention
projections the hybrid family's ``GriffinLM`` and the audio family's
``EncDecLM`` use too, and ``build_model`` picks the family (``XLSTMLM``
for ssm).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import check_kv_quant
from repro_torch.models.bridge import reference_tree
from repro_torch.models.layers import (PagedKVCache, QKVCache,
                                       aligned_cache_len, chunked_attention,
                                       dense, gated_mlp, kv_cache_axes,
                                       kv_cache_init,
                                       kv_cache_len, kv_cache_store,
                                       kv_cache_update, kv_cast,
                                       paged_last_writers,
                                       ring_cache_update, ring_position_ids,
                                       rms_norm, rope, softmax_xent,
                                       stack_kv)
from repro_torch.models.module import (attn_param_specs, block_specs,
                                       mlp_param_specs, moe_param_specs,
                                       param_specs, torch_dtype)
from repro_torch.models.moe import moe_ffn
from repro_torch.tree import leaves, tree_map, unflatten

Cache = Dict[str, Any]


def _add_params(module: nn.Module, specs, device) -> None:
    for name, s in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.zeros(s.shape, dtype=s.dtype, device=device),
            requires_grad=False))


class _Group(nn.Module):
    def __init__(self, specs, device):
        super().__init__()
        _add_params(self, specs, device)


class Block(nn.Module):
    """ln1, attn.{w_q,w_k,w_v,w_o}, ln2, and mlp.{wi_gate,wi_up,wo} or, with
    experts, moe.{router,wi_gate,wi_up,wo}."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        specs = block_specs(cfg)
        _add_params(self, {k: specs[k] for k in ("ln1", "ln2")}, device)
        self.attn = _Group(attn_param_specs(cfg, dtype), device)
        if cfg.num_experts > 0:
            self.moe = _Group(moe_param_specs(cfg, dtype), device)
        else:
            self.mlp = _Group(mlp_param_specs(cfg, dtype), device)


def qkv(cfg: ModelConfig, p, xn: torch.Tensor, positions: torch.Tensor):
    """q, k, v (B, S, H, D) of the normed input, rope applied to q and k.
    ``p`` maps ``w_q``/``w_k``/``w_v`` to weights in compute dtype."""
    q = dense(xn, p["w_q"], "bsd,dhe->bshe")
    k = dense(xn, p["w_k"], "bsd,dhe->bshe")
    v = dense(xn, p["w_v"], "bsd,dhe->bshe")
    theta = cfg.rope_theta
    return rope(q, positions, theta), rope(k, positions, theta), v


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    return dense(o, p["w_o"], "bshe,hed->bsd")


def layer_trees(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` per-layer trees of a tree whose leaves carry a leading
    layer axis: one ``unbind`` per leaf, whose backward stacks the layers'
    gradients once."""
    per = tree_map(torch.unbind, stacked)
    return [tree_map(lambda t: t[i], per, is_leaf=lambda x: isinstance(
        x, tuple)) for i in range(n)]


def remat_call(cfg: ModelConfig, fn: Callable, x: torch.Tensor,
               tree: Any, *args) -> torch.Tensor:
    """``fn(x, tree, *args)``, recomputed in the backward when gradients
    are on and ``cfg.remat`` is not ``"none"`` (the reference wraps the
    same body in ``jax.checkpoint``). ``tree``'s leaves are passed to the
    checkpoint as arguments, so the recompute sees them."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(x, tree, *args)
    ws = leaves(tree)
    n = len(args)

    def body(x, *rest):
        return fn(x, unflatten(tree, list(rest[n:])), *rest[:n])
    return checkpoint(body, x, *args, *ws, use_reentrant=False)


class ServingLM(nn.Module):
    """What the model families share: the device, the KV layout, the
    top-level parameters of ``param_specs`` and the compute-dtype weight
    copies. ``LISTS`` are the top-level keys the reference keeps as a
    list of unlike layers, not a stack (``bridge.reference_tree``).

    On the ``meta`` device the model holds no weights: a train step's
    ``loss(params, batch)`` reads only the tree it is given
    (``training_model``)."""

    LISTS: Tuple[str, ...] = ()

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kv_quant: str = "off", page_size: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.kv_quant = check_kv_quant(kv_quant)
        if page_size < 0:
            raise ValueError(f"page_size {page_size}: expected >= 0")
        self.page_size = int(page_size)
        self.cdtype = torch_dtype(cfg.compute_dtype)
        _add_params(self, {k: s for k, s in param_specs(cfg).items()
                           if "." not in k}, self.device)
        self._cast: Dict[int, Tuple[int, int, torch.Tensor]] = {}

    def own_tree(self) -> Dict[str, Any]:
        """The module's own weights as the reference's parameter tree (the
        stacked layers copied into one tensor a leaf)."""
        return reference_tree(dict(self.named_parameters()), self.LISTS)

    def cache_batch_axes(self) -> Cache:
        """The batch axis of every leaf of ``init_cache``'s tree: where the
        leaf's ``cache_logical_axes`` has ``act_batch`` (a QKVCache's codes
        and scales share the codes' one; a paged leaf's is its table's,
        through which the paged engine writes)."""
        def axis(ax):
            if isinstance(ax, dict):
                return {k: axis(v) for k, v in ax.items()}
            if isinstance(ax, list):
                return [axis(v) for v in ax]
            if isinstance(ax, PagedKVCache):
                return axis(ax.table)
            if isinstance(ax, QKVCache):
                return axis(ax.codes)
            return ax.index("act_batch")
        return axis(self.cache_logical_axes())

    def with_kv_layout(self, kv_quant: str = "off", page_size: int = 0):
        """This model (weights shared, not copied) serving from another KV
        layout."""
        if (kv_quant, page_size) == (self.kv_quant, self.page_size):
            return self
        other = copy.copy(self)
        other.kv_quant = check_kv_quant(kv_quant)
        other.page_size = int(page_size)
        return other

    # -- weights in compute dtype (cast once, recast after an in-place load) --
    def _w(self, p: torch.Tensor) -> torch.Tensor:
        if p.dtype == self.cdtype:
            return p
        hit = self._cast.get(id(p))
        if hit is None or hit[0] != p._version or hit[1] != p.data_ptr():
            hit = (p._version, p.data_ptr(), p.detach().to(self.cdtype))
            self._cast[id(p)] = hit
        return hit[2]

    def _ws(self, group: nn.Module) -> Dict[str, torch.Tensor]:
        """The group's own weights in compute dtype, by name."""
        return {n: self._w(t) for n, t in group.named_parameters(recurse=False)}

    def _embed(self, tokens: torch.Tensor,
               patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._w(self.embed)[tokens.long()]
        if patch_embeds is None:
            return x
        return torch.cat([patch_embeds.to(device=x.device, dtype=x.dtype), x],
                         dim=1)

    def _mlp_residual(self, blk: nn.Module, h: torch.Tensor) -> torch.Tensor:
        xn2 = rms_norm(h, blk.ln2, self.cfg.norm_eps)
        if self.cfg.num_experts > 0:
            return h + moe_ffn(self.cfg, self._ws(blk.moe), xn2)
        m = self._ws(blk.mlp)
        return h + gated_mlp(xn2, m["wi_gate"], m["wi_up"], m["wo"])


class TransformerLM(ServingLM):
    """Decoder LM (dense, MoE or VLM) on one device (``"cuda"`` by
    default), serving from a KV cache laid out as ``kv_quant`` and
    ``page_size`` say."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kv_quant: str = "off", page_size: int = 0):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerLM is the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        super().__init__(cfg, device, kv_quant=kv_quant, page_size=page_size)
        self.blocks = nn.ModuleList(Block(cfg, self.device)
                                    for _ in range(cfg.num_layers))

    @property
    def window(self) -> int:
        cfg = self.cfg
        return cfg.sliding_window if cfg.attention_kind == "sliding" else 0

    def _qkv(self, blk: Block, xn: torch.Tensor, positions: torch.Tensor):
        return qkv(self.cfg, self._ws(blk.attn), xn, positions)

    def _finish_block(self, blk: Block, h: torch.Tensor,
                      o: torch.Tensor) -> torch.Tensor:
        return self._mlp_residual(blk, h + attn_out(self._ws(blk.attn), o))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = (self._w(self.embed).T if self.cfg.tie_embeddings
                else self._w(self.head))
        return dense(x, head, "bsd,dv->bsv")

    # -- full-sequence forward and loss ------------------------------------
    def forward(self, tokens: torch.Tensor,
                params: Optional[Dict[str, Any]] = None,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) tokens (after ``patch_embeds`` (B, P, D), if given) ->
        (B, P + S, V) logits, differentiable in ``params`` (a parameter tree
        in the reference's layout); without ``params``, from the module's own
        weights under ``no_grad``."""
        if params is None:
            with torch.no_grad():
                return self._tree_forward(self.own_tree(), tokens,
                                          patch_embeds)
        return self._tree_forward(params, tokens, patch_embeds)

    def _tree_block(self, x, p, positions) -> torch.Tensor:
        """One block (counterpart: the reference's ``_block``) from weights
        in any dtype; ``dense`` casts each to the compute dtype inside the
        graph (and inside the recompute)."""
        cfg = self.cfg
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = qkv(cfg, p["attn"], xn, positions)
        o = chunked_attention(q, k, v, causal=True, window=self.window,
                              chunk_q=cfg.attn_chunk_q,
                              chunk_kv=cfg.attn_chunk_kv)
        x = x + attn_out(p["attn"], o)
        xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.num_experts > 0:
            return x + moe_ffn(cfg, p["moe"], xn2)
        m = p["mlp"]
        return x + gated_mlp(xn2, m["wi_gate"], m["wi_up"], m["wo"])

    def _tree_forward(self, params: Dict[str, Any], tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens.long(), params["embed"].to(self.cdtype))
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.device, self.cdtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for p in layer_trees(params["blocks"], cfg.num_layers):
            x = remat_call(cfg, self._tree_block, x, p, positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return dense(x, head, "bsd,dv->bsv")

    def loss(self, params: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` (``tokens``,
        ``labels``, optional ``loss_mask`` and, for a VLM, ``patch_embeds``
        (B, P, D), whose P positions' logits are dropped before the shift)
        under ``params``."""
        patch = batch.get("patch_embeds")
        logits = self.forward(batch["tokens"], params, patch)
        if patch is not None:
            logits = logits[:, patch.shape[1]:]
        mask = batch.get("loss_mask")
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                            None if mask is None else mask[:, 1:])

    # -- serving -----------------------------------------------------------
    def cache_len(self, max_len: int) -> int:
        """Ring slots per sequence: ``max_len`` (the window for sliding
        attention), rounded up to whole pages when paged."""
        cfg = self.cfg
        if cfg.attention_kind == "sliding" and cfg.sliding_window > 0:
            max_len = min(max_len, cfg.sliding_window)
        return aligned_cache_len(max_len, self.page_size)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        T = self.cache_len(max_len)
        kv = (cfg.num_layers, batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)
        dev = self.device

        def leaf():
            return kv_cache_init(kv, self.cdtype, self.kv_quant,
                                 self.page_size, dev)
        return {
            "k": leaf(), "v": leaf(),
            "pos_ids": torch.full((batch, T), -1, dtype=torch.int32, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    def cache_logical_axes(self) -> Cache:
        """The logical axes of every leaf of ``init_cache``'s tree, in this
        model's KV layout (the reference's ``cache_logical_axes``)."""
        kv = kv_cache_axes(("layers", "act_batch", "cache_seq", "cache_kv",
                            "cache_hd"), self.kv_quant, self.page_size)
        return {"k": kv, "v": kv, "pos_ids": ("act_batch", "cache_seq"),
                "pos": ("act_batch",)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                full_logits: bool = False,
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, S), after ``patch_embeds`` (B, P, D) if given;
        return last-position logits (B, 1, V) (every position with
        ``full_logits``) and the cache pre-sized for ``max_len`` positions
        (the patch prefix holds positions 0 .. P - 1)."""
        x = self._embed(tokens, patch_embeds)
        B, S, _ = x.shape
        T = self.cache_len(max(max_len or S, S))
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        ks, vs = [], []

        def store(t):
            return kv_cache_store(t.to(self.cdtype), S, T, self.kv_quant,
                                  self.page_size)
        for blk in self.blocks:
            xn = rms_norm(x, blk.ln1, self.cfg.norm_eps)
            q, k, v = self._qkv(blk, xn, positions)
            o = chunked_attention(q, k, v, causal=True, window=self.window)
            x = self._finish_block(blk, x, o)
            ks.append(store(k))
            vs.append(store(v))
        logits = self._logits(x if full_logits else x[:, -1:])
        cache = {
            "k": stack_kv(ks), "v": stack_kv(vs),
            "pos_ids": ring_position_ids(B, S, T, x.device),
            "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
        }
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    layers: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S): append S tokens per row at per-slot positions
        ``cache["pos"]`` and return their logits (B, S, V). S > 1 is a verify
        block written at consecutive slots; ``layers`` runs (and writes the
        cache of) only the first N blocks. Updates ``cache`` in place: every
        tensor stays the same object (``pos`` advances by S), which a CUDA
        graph of the decode chunk replays on."""
        S = tokens.shape[1]
        x = self._embed(tokens)
        pos = cache["pos"]
        T = kv_cache_len(cache["k"])
        block_pos = pos[:, None] + torch.arange(S, dtype=pos.dtype,
                                                device=pos.device)
        slot = block_pos % T
        ring_cache_update(cache["pos_ids"], block_pos, slot)
        # rows share expert capacity, so colliding trash-page writes must
        # land as the reference's do: one gather index for every layer
        last = (paged_last_writers(cache["k"][0], slot)
                if self.cfg.num_experts > 0 else None)
        blocks = self.blocks if layers is None else self.blocks[:layers]
        for i, blk in enumerate(blocks):
            xn = rms_norm(x, blk.ln1, self.cfg.norm_eps)
            q, k, v = self._qkv(blk, xn, block_pos)
            if last is not None:
                k = k.flatten(0, 1)[last].view_as(k)
                v = v.flatten(0, 1)[last].view_as(v)
            ck = kv_cache_update(cache["k"][i], k, slot, self.kv_quant)
            cv = kv_cache_update(cache["v"][i], v, slot, self.kv_quant)
            o = chunked_attention(q, kv_cast(ck, x.dtype), kv_cast(cv, x.dtype),
                                  causal=True, window=self.window,
                                  q_offset=pos, kv_positions=cache["pos_ids"])
            x = self._finish_block(blk, x, o)
        pos.add_(S)
        return self._logits(x), cache



def model_class(cfg: ModelConfig) -> type:
    """The module class of ``cfg``'s family."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM
    # the other families' modules build on this one
    if cfg.family == "hybrid":
        from repro_torch.models.recurrent_lm import GriffinLM
        return GriffinLM
    if cfg.family == "ssm":
        from repro_torch.models.recurrent_lm import XLSTMLM
        return XLSTMLM
    if cfg.family == "audio":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM
    raise ValueError(f"unknown model family {cfg.family!r}")


def build_model(cfg: ModelConfig, device="cuda", *, kv_quant: str = "off",
                page_size: int = 0) -> ServingLM:
    return model_class(cfg)(cfg, device, kv_quant=kv_quant,
                            page_size=page_size)


def training_model(cfg: ModelConfig) -> ServingLM:
    """``cfg``'s model with no weights of its own (on the ``meta``
    device): what a train step's ``loss(params, batch)`` needs, so that the
    tree being trained is the only copy of the weights."""
    return build_model(cfg, "meta")
