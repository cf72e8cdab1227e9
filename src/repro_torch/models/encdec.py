"""Encoder-decoder LM, the audio family (counterpart:
``repro/models/encdec.py``, ``EncDecLM``; the seamless-m4t-large-v2
backbone).

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``src_embeds`` (B, src_len, d_model), cast to
the compute dtype. The encoder's layers are self-attention (non-causal,
RoPE) and a gated MLP, then ``enc_norm``; the decoder's are causal
self-attention, cross-attention over the encoder's output (non-causal, no
RoPE) and a gated MLP, then ``final_norm`` and an untied ``head``.
Parameters carry the reference's keys with both layer stacks unrolled:
``enc_blocks.<i>.attn.w_q``, ``dec_blocks.<i>.cross_attn.w_k``, ...

Training is functional over the reference's tree (``enc_blocks`` and
``dec_blocks`` stacked on a leading axis): ``forward(tokens, src_embeds,
params)`` and ``loss(params, batch)`` with ``batch["src_embeds"]``, each
layer of both stacks recomputed in the backward as the reference
checkpoints its scan bodies.

Serving keeps two caches per decoder layer:

    k / v    (L, B, T, H, D)    the self-attention cache, in the model's KV
                                layout (``kv_quant``, ``page_size``)
    xk / xv  (L, B, src, H, D)  the cross-attention cache, the encoder's
                                projected output: codes when ``kv_quant``
                                is on, always contiguous, the exact source
                                length
    pos      (B,) int32

The self cache is not a ring: the prefill pre-sizes it for ``max_len``
positions, a decode step writes at ``min(pos, T - 1)`` and masks positions
from ``pos + 1`` on (``kv_valid_len``), and there are no ``pos_ids``. Every
attention goes through ``chunked_attention``: the flash prefill kernel for
the encoder's self-attention and each decoder layer's two prefill
attentions (72 launches a prefill at 24 + 24 layers), and per decode step
the self cache's decode kernel and the contiguous one of the quant mode
for the cross cache.
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
                                       kv_cache_store,
                                       kv_cache_update, kv_cast, kv_quantize,
                                       rms_norm, softmax_xent, stack_kv)
from repro_torch.models.model import (Block, ServingLM, _add_params, _Group,
                                      attn_out, layer_trees, qkv, remat_call)
from repro_torch.models.module import (ParamSpec, attn_param_specs,
                                       block_specs, embed_spec, head_spec,
                                       mlp_param_specs, norm_spec,
                                       torch_dtype)

Cache = Dict[str, Any]


def dec_layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    dtype = torch_dtype(cfg.param_dtype)
    norm = norm_spec(cfg)
    specs = {"ln1": norm}
    specs.update({f"self_attn.{k}": s
                  for k, s in attn_param_specs(cfg, dtype).items()})
    specs["ln_x"] = norm
    specs.update({f"cross_attn.{k}": s
                  for k, s in attn_param_specs(cfg, dtype).items()})
    specs["ln2"] = norm
    specs.update({f"mlp.{k}": s
                  for k, s in mlp_param_specs(cfg, dtype).items()})
    return specs


def encdec_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Flat ``name -> ParamSpec`` of ``EncDecLM(cfg)``, in the reference's
    order."""
    dtype = torch_dtype(cfg.param_dtype)
    norm = norm_spec(cfg)
    specs = {"embed": embed_spec(cfg, dtype)}
    for i in range(cfg.num_encoder_layers):
        specs.update({f"enc_blocks.{i}.{k}": s
                      for k, s in block_specs(cfg).items()})
    specs["enc_norm"] = norm
    for i in range(cfg.num_layers):
        specs.update({f"dec_blocks.{i}.{k}": s
                      for k, s in dec_layer_specs(cfg).items()})
    specs["final_norm"] = norm
    specs["head"] = head_spec(cfg, dtype)
    return specs


class DecBlock(nn.Module):
    """ln1, self_attn.{w_q,w_k,w_v,w_o}, ln_x, cross_attn.{...}, ln2,
    mlp.{wi_gate,wi_up,wo}."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        specs = dec_layer_specs(cfg)
        _add_params(self, {k: specs[k] for k in ("ln1", "ln_x", "ln2")},
                    device)
        self.self_attn = _Group(attn_param_specs(cfg, dtype), device)
        self.cross_attn = _Group(attn_param_specs(cfg, dtype), device)
        self.mlp = _Group(mlp_param_specs(cfg, dtype), device)


class EncDecLM(ServingLM):
    """The encoder-decoder LM on one device (``"cuda"`` by default), its
    self-attention cache laid out as ``kv_quant`` and ``page_size`` say."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kv_quant: str = "off", page_size: int = 0):
        if cfg.family != "audio":
            raise ValueError(f"EncDecLM is the audio family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg, device, kv_quant=kv_quant, page_size=page_size)
        self.enc_blocks = nn.ModuleList(Block(cfg, self.device)
                                        for _ in range(cfg.num_encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, self.device)
                                        for _ in range(cfg.num_layers))

    # -- layers --------------------------------------------------------------
    def encode(self, src_embeds: torch.Tensor) -> torch.Tensor:
        """(B, src, D) frame embeddings -> the encoder's normed output in
        the compute dtype."""
        cfg = self.cfg
        h = src_embeds.to(device=self.device, dtype=self.cdtype)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for blk in self.enc_blocks:
            xn = rms_norm(h, blk.ln1, cfg.norm_eps)
            p = self._ws(blk.attn)
            q, k, v = qkv(cfg, p, xn, positions)
            h = h + attn_out(p, chunked_attention(q, k, v, causal=False))
            h = self._mlp_residual(blk, h)
        return rms_norm(h, self.enc_norm, cfg.norm_eps)

    def _cross_q(self, blk: DecBlock, h: torch.Tensor) -> torch.Tensor:
        xn = rms_norm(h, blk.ln_x, self.cfg.norm_eps)
        return dense(xn, self._ws(blk.cross_attn)["w_q"], "bsd,dhe->bshe")

    def _cross_kv(self, blk: DecBlock, enc_out: torch.Tensor):
        p = self._ws(blk.cross_attn)
        return (dense(enc_out, p["w_k"], "bsd,dhe->bshe"),
                dense(enc_out, p["w_v"], "bsd,dhe->bshe"))

    def _dec_block(self, blk: DecBlock, h, enc_out, positions):
        """One decoder layer over a full sequence: returns the new hidden
        state and the layer's self k / v (roped) and cross k / v."""
        cfg = self.cfg
        xn = rms_norm(h, blk.ln1, cfg.norm_eps)
        p = self._ws(blk.self_attn)
        q, k, v = qkv(cfg, p, xn, positions)
        h = h + attn_out(p, chunked_attention(q, k, v, causal=True))
        kx, vx = self._cross_kv(blk, enc_out)
        ox = chunked_attention(self._cross_q(blk, h), kx, vx, causal=False)
        h = h + attn_out(self._ws(blk.cross_attn), ox)
        return self._mlp_residual(blk, h), (k, v, kx, vx)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return dense(x, self._w(self.head), "bsd,dv->bsv")

    @staticmethod
    def _src(src_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        if src_embeds is None:
            raise ValueError("the encoder-decoder model needs src_embeds "
                             "(B, src_len, d_model)")
        return src_embeds

    # -- full-sequence forward and loss (counterpart: encode / forward /
    # loss) -----------------------------------------------------------------
    def forward(self, tokens: torch.Tensor,
                src_embeds: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """(B, S) tokens over (B, src, D) frames -> (B, S, V) logits,
        differentiable in ``params`` (a tree in the reference's layout);
        without ``params``, from the module's own weights under
        ``no_grad``."""
        if params is None:
            with torch.no_grad():
                return self._tree_forward(self.own_tree(), tokens,
                                          self._src(src_embeds))
        return self._tree_forward(params, tokens, self._src(src_embeds))

    def _tree_enc_block(self, h: torch.Tensor, p, positions) -> torch.Tensor:
        """An encoder layer (the reference's ``encode`` scan body) from
        weights in any dtype."""
        cfg = self.cfg
        q, k, v = qkv(cfg, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                      positions)
        h = h + attn_out(p["attn"], chunked_attention(q, k, v, causal=False))
        m = p["mlp"]
        return h + gated_mlp(rms_norm(h, p["ln2"], cfg.norm_eps),
                             m["wi_gate"], m["wi_up"], m["wo"])

    def _tree_dec_block(self, h: torch.Tensor, p, enc_out: torch.Tensor,
                        positions) -> torch.Tensor:
        """A decoder layer (the reference's ``_dec_block``): causal
        self-attention, cross-attention without RoPE, the MLP."""
        cfg = self.cfg
        sa, xa = p["self_attn"], p["cross_attn"]
        q, k, v = qkv(cfg, sa, rms_norm(h, p["ln1"], cfg.norm_eps), positions)
        h = h + attn_out(sa, chunked_attention(q, k, v, causal=True))
        qx = dense(rms_norm(h, p["ln_x"], cfg.norm_eps), xa["w_q"],
                   "bsd,dhe->bshe")
        kx = dense(enc_out, xa["w_k"], "bsd,dhe->bshe")
        vx = dense(enc_out, xa["w_v"], "bsd,dhe->bshe")
        h = h + attn_out(xa, chunked_attention(qx, kx, vx, causal=False))
        m = p["mlp"]
        return h + gated_mlp(rms_norm(h, p["ln2"], cfg.norm_eps),
                             m["wi_gate"], m["wi_up"], m["wo"])

    def _tree_forward(self, params: Dict[str, Any], tokens: torch.Tensor,
                      src_embeds: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = src_embeds.to(self.cdtype)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for p in layer_trees(params["enc_blocks"], cfg.num_encoder_layers):
            h = remat_call(cfg, self._tree_enc_block, h, p, positions)
        enc_out = rms_norm(h, params["enc_norm"], cfg.norm_eps)
        x = F.embedding(tokens.long(), params["embed"].to(self.cdtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for p in layer_trees(params["dec_blocks"], cfg.num_layers):
            x = remat_call(cfg, self._tree_dec_block, x, p, enc_out,
                           positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["head"], "bsd,dv->bsv")

    def loss(self, params: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of the decoder over
        ``batch["src_embeds"]`` under ``params``; ``loss_mask`` unsliced,
        as the reference passes it (ROADMAP §C)."""
        logits = self.forward(batch["tokens"], batch["src_embeds"], params)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                            batch.get("loss_mask"))

    # -- serving -----------------------------------------------------------
    def cache_len(self, max_len: int) -> int:
        """Self-cache positions per sequence: ``max_len``, whole pages
        when paged."""
        return aligned_cache_len(max_len, self.page_size)

    def init_cache(self, batch: int, max_len: int,
                   src_len: Optional[int] = None) -> Cache:
        """Zeros: the self cache for ``max_len`` positions, the cross cache
        for ``src_len`` frames (the reference's ``int(max_len *
        src_len_ratio)`` by default)."""
        cfg = self.cfg
        L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        if src_len is None:
            src_len = int(max_len * cfg.src_len_ratio)
        T = self.cache_len(max_len)

        def leaf(n, page_size):
            return kv_cache_init((L, batch, n, H, D), self.cdtype,
                                 self.kv_quant, page_size, self.device)
        return {"k": leaf(T, self.page_size), "v": leaf(T, self.page_size),
                "xk": leaf(src_len, 0), "xv": leaf(src_len, 0),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    def cache_logical_axes(self) -> Cache:
        """The logical axes of every leaf of ``init_cache``'s tree (the
        reference's ``cache_logical_axes``): the self cache in this model's
        KV layout, the cross cache contiguous (codes when quantized)."""
        axes = ("layers", "act_batch", "cache_seq", "cache_kv", "cache_hd")
        kv = kv_cache_axes(axes, self.kv_quant, self.page_size)
        xkv = kv_cache_axes(axes, self.kv_quant, 0)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
                "pos": ("act_batch",)}

    def _cross_store(self, x: torch.Tensor):
        x = x.to(self.cdtype)
        return x if self.kv_quant == "off" else kv_quantize(x, self.kv_quant)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                full_logits: bool = False,
                src_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Encode ``src_embeds`` (B, src, D), run the decoder over the
        prompt (B, S); return the last position's logits (B, 1, V) (every
        position's with ``full_logits``) and the caches: the self cache
        pre-sized for ``max_len`` positions, the cross cache at the exact
        source length."""
        enc_out = self.encode(self._src(src_embeds))
        h = self._embed(tokens)
        B, S, _ = h.shape
        T = self.cache_len(max(max_len or S, S))
        positions = torch.arange(S, dtype=torch.int32, device=h.device)

        def store(t):
            # S <= T: the ring store is a pad to T
            return kv_cache_store(t.to(self.cdtype), S, T, self.kv_quant,
                                  self.page_size)
        ks, vs, xks, xvs = [], [], [], []
        for blk in self.dec_blocks:
            h, (k, v, kx, vx) = self._dec_block(blk, h, enc_out, positions)
            ks.append(store(k))
            vs.append(store(v))
            xks.append(self._cross_store(kx))
            xvs.append(self._cross_store(vx))
        logits = self._logits(h if full_logits else h[:, -1:])
        cache = {"k": stack_kv(ks), "v": stack_kv(vs),
                 "xk": stack_kv(xks), "xv": stack_kv(xvs),
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=h.device)}
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: Cache,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, 1) at per-slot positions ``cache["pos"]``: the self
        cache written at ``min(pos, T - 1)`` and read up to ``pos``, the
        cross cache read whole. Returns the logits (B, 1, V) and updates
        ``cache`` in place: every tensor stays the same object (``pos``
        advances by 1), which a CUDA graph of the decode chunk replays
        on."""
        if tokens.shape[1] != 1:
            raise ValueError(f"EncDecLM.decode_step takes one token a row, "
                             f"got {tokens.shape[1]}")
        cfg = self.cfg
        h = self._embed(tokens)
        pos = cache["pos"]
        T = kv_cache_len(cache["k"])
        slot = torch.clamp(pos, max=T - 1)
        for i, blk in enumerate(self.dec_blocks):
            xn = rms_norm(h, blk.ln1, cfg.norm_eps)
            p = self._ws(blk.self_attn)
            q, k, v = qkv(cfg, p, xn, pos[:, None])
            ck = kv_cache_update(cache["k"][i], k, slot, self.kv_quant)
            cv = kv_cache_update(cache["v"][i], v, slot, self.kv_quant)
            o = chunked_attention(q, kv_cast(ck, h.dtype), kv_cast(cv, h.dtype),
                                  causal=True, q_offset=pos,
                                  kv_valid_len=pos + 1)
            h = h + attn_out(p, o)
            ox = chunked_attention(self._cross_q(blk, h),
                                   kv_cast(cache["xk"][i], h.dtype),
                                   kv_cast(cache["xv"][i], h.dtype),
                                   causal=False)
            h = h + attn_out(self._ws(blk.cross_attn), ox)
            h = self._mlp_residual(blk, h)
        pos.add_(1)
        return self._logits(h), cache
