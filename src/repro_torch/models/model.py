"""Dense decoder-only transformer LM (counterpart: ``repro/models/model.py``,
``TransformerLM`` with ``family="dense"``).

An ``nn.Module`` whose parameters carry the reference's keys
(``blocks.<i>.attn.w_q`` ...), held in ``param_dtype`` and applied in
``compute_dtype`` (the compute-dtype copies are cast once and cached).
Serving uses a pre-sized ring KV cache:

    prefill(tokens, max_len) -> (last_logits, cache)
    decode_step(cache, tokens) -> (logits, cache)   # cache updated in place
    init_cache(batch, max_len) -> cache

The cache is a dict: ``k``/``v`` ``(L, B, T, Hkv, D)`` in compute dtype,
``pos_ids`` ``(B, T)`` int32 (-1 = empty slot) and ``pos`` ``(B,)`` int32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (chunked_attention, dense, gated_mlp,
                                       ring_cache_store, ring_cache_update,
                                       ring_position_ids, rms_norm, rope)
from repro_torch.models.module import (attn_param_specs, block_specs,
                                       mlp_param_specs, param_specs,
                                       torch_dtype)

Cache = Dict[str, torch.Tensor]


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
    """ln1, attn.{w_q,w_k,w_v,w_o}, ln2, mlp.{wi_gate,wi_up,wo}."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        specs = block_specs(cfg)
        _add_params(self, {k: specs[k] for k in ("ln1", "ln2")}, device)
        self.attn = _Group(attn_param_specs(cfg, dtype), device)
        self.mlp = _Group(mlp_param_specs(cfg, dtype), device)


class TransformerLM(nn.Module):
    """Dense decoder LM on one device (``"cuda"`` by default)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is ported in a later slice")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cdtype = torch_dtype(cfg.compute_dtype)
        specs = param_specs(cfg)
        top = {k: s for k, s in specs.items() if not k.startswith("blocks.")}
        _add_params(self, top, self.device)
        self.blocks = nn.ModuleList(Block(cfg, self.device)
                                    for _ in range(cfg.num_layers))
        self._cast: Dict[int, Tuple[int, int, torch.Tensor]] = {}

    # -- weights in compute dtype (cast once, recast after an in-place load) --
    def _w(self, p: torch.Tensor) -> torch.Tensor:
        if p.dtype == self.cdtype:
            return p
        hit = self._cast.get(id(p))
        if hit is None or hit[0] != p._version or hit[1] != p.data_ptr():
            hit = (p._version, p.data_ptr(), p.detach().to(self.cdtype))
            self._cast[id(p)] = hit
        return hit[2]

    @property
    def window(self) -> int:
        cfg = self.cfg
        return cfg.sliding_window if cfg.attention_kind == "sliding" else 0

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._w(self.embed)[tokens.long()]

    def _qkv(self, blk: Block, xn: torch.Tensor, positions: torch.Tensor):
        a, theta = blk.attn, self.cfg.rope_theta
        q = dense(xn, self._w(a.w_q), "bsd,dhe->bshe")
        k = dense(xn, self._w(a.w_k), "bsd,dhe->bshe")
        v = dense(xn, self._w(a.w_v), "bsd,dhe->bshe")
        return rope(q, positions, theta), rope(k, positions, theta), v

    def _finish_block(self, blk: Block, h: torch.Tensor,
                      o: torch.Tensor) -> torch.Tensor:
        h = h + dense(o, self._w(blk.attn.w_o), "bshe,hed->bsd")
        xn2 = rms_norm(h, blk.ln2, self.cfg.norm_eps)
        m = blk.mlp
        return h + gated_mlp(xn2, self._w(m.wi_gate), self._w(m.wi_up),
                             self._w(m.wo))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = (self._w(self.embed).T if self.cfg.tie_embeddings
                else self._w(self.head))
        return dense(x, head, "bsd,dv->bsv")

    # -- full-sequence forward ---------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, V) logits."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for blk in self.blocks:
            xn = rms_norm(x, blk.ln1, self.cfg.norm_eps)
            q, k, v = self._qkv(blk, xn, positions)
            o = chunked_attention(q, k, v, causal=True, window=self.window)
            x = self._finish_block(blk, x, o)
        return self._logits(x)

    # -- serving -----------------------------------------------------------
    def cache_len(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.attention_kind == "sliding" and cfg.sliding_window > 0:
            return min(max_len, cfg.sliding_window)
        return max_len

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        T = self.cache_len(max_len)
        kv = (cfg.num_layers, batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)
        dev = self.device
        return {
            "k": torch.zeros(kv, dtype=self.cdtype, device=dev),
            "v": torch.zeros(kv, dtype=self.cdtype, device=dev),
            "pos_ids": torch.full((batch, T), -1, dtype=torch.int32, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                full_logits: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, S); return last-token logits (B, 1, V) (every
        position with ``full_logits``) and the cache pre-sized for
        ``max_len`` positions."""
        x = self._embed(tokens)
        B, S, _ = x.shape
        T = self.cache_len(max(max_len or S, S))
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        ks, vs = [], []
        for blk in self.blocks:
            xn = rms_norm(x, blk.ln1, self.cfg.norm_eps)
            q, k, v = self._qkv(blk, xn, positions)
            o = chunked_attention(q, k, v, causal=True, window=self.window)
            x = self._finish_block(blk, x, o)
            ks.append(ring_cache_store(k.to(self.cdtype), S, T))
            vs.append(ring_cache_store(v.to(self.cdtype), S, T))
        logits = self._logits(x if full_logits else x[:, -1:])
        cache = {
            "k": torch.stack(ks), "v": torch.stack(vs),
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
        cache of) only the first N blocks. Updates ``cache`` in place."""
        S = tokens.shape[1]
        x = self._embed(tokens)
        pos = cache["pos"]
        T = cache["k"].shape[2]
        block_pos = pos[:, None] + torch.arange(S, dtype=pos.dtype,
                                                device=pos.device)
        slot = block_pos % T
        ring_cache_update(cache["pos_ids"], block_pos, slot)
        blocks = self.blocks if layers is None else self.blocks[:layers]
        for i, blk in enumerate(blocks):
            xn = rms_norm(x, blk.ln1, self.cfg.norm_eps)
            q, k, v = self._qkv(blk, xn, block_pos)
            ck = ring_cache_update(cache["k"][i], k, slot)
            cv = ring_cache_update(cache["v"][i], v, slot)
            o = chunked_attention(q, ck.to(x.dtype), cv.to(x.dtype),
                                  causal=True, window=self.window,
                                  q_offset=pos, kv_positions=cache["pos_ids"])
            x = self._finish_block(blk, x, o)
        cache["pos"] = pos + S
        return self._logits(x), cache


def build_model(cfg: ModelConfig, device="cuda") -> TransformerLM:
    if cfg.family == "dense":
        return TransformerLM(cfg, device)
    raise NotImplementedError(f"family {cfg.family!r} is ported in a later slice")
