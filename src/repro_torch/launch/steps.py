"""Sampling and the fused decode loop (counterpart: ``repro/launch/steps.py``,
``logits_transform``, ``sample_tokens`` and ``make_generate_step`` with
speculation off).

The chunk is a Python loop over ``decode_step`` that stays on the device:
EOS detection, the finite guard and sampling are tensor ops, and the caller
reads the results with one host sync per chunk.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.models.layers import slot_isfinite


def logits_transform(logits: torch.Tensor, temperature: float,
                     top_k: int) -> torch.Tensor:
    """fp32 scale by ``temperature``, then everything below the k-th highest
    logit set to -1e30. Requires ``temperature > 0``."""
    lf = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, -1e30), lf)
    return lf


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """(..., V) logits -> (...) int32. ``temperature <= 0`` is greedy: the
    first maximal index; otherwise a draw from the top-k tempered softmax
    through ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits_transform(logits, temperature, top_k)
    probs = torch.softmax(lf, dim=-1).reshape(-1, lf.shape[-1])
    draw = torch.multinomial(probs, 1, generator=generator)
    return draw.reshape(lf.shape[:-1]).to(torch.int32)


def make_generate_step(model, *, chunk: int, temperature: float = 0.0,
                       top_k: int = 0):
    """Fused decode loop of ``chunk`` steps (speculation off; speculative
    decoding is ported in a later slice):

        generate_step(cache, tok, generator, eos_id)
            -> (cache, tok, generator, done, n_valid, toks, failed)

    ``tok`` (B, 1) is the next token to feed; ``toks`` (B, chunk) are the
    emitted tokens, the first being ``tok`` itself. ``eos_id`` -1 disables
    EOS. A slot that emits EOS is ``done``: its later tokens are the EOS
    token re-fed, and ``n_valid`` counts its tokens up to and including EOS.
    ``failed`` marks slots whose logits went non-finite; their counting
    stops with the last token sampled from finite logits. The cache is
    updated in place.
    """
    def generate_step(cache, tok: torch.Tensor,
                      generator: Optional[torch.Generator],
                      eos_id: Union[int, torch.Tensor]):
        B = tok.shape[0]
        dev = tok.device
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        failed = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_valid = torch.zeros((B,), dtype=torch.int32, device=dev)
        toks = []
        for _ in range(chunk):
            emitted = tok[:, 0]
            done_now = done | (emitted == eos_id)
            n_valid = n_valid + (~(done | failed)).to(torch.int32)
            logits, cache = model.decode_step(cache, tok)
            failed_now = failed | (~slot_isfinite(logits) & ~done_now)
            nxt = sample_tokens(logits[:, -1], generator, temperature, top_k)
            nxt = torch.where(done_now | failed_now, emitted, nxt)
            toks.append(emitted)
            tok, done, failed = nxt[:, None], done_now, failed_now
        return cache, tok, generator, done, n_valid, torch.stack(toks, 1), failed

    return generate_step
