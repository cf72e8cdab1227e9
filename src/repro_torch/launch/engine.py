"""Continuous-batching serving engine over the fused decode loop, contiguous
KV layout (counterpart: ``repro/launch/engine.py``, ``ServeEngine``).

Callers submit :class:`Request`s and get :class:`Completion`s back. The engine
keeps ``slots`` rows of one pre-sized ring KV cache. Between fused decode
chunks it retires finished sequences (from the on-device ``done`` flags and
``n_valid`` counts) and prefills queued prompts into the freed rows: each
prompt is left-padded to the ``prompt_len`` bucket, prefilled at batch 1 and
copied into its slot row. Every request ends in exactly one completion:
``length``, ``eos``, or an ``error`` with a typed reason for a prompt that
is too long or malformed.

Paged and quantized caches, speculative decoding, deadlines, retries and
fault injection are ported in later slices.
"""
from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.steps import make_generate_step


class ErrorReason(str, enum.Enum):
    """Typed ``Completion.reason`` values."""

    PROMPT_TOO_LONG = "prompt_too_long"   # prompt exceeds the engine bucket
    BAD_REQUEST = "bad_request"           # empty prompt, bad ids or extras
    NAN_LOGITS = "nan_logits"             # finite guard retired the slot

    def __str__(self) -> str:
        return self.value


@dataclass
class Request:
    """One generation request; ``tokens`` is a 1-D int prompt. Prompts longer
    than the bucket complete with a ``prompt_too_long`` error."""

    uid: int
    tokens: np.ndarray
    max_new_tokens: int
    extras: Optional[Dict[str, Any]] = None


@dataclass
class Completion:
    uid: int
    tokens: np.ndarray            # generated token ids (1-D)
    finish_reason: str            # "length" | "eos" | "error"
    error: Optional[str] = None
    reason: Optional[str] = None  # ErrorReason value when error, else None


@dataclass
class _Slot:
    request: Request
    cap: int                      # per-request generation cap
    produced: List[int] = field(default_factory=list)


class PromptTooLongError(ValueError):
    """Prompt exceeds the engine's prompt bucket (no silent truncation)."""


class ServeEngine:
    """Slot-based continuous batching over :func:`make_generate_step`.

    Args:
      model: a ``TransformerLM``; the engine runs on its device.
      slots: concurrently decoded sequences (cache batch rows).
      prompt_len: prompt bucket (left-padded; longer prompts are rejected).
      max_new: per-request generation cap; the cache holds
        ``max_len = prompt_len + max_new`` positions.
      chunk: decode steps per fused chunk (one host sync each).
      eos_id: stop token (None = length-only stopping).
      temperature/top_k: sampling (0 temperature = greedy).
    """

    def __init__(self, model, *, slots: int = 4, prompt_len: int = 32,
                 max_new: int = 32, chunk: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        if max_new < 1 or prompt_len < 1:
            raise ValueError(f"prompt_len {prompt_len} and max_new {max_new} "
                             "must be positive")
        self.model = model
        self.device = model.device
        self.slots, self.prompt_len, self.chunk = slots, prompt_len, chunk
        self.max_new, self.eos_id = max_new, eos_id
        self.max_len = prompt_len + max_new
        self._generate = make_generate_step(model, chunk=chunk,
                                            temperature=temperature,
                                            top_k=top_k)
        # empty slot rows are zeros, like the reference's tiled template
        self.cache = model.init_cache(slots, self.max_len)
        self.cache["pos_ids"].zero_()
        self._tok = torch.zeros((slots, 1), dtype=torch.int32,
                                device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, _Slot] = {}
        self._free: List[int] = list(range(slots))[::-1]
        self.completions: List[Completion] = []
        self.stats: Dict[str, Any] = {
            "decode_dispatches": 0, "decode_steps": 0, "prefills": 0,
            "tokens_out": 0, "wall_seconds": 0.0, "error_completions": 0,
        }

    # -- queue interface ---------------------------------------------------
    def _error(self, uid: int, tokens, reason: ErrorReason, msg: str) -> None:
        self.completions.append(Completion(
            uid=uid, tokens=np.asarray(tokens, np.int32).reshape(-1),
            finish_reason="error", error=msg, reason=reason.value))
        self.stats["error_completions"] += 1

    def submit(self, request: Request) -> None:
        self._queue.append(request)

    def _prefill_tokens(self, req: Request) -> torch.Tensor:
        """The prompt left-padded to the (1, prompt_len) bucket."""
        t = np.asarray(req.tokens, np.int32).reshape(-1)
        if len(t) > self.prompt_len:
            raise PromptTooLongError(
                f"request {req.uid}: prompt has {len(t)} tokens, engine "
                f"bucket holds {self.prompt_len} (submit shorter prompts or "
                "build the engine with a larger prompt_len)")
        if len(t) < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        vocab = self.model.cfg.vocab_size
        if t.min() < 0 or t.max() >= vocab:
            # an out-of-range id would fault the embedding gather on the card
            raise ValueError(f"request {req.uid}: token ids must lie in "
                             f"[0, {vocab}), got [{t.min()}, {t.max()}]")
        if req.extras:
            raise ValueError(f"request {req.uid}: family "
                             f"{self.model.cfg.family!r} takes no extras, got "
                             f"{sorted(req.extras)}")
        toks = np.zeros((1, self.prompt_len), np.int32)
        toks[0, self.prompt_len - len(t):] = t
        return torch.from_numpy(toks).to(self.device)

    def _admit(self) -> None:
        while self._free and self._queue:
            req = self._queue[0]
            try:
                toks = self._prefill_tokens(req)
            except PromptTooLongError as e:
                self._queue.popleft()
                self._error(req.uid, (), ErrorReason.PROMPT_TOO_LONG, str(e))
                continue
            except ValueError as e:
                self._queue.popleft()
                self._error(req.uid, (), ErrorReason.BAD_REQUEST, str(e))
                continue
            self._queue.popleft()
            slot = self._free.pop()
            logits, small = self.model.prefill(toks, max_len=self.max_len)
            cap = min(req.max_new_tokens, self.max_len - self.prompt_len)
            first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            c = self.cache
            c["k"][:, slot] = small["k"][:, 0]
            c["v"][:, slot] = small["v"][:, 0]
            c["pos_ids"][slot] = small["pos_ids"][0]
            c["pos"][slot] = small["pos"][0]
            self._tok[slot, 0] = first[0]
            self._active[slot] = _Slot(request=req, cap=cap)
            self.stats["prefills"] += 1

    def step(self) -> bool:
        """Admit waiting requests, run one fused decode chunk, retire
        finished slots. Returns False when fully drained."""
        self._admit()
        if not self._active:
            return bool(self._queue)
        eos = -1 if self.eos_id is None else int(self.eos_id)
        (self.cache, self._tok, self._gen, done, n_valid, toks,
         failed) = self._generate(self.cache, self._tok, self._gen, eos)
        # ONE host sync per chunk: tokens and per-slot flags in one transfer
        host = torch.cat([toks, done[:, None].to(torch.int32),
                          n_valid[:, None], failed[:, None].to(torch.int32)],
                         dim=1).cpu().numpy()
        toks_np, done_np = host[:, :self.chunk], host[:, self.chunk] != 0
        n_np, failed_np = host[:, self.chunk + 1], host[:, self.chunk + 2] != 0
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += self.chunk
        for slot in list(self._active):
            st = self._active[slot]
            take = min(int(n_np[slot]), st.cap - len(st.produced))
            st.produced.extend(int(t) for t in toks_np[slot][:take])
            if bool(done_np[slot]) and take == int(n_np[slot]):
                self._retire(slot, "eos")
            elif len(st.produced) >= st.cap:
                self._retire(slot, "length")
            elif bool(failed_np[slot]):
                self._retire(slot, "error",
                             error=f"non-finite logits after "
                                   f"{len(st.produced)} tokens")
        return bool(self._active or self._queue)

    def _retire(self, slot: int, finish: str,
                error: Optional[str] = None) -> None:
        st = self._active.pop(slot)
        self._free.append(slot)
        self.stats["tokens_out"] += len(st.produced)
        if finish == "error":
            self._error(st.request.uid, st.produced, ErrorReason.NAN_LOGITS,
                        error or "non-finite logits")
        else:
            self.completions.append(Completion(
                uid=st.request.uid, tokens=np.asarray(st.produced, np.int32),
                finish_reason=finish))

    def run(self, requests: Optional[List[Request]] = None) -> List[Completion]:
        """Drain the queue (plus ``requests``); returns all completions."""
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats["wall_seconds"] += time.perf_counter() - t0
        self.stats["tokens_per_second"] = self.stats["tokens_out"] / max(
            self.stats["wall_seconds"], 1e-9)
        self.stats["dispatches_per_token"] = (
            self.stats["decode_dispatches"] / max(self.stats["tokens_out"], 1))
        return self.completions
