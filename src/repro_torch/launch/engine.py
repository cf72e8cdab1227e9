"""Continuous-batching serving engine over the fused decode loop
(counterpart: ``repro/launch/engine.py``, ``ServeEngine``).

Callers submit :class:`Request`s and get :class:`Completion`s back. The engine
keeps ``slots`` rows of one pre-sized KV cache. Between fused decode chunks
it retires finished sequences (from the on-device ``done`` flags and
``n_valid`` counts) and prefills queued prompts into the freed rows, one
prompt at batch 1 each. Every request ends in exactly one completion:
``length``, ``eos``, or an ``error`` with a typed reason.

On the card a chunk is one CUDA graph replay. The cache, the next-token
buffer, the EOS id (a device scalar) and the sampler's generator live as
long as the engine, so its first chunk captures the graph once and every
later chunk replays it: slot inserts, page-table rows, copy-on-write and
positions are written in place into the tensors the graph reads.

The cache is laid out as the model says (``kv_quant``, ``page_size``):

* contiguous (ring per slot, values or Proteus codes and scales, and the
  hybrid family's recurrent states): each prompt is left-padded to the
  ``prompt_len`` bucket, the pads run through the model like tokens, and
  the prefill cache's rows are copied into the slot's rows along each
  leaf's batch axis (``model.cache_batch_axes()``);
* paged: fixed-size pages live in one pool per leaf and each slot holds a
  page table. Prompts are right-padded, prefilled with every position's
  logits, and the first token is read at the true prompt end. A host-side
  free-list allocator hands out pool rows at admission and takes them back
  at retirement, so the memory committed to KV follows the tokens held.
  Full prompt pages are hash-consed across concurrent slots (prefix
  sharing, reference-counted, copied before a divergent write), and pool
  row 0 is the trash page: unused and retired slots point there. Admission
  reserves each request's worst-case pages, so decode can never run out of
  pages; a request that can never fit ends in a ``page_pool`` error.

With speculative decoding (``spec``: ``ngram`` or ``draft``) each chunk
iteration drafts ``spec_k`` tokens and verifies them in one (k + 1)-token
block (:func:`~repro_torch.launch.steps.make_generate_step`): a chunk may
write ``chunk * (spec_k + 1)`` positions, so the cache holds ``spec_k`` rows
of slack, page reservations and copy-on-write cover that span, and each slot
keeps the drafter's history (its prompt, then its committed tokens) on the
device. Greedy completions equal those with speculation off.

Fault tolerance (the reference's contract: adapt, don't crash). A bounded
frontend queue (``max_queue``) rejects overflow with ``queue_full``
completions; per-request deadlines retire expired work (``deadline``, with
the partial tokens); the chunk's on-device finite guard quarantines exactly
the slot whose logits went non-finite (``nan_logits``); transient failures
before a dispatch retry with backoff, and a failed dispatch or a retry
budget spent ends everything in flight with ``step_failure`` and leaves
the engine dead; a :class:`StragglerMonitor` watchdog over the chunk sheds
load under sustained pressure (speculation off, then the chunk halved;
greedy tokens unchanged); ``snapshot()`` / ``load_snapshot()`` carry the
queue and each slot's progress through a ``RestartManifest`` (a restore
regenerates in-flight requests from their prompts). A seeded
:class:`~repro_torch.distributed.chaos.ChaosMonkey` (``chaos``) injects
each of these faults. Every submitted request ends in exactly one
:class:`Completion`.

Where the card changes the design:

* NaN injection is a ``logits_hook`` inside the chunk, captured only when
  the chaos config wants NaN; the per-slot poison positions ``arm`` are a
  static input of the graph, copied in before each replay, so armed and
  clean chunks replay one graph, and a clean engine's graph is the
  unhooked one.
* A shed level is a new decode program, so a new graph capture (0.5-1.2 s
  at full width). It is built in ``_shed`` and captured on its first call,
  inside the watchdog's window, as the reference compiles there; each
  level's capture time is in ``stats["shed_capture_seconds"]``. The
  level-0 program keeps its graph; a deeper shed level drops the previous
  shed program, freeing its graph's memory pool.
* The watchdog's window opens before the injected faults and closes after
  the chunk's one host read: a replay returns before the card finishes, so
  the replay alone would time nothing.
* A dispatch that raises (a sticky CUDA error surfaces at the replay or at
  the host read) kills the engine: it touches no device buffer afterwards.
* A restore regenerates in-flight requests where the reference's paged
  layout resumes from ``prompt + produced``: a re-prefilled prefix need
  not reproduce the decode-time cache on the card (see
  :meth:`ServeEngine.load_snapshot`), and regeneration keeps restored
  drains byte-identical. ``resume=True`` keeps the reference's shortcut.
"""
from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.chaos import (ChaosConfig, ChaosMonkey,
                                           TransientStepError,
                                           nan_logits_hook)
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.launch.steps import make_generate_step, spec_config
from repro_torch.models.layers import (PagedKVCache, QKVCache, TRASH_PAGE,
                                       kv_zeros)


class ErrorReason(str, enum.Enum):
    """Typed ``Completion.reason`` values: the engine's and the fleet's
    failure model."""

    PROMPT_TOO_LONG = "prompt_too_long"   # prompt exceeds the engine bucket
    BAD_REQUEST = "bad_request"           # empty prompt, bad ids or extras
    QUEUE_FULL = "queue_full"             # bounded frontend queue overflow
    DEADLINE = "deadline"                 # per-request deadline expired
    PAGE_POOL = "page_pool"               # KV page pool cannot hold request
    NAN_LOGITS = "nan_logits"             # finite guard retired the slot
    STEP_FAILURE = "step_failure"         # chunk dispatch failed (post-retry)
    SHARD_LOST = "shard_lost"             # fleet shard died, replay impossible

    def __str__(self) -> str:
        return self.value


@dataclass
class Request:
    """One generation request; ``tokens`` is a 1-D int prompt. Prompts longer
    than the bucket complete with a ``prompt_too_long`` error.
    ``deadline_ms``: wall-clock budget from submission; expiry retires the
    request with a ``deadline`` error carrying the tokens produced."""

    uid: int
    tokens: np.ndarray
    max_new_tokens: int
    extras: Optional[Dict[str, Any]] = None
    deadline_ms: Optional[float] = None


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
    n: int = 0                    # true prompt length
    produced: List[int] = field(default_factory=list)
    chunks: int = 0               # decode chunks dispatched since insert


class PromptTooLongError(ValueError):
    """Prompt exceeds the engine's prompt bucket (no silent truncation)."""


class PagePoolExhaustedError(RuntimeError):
    """The KV page pool has no free page. Admission reserves every active
    slot's worst case, so only external pressure (the chaos harness
    stealing pages) raises this; the engine retires the request that needed
    the page with a ``page_pool`` error."""

    def __init__(self, alloc: "_PageAllocator", what: str):
        self.pool_stats = {"n_phys": alloc.n_phys, "free": len(alloc.free),
                           "used": alloc.used,
                           "registered": len(alloc.registry)}
        super().__init__(
            f"KV page pool exhausted during {what}: {alloc.used}/"
            f"{alloc.n_phys - 1} pages in use, {len(alloc.free)} free, "
            f"{len(alloc.registry)} prefix-registered")


class _PageAllocator:
    """Host-side free-list allocator over the physical page pool.

    Pool row 0 is the trash page and is never handed out. ``refs`` counts the
    slot-table entries that point at each page; ``registry`` hash-conses full
    prompt pages, (logical page index, prefix-token bytes) -> page. A
    registered page leaves the registry when its last reference drops, so
    sharing is across concurrent slots.
    """

    def __init__(self, n_phys: int):
        self.n_phys = n_phys
        self.free: List[int] = list(range(n_phys - 1, 0, -1))
        self.refs = np.zeros(n_phys, np.int32)
        self.registry: Dict[Tuple[int, bytes], int] = {}
        self.reg_key: Dict[int, Tuple[int, bytes]] = {}
        self.hits = 0

    def alloc(self, what: str = "alloc") -> int:
        if not self.free:
            raise PagePoolExhaustedError(self, what)
        phys = self.free.pop()
        self.refs[phys] = 1
        return phys

    def lookup(self, key: Tuple[int, bytes]) -> Optional[int]:
        phys = self.registry.get(key)
        if phys is not None:
            self.refs[phys] += 1
            self.hits += 1
        return phys

    def register(self, phys: int, key: Tuple[int, bytes]) -> None:
        self.registry[key] = phys
        self.reg_key[phys] = key

    def unregister(self, phys: int) -> None:
        key = self.reg_key.pop(phys, None)
        if key is not None:
            self.registry.pop(key, None)

    def decref(self, phys: int) -> None:
        self.refs[phys] -= 1
        if self.refs[phys] == 0:
            self.unregister(phys)
            self.free.append(phys)

    @property
    def used(self) -> int:
        return int((self.refs > 0).sum())


def _pools(pages) -> List[torch.Tensor]:
    """The tensors of a pool: values, or codes and scales."""
    return [pages.codes, pages.scale] if isinstance(pages, QKVCache) \
        else [pages]


def _put_rows(big, small, axis, slot: int) -> None:
    """Copy batch row 0 of every leaf of the cache ``small`` into row
    ``slot`` of the same leaf of ``big``; ``axis`` is a tree of the caches'
    structure that gives each leaf's batch axis."""
    if isinstance(big, dict):
        for name in big:
            _put_rows(big[name], small[name], axis[name], slot)
    elif isinstance(big, list):
        for b, s, a in zip(big, small, axis):
            _put_rows(b, s, a, slot)
    else:
        for b, s in zip(_pools(big), _pools(small)):
            b.select(axis, slot).copy_(s.select(axis, 0))


class ServeEngine:
    """Slot-based continuous batching over :func:`make_generate_step`.

    Args:
      model: a ``TransformerLM`` or ``GriffinLM``; the engine runs on its
        device and serves from the KV layout of its ``kv_quant`` and
        ``page_size``.
      slots: concurrently decoded sequences (cache batch rows).
      prompt_len: prompt bucket (longer prompts are rejected).
      max_new: per-request generation cap; the cache holds
        ``max_len = prompt_len + max_new`` positions, ``spec_k`` more with
        speculation (whole pages when paged).
      chunk: decode steps per fused chunk (one host sync each; one graph
        replay on the card).
      eos_id: stop token (None = length-only stopping).
      temperature/top_k: sampling (0 temperature = greedy).
      spec/spec_k/draft_layers: speculative decoding (``off``, ``ngram``,
        ``draft``; see :func:`~repro_torch.launch.steps.spec_config`), the
        draft length (default 3) and the ``draft`` mode's layer budget
        (default half the layers). Stats gain ``spec_draft_iters``,
        ``spec_emitted_tokens``, the accepted-length histogram
        ``spec_accept_hist`` (bin i: iterations that committed i + 1
        tokens) and, after ``run``, ``spec_accepted_len_per_draft``.
      page_pool_pages: physical pages of the paged pool (default
        ``slots`` times the pages of one slot, the worst case). A smaller
        pool makes admission wait until a request's worst-case pages fit.
      max_queue: bound on the waiting queue (active slots apart);
        submissions past it complete at once with a ``queue_full`` error.
        None = unbounded.
      deadline_ms: default wall-clock budget of requests that carry no
        ``Request.deadline_ms``. None = no deadline.
      chaos: a :class:`~repro_torch.distributed.chaos.ChaosConfig` arming
        the seeded fault injection for this engine.
      max_retries/retry_backoff_s: retries of a transient failure before a
        dispatch, the n-th after ``n * retry_backoff_s`` seconds; past the
        budget (or on a failed dispatch) everything in flight ends with
        ``step_failure``.
      straggler_threshold/shed_after: the chunk watchdog: a chunk slower
        than ``threshold x`` the wall-time EMA is a straggler event, and
        ``shed_after`` consecutive events shed load one level (speculation
        off, then the chunk halved); greedy tokens are unchanged.
      clock: monotonic-seconds callable for deadlines (tests inject one).
    """

    def __init__(self, model, *, slots: int = 4, prompt_len: int = 32,
                 max_new: int = 32, chunk: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, spec: str = "off",
                 spec_k: Optional[int] = None,
                 draft_layers: Optional[int] = None,
                 page_pool_pages: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 chaos: Optional[ChaosConfig] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.02,
                 straggler_threshold: float = 3.0, shed_after: int = 2,
                 clock: Optional[Callable[[], float]] = None):
        if max_new < 1 or prompt_len < 1:
            raise ValueError(f"prompt_len {prompt_len} and max_new {max_new} "
                             "must be positive")
        self.model = model
        self.device = model.device
        self.slots, self.prompt_len, self.chunk = slots, prompt_len, chunk
        self.max_new, self.eos_id = max_new, eos_id
        self.max_len = prompt_len + max_new
        self.paged = model.page_size > 0
        self.seed, self._temperature, self._top_k = seed, temperature, top_k
        self.max_queue, self.deadline_ms = max_queue, deadline_ms
        self.max_retries, self.retry_backoff_s = max_retries, retry_backoff_s
        self.shed_after = shed_after
        self._clock = clock or time.monotonic
        self._chaos = ChaosMonkey(chaos) if chaos is not None else None
        self._straggler = StragglerMonitor(threshold=straggler_threshold,
                                           warmup_steps=3)
        self._dead = False
        # NaN injection is captured into the chunk only when chaos wants
        # it; arming is data (arm[slot] = poison position, -1 disarmed)
        self._hook = (nan_logits_hook if self._chaos is not None
                      and self._chaos.cfg.wants_nan else None)
        self._arm_np = np.full((slots,), -1, np.int32)
        # speculation: a chunk writes up to chunk_span positions, k of them
        # past the last committed one, so the cache holds spec_k more rows
        self.spec, self.spec_k = spec_config(model, spec, spec_k)
        self._generate = make_generate_step(model, chunk=chunk,
                                            temperature=temperature,
                                            top_k=top_k, spec=self.spec,
                                            spec_k=self.spec_k,
                                            draft_layers=draft_layers,
                                            logits_hook=self._hook)
        self.chunk_span = self._generate.span
        # load shedding swaps in a degraded program (built in _shed);
        # self._generate stays the level-0 program with its graph
        self._spec_live, self._chunk_live = self.spec, chunk
        self._gen_shed = None
        self._cache_max = self.max_len + self.spec_k
        # empty slot rows are zeros, like the reference's tiled template
        if self.paged:
            cfg, dev = model.cfg, self.device
            self.page_size = model.page_size
            self.cache_pos_len = model.cache_len(self._cache_max)
            self.n_logical_pages = self.cache_pos_len // self.page_size
            # +1: pool row 0 is the trash page
            self.n_phys_pages = (slots * self.n_logical_pages
                                 if page_pool_pages is None
                                 else int(page_pool_pages)) + 1
            pool = (cfg.num_layers, self.n_phys_pages, self.page_size,
                    cfg.num_kv_heads, cfg.resolved_head_dim)
            table = (cfg.num_layers, slots, self.n_logical_pages)

            def leaf():                  # every table row on the trash page
                return PagedKVCache(
                    kv_zeros(pool, model.cdtype, model.kv_quant, dev),
                    torch.zeros(table, dtype=torch.int32, device=dev))
            self.cache = {
                "k": leaf(), "v": leaf(),
                "pos_ids": torch.zeros((slots, self.cache_pos_len),
                                       dtype=torch.int32, device=dev),
                "pos": torch.zeros((slots,), dtype=torch.int32, device=dev)}
            self._alloc = _PageAllocator(self.n_phys_pages)
            self._host_table = np.zeros((slots, self.n_logical_pages),
                                        np.int32)
            # prefix sharing needs page <-> position identity: a bucket
            # prefill that never ring-wraps
            self._share_ok = self.cache_pos_len >= self.prompt_len
        else:
            self.cache = model.init_cache(slots, self._cache_max)
            self.cache["pos_ids"].zero_()
            self._batch_axes = model.cache_batch_axes()
        self._tok = torch.zeros((slots, 1), dtype=torch.int32,
                                device=self.device)
        # the EOS id as the chunk reads it, so setting eos_id between chunks
        # takes effect in a captured graph too
        self._eos = torch.full((), -1, dtype=torch.int32, device=self.device)
        self._arm = (torch.full((slots,), -1, dtype=torch.int32,
                                device=self.device)
                     if self._hook is not None else None)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._spec_state: Tuple[torch.Tensor, ...] = ()
        if self.spec != "off":
            # the drafter's history: each slot's prompt and committed
            # tokens, room for the bucket, the cap and a chunk's overshoot
            self.hist_cap = prompt_len + max_new + self.chunk_span
            self._spec_state = (
                torch.zeros((slots, self.hist_cap), dtype=torch.int32,
                            device=self.device),
                torch.zeros((slots,), dtype=torch.int32, device=self.device))
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, _Slot] = {}
        self._free: List[int] = list(range(slots))[::-1]
        # admission reservation: worst-case pages per active slot
        self._reserved: Dict[int, int] = {}
        self._reserved_total = 0
        self._deadline_at: Dict[int, float] = {}     # uid -> absolute clock
        self._resume_prefix: Dict[int, List[int]] = {}   # restored progress
        self._pressure = 0                           # consecutive stragglers
        self.completions: List[Completion] = []
        self.stats: Dict[str, Any] = {
            "decode_dispatches": 0, "decode_steps": 0, "prefills": 0,
            "tokens_out": 0, "wall_seconds": 0.0, "chunk_seconds": [],
            "error_completions": 0, "kv_pages_in_use": 0, "kv_pages_peak": 0,
            "kv_pages_reserved": 0, "prefix_hits": 0, "admission_blocked": 0,
            "graph_captures": 0, "capture_seconds": 0.0, "draft_steps": 0,
            "deadline_miss": 0, "shed_events": 0, "retries": 0,
            "straggler_events": 0, "queue_peak": 0,
            "shed_capture_seconds": [],
        }
        if self.spec != "off":
            self.stats["spec_draft_iters"] = 0
            self.stats["spec_emitted_tokens"] = 0
            self.stats["spec_accept_hist"] = [0] * (self.spec_k + 1)
        kv = [t for name in ("k", "v") for t in self._leaf_tensors(name)]
        if self.paged:
            self._page_bytes = sum(t.nbytes // t.shape[1] for t in kv)
            self.stats["kv_hbm_bytes"] = 0
        else:
            # contiguous: the whole cache is committed up front (the ring
            # positions count, as in the reference)
            self.stats["kv_hbm_bytes"] = (sum(t.nbytes for t in kv)
                                          + self.cache["pos_ids"].nbytes)
        self.stats["kv_hbm_bytes_peak"] = self.stats["kv_hbm_bytes"]

    def _leaf_tensors(self, name: str) -> List[torch.Tensor]:
        leaf = self.cache[name]
        if isinstance(leaf, PagedKVCache):
            return _pools(leaf.pages)
        return _pools(leaf)

    # -- queue interface ---------------------------------------------------
    def _error(self, uid: int, tokens, reason: ErrorReason, msg: str) -> None:
        """Append a typed error completion (the one error path)."""
        self.completions.append(Completion(
            uid=uid, tokens=np.asarray(tokens, np.int32).reshape(-1),
            finish_reason="error", error=msg, reason=reason.value))
        self.stats["error_completions"] += 1
        self._deadline_at.pop(uid, None)

    def submit(self, request: Request) -> bool:
        """Enqueue a request; returns False (with an immediate
        ``queue_full`` error completion) when the bounded queue is full."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._error(request.uid, (), ErrorReason.QUEUE_FULL,
                        f"request {request.uid}: queue full "
                        f"({len(self._queue)}/{self.max_queue} waiting)")
            return False
        dl = (request.deadline_ms if request.deadline_ms is not None
              else self.deadline_ms)
        if dl is not None:
            self._deadline_at[request.uid] = self._clock() + dl / 1e3
        self._queue.append(request)
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self._queue))
        return True

    def _expired(self, uid: int) -> bool:
        at = self._deadline_at.get(uid)
        return at is not None and self._clock() >= at

    def _expire_deadlines(self) -> None:
        """Retire queued and in-flight requests whose deadline passed (at
        the top of every step): a queued one ends empty, an active one with
        its partial tokens, its slot and pages freed."""
        if not self._deadline_at:
            return
        keep: Deque[Request] = deque()
        for req in self._queue:
            if self._expired(req.uid):
                self.stats["deadline_miss"] += 1
                self._error(req.uid, (), ErrorReason.DEADLINE,
                            f"request {req.uid}: deadline expired while "
                            "queued")
            else:
                keep.append(req)
        self._queue = keep
        for slot in list(self._active):
            if self._expired(self._active[slot].request.uid):
                self.stats["deadline_miss"] += 1
                self._retire(slot, "error", reason=ErrorReason.DEADLINE,
                             error="deadline expired during decode")

    def _prefill_tokens(self, req: Request
                        ) -> Tuple[torch.Tensor, int, np.ndarray]:
        """The prompt padded to the (1, prompt_len) bucket (left-padded, or
        right-padded when paged), its true length and the flat prompt."""
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
        if self.paged:
            toks[0, :len(t)] = t          # right-pad; decode overwrites pads
        else:
            toks[0, self.prompt_len - len(t):] = t
        return torch.from_numpy(toks).to(self.device), len(t), t

    # -- pages -------------------------------------------------------------
    def _worst_pages(self, n: int, cap: int) -> int:
        """Worst-case pages a request can touch: the prompt, ``cap`` decode
        steps and the overrun of the last chunk (``chunk_span``: with
        speculation its k-ahead writes too). Pages past that hold only
        prefill pad rows, which decode never writes and always reads
        masked: they stay on the trash page."""
        maxp = n + cap - 1 + self.chunk_span  # one past the last written pos
        return min(-(-min(maxp, self.cache_pos_len) // self.page_size),
                   self.n_logical_pages)

    def _plan_pages(self, slot: int, toks: np.ndarray, n: int,
                    cap: int) -> Tuple[np.ndarray, np.ndarray]:
        """Claim the slot's pages; returns (dest, table_row). ``dest[i]`` is
        the pool row the prefill writes logical page i to, 0 for a page
        shared through the prefix registry (its content exists) or an
        unclaimed tail."""
        ps, NP = self.page_size, self.n_logical_pages
        dest = np.zeros(NP, np.int32)
        trow = np.zeros(NP, np.int32)
        claimed: List[int] = []
        try:
            for i in range(self._worst_pages(n, cap)):
                key = ((i, toks[:(i + 1) * ps].tobytes())
                       if self._share_ok and (i + 1) * ps <= n else None)
                phys = self._alloc.lookup(key) if key is not None else None
                if phys is None:
                    phys = self._alloc.alloc("prefill page planning")
                    if key is not None:
                        self._alloc.register(phys, key)
                    dest[i] = phys
                claimed.append(phys)
                trow[i] = phys
        except PagePoolExhaustedError:
            for phys in claimed:
                self._alloc.decref(phys)
            raise
        self._host_table[slot] = trow
        return dest, trow

    def _refresh_page_stats(self) -> None:
        used = self._alloc.used
        s = self.stats
        s["kv_pages_in_use"] = used
        s["kv_pages_peak"] = max(s["kv_pages_peak"], used)
        s["kv_hbm_bytes"] = used * self._page_bytes
        s["kv_hbm_bytes_peak"] = max(s["kv_hbm_bytes_peak"], s["kv_hbm_bytes"])
        s["prefix_hits"] = self._alloc.hits
        s["kv_pages_reserved"] = self._reserved_total

    def _set_table_row(self, slot: int, row) -> None:
        for name in ("k", "v"):
            self.cache[name].table[:, slot] = row

    def _ensure_writable(self) -> None:
        """Copy-on-write before a chunk: a page the chunk may write that
        other slots share is copied to a fresh pool row first, and a
        sole-owned page still in the prefix registry leaves it. A pool
        emptied by external pressure quarantines the slot (``page_pool``)."""
        ps, T = self.page_size, self.cache_pos_len
        for slot, st in list(self._active.items()):
            pos0 = st.n + len(st.produced)
            try:
                for i in sorted({(p % T) // ps for p in
                                 range(pos0, pos0 + self.chunk_span)}):
                    phys = int(self._host_table[slot, i])
                    if phys == TRASH_PAGE:
                        continue          # unclaimed tail: writes go to trash
                    if self._alloc.refs[phys] > 1:
                        new = self._alloc.alloc("copy-on-write")
                        for name in ("k", "v"):
                            leaf = self.cache[name]
                            for pool in _pools(leaf.pages):
                                pool[:, new] = pool[:, phys]
                            leaf.table[:, slot, i] = new
                        self._alloc.refs[phys] -= 1
                        self._host_table[slot, i] = new
                    elif phys in self._alloc.reg_key:
                        self._alloc.unregister(phys)
            except PagePoolExhaustedError as e:
                self._retire(slot, "error", reason=ErrorReason.PAGE_POOL,
                             error=str(e))

    # -- admission ---------------------------------------------------------
    def _insert(self, slot: int, small, first: torch.Tensor, t: np.ndarray,
                dest: Optional[np.ndarray], trow: Optional[np.ndarray]) -> None:
        """Copy a batch-1 prefill cache into slot ``slot``: its rows along
        each leaf's batch axis (contiguous), or its owned pages into the
        pool rows ``dest`` plus the slot's table row (paged; pages resolved
        by sharing and unclaimed tails are not written). With speculation
        the slot's drafter history becomes the prompt ``t``."""
        n = len(t)
        c = self.cache
        if self.paged:
            own = np.nonzero(dest)[0]
            dst = torch.from_numpy(dest[own].astype(np.int64)).to(self.device)
            src = torch.from_numpy(own + 1).to(self.device)   # identity table
            for name in ("k", "v"):
                for pool, spool in zip(_pools(c[name].pages),
                                       _pools(small[name].pages)):
                    pool[:, dst] = spool[:, src]
            self._set_table_row(slot, torch.from_numpy(trow).to(self.device))
            c["pos"][slot] = n      # decode resumes at the true prompt end
            c["pos_ids"][slot] = small["pos_ids"][0]
        else:
            _put_rows(c, small, self._batch_axes, slot)
        self._tok[slot, 0] = first
        if self._spec_state:
            hist, hist_len = self._spec_state
            row = np.zeros(self.hist_cap, np.int32)
            row[:n] = t
            hist[slot] = torch.from_numpy(row).to(self.device)
            hist_len[slot] = n

    def _admit(self) -> None:
        while self._free and self._queue:
            req = self._queue[0]
            try:
                toks, n, t = self._prefill_tokens(req)
            except PromptTooLongError as e:
                self._queue.popleft()
                self._error(req.uid, (), ErrorReason.PROMPT_TOO_LONG, str(e))
                continue
            except ValueError as e:
                self._queue.popleft()
                self._error(req.uid, (), ErrorReason.BAD_REQUEST, str(e))
                continue
            if self.paged:
                cap = min(req.max_new_tokens, self.max_len - n)
                need = self._worst_pages(n, cap)
                capacity = self.n_phys_pages - 1
                if need > capacity:
                    self._queue.popleft()
                    self._error(
                        req.uid, (), ErrorReason.PAGE_POOL,
                        f"request {req.uid}: needs {need} KV pages, pool "
                        f"holds {capacity} (shrink the request or grow "
                        "page_pool_pages)")
                    continue
                if self._reserved_total + need > capacity:
                    # wait for retirements to free reservations
                    self.stats["admission_blocked"] += 1
                    break
            else:
                cap = min(req.max_new_tokens, self.max_len - self.prompt_len)
            self._queue.popleft()
            slot = self._free.pop()
            logits, small = self.model.prefill(toks, max_len=self._cache_max,
                                               full_logits=self.paged)
            if self.paged:
                first = torch.argmax(logits[0, n - 1], dim=-1)
                try:
                    dest, trow = self._plan_pages(slot, t, n, cap)
                except PagePoolExhaustedError as e:
                    # only external pressure (a chaos steal) gets here: the
                    # reservation covers the engine's own demand
                    self._free.append(slot)
                    self._error(req.uid, (), ErrorReason.PAGE_POOL, str(e))
                    continue
                self._reserved[slot] = need
                self._reserved_total += need
                self._insert(slot, small, first, t, dest, trow)
            else:
                first = torch.argmax(logits[0, -1], dim=-1)
                self._insert(slot, small, first, t, None, None)
            self._active[slot] = _Slot(request=req, cap=cap, n=n)
            if self._hook is not None:
                # absolute positions: the true prompt end (paged right-pad)
                # or the bucket end (contiguous left-pad)
                pos = self._chaos.plan_request(
                    req.uid, n if self.paged else self.prompt_len, cap)
                self._arm_np[slot] = -1 if pos is None else pos
            if self.paged:
                self._refresh_page_stats()
            self.stats["prefills"] += 1

    # -- decode ------------------------------------------------------------
    def step(self) -> bool:
        """Admit waiting requests, run one fused decode chunk, retire
        finished slots. Returns False when fully drained (or dead)."""
        if self._dead:
            return False
        idx = self.stats["decode_dispatches"]          # chunk index
        if self._chaos is not None and self.paged:
            self._chaos.page_pressure(self._alloc, idx)
        self._expire_deadlines()
        self._admit()
        if not self._active:
            return bool(self._queue)
        if self.paged:
            self._ensure_writable()
            self._refresh_page_stats()
            if not self._active:                       # COW quarantine
                return bool(self._queue)
        # the watchdog window opens before the injected faults (slow chunks
        # and retry backoff are the stalls it must see) and closes after the
        # host read below, which waits for the card
        self._straggler.step_start()
        attempt = 0
        while self._chaos is not None:
            try:
                self._chaos.on_chunk(idx)
                break
            except TransientStepError as e:
                attempt += 1
                self.stats["retries"] += 1
                if attempt > self.max_retries:
                    self._fail_all(f"transient failure persisted past "
                                   f"{self.max_retries} retries: {e}")
                    return False
                time.sleep(self.retry_backoff_s * attempt)
        t0 = time.perf_counter()
        gen = self._gen_shed if self._gen_shed is not None else self._generate
        state = self._spec_state if gen.spec != "off" else ()
        captures = gen.captures
        try:
            self._eos.fill_(-1 if self.eos_id is None else int(self.eos_id))
            kw = {}
            if self._hook is not None:
                self._arm.copy_(torch.from_numpy(self._arm_np))
                kw["arm"] = self._arm
            out = gen(self.cache, self._tok, self._gen, self._eos, *state,
                      **kw)
            self.cache, self._tok, self._gen, done, n_valid, toks = out[:6]
            cols = [toks, done[:, None].to(torch.int32), n_valid[:, None],
                    out[-1][:, None].to(torch.int32)]
            if state:
                cols.append(out[8])                    # acc (B, chunk)
            # ONE host sync per chunk: tokens, per-slot flags, accept counts
            host = torch.cat(cols, dim=1).cpu().numpy()
        except Exception as e:  # noqa: BLE001 - the device state is unknown
            self._fail_all(f"chunk dispatch failed: {e!r}")
            return False
        span = gen.span
        toks_np, done_np = host[:, :span], host[:, span] != 0
        n_np, failed_np = host[:, span + 1], host[:, span + 2] != 0
        s = self.stats
        s["chunk_seconds"].append(time.perf_counter() - t0)
        s["decode_dispatches"] += 1
        # a capture's eager warm-up chunk ran its decode steps too
        new = gen.captures - captures
        s["decode_steps"] += gen.chunk * (1 + new)
        if gen.spec == "draft":
            s["draft_steps"] += gen.chunk * gen.spec_k * (1 + new)
        s["graph_captures"] += new
        if gen is self._generate:
            s["capture_seconds"] = gen.capture_seconds
        else:
            s["shed_capture_seconds"][-1] = gen.capture_seconds
        # watchdog: `shed_after` consecutive straggler chunks shed a level
        if self._straggler.step_end(idx) is not None:
            s["straggler_events"] += 1
            self._pressure += 1
            if self._pressure >= self.shed_after:
                self._shed()
                self._pressure = 0
        else:
            self._pressure = 0
        if state:
            # accepted lengths of the active slots' live iterations (free
            # and retired slots ride the chunk too)
            acc = host[sorted(self._active), span + 3:]
            live = acc[acc >= 0]
            s["spec_draft_iters"] += int(live.size)
            s["spec_emitted_tokens"] += int(live.sum())
            for c, freq in zip(*np.unique(live, return_counts=True)):
                s["spec_accept_hist"][int(c) - 1] += int(freq)
        for slot in list(self._active):
            st = self._active[slot]
            st.chunks += 1
            take = min(int(n_np[slot]), st.cap - len(st.produced))
            st.produced.extend(int(t) for t in toks_np[slot][:take])
            if bool(done_np[slot]) and take == int(n_np[slot]):
                self._retire(slot, "eos")
            elif len(st.produced) >= st.cap:
                self._retire(slot, "length")
            elif bool(failed_np[slot]):
                # the finite guard quarantined exactly this slot; n_valid
                # stopped at the last token sampled from finite logits
                self._retire(slot, "error", reason=ErrorReason.NAN_LOGITS,
                             error=f"non-finite logits after "
                                   f"{len(st.produced)} tokens; slot "
                                   "quarantined")
        return bool(self._active or self._queue)

    def _retire(self, slot: int, finish: str, *,
                reason: Optional[ErrorReason] = None,
                error: Optional[str] = None) -> None:
        st = self._active.pop(slot)
        self._free.append(slot)
        self._arm_np[slot] = -1
        self._reserved_total -= self._reserved.pop(slot, 0)
        if self.paged:
            for phys in self._host_table[slot]:
                if phys:
                    self._alloc.decref(int(phys))
            self._host_table[slot] = TRASH_PAGE
            # the retired slot rides the fused chunks until reused: its
            # writes must land on the trash page, never in a page the
            # allocator may hand to another slot. A dead engine touches no
            # device buffer (after a CUDA error the card's state is unknown)
            if not self._dead:
                self._set_table_row(slot, TRASH_PAGE)
            self._refresh_page_stats()
        self.stats["tokens_out"] += len(st.produced)
        uid = st.request.uid
        self._deadline_at.pop(uid, None)
        produced = st.produced
        pre = self._resume_prefix.pop(uid, None)
        if pre:
            # a restored request: its earlier tokens were re-prefilled as
            # prompt; the completion carries the whole stream
            produced = pre + produced
        if finish == "error":
            self._error(uid, produced, reason or ErrorReason.STEP_FAILURE,
                        error or "unknown failure")
        else:
            self.completions.append(Completion(
                uid=uid, tokens=np.asarray(produced, np.int32),
                finish_reason=finish))

    def _fail_all(self, msg: str) -> None:
        """Unrecoverable dispatch failure: every in-flight and queued request
        ends with a ``step_failure`` error (active slots with their partial
        tokens) and the engine goes dead."""
        self._dead = True
        for slot in list(self._active):
            self._retire(slot, "error", reason=ErrorReason.STEP_FAILURE,
                         error=msg)
        while self._queue:
            req = self._queue.popleft()
            self._error(req.uid, (), ErrorReason.STEP_FAILURE, msg)

    def _shed(self) -> None:
        """Load shedding, one level a call: speculation off, then the chunk
        halved (down to one step a chunk). The degraded program resumes
        from the same cache, tokens and positions at the chunk boundary, so
        greedy streams are unchanged. On the card it is a new graph,
        captured on its first call; the previous shed program is dropped
        first (its graph pool freed), the level-0 program keeps its graph."""
        if self._spec_live != "off":
            self._spec_live = "off"
        elif self._chunk_live > 1:
            self._chunk_live = max(self._chunk_live // 2, 1)
        else:
            return
        self.stats["shed_events"] += 1
        self._gen_shed = None
        self._gen_shed = make_generate_step(
            self.model, chunk=self._chunk_live,
            temperature=self._temperature, top_k=self._top_k,
            logits_hook=self._hook)
        self.stats["shed_capture_seconds"].append(0.0)

    # -- checkpoint / restore ------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable serving state for a ``RestartManifest``: every
        request not yet completed (queued, or mid-decode with the tokens
        produced so far) and the completions already emitted. No device
        state: a restore re-prefills."""
        def entry(req: Request, produced: List[int]) -> Dict[str, Any]:
            toks = np.asarray(req.tokens, np.int32).reshape(-1).tolist()
            pre = self._resume_prefix.get(req.uid)
            if pre:      # a restored request: split back to the original
                produced = list(pre) + produced
                toks = toks[:len(toks) - len(pre)]
            d = {"uid": req.uid, "tokens": toks,
                 "max_new_tokens": int(req.max_new_tokens) + len(pre or ()),
                 "produced": [int(x) for x in produced]}
            if req.deadline_ms is not None:
                d["deadline_ms"] = float(req.deadline_ms)
            return d

        return {
            "seed": self.seed,
            "temperature": self._temperature,
            "queued": [entry(r, []) for r in self._queue],
            "active": [entry(self._active[s].request,
                             list(self._active[s].produced))
                       for s in sorted(self._active)],
            "completions": [
                {"uid": c.uid, "tokens": np.asarray(c.tokens).tolist(),
                 "finish_reason": c.finish_reason, "error": c.error,
                 "reason": c.reason}
                for c in self.completions],
        }

    def load_snapshot(self, snap: Dict[str, Any],
                      resume: bool = False) -> None:
        """Restore a :meth:`snapshot`: completions replay verbatim, queued
        and in-flight requests are resubmitted and regenerate from their
        prompts, so greedy completions equal an uninterrupted drain's.

        ``resume=True`` (paged, greedy) is the reference's default: an
        in-flight request re-prefills ``prompt + produced`` and decodes the
        rest (``prompt_len`` must hold the grown prompts). It is exact only
        where a prefill reproduces the cache the decode steps wrote, which
        the port does not promise: on the card the prefill and decode
        kernels round differently (the bf16 prefill feeds p to ``p @ v`` in
        bf16), and over a quantized cache a decode step attends over the
        dequantized codes where a prefill attends over exact values (the
        reference too). So the port regenerates by default."""
        if resume and not (self.paged and self._temperature <= 0):
            raise ValueError("resume needs the paged layout and greedy "
                             "sampling")
        for c in snap.get("completions", ()):
            self.completions.append(Completion(
                uid=c["uid"], tokens=np.asarray(c["tokens"], np.int32),
                finish_reason=c["finish_reason"], error=c.get("error"),
                reason=c.get("reason")))
        for d in list(snap.get("queued", ())) + list(snap.get("active", ())):
            produced = [int(x) for x in d.get("produced") or ()]
            prompt = [int(x) for x in d["tokens"]]
            if resume and produced:
                self._resume_prefix[d["uid"]] = produced
                req = Request(uid=d["uid"],
                              tokens=np.asarray(prompt + produced, np.int32),
                              max_new_tokens=d["max_new_tokens"]
                              - len(produced),
                              deadline_ms=d.get("deadline_ms"))
            else:
                req = Request(uid=d["uid"],
                              tokens=np.asarray(prompt, np.int32),
                              max_new_tokens=d["max_new_tokens"],
                              deadline_ms=d.get("deadline_ms"))
            self.submit(req)

    def run(self, requests: Optional[List[Request]] = None, *,
            stop: Optional[Callable[[], bool]] = None) -> List[Completion]:
        """Drain the queue (plus ``requests``); returns all completions.
        ``stop`` is polled between chunks (e.g. a PreemptionHandler's
        ``requested`` flag): when it fires, draining halts at the chunk
        boundary with the state intact for :meth:`snapshot`."""
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.step():
            if stop is not None and stop():
                break
        s = self.stats
        s["wall_seconds"] += time.perf_counter() - t0
        s["tokens_per_second"] = s["tokens_out"] / max(s["wall_seconds"], 1e-9)
        s["dispatches_per_token"] = (s["decode_dispatches"]
                                     / max(s["tokens_out"], 1))
        s["kv_bytes_per_token"] = (s["kv_hbm_bytes_peak"]
                                   / max(s["tokens_out"], 1))
        if self.spec != "off":
            # tokens committed per draft-verify iteration: 1.0 accepts
            # nothing, spec_k + 1 every draft and the bonus
            s["spec_accepted_len_per_draft"] = (
                s["spec_emitted_tokens"] / max(s["spec_draft_iters"], 1))
        return self.completions

    @property
    def chaos_events(self) -> List[Dict[str, Any]]:
        """Injection log of the attached chaos harness ([] when unarmed)."""
        return [] if self._chaos is None else list(self._chaos.events)
