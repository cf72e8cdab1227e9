"""The train step, sampling, speculative decoding and the fused decode loop
(counterpart: ``repro/launch/steps.py``: ``auto_microbatches``,
``_loss_and_grads``, ``make_train_step``, ``logits_transform``,
``sample_tokens``, ``spec_config``, ``ngram_draft`` and
``make_generate_step``).

A train step takes the parameter tree and optimizer state in the
reference's layout and updates them in place; gradients accumulate over
microbatches in fp32, and the guard's choice between the new and the old
state is made on the device (no host read inside the step).

A chunk is ``chunk`` decode iterations that stay on the device: EOS
detection, the finite guard, sampling and, with speculation, drafting,
verifying and the rollback are tensor ops, and the caller reads the results
with one host sync per chunk. On the card the chunk is one CUDA graph
replay, the counterpart of the reference's jitted ``lax.scan``: it is
captured once per cache and replayed for every chunk. On the CPU the same
body runs eagerly.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, fields, is_dataclass
from typing import Callable, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.kernels import launch_counters
from repro_torch.kernels.common import (SPEC_K_DEFAULT, check_draft_layers,
                                        check_spec_decode, check_spec_k)
from repro_torch.models.layers import slot_isfinite
from repro_torch.optim import Optimizer, global_norm
from repro_torch.tree import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------
def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      budget_bytes: float = 5e9) -> int:
    """Pick the grad-accumulation factor so saved activations + logits fit
    (the reference's estimate on one device: no data or vocab sharding).

    Rough model: saved block inputs (B*S*d*2B*L) plus the logits round trip
    (B*S*V*6B)."""
    if shape.mode != "train":
        return 1
    if cfg.microbatches_hint:
        return cfg.microbatches_hint
    b = shape.global_batch
    saved = b * shape.seq_len * cfg.d_model * 2 * max(cfg.num_layers, 1)
    logits = b * shape.seq_len * cfg.vocab_size * 6
    est = saved + logits
    nm = 1
    while est / nm > budget_bytes and nm < b:
        nm *= 2
    return nm


def _value_and_grad(model, params, batch):
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = model.loss(tracked, batch)
        grads = torch.autograd.grad(loss, leaves(tracked))
    return loss.detach(), unflatten(params, list(grads))


def _loss_and_grads(model, params, batch, nm: int):
    """Loss and gradients, with gradient accumulation over ``nm``
    microbatches (split along the batch axis) in fp32, or in bf16 when every
    floating parameter is bf16 (the reference's rule)."""
    if nm <= 1:
        return _value_and_grad(model, params, batch)
    mbs = [{k: v.reshape((nm, v.shape[0] // nm) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()} for i in range(nm)]
    floats = [p for p in leaves(params) if p.is_floating_point()]
    acc_dt = (torch.bfloat16 if all(p.dtype == torch.bfloat16 for p in floats)
              else torch.float32)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=leaves(params)[0].device)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                          device=p.device), params)
    for mb in mbs:
        loss, g = _value_and_grad(model, params, mb)
        for a, b in zip(leaves(gsum), leaves(g)):
            a.add_(b.to(a.dtype))
        del g
        lsum = lsum + loss
    inv = 1.0 / nm
    for a in leaves(gsum):
        a.mul_(inv)
    return lsum * inv, gsum


def make_train_step(model, optimizer: Optimizer, run: RunConfig, *,
                    guard: bool = False, grad_hook=None):
    """``train_step(params, opt_state, batch[, arm]) -> (params', opt_state',
    metrics)`` on one device (the reference's GSPMD step without a mesh).

    The update is written into ``params`` and ``opt_state`` in place
    (``optimizer.update_``), which the step returns: the reference's train
    loop donates both to its jitted step, so the step holds the weights,
    the optimizer state and the gradients once. A caller that needs the old
    state keeps a copy.

    ``guard=True`` arms the non-finite guard: the step still computes the
    gradients and the candidate update, but a non-finite loss or gradient
    norm keeps the *old* value of every params / opt_state element
    (``torch.where`` on the device, so a clean step is bitwise-identical to
    the unguarded step and nothing is read back inside the step). Guarded
    metrics are ``{"loss", "grad_norm", "skipped"}``, device scalars.

    ``grad_hook(loss, grads, arm) -> (loss, grads)`` is the chaos harness's
    injection point (:func:`repro_torch.distributed.chaos.nan_grad_hook`);
    with it, ``train_step`` takes a trailing ``arm`` device scalar.
    """
    nm = max(run.microbatches, 1)

    def train_step(params, opt_state, batch, arm=None):
        loss, grads = _loss_and_grads(model, params, batch, nm)
        if grad_hook is not None:
            loss, grads = grad_hook(loss, grads, arm)
        ok, metrics = None, {"loss": loss}
        if guard:
            gnorm = global_norm(grads)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "skipped": torch.logical_not(ok)}
        optimizer.update_(grads, opt_state, params, ok)
        return params, opt_state, metrics

    return train_step


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
    through ``generator``: an exponential race, ``argmax(p / E)`` with
    ``E ~ Exp(1)``. That is how ``torch.multinomial`` draws one sample (the
    same numbers from the same generator state), without its checks of
    ``p``: a failed slot's NaN row draws some index instead of raising (the
    chunk re-feeds that slot's last token), on every device and in a CUDA
    graph alike."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits_transform(logits, temperature, top_k),
                          dim=-1)
    race = probs / torch.empty_like(probs).exponential_(1.0,
                                                        generator=generator)
    return torch.argmax(race, dim=-1).to(torch.int32)


def spec_config(model, mode: str = "off",
                k: Optional[int] = None) -> Tuple[str, int]:
    """Effective ``(mode, k)`` of speculative decoding on ``model``: ``("off",
    0)`` for ``off``; ``k`` defaults to 3. Speculation needs a multi-token
    verify step and room for the k-ahead writes, so it is for the dense
    families with full attention: any other family, or sliding attention
    (whose ring has no slack for the writes), warns and falls back to
    ``("off", 0)``. An unknown mode or k < 1 raises ValueError."""
    check_spec_decode(mode)
    if mode == "off":
        return "off", 0
    k = check_spec_k(SPEC_K_DEFAULT if k is None else k)
    cfg = model.cfg
    if cfg.family not in ("dense", "moe", "vlm"):
        warnings.warn(f"spec-decode {mode!r} unsupported for family "
                      f"{cfg.family!r}; falling back to off")
        return "off", 0
    if cfg.attention_kind == "sliding":
        warnings.warn(f"spec-decode {mode!r} unsupported with sliding-window "
                      "attention; falling back to off")
        return "off", 0
    return mode, k


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, t0: torch.Tensor,
                k: int) -> torch.Tensor:
    """(B, k) draft tokens by lookup over each slot's history: ``hist`` (B,
    H) holds the committed prompt and emitted tokens (``hist_len`` valid),
    ``t0`` (B,) the token about to be emitted. The most recent earlier
    occurrence of ``t0`` that has a following token, preferring a bigram
    match (the token before it equal to ``hist[len - 1]``), proposes the k
    tokens that followed it. A miss, or a continuation past ``hist_len``,
    drafts whatever the clipped indices hold: the verifier commits only
    what the model confirms. Indices past the row clamp, as the reference's
    gathers do."""
    B, H = hist.shape
    pos = torch.arange(H, dtype=torch.int32, device=hist.device)
    valid = pos[None, :] < (hist_len - 1)[:, None]        # a continuation
    last = (hist_len - 1).clamp(0, H - 1).long()
    t_prev = hist.gather(1, last[:, None])               # the token before t0
    prev_col = torch.cat([torch.full_like(hist[:, :1], -1), hist[:, :-1]], 1)
    uni = (hist == t0[:, None]) & valid
    bi = uni & (prev_col == t_prev)
    none = torch.full_like(pos, -1)
    j_bi = torch.amax(torch.where(bi, pos, none), dim=1)
    j_uni = torch.amax(torch.where(uni, pos, none), dim=1)
    j = torch.where(j_bi >= 0, j_bi, j_uni)               # -1 on a miss
    src = (j[:, None] + 1 + torch.arange(k, dtype=torch.int32,
                                         device=hist.device)).clamp(0, H - 1)
    return hist.gather(1, src.long()).to(t0.dtype)


def clone_cache(x):
    """A copy of a cache (dicts and lists of tensors and KV leaves)."""
    if isinstance(x, dict):
        return {k: clone_cache(v) for k, v in x.items()}
    if isinstance(x, list):
        return [clone_cache(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(clone_cache(getattr(x, f.name)) for f in fields(x)))


def cache_tensors(x) -> Iterator[torch.Tensor]:
    """Every tensor of a cache, in a fixed order."""
    if isinstance(x, dict):
        for v in x.values():
            yield from cache_tensors(v)
    elif isinstance(x, list):
        for v in x:
            yield from cache_tensors(v)
    elif isinstance(x, torch.Tensor):
        yield x
    elif is_dataclass(x):
        for f in fields(x):
            yield from cache_tensors(getattr(x, f.name))


def decode_chunk(model, cache, tok: torch.Tensor,
                 generator: Optional[torch.Generator],
                 eos_id: Union[int, torch.Tensor], *, chunk: int,
                 temperature: float = 0.0, top_k: int = 0,
                 logits_hook: Optional[Callable] = None,
                 arm: Optional[torch.Tensor] = None):
    """The chunk body, run eagerly: ``chunk`` decode steps from ``tok``
    (B, 1). Returns (next tok, done, n_valid, toks, failed), as
    :func:`make_generate_step` describes them; updates ``cache`` in place.
    ``logits_hook(logits, row_pos, arm)`` sees each step's logits before
    the finite guard, ``row_pos`` (B, 1) their cache positions."""
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
        if logits_hook is not None:
            pos0 = cache["pos"].clone()
        logits, cache = model.decode_step(cache, tok)
        if logits_hook is not None:
            logits = logits_hook(logits, pos0[:, None], arm)
        failed_now = failed | (~slot_isfinite(logits) & ~done_now)
        nxt = sample_tokens(logits[:, -1], generator, temperature, top_k)
        nxt = torch.where(done_now | failed_now, emitted, nxt)
        toks.append(emitted)
        tok, done, failed = nxt[:, None], done_now, failed_now
    return tok, done, n_valid, torch.stack(toks, 1), failed


def _put_block(buf: torch.Tensor, start: torch.Tensor, cnt: torch.Tensor,
               blk: torch.Tensor) -> torch.Tensor:
    """``buf[b, start[b] + i] = blk[b, i]`` for ``i < cnt[b]``, indices past
    the row dropped (the reference's ``.at[].set(mode="drop")``), as a
    gather and a select over the whole row: the same work every call, no
    index leaves the row, and ``buf`` is written in place."""
    cols = torch.arange(buf.shape[1], dtype=start.dtype, device=buf.device)
    rel = cols[None, :] - start[:, None]
    put = (rel >= 0) & (rel < cnt[:, None])
    src = blk.gather(1, rel.clamp(0, blk.shape[1] - 1).long())
    return buf.copy_(torch.where(put, src.to(buf.dtype), buf))


def spec_decode_chunk(model, cache, tok: torch.Tensor,
                      generator: Optional[torch.Generator],
                      eos_id: Union[int, torch.Tensor], hist: torch.Tensor,
                      hist_len: torch.Tensor, *, chunk: int, k: int,
                      mode: str, draft_layers: int = 1,
                      temperature: float = 0.0, top_k: int = 0,
                      logits_hook: Optional[Callable] = None,
                      arm: Optional[torch.Tensor] = None):
    """The speculative chunk body, run eagerly: ``chunk`` draft-verify
    iterations from ``tok`` (B, 1). Each drafts k tokens (``ngram``: lookup
    over ``hist``; ``draft``: k greedy steps through the first
    ``draft_layers`` layers, whose scratch writes the verify block
    overwrites), runs the fed token and the drafts as one (k + 1)-token
    ``decode_step``, commits the drafts its targets confirm plus the bonus
    token (truncated at EOS), and rolls back by rewinding ``cache["pos"]``.
    Returns (next tok, done, n_valid, toks, hist, hist_len, acc, failed), as
    :func:`make_generate_step` describes them; ``cache``, ``hist`` and
    ``hist_len`` are updated in place. ``logits_hook`` sees the verify
    block's logits, rows at positions ``pos0 + 0..k``."""
    B = tok.shape[0]
    dev = tok.device
    span = k + 1
    idx = torch.arange(span, dtype=torch.int32, device=dev)
    pos = cache["pos"]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_valid = torch.zeros((B,), dtype=torch.int32, device=dev)
    toks = torch.zeros((B, chunk * span), dtype=tok.dtype, device=dev)
    accs = []
    for _ in range(chunk):
        t0 = tok[:, 0]
        if mode == "ngram":
            drafts = ngram_draft(hist, hist_len, t0, k)
        else:
            pos_in = pos.clone()
            dt, dr = tok, []
            for _ in range(k):
                dlogits, _ = model.decode_step(cache, dt, layers=draft_layers)
                dt = torch.argmax(dlogits[:, -1], dim=-1).to(t0.dtype)[:, None]
                dr.append(dt)
            pos.copy_(pos_in)
            drafts = torch.cat(dr, 1)
        blk = torch.cat([tok, drafts], 1)                   # (B, k + 1)
        pos0 = pos.clone()
        logits, _ = model.decode_step(cache, blk)
        if logits_hook is not None:
            logits = logits_hook(logits, pos0[:, None] + idx[None, :], arm)
        # row j's logits are the target of draft j + 1 and the bonus after j
        # accepts: acceptance stops at the last finite target
        fin_row = torch.isfinite(logits).all(dim=-1)        # (B, k + 1)
        tgt = sample_tokens(logits, generator, temperature, top_k)
        ok = (blk[:, 1:] == tgt[:, :-1]) & fin_row[:, :-1]
        a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)   # 0..k
        eos_hit = (blk == eos_id) & (idx[None, :] <= a[:, None])
        any_eos = eos_hit.any(dim=1)
        first_eos = torch.amin(torch.where(eos_hit, idx, span), dim=1)
        cnt = torch.where(any_eos, first_eos + 1, a + 1)
        cnt = torch.where(done | failed, 0, cnt).to(torch.int32)
        bonus_fin = fin_row.gather(1, a[:, None])[:, 0]
        failed_now = failed | (~bonus_fin & ~any_eos & ~done)
        # rollback: the next block's k + 1 writes start at pos0 + cnt and
        # cover every rejected row before anything attends to it (a done
        # slot advances 1, its frozen re-feed)
        pos.copy_(pos0 + cnt.clamp(min=1))
        bonus = tgt.gather(1, a[:, None])[:, 0]
        nxt = torch.where(any_eos, eos_id, bonus).to(t0.dtype)
        nxt = torch.where(done | failed_now, t0, nxt)       # frozen re-feed
        _put_block(toks, n_valid, cnt, blk)
        _put_block(hist, hist_len, cnt, blk)
        hist_len.add_(cnt)
        accs.append(torch.where(done | failed, -1, cnt))
        tok, done, failed = nxt[:, None], done | any_eos, failed_now
        n_valid = n_valid + cnt
    return (tok, done, n_valid, toks, hist, hist_len, torch.stack(accs, 1),
            failed)


def _launch_counts() -> List[int]:
    return [n for counter in launch_counters() for n in counter.values()]


def _add_launches(delta: List[int]) -> None:
    it = iter(delta)
    for counter in launch_counters():
        for name in counter:
            counter[name] += next(it)


def _weights(model) -> Tuple:
    """What a captured graph read the weights through: every parameter's
    identity, version and address (the compute-dtype casts follow them)."""
    return tuple((id(p), p._version, p.data_ptr()) for p in model.parameters())


def _cache_key(cache, tok: torch.Tensor, state: Tuple = ()) -> Tuple:
    """What a graph is captured on: the address and layout of every cache
    tensor and of the drafter's history (``state``: ``hist``, ``hist_len``),
    and ``tok``'s shape."""
    return (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in cache_tensors([cache, *state])),
            tuple(tok.shape), tok.dtype)


@dataclass
class _Captured:
    """One captured chunk: the graph, what it was captured on (the cache and
    history, the generator, the weights), its static inputs ``tok``,
    ``eos`` and (with a logits hook) ``arm`` and outputs, and the launches
    of one replay."""

    graph: "torch.cuda.CUDAGraph"
    key: Tuple
    generator: Optional[torch.Generator]
    weights: Tuple
    tok: torch.Tensor
    eos: torch.Tensor
    arm: Optional[torch.Tensor]
    outputs: Tuple[torch.Tensor, ...]
    launches: List[int]


class GenerateStep:
    """The fused decode chunk of :func:`make_generate_step`. ``captures``
    counts its CUDA graph captures and ``capture_seconds`` their time, the
    eager warm-up included; ``span`` is the width of a chunk's token
    buffer."""

    def __init__(self, model, *, chunk: int, temperature: float = 0.0,
                 top_k: int = 0, spec: str = "off", spec_k: int = 0,
                 draft_layers: Optional[int] = None,
                 logits_hook: Optional[Callable] = None):
        self.model, self.chunk = model, chunk
        self.temperature, self.top_k = temperature, top_k
        self.logits_hook = logits_hook
        self.spec = check_spec_decode(spec)
        self.spec_k = 0 if spec == "off" else check_spec_k(spec_k)
        L = model.cfg.num_layers
        n = check_draft_layers(draft_layers or 0) or max(1, L // 2)
        self.draft_layers = min(n, L) if spec == "draft" else 0
        self.span = chunk * (self.spec_k + 1)
        self.captures = 0
        self.capture_seconds = 0.0
        self._captured: Optional[_Captured] = None

    def _state(self, hist, hist_len) -> Tuple:
        """The in-place state beside the cache: (hist, hist_len) with
        speculation, nothing without."""
        if (self.spec == "off") != (hist is None and hist_len is None):
            raise ValueError(f"spec={self.spec!r}: hist and hist_len are "
                             + ("not taken" if self.spec == "off"
                                else "required"))
        return () if self.spec == "off" else (hist, hist_len)

    def _arm(self, arm: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``arm`` (B,) int32, taken iff the step has a logits hook."""
        if (self.logits_hook is None) != (arm is None):
            raise ValueError("arm is " + ("required with" if arm is None
                                          else "not taken without")
                             + " a logits hook")
        return arm

    def _body(self, cache, tok, generator, eos_id, *state, arm=None):
        hook = dict(logits_hook=self.logits_hook, arm=arm)
        if self.spec == "off":
            return decode_chunk(self.model, cache, tok, generator, eos_id,
                                chunk=self.chunk, temperature=self.temperature,
                                top_k=self.top_k, **hook)
        return spec_decode_chunk(self.model, cache, tok, generator, eos_id,
                                 *state, chunk=self.chunk, k=self.spec_k,
                                 mode=self.spec,
                                 draft_layers=self.draft_layers,
                                 temperature=self.temperature,
                                 top_k=self.top_k, **hook)

    def _eager(self, cache, tok, generator, eos_id, *state, arm=None):
        tok, *outputs = self._body(cache, tok, generator, eos_id, *state,
                                   arm=arm)
        return (cache, tok, generator, *outputs)

    def _warm_up(self, cache, tok: torch.Tensor, state: Tuple = (),
                 arm: Optional[torch.Tensor] = None) -> None:
        """One eager chunk on copies of the cache and the history:
        first-call costs (cuBLAS handles, weight casts) paid, the cache,
        the history, ``tok`` and the caller's generator untouched."""
        spare = (torch.Generator(device=tok.device).manual_seed(0)
                 if self.temperature > 0 else None)
        self._body(clone_cache(cache), tok.clone(), spare, -1,
                   *(t.clone() for t in state),
                   arm=None if arm is None else arm.clone())

    def _capture(self, cache, tok: torch.Tensor,
                 generator: Optional[torch.Generator],
                 state: Tuple, arm: Optional[torch.Tensor]) -> _Captured:
        t0 = time.perf_counter()
        self._captured = None                 # free the old graph's pool
        dev = tok.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._warm_up(cache, tok, state, arm)
        torch.cuda.current_stream(dev).wait_stream(side)
        static_tok = tok.clone()
        eos = torch.full((), -1, dtype=torch.int32, device=dev)
        static_arm = None if arm is None else arm.clone()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _launch_counts()
        with torch.cuda.graph(graph):
            nxt, *outputs = self._body(cache, static_tok, generator, eos,
                                       *state, arm=static_arm)
            static_tok.copy_(nxt)
        # capture launches nothing: take its counts back, add them per replay
        delta = [a - b for a, b in zip(_launch_counts(), before)]
        _add_launches([-d for d in delta])
        self._captured = _Captured(graph, _cache_key(cache, tok, state),
                                   generator, _weights(self.model), static_tok,
                                   eos, static_arm, tuple(outputs), delta)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return self._captured

    def _graph_for(self, cache, tok, generator, state, arm) -> _Captured:
        c = self._captured
        if (c is None or c.generator is not generator
                or c.key != _cache_key(cache, tok, state)
                or c.weights != _weights(self.model)):
            c = self._capture(cache, tok, generator, state, arm)
        return c

    def prepare(self, cache, tok: torch.Tensor,
                generator: Optional[torch.Generator],
                hist: Optional[torch.Tensor] = None,
                hist_len: Optional[torch.Tensor] = None, *,
                arm: Optional[torch.Tensor] = None) -> None:
        """First-call costs before the first chunk: on the card, the capture
        on ``cache`` (and the history), after the eager warm-up on copies;
        on the CPU, the warm-up alone. Neither changes ``cache``, the
        history, ``tok``, ``arm`` or ``generator``."""
        state, arm = self._state(hist, hist_len), self._arm(arm)
        if tok.device.type == "cuda":
            self._graph_for(cache, tok, generator, state, arm)
        else:
            self._warm_up(cache, tok, state, arm)

    def __call__(self, cache, tok: torch.Tensor,
                 generator: Optional[torch.Generator],
                 eos_id: Union[int, torch.Tensor],
                 hist: Optional[torch.Tensor] = None,
                 hist_len: Optional[torch.Tensor] = None, *,
                 arm: Optional[torch.Tensor] = None):
        state, arm = self._state(hist, hist_len), self._arm(arm)
        if tok.device.type != "cuda":
            return self._eager(cache, tok, generator, eos_id, *state,
                               arm=arm)
        c = self._graph_for(cache, tok, generator, state, arm)
        if tok is not c.tok:
            c.tok.copy_(tok)
        if isinstance(eos_id, torch.Tensor):
            c.eos.copy_(eos_id)
        else:
            c.eos.fill_(eos_id)
        if arm is not None and arm is not c.arm:
            c.arm.copy_(arm)
        c.graph.replay()
        _add_launches(c.launches)
        return (cache, c.tok, generator) + c.outputs


def make_generate_step(model, *, chunk: int, temperature: float = 0.0,
                       top_k: int = 0, spec: str = "off", spec_k: int = 0,
                       draft_layers: Optional[int] = None,
                       logits_hook: Optional[Callable] = None
                       ) -> GenerateStep:
    """Fused decode loop of ``chunk`` iterations:

        generate_step(cache, tok, generator, eos_id)
            -> (cache, tok, generator, done, n_valid, toks, failed)

    ``tok`` (B, 1) is the next token to feed; ``toks`` (B, chunk) are the
    emitted tokens, the first being ``tok`` itself. ``eos_id`` (an int or a
    0-d int32 tensor on the cache's device) -1 disables EOS. A slot that
    emits EOS is ``done``: its later tokens are the EOS token re-fed, and
    ``n_valid`` counts its tokens up to and including EOS. ``failed`` marks
    slots whose logits went non-finite; their counting stops with the last
    token sampled from finite logits. The cache is updated in place.

    Speculative decoding (``spec="ngram"`` or ``"draft"``, draft length
    ``spec_k``; ``draft_layers`` is the ``draft`` mode's layer budget, by
    default half the layers) keeps one chunk per call. Each iteration
    drafts k tokens, verifies the fed token and the drafts as one (k +
    1)-token ``decode_step``, and commits the leading drafts its targets
    confirm plus the target after the last of them (the bonus token);
    rollback rewinds ``cache["pos"]``. The call takes and updates the
    drafter's history in place, ``hist`` (B, Hcap) int32 (each slot's
    committed prompt and output tokens, ``hist_len`` (B,) int32 of them):

        generate_step(cache, tok, generator, eos_id, hist, hist_len)
            -> (cache, tok, generator, done, n_valid, toks, hist, hist_len,
                acc, failed)

    ``toks`` (B, chunk * (k + 1)) is compacted: the first ``n_valid`` of a
    row are its emitted tokens. ``acc`` (B, chunk) counts the tokens each
    iteration committed (1..k + 1; -1 for a slot already done or failed).
    Greedy tokens equal those of ``spec="off"``; sampled speculation draws
    the k + 1 targets of an iteration from the same generator, in another
    order than the plain loop. The cache's ring must hold ``spec_k`` rows
    more than the positions served (the k-ahead writes).

    ``logits_hook(logits, row_pos, arm) -> logits``, with ``row_pos`` (B,
    S) the absolute cache position of each logits row, is the chaos
    harness's NaN-injection point (:func:`~repro_torch.distributed.chaos.
    nan_logits_hook`), applied where a real overflow would appear: before
    the finite guard and the sampler, on every step's logits and on a
    verify block's (positions ``pos0 + 0..k``). With a hook the call takes
    a trailing keyword ``arm`` (B,) int32 (the poison position per slot, -1
    disarmed): on the card a static input of the graph, copied in before
    each replay like ``eos_id``, so armed and clean chunks replay one
    graph.

    On the card the chunk is one CUDA graph replay. The graph is captured
    on the first call for a cache (keyed on the addresses of its tensors,
    and of ``hist`` and ``hist_len``, and on ``generator``, which is
    registered with it so that every replay draws fresh numbers), after one
    eager chunk on copies of them; a parameter changed in place since the
    capture makes the next call capture again. ``tok`` and ``eos_id`` are
    copied into the graph's static inputs before each replay (``tok`` not,
    when it is the static ``tok`` a call returned: write into that one
    between chunks). The returned ``tok``, ``done``, ``n_valid``, ``toks``,
    ``acc`` and ``failed`` are the graph's own tensors, overwritten by the
    next replay: read them before the next call. ``prepare`` captures ahead
    of the first chunk. The kernels' launch counters advance by one
    chunk's launches per replay, and not at the capture. On the CPU the
    chunk runs eagerly and returns new tensors (``hist`` and ``hist_len``
    are the caller's, updated).
    """
    return GenerateStep(model, chunk=chunk, temperature=temperature,
                        top_k=top_k, spec=spec, spec_k=spec_k,
                        draft_layers=draft_layers, logits_hook=logits_hook)
