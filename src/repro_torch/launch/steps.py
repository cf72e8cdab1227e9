"""Sampling and the fused decode loop (counterpart: ``repro/launch/steps.py``,
``logits_transform``, ``sample_tokens`` and ``make_generate_step`` with
speculation off).

A chunk is ``chunk`` decode steps that stay on the device: EOS detection,
the finite guard and sampling are tensor ops, and the caller reads the
results with one host sync per chunk. On the card the chunk is one CUDA
graph replay, the counterpart of the reference's jitted ``lax.scan``: it is
captured once per cache and replayed for every chunk. On the CPU the same
body runs eagerly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields, is_dataclass
from typing import Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.kernels import launch_counters
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
                 temperature: float = 0.0, top_k: int = 0):
    """The chunk body, run eagerly: ``chunk`` decode steps from ``tok``
    (B, 1). Returns (next tok, done, n_valid, toks, failed), as
    :func:`make_generate_step` describes them; updates ``cache`` in place."""
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
    return tok, done, n_valid, torch.stack(toks, 1), failed


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


def _cache_key(cache, tok: torch.Tensor) -> Tuple:
    """What a graph is captured on: the address and layout of every cache
    tensor, and ``tok``'s shape."""
    return (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in cache_tensors(cache)), tuple(tok.shape), tok.dtype)


@dataclass
class _Captured:
    """One captured chunk: the graph, what it was captured on (the cache,
    the generator, the weights), its static inputs ``tok`` and ``eos`` and
    outputs, and the launches of one replay."""

    graph: "torch.cuda.CUDAGraph"
    key: Tuple
    generator: Optional[torch.Generator]
    weights: Tuple
    tok: torch.Tensor
    eos: torch.Tensor
    outputs: Tuple[torch.Tensor, ...]
    launches: List[int]


class GenerateStep:
    """The fused decode chunk of :func:`make_generate_step`. ``captures``
    counts its CUDA graph captures and ``capture_seconds`` their time, the
    eager warm-up included."""

    def __init__(self, model, *, chunk: int, temperature: float = 0.0,
                 top_k: int = 0):
        self.model, self.chunk = model, chunk
        self.temperature, self.top_k = temperature, top_k
        self.captures = 0
        self.capture_seconds = 0.0
        self._captured: Optional[_Captured] = None

    def _body(self, cache, tok, generator, eos_id):
        return decode_chunk(self.model, cache, tok, generator, eos_id,
                            chunk=self.chunk, temperature=self.temperature,
                            top_k=self.top_k)

    def _eager(self, cache, tok, generator, eos_id):
        tok, done, n_valid, toks, failed = self._body(cache, tok, generator,
                                                      eos_id)
        return cache, tok, generator, done, n_valid, toks, failed

    def _warm_up(self, cache, tok: torch.Tensor) -> None:
        """One eager chunk on a copy of the cache: first-call costs (cuBLAS
        handles, weight casts) paid, the cache, ``tok`` and the caller's
        generator untouched."""
        spare = (torch.Generator(device=tok.device).manual_seed(0)
                 if self.temperature > 0 else None)
        self._body(clone_cache(cache), tok.clone(), spare, -1)

    def _capture(self, cache, tok: torch.Tensor,
                 generator: Optional[torch.Generator]) -> _Captured:
        t0 = time.perf_counter()
        self._captured = None                 # free the old graph's pool
        dev = tok.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._warm_up(cache, tok)
        torch.cuda.current_stream(dev).wait_stream(side)
        static_tok = tok.clone()
        eos = torch.full((), -1, dtype=torch.int32, device=dev)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _launch_counts()
        with torch.cuda.graph(graph):
            nxt, *outputs = self._body(cache, static_tok, generator, eos)
            static_tok.copy_(nxt)
        # capture launches nothing: take its counts back, add them per replay
        delta = [a - b for a, b in zip(_launch_counts(), before)]
        _add_launches([-d for d in delta])
        self._captured = _Captured(graph, _cache_key(cache, tok), generator,
                                   _weights(self.model), static_tok, eos,
                                   tuple(outputs), delta)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return self._captured

    def _graph_for(self, cache, tok, generator) -> _Captured:
        c = self._captured
        if (c is None or c.generator is not generator
                or c.key != _cache_key(cache, tok)
                or c.weights != _weights(self.model)):
            c = self._capture(cache, tok, generator)
        return c

    def prepare(self, cache, tok: torch.Tensor,
                generator: Optional[torch.Generator]) -> None:
        """First-call costs before the first chunk: on the card, the capture
        on ``cache`` (after the eager warm-up on a copy); on the CPU, the
        warm-up alone. Neither changes ``cache``, ``tok`` or ``generator``."""
        if tok.device.type == "cuda":
            self._graph_for(cache, tok, generator)
        else:
            self._warm_up(cache, tok)

    def __call__(self, cache, tok: torch.Tensor,
                 generator: Optional[torch.Generator],
                 eos_id: Union[int, torch.Tensor]):
        if tok.device.type != "cuda":
            return self._eager(cache, tok, generator, eos_id)
        c = self._graph_for(cache, tok, generator)
        if tok is not c.tok:
            c.tok.copy_(tok)
        if isinstance(eos_id, torch.Tensor):
            c.eos.copy_(eos_id)
        else:
            c.eos.fill_(eos_id)
        c.graph.replay()
        _add_launches(c.launches)
        return (cache, c.tok, generator) + c.outputs


def make_generate_step(model, *, chunk: int, temperature: float = 0.0,
                       top_k: int = 0) -> GenerateStep:
    """Fused decode loop of ``chunk`` steps (speculation off; speculative
    decoding is ported in a later slice):

        generate_step(cache, tok, generator, eos_id)
            -> (cache, tok, generator, done, n_valid, toks, failed)

    ``tok`` (B, 1) is the next token to feed; ``toks`` (B, chunk) are the
    emitted tokens, the first being ``tok`` itself. ``eos_id`` (an int or a
    0-d int32 tensor on the cache's device) -1 disables EOS. A slot that
    emits EOS is ``done``: its later tokens are the EOS token re-fed, and
    ``n_valid`` counts its tokens up to and including EOS. ``failed`` marks
    slots whose logits went non-finite; their counting stops with the last
    token sampled from finite logits. The cache is updated in place.

    On the card the chunk is one CUDA graph replay. The graph is captured
    on the first call for a cache (keyed on the addresses of its tensors
    and on ``generator``, which is registered with it so that every replay
    draws fresh numbers), after one eager chunk on a copy of the cache; a
    parameter changed in place since the capture makes the next call
    capture again. ``tok`` and ``eos_id`` are copied into the graph's
    static inputs before each replay (``tok`` not, when it is the static
    ``tok`` a call returned: write into that one between chunks). The
    returned ``tok``, ``done``, ``n_valid``, ``toks`` and ``failed`` are
    the graph's own tensors, overwritten by the next replay: read them
    before the next call. ``prepare`` captures ahead of the first chunk.
    The kernels' launch counters advance by one chunk's launches per
    replay, and not at the capture. On the CPU the chunk runs eagerly and
    returns new tensors.
    """
    return GenerateStep(model, chunk=chunk, temperature=temperature,
                        top_k=top_k)
