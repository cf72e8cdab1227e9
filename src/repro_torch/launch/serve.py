"""Serving driver: pre-sized cache prefill + fused decode (counterpart:
``repro/launch/serve.py``).

Two decode engines share one pre-sized cache:

  * ``loop``  — one ``decode_step`` and one host sync per generated token;
  * ``fused`` — ``make_generate_step``: ``chunk`` decode steps per host
    sync, one CUDA graph replay per chunk on the card.

Greedy tokens of the two are identical. ``fused`` may speculate (``spec``:
``ngram`` or ``draft``, draft length ``spec_k``): each chunk iteration
drafts k tokens and verifies them in one (k + 1)-token step, with greedy
tokens unchanged; ``loop`` never speculates. The KV cache layout is
explicit:
``kv_quant`` (``off|int8|int4|auto``, the Proteus narrow-value cache) and
``page_size`` (0 = contiguous ring, else the paged cache with prefix
sharing); the reference reads them from ``REPRO_KV_QUANT`` /
``REPRO_KV_PAGES``. ``--arch`` names a ported model: ``pimref-100m``
(dense, every KV layout) or ``recurrentgemma-2b`` (hybrid Griffin,
contiguous KV only; the layout flags raise for it). Runs on the card
unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch pimref-100m \\
      [--mode batch|queue] [--kv-quant int8] [--kv-page-size 16] \\
      [--spec-decode ngram|draft] [--spec-k 3] [--spec-verify] \\
      [--device cuda|cpu] [--smoke]

Queue mode also takes the reference's robust-serving flags (``--max-queue``,
``--deadline-ms``, ``--chaos-seed`` with ``REPRO_CHAOS``, ``--chaos-verify``,
``--preempt-after`` / ``--snapshot``, ``--restore`` / ``--restore-verify``)
and its fleet flags (``--shards``, ``--fleet-backend inproc|mp``,
``--fleet-chaos``, ``--fleet-verify``, ``--heartbeat-timeout``,
``--miss-suspect``, ``--miss-dead``, ``--checkpoint-every``,
``--manifest-dir``). A serving manifest records the KV layout and the
drafter as fields and, for the reference's restore, under its environment
knobs (``_SERVE_ENV_KNOBS``).
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_IDS, ModelConfig, get_config
from repro_torch.distributed.chaos import ChaosConfig, ShardChaosConfig
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     RestartManifest)
from repro_torch.kernels.common import KV_QUANT_MODES, SPEC_DECODE_MODES
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.launch.fleet import ServeFleet
from repro_torch.launch.steps import (clone_cache, make_generate_step,
                                      sample_tokens, spec_config)
from repro_torch.models import build_model, init_params, load_jax_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_model(arch: str, *, smoke: bool, seed: int, device,
               cfg: Optional[ModelConfig] = None, params=None,
               kv_quant: str = "off", page_size: int = 0):
    """Build the model for ``arch`` (or ``cfg``) on ``device`` with the
    port's own init from ``seed``, or with ``params``: the reference's
    parameter tree as numpy arrays (see ``models/bridge.py``); it serves
    from the KV layout ``kv_quant`` / ``page_size``."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch, smoke=smoke)
    model = build_model(cfg, dev, kv_quant=kv_quant, page_size=page_size)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model.load_state_dict(init_params(cfg, gen, dev))
    else:
        load_jax_params(model, params)
    return model


def _model(model, arch, *, smoke, seed, device, cfg, params, kv_quant,
           page_size):
    """``model`` in the asked KV layout (weights shared), or a new one."""
    if model is None:
        return load_model(arch, smoke=smoke, seed=seed, device=device,
                          cfg=cfg, params=params, kv_quant=kv_quant,
                          page_size=page_size)
    return model.with_kv_layout(kv_quant, page_size)


def serve(arch: str = "pimref-100m", *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          engine: str = "fused", chunk: int = 8, temperature: float = 0.0,
          top_k: int = 0, device="cuda", cfg: Optional[ModelConfig] = None,
          params=None, model=None, kv_quant: str = "off",
          page_size: int = 0, spec: str = "off", spec_k: Optional[int] = None,
          draft_layers: Optional[int] = None) -> Dict[str, Any]:
    """Prefill a synthetic batch, then decode ``gen`` tokens per sequence
    from a KV cache laid out as ``kv_quant`` / ``page_size`` say, with
    speculative decoding ``spec`` (``fused`` only; see
    :func:`~repro_torch.launch.steps.spec_config`).

    Returns the tokens with timing and dispatch counts. ``prefills`` and
    ``decode_steps`` count the prefills and decode steps the device ran:
    the untimed warm-up (one step for ``loop``; for ``fused`` one eager
    chunk of ``chunk`` steps on a copy of the cache) and then one step per
    token (``loop``) or ``chunk`` steps per chunk (``fused``; on the card
    each chunk is one replay of the graph captured, after the warm-up, on
    the real cache before the timed region). With speculation a decode
    step is one verify block, chunks run until every row holds ``gen``
    tokens, ``draft_steps`` counts the ``draft`` mode's steps through its
    first layers and ``accepted_len_per_draft`` is the tokens committed
    per iteration. ``capture_s`` is the warm-up and capture time on the
    card (0 on the CPU and for ``loop``). ``model`` reuses the weights of
    an already built model.
    """
    assert engine in ("fused", "loop"), engine
    model = _model(model, arch, smoke=smoke, seed=seed, device=device,
                   cfg=cfg, params=params, kv_quant=kv_quant,
                   page_size=page_size)
    dev, cfg = model.device, model.cfg
    spec, spec_k = spec_config(model, spec, spec_k)
    if engine == "loop":
        spec, spec_k = "off", 0      # the per-token baseline never speculates
    max_len = prompt_len + gen
    generate = make_generate_step(model, chunk=chunk, temperature=temperature,
                                  top_k=top_k, spec=spec, spec_k=spec_k,
                                  draft_layers=draft_layers)
    n_chunks = -(-gen // chunk)
    draft_steps_per_chunk = chunk * spec_k if spec == "draft" else 0

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    # the cache holds the k-ahead writes of a verify block too
    logits, cache = model.prefill(tokens, max_len=max_len + spec_k)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    decode_steps = draft_steps = 0

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    eos = -1                       # batch mode: length-only stopping
    state = ()
    if spec != "off":              # the drafter's history: the prompts
        hist = torch.zeros((batch, prompt_len + gen + generate.span),
                           dtype=torch.int32, device=dev)
        hist[:, :prompt_len] = tokens
        state = (hist, torch.full((batch,), prompt_len, dtype=torch.int32,
                                  device=dev))
    # warmup (and on the card the capture): first-call costs outside the
    # timed region
    if engine == "loop":
        model.decode_step(clone_cache(cache), tok)
        decode_steps += 1
    else:
        generate.prepare(cache, tok, sampler, *state)
        decode_steps += chunk
        draft_steps += draft_steps_per_chunk
    _sync(dev)

    dispatches = 0
    acc_sum = acc_iters = 0
    t0 = time.perf_counter()
    out_tokens: List[np.ndarray] = []
    if engine == "loop":
        for _ in range(gen):
            out_tokens.append(tok.cpu().numpy())         # host sync, per token
            logits, cache = model.decode_step(cache, tok)
            tok = sample_tokens(logits[:, -1], sampler, temperature,
                                top_k)[:, None]
            dispatches += 1
            decode_steps += 1
        _sync(dev)
    elif spec != "off":
        # an iteration commits 1..spec_k + 1 tokens: drain the compacted
        # buffers until every row holds gen tokens
        rows: List[List[int]] = [[] for _ in range(batch)]
        while min(len(r) for r in rows) < gen:
            (cache, tok, sampler, _done, n_valid, toks_d, *state, acc,
             _failed) = generate(cache, tok, sampler, eos, *state)
            host = torch.cat([toks_d, n_valid[:, None], acc], dim=1)
            host = host.cpu().numpy()                   # host sync, per chunk
            span = toks_d.shape[1]
            live = host[:, span + 1:]
            live = live[live >= 0]
            acc_iters += live.size
            acc_sum += int(live.sum())
            for r in range(batch):
                rows[r].extend(host[r, :host[r, span]].tolist())
            dispatches += 1
            decode_steps += chunk
            draft_steps += draft_steps_per_chunk
        out_tokens.append(np.asarray([r[:gen] for r in rows], np.int32))
    else:
        for _ in range(n_chunks):
            cache, tok, sampler, _done, _n, toks_d, _failed = generate(
                cache, tok, sampler, eos)
            out_tokens.append(toks_d.cpu().numpy())     # host sync, per chunk
            dispatches += 1
            decode_steps += chunk
    toks = np.concatenate(out_tokens, axis=1)[:, :gen]
    t_decode = time.perf_counter() - t0

    out = {
        "tokens": toks,
        "device": str(dev),
        "prefill_s": t_prefill,
        "capture_s": generate.capture_seconds,
        "decode_s_per_tok": t_decode / max(gen, 1),
        "throughput_tok_s": batch * gen / max(t_decode, 1e-9),
        "dispatches": dispatches,
        "dispatches_per_token": dispatches / max(gen, 1),
        "prefills": 1,
        "decode_steps": decode_steps,
        "draft_steps": draft_steps,
    }
    if spec != "off":
        out["accepted_len_per_draft"] = acc_sum / max(acc_iters, 1)
    return out


def make_queue_engine(arch: str = "pimref-100m", *, smoke: bool = True,
                      slots: int = 4, prompt_len: int = 32, gen: int = 16,
                      chunk: int = 8, seed: int = 0, temperature: float = 0.0,
                      top_k: int = 0, eos_id: Optional[int] = None,
                      device="cuda", cfg: Optional[ModelConfig] = None,
                      params=None, model=None, kv_quant: str = "off",
                      page_size: int = 0,
                      page_pool_pages: Optional[int] = None,
                      spec: str = "off", spec_k: Optional[int] = None,
                      draft_layers: Optional[int] = None,
                      **engine_kwargs: Any) -> ServeEngine:
    """A fresh :class:`ServeEngine` for ``arch`` over the KV layout
    ``kv_quant`` / ``page_size`` (``page_pool_pages`` sizes the paged
    pool), speculating as ``spec`` / ``spec_k`` / ``draft_layers`` say.
    ``engine_kwargs`` forwards the robustness knobs (``max_queue``,
    ``deadline_ms``, ``chaos``, ``max_retries``, ...)."""
    model = _model(model, arch, smoke=smoke, seed=seed, device=device,
                   cfg=cfg, params=params, kv_quant=kv_quant,
                   page_size=page_size)
    return ServeEngine(model, slots=slots, prompt_len=prompt_len, max_new=gen,
                       chunk=chunk, eos_id=eos_id, temperature=temperature,
                       top_k=top_k, seed=seed, spec=spec, spec_k=spec_k,
                       draft_layers=draft_layers,
                       page_pool_pages=page_pool_pages, **engine_kwargs)


def synth_requests(arch: str = "pimref-100m", *, smoke: bool = True,
                   requests: int = 10, prompt_len: int = 32, gen: int = 16,
                   seed: int = 0, shared_prefix: int = 0,
                   repeat_period: int = 0,
                   cfg: Optional[ModelConfig] = None) -> List[Request]:
    """The synthetic mixed-length request stream of queue mode, the same
    stream as the reference's for the same arguments. ``shared_prefix > 0``
    gives every request the same first tokens (a common system prompt),
    which the paged cache shares; ``repeat_period > 0`` tiles each prompt
    from a short period of its own (what the n-gram drafter finds)."""
    cfg = cfg or get_config(arch, smoke=smoke)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, shared_prefix).astype(np.int32)
    reqs = []
    for i in range(requests):
        n = int(rng.integers(max(4, shared_prefix + 1), prompt_len + 1))
        if repeat_period > 0:
            period = rng.integers(1, cfg.vocab_size,
                                  repeat_period).astype(np.int32)
            toks = np.tile(period, -(-n // repeat_period))[:n]
        else:
            toks = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        toks[:shared_prefix] = prefix
        reqs.append(Request(
            uid=i, tokens=toks,
            max_new_tokens=int(rng.integers(max(gen // 2, 1), gen + 1))))
    return reqs


def serve_queue(arch: str = "pimref-100m", *, smoke: bool = True,
                slots: int = 4, requests: int = 10, prompt_len: int = 32,
                gen: int = 16, chunk: int = 8, seed: int = 0,
                temperature: float = 0.0, top_k: int = 0,
                shared_prefix: int = 0, repeat_period: int = 0,
                kv_quant: str = "off", page_size: int = 0,
                page_pool_pages: Optional[int] = None,
                spec: str = "off", spec_k: Optional[int] = None,
                draft_layers: Optional[int] = None,
                max_queue: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                chaos: Optional[ChaosConfig] = None,
                stop: Optional[Callable[[ServeEngine], bool]] = None,
                device="cuda", cfg: Optional[ModelConfig] = None,
                params=None, model=None) -> ServeEngine:
    """Continuous batching: drain the synthetic request stream through a
    :class:`ServeEngine`; returns the drained engine. Robustness knobs:
    ``max_queue`` bounds the waiting queue, ``deadline_ms`` retires overdue
    requests, ``chaos`` arms seeded fault injection and ``stop(engine)``
    halts the drain at a chunk boundary (preemption)."""
    eng = make_queue_engine(arch, smoke=smoke, slots=slots,
                            prompt_len=prompt_len, gen=gen, chunk=chunk,
                            seed=seed, temperature=temperature, top_k=top_k,
                            device=device, cfg=cfg, params=params,
                            model=model, kv_quant=kv_quant,
                            page_size=page_size,
                            page_pool_pages=page_pool_pages, spec=spec,
                            spec_k=spec_k, draft_layers=draft_layers,
                            max_queue=max_queue, deadline_ms=deadline_ms,
                            chaos=chaos)
    eng.run(synth_requests(arch, smoke=smoke, requests=requests,
                           prompt_len=prompt_len, gen=gen, seed=seed,
                           shared_prefix=shared_prefix,
                           repeat_period=repeat_period, cfg=eng.model.cfg),
            stop=(lambda: stop(eng)) if stop is not None else None)
    return eng


def make_fleet(arch: str = "pimref-100m", *, shards: int = 2,
               backend: str = "inproc", smoke: bool = True, slots: int = 4,
               prompt_len: int = 32, gen: int = 16, chunk: int = 8,
               seed: int = 0, temperature: float = 0.0, top_k: int = 0,
               spec: str = "off", spec_k: Optional[int] = None,
               fleet_chaos: Optional[ShardChaosConfig] = None,
               checkpoint_every: int = 1, manifest_dir: Optional[str] = None,
               miss_suspect: int = 2, miss_dead: int = 4,
               heartbeat_timeout_s: float = 120.0, max_replays: int = 2,
               **engine_kwargs: Any) -> ServeFleet:
    """A :class:`ServeFleet` of identical engine shards: the same arch,
    seed, layout and knobs (``engine_kwargs`` goes to
    :func:`make_queue_engine`), so any shard decodes any request as any
    other, which failover replay rests on. In-process shards may share one
    ``model`` (its weights); each ``mp`` worker (spawned) builds its own
    engine on the device named (``device``, the card by default) from the
    same seed or ``params``."""
    ekw = dict(arch=arch, smoke=smoke, slots=slots, prompt_len=prompt_len,
               gen=gen, chunk=chunk, seed=seed, temperature=temperature,
               top_k=top_k, spec=spec, spec_k=spec_k, **engine_kwargs)
    factory = worker_spec = None
    if backend == "mp":
        if ekw.get("model") is not None:
            raise ValueError("an mp fleet's workers build their own models: "
                             "pass seed or params, not model")
        worker_spec = {"engine": ekw, "env": {}}
    else:
        factory = lambda sid: make_queue_engine(**ekw)  # noqa: E731
    return ServeFleet(factory, shards=shards, backend=backend,
                      worker_spec=worker_spec, chaos=fleet_chaos,
                      checkpoint_every=checkpoint_every,
                      manifest_dir=manifest_dir, miss_suspect=miss_suspect,
                      miss_dead=miss_dead,
                      heartbeat_timeout_s=heartbeat_timeout_s,
                      max_replays=max_replays, seed=seed)


def serve_fleet(arch: str = "pimref-100m", *, smoke: bool = True,
                shards: int = 2, backend: str = "inproc", slots: int = 4,
                requests: int = 10, prompt_len: int = 32, gen: int = 16,
                chunk: int = 8, seed: int = 0, temperature: float = 0.0,
                top_k: int = 0, shared_prefix: int = 0,
                repeat_period: int = 0, spec: str = "off",
                spec_k: Optional[int] = None,
                **fleet_kwargs: Any) -> ServeFleet:
    """Drain the queue-mode request stream through a sharded fleet; returns
    the drained fleet (the caller closes it). The stream is
    :func:`serve_queue`'s, so one engine drains the same queue for the
    byte-identity check."""
    fleet = make_fleet(arch, shards=shards, backend=backend, smoke=smoke,
                       slots=slots, prompt_len=prompt_len, gen=gen,
                       chunk=chunk, seed=seed, temperature=temperature,
                       top_k=top_k, spec=spec, spec_k=spec_k, **fleet_kwargs)
    try:
        fleet.run(synth_requests(arch, smoke=smoke, requests=requests,
                                 prompt_len=prompt_len, gen=gen, seed=seed,
                                 shared_prefix=shared_prefix,
                                 repeat_period=repeat_period,
                                 cfg=fleet_kwargs.get("cfg")))
    except BaseException:
        fleet.close()
        raise
    return fleet


def _print_fleet_stats(fleet: ServeFleet) -> None:
    s = fleet.stats
    print(f"fleet: {fleet.n_shards} shards ({fleet.backend}), "
          f"{len(fleet.completions)} requests, {s['tokens_out']} tokens in "
          f"{s['wall_seconds']:.2f}s ({s['tokens_per_second']:.1f} tok/s), "
          f"{s['fleet_steps']} fleet steps, {s['checkpoints']} checkpoints")
    if (s["failovers"] or s["heartbeat_misses"] or s["error_completions"]
            or fleet.chaos_events):
        print(f"fleet robust: {s['failovers']} failovers "
              f"({s['replays']} replays, {s['shard_lost']} shard_lost), "
              f"{s['heartbeat_misses']} heartbeat misses "
              f"({s.get('suspects', 0)} suspects, "
              f"{s.get('recoveries', 0)} recoveries, "
              f"{s.get('deaths', 0)} deaths), "
              f"{s['error_completions']} error completions, "
              f"{len(fleet.chaos_events)} chaos events")
    for row in fleet.per_shard_stats():
        print(f"  shard {row['shard']} [{row['state']}]: "
              f"{row['tokens_out']} tokens, {row['dispatches']} dispatches, "
              f"{row['tok_s']:.1f} tok/s, p50 {row['p50_ms']:.1f}ms, "
              f"p95 {row['p95_ms']:.1f}ms")


# the reference's environment knobs of a serving manifest: the port's
# manifests record the layout under them too, so either package restores it
_SERVE_ENV_KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
                    "REPRO_SPEC_K", "REPRO_ATTN_IMPL")


def save_serve_manifest(path: str, eng: ServeEngine, *, arch: str,
                        smoke: bool, slots: int, prompt_len: int, gen: int,
                        chunk: int,
                        queue: Optional[Dict[str, Any]] = None) -> None:
    """Write a serving :class:`RestartManifest`: the engine's snapshot and
    what a restarted process needs to build the same engine. The layout
    and drafter are fields of the ``engine`` block (``kv_quant``,
    ``page_size``, ``spec``, ``spec_k``, ``draft_layers``, ``device``) and
    also its ``env``, under the reference's knob names."""
    snap = eng.snapshot()
    env = {"REPRO_KV_PAGES": str(eng.model.page_size),
           "REPRO_KV_QUANT": eng.model.kv_quant,
           "REPRO_SPEC_DECODE": eng.spec}
    if eng.spec != "off":
        env["REPRO_SPEC_K"] = str(eng.spec_k)
    snap["engine"] = {
        "arch": arch, "smoke": smoke, "slots": slots,
        "prompt_len": prompt_len, "gen": gen, "chunk": chunk,
        "top_k": eng._top_k, "spec": eng.spec, "spec_k": eng.spec_k,
        "draft_layers": eng._generate.draft_layers or None,
        "kv_quant": eng.model.kv_quant, "page_size": eng.model.page_size,
        "device": eng.device.type, "env": env,
    }
    if queue is not None:
        snap["engine"]["queue"] = queue
    RestartManifest(
        step=eng.stats["decode_dispatches"], checkpoint_dir="",
        mesh_shape=[1], mesh_axes=["data"], data_seed=eng.seed, arch=arch,
        shape="serve", straggler_events=list(eng._straggler.flagged),
        serve=snap,
    ).save(path)


def _manifest_layout(ecfg: Dict[str, Any]) -> Dict[str, Any]:
    """The KV layout and drafter of a manifest's ``engine`` block: its
    fields (a port manifest) or else its ``env`` knobs (a reference
    manifest)."""
    env = ecfg.get("env", {})
    spec = ecfg.get("spec") or env.get("REPRO_SPEC_DECODE") or "off"
    spec_k = ecfg.get("spec_k") or env.get("REPRO_SPEC_K")
    return dict(
        kv_quant=ecfg.get("kv_quant") or env.get("REPRO_KV_QUANT") or "off",
        page_size=int(ecfg.get("page_size")
                      or env.get("REPRO_KV_PAGES") or 0),
        spec=spec, spec_k=int(spec_k) if spec != "off" and spec_k else None,
        draft_layers=ecfg.get("draft_layers"))


def restore_serve(path: str, *, device=None, cfg: Optional[ModelConfig] = None,
                  params=None, model=None, resume: bool = False
                  ) -> ServeEngine:
    """Rebuild a :class:`ServeEngine` from a serving manifest (the port's or
    the reference's) and drain it. In-flight requests regenerate from their
    prompts, so greedy completions equal an uninterrupted drain's;
    ``resume=True`` (paged) re-prefills ``prompt + produced`` instead, the
    bucket grown to the longest such prompt (see
    :meth:`ServeEngine.load_snapshot`). ``device`` defaults to the
    manifest's (the card when it names none); ``cfg`` / ``params`` /
    ``model`` give the weights, else the seed's."""
    man = RestartManifest.load(path)
    if man.serve is None:
        raise ValueError(f"{path}: not a serving manifest")
    snap = man.serve
    ecfg = snap["engine"]
    prompt_len = ecfg["prompt_len"]
    if resume:
        need = max((len(d["tokens"]) + len(d.get("produced", []))
                    for d in snap.get("queued", []) + snap.get("active", [])),
                   default=0)
        prompt_len = max(prompt_len, need)
    eng = make_queue_engine(
        ecfg["arch"], smoke=ecfg["smoke"], slots=ecfg["slots"],
        prompt_len=prompt_len, gen=ecfg["gen"], chunk=ecfg["chunk"],
        seed=snap["seed"], temperature=snap["temperature"],
        top_k=ecfg.get("top_k", 0),
        device=device or ecfg.get("device", "cuda"), cfg=cfg, params=params,
        model=model, **_manifest_layout(ecfg))
    eng.load_snapshot(snap, resume=resume)
    eng.run()
    return eng


def _print_queue_stats(eng: ServeEngine) -> None:
    s = eng.stats
    print(f"device={eng.device} {len(eng.completions)} requests, "
          f"{s['tokens_out']} tokens in {s['wall_seconds']:.3f}s "
          f"({s['tokens_per_second']:.1f} tok/s, "
          f"{s['dispatches_per_token']:.3f} dispatches/token, "
          f"{s['prefills']} prefills)")
    print(f"kv: {s['kv_hbm_bytes_peak'] / 1e6:.2f} MB peak "
          f"({s['kv_bytes_per_token']:.0f} B/token"
          + (f", {s['kv_pages_peak']} pages peak, "
             f"{s['prefix_hits']} prefix hits" if eng.paged else "")
          + ")")
    if eng.spec != "off":
        print(f"spec: mode={eng.spec} k={eng.spec_k} accepted_len/draft="
              f"{s['spec_accepted_len_per_draft']:.3f} "
              f"accept hist={s['spec_accept_hist']}")
    if (s["error_completions"] or s["deadline_miss"] or s["retries"]
            or s["shed_events"] or s["admission_blocked"]
            or eng.chaos_events):
        print(f"robust: {s['error_completions']} error completions "
              f"({s['deadline_miss']} deadline misses), "
              f"{s['retries']} retries, {s['shed_events']} shed events, "
              f"{s['straggler_events']} stragglers, "
              f"{s['admission_blocked']} admission stalls, "
              f"queue peak {s['queue_peak']}, "
              f"{len(eng.chaos_events)} chaos events")


def _assert_identical(eng, ref, label: str, skip_uids=()) -> int:
    """``eng``'s non-error completions (an engine's or a fleet's) equal
    ``ref``'s token for token, but for ``skip_uids``; returns how many
    were compared."""
    got = {c.uid: c for c in eng.completions}
    want = sorted(c.uid for c in ref.completions)
    if sorted(got) != want:
        raise AssertionError(f"{label}: completion uids {sorted(got)} != "
                             f"{want}")
    checked = 0
    for c in ref.completions:
        g = got[c.uid]
        if g.finish_reason == "error" or c.uid in skip_uids:
            continue
        if list(np.asarray(g.tokens)) != list(np.asarray(c.tokens)):
            raise AssertionError(f"{label} mismatch on uid={c.uid}: "
                                 f"{np.asarray(g.tokens)} != "
                                 f"{np.asarray(c.tokens)}")
        checked += 1
    return checked


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pimref-100m", choices=list(ALL_IDS))
    ap.add_argument("--mode", default="batch", choices=["batch", "queue"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of the full one")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--engine", default="fused", choices=["fused", "loop"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-quant", default="off", choices=list(KV_QUANT_MODES),
                    help="Proteus-quantized KV cache: int8 / int4 codes with "
                    "per-row fp32 scales, or auto (grid picked per tensor)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="paged KV cache with this many tokens per page "
                    "(0 = contiguous per-slot ring)")
    ap.add_argument("--page-pool-pages", type=int, default=None,
                    help="queue mode: physical pages of the paged pool "
                    "(default slots * pages per slot)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="queue mode: give every request the same first N "
                    "tokens (exercises paged prefix sharing)")
    ap.add_argument("--repeat-period", type=int, default=0,
                    help="queue mode: tile each prompt from a short period "
                    "(what the n-gram drafter finds)")
    ap.add_argument("--spec-decode", default="off",
                    choices=list(SPEC_DECODE_MODES),
                    help="speculative decoding inside the fused chunk: "
                    "n-gram lookup over each slot's history, or layer-skip "
                    "self-drafting through the first half of the layers")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft length per speculative iteration (default 3)")
    ap.add_argument("--spec-verify", action="store_true",
                    help="queue mode: drain the same queue again with "
                    "speculation off and assert identical completions")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="queue mode: bound the waiting queue; submissions "
                    "beyond it get a queue_full error completion")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="queue mode: per-request deadline; overdue requests "
                    "retire with a deadline error completion")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="queue mode: arm seeded fault injection; the plan "
                    "comes from REPRO_CHAOS (e.g. 'nan=1,slow=2,fail=1,"
                    "pages=4') or defaults to nan=1,slow=1,fail=1")
    ap.add_argument("--chaos-verify", action="store_true",
                    help="queue mode: drain the same queue without chaos and "
                    "assert the fault-free survivors are byte-identical")
    ap.add_argument("--preempt-after", type=int, default=None,
                    help="queue mode: raise SIGTERM after N chunks and write "
                    "the in-flight state to --snapshot (the real signal "
                    "path)")
    ap.add_argument("--snapshot", default="serve_manifest.json",
                    help="manifest written on preemption")
    ap.add_argument("--restore", default=None,
                    help="restore a serving manifest and drain the remaining "
                    "requests (implies queue mode)")
    ap.add_argument("--restore-verify", action="store_true",
                    help="with --restore: also drain the original queue "
                    "uninterrupted and assert byte-identical completions")
    ap.add_argument("--shards", type=int, default=1,
                    help="queue mode: drain through a ServeFleet of this "
                    "many engine shards (1 = one engine, no fleet)")
    ap.add_argument("--fleet-backend", default="inproc",
                    choices=["inproc", "mp"],
                    help="shards as objects in this process, or spawned "
                    "worker processes, each with its own engine on --device")
    ap.add_argument("--fleet-chaos", default=None,
                    help="shard-level fault plan, e.g. 'kill=1@2' (kill "
                    "shard 1 at fleet step 2), 'stall=0@3', 'drop=1@2x2', "
                    "or seeded budgets 'kills=1,seed=7' (implies --shards)")
    ap.add_argument("--fleet-verify", action="store_true",
                    help="drain the same queue through one engine and assert "
                    "exactly one completion per request with byte-identical "
                    "survivors")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0,
                    help="seconds a shard may owe its step reply before a "
                    "missed heartbeat is counted")
    ap.add_argument("--miss-suspect", type=int, default=2,
                    help="consecutive missed heartbeats before a shard is "
                    "SUSPECT (no new routing)")
    ap.add_argument("--miss-dead", type=int, default=4,
                    help="consecutive missed heartbeats before a shard is "
                    "DEAD (failover)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="fleet steps between shard snapshots (the failover "
                    "replay source)")
    ap.add_argument("--manifest-dir", default=None,
                    help="persist each shard snapshot as an atomic "
                    "RestartManifest under this directory")
    args = ap.parse_args()
    if args.restore:
        eng = restore_serve(args.restore, device=args.device)
        _print_queue_stats(eng)
        if args.restore_verify:
            man = RestartManifest.load(args.restore)
            e, q = man.serve["engine"], man.serve["engine"].get("queue")
            if not q:
                raise SystemExit("--restore-verify needs a manifest saved "
                                 "by queue mode")
            layout = _manifest_layout(e)
            ref = serve_queue(
                e["arch"], smoke=e["smoke"], slots=e["slots"],
                requests=q["requests"], prompt_len=e["prompt_len"],
                gen=e["gen"], chunk=e["chunk"], seed=man.serve["seed"],
                temperature=man.serve["temperature"], top_k=e.get("top_k", 0),
                shared_prefix=q.get("shared_prefix", 0),
                repeat_period=q.get("repeat_period", 0), device=args.device,
                **layout)
            n = _assert_identical(eng, ref, "restore-verify")
            print(f"restore-verify: {n} completions byte-identical with an "
                  "uninterrupted drain")
        return
    layout = dict(kv_quant=args.kv_quant, page_size=args.kv_page_size)
    if args.mode == "queue":
        chaos = ChaosConfig.from_env(args.chaos_seed)
        if chaos is None and args.chaos_seed is not None:
            chaos = ChaosConfig.parse("nan=1,slow=1,fail=1",
                                      seed=args.chaos_seed)
        queue_kw = dict(
            smoke=args.smoke, slots=args.slots, requests=args.requests,
            prompt_len=args.prompt_len, gen=args.gen, chunk=args.chunk,
            seed=args.seed, temperature=args.temperature, top_k=args.top_k,
            shared_prefix=args.shared_prefix,
            repeat_period=args.repeat_period, device=args.device,
            spec=args.spec_decode, spec_k=args.spec_k, **layout)
        if args.shards > 1 or args.fleet_chaos or \
                args.fleet_backend == "mp":
            fc = (ShardChaosConfig.parse(args.fleet_chaos,
                                         seed=args.chaos_seed or 0)
                  if args.fleet_chaos else None)
            fleet = serve_fleet(
                args.arch, shards=max(args.shards, 1),
                backend=args.fleet_backend, fleet_chaos=fc,
                checkpoint_every=args.checkpoint_every,
                manifest_dir=args.manifest_dir,
                miss_suspect=args.miss_suspect, miss_dead=args.miss_dead,
                heartbeat_timeout_s=args.heartbeat_timeout,
                page_pool_pages=args.page_pool_pages, **queue_kw)
            _print_fleet_stats(fleet)
            try:
                if args.fleet_verify:
                    uids = sorted(c.uid for c in fleet.completions)
                    if uids != list(range(args.requests)):
                        raise AssertionError(
                            f"fleet-verify: expected exactly one completion "
                            f"per request, got uids {uids}")
                    ref = serve_queue(args.arch,
                                      page_pool_pages=args.page_pool_pages,
                                      **queue_kw)
                    n = _assert_identical(fleet, ref, "fleet-verify")
                    print(f"fleet-verify: {n}/{args.requests} surviving "
                          f"completions byte-identical with a single-engine "
                          f"drain ({fleet.stats['failovers']} failovers)")
            finally:
                fleet.close()
            return
        handler = stop = None
        if args.preempt_after is not None:
            handler = PreemptionHandler().install()

            def stop(e, _h=handler):
                if (not _h.requested and
                        e.stats["decode_dispatches"] >= args.preempt_after):
                    os.kill(os.getpid(), signal.SIGTERM)
                return _h.requested
        eng = serve_queue(args.arch, max_queue=args.max_queue,
                          deadline_ms=args.deadline_ms, chaos=chaos,
                          page_pool_pages=args.page_pool_pages, stop=stop,
                          **queue_kw)
        _print_queue_stats(eng)
        if handler is not None:
            handler.uninstall()
            if handler.requested:
                save_serve_manifest(
                    args.snapshot, eng, arch=args.arch, smoke=args.smoke,
                    slots=args.slots, prompt_len=args.prompt_len,
                    gen=args.gen, chunk=args.chunk,
                    queue={"requests": args.requests,
                           "shared_prefix": args.shared_prefix,
                           "repeat_period": args.repeat_period})
                print(f"preempted after {eng.stats['decode_dispatches']} "
                      f"chunks: {len(eng.completions)}/{args.requests} done, "
                      f"manifest -> {args.snapshot}")
                return
        if args.chaos_verify and chaos is not None:
            ref = serve_queue(args.arch, page_pool_pages=args.page_pool_pages,
                              **queue_kw)
            poisoned = {ev["uid"] for ev in eng.chaos_events
                        if ev["kind"] == "nan"}
            n = _assert_identical(eng, ref, "chaos-verify",
                                  skip_uids=poisoned)
            print(f"chaos-verify: {n}/{len(eng.completions)} fault-free "
                  f"survivors byte-identical "
                  f"({len(eng.chaos_events)} injected events)")
        if args.spec_verify and eng.spec != "off":
            ref = serve_queue(args.arch, page_pool_pages=args.page_pool_pages,
                              **{**queue_kw, "spec": "off"})
            n = _assert_identical(eng, ref, "spec-verify")
            print(f"spec-verify: {n} completions byte-identical with "
                  "speculation off")
        return
    out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, chunk=args.chunk,
                engine=args.engine, temperature=args.temperature,
                top_k=args.top_k, seed=args.seed, device=args.device,
                spec=args.spec_decode, spec_k=args.spec_k, **layout)
    print(f"device={out['device']} engine={args.engine}  prefill: "
          f"{out['prefill_s'] * 1e3:.2f}ms  decode: "
          f"{out['decode_s_per_tok'] * 1e3:.3f}ms/tok  "
          f"throughput: {out['throughput_tok_s']:.1f} tok/s  "
          f"dispatches/token: {out['dispatches_per_token']:.3f}")
    if "accepted_len_per_draft" in out:
        print(f"spec accepted_len/draft: {out['accepted_len_per_draft']:.3f}")
    print("sample tokens:", out["tokens"][0][:10])


if __name__ == "__main__":
    main()
