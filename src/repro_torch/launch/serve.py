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
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_IDS, ModelConfig, get_config
from repro_torch.kernels.common import KV_QUANT_MODES, SPEC_DECODE_MODES
from repro_torch.launch.engine import Request, ServeEngine
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
                      draft_layers: Optional[int] = None) -> ServeEngine:
    """A fresh :class:`ServeEngine` for ``arch`` over the KV layout
    ``kv_quant`` / ``page_size`` (``page_pool_pages`` sizes the paged
    pool), speculating as ``spec`` / ``spec_k`` / ``draft_layers`` say."""
    model = _model(model, arch, smoke=smoke, seed=seed, device=device,
                   cfg=cfg, params=params, kv_quant=kv_quant,
                   page_size=page_size)
    return ServeEngine(model, slots=slots, prompt_len=prompt_len, max_new=gen,
                       chunk=chunk, eos_id=eos_id, temperature=temperature,
                       top_k=top_k, seed=seed, spec=spec, spec_k=spec_k,
                       draft_layers=draft_layers,
                       page_pool_pages=page_pool_pages)


def synth_requests(arch: str = "pimref-100m", *, smoke: bool = True,
                   requests: int = 10, prompt_len: int = 32, gen: int = 16,
                   seed: int = 0, shared_prefix: int = 0,
                   cfg: Optional[ModelConfig] = None) -> List[Request]:
    """The synthetic mixed-length request stream of queue mode (the same
    stream as the reference's for the same arguments, without its repeat
    option). ``shared_prefix > 0`` gives every request the same first
    tokens (a common system prompt), which the paged cache shares."""
    cfg = cfg or get_config(arch, smoke=smoke)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, shared_prefix).astype(np.int32)
    reqs = []
    for i in range(requests):
        n = int(rng.integers(max(4, shared_prefix + 1), prompt_len + 1))
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
                shared_prefix: int = 0, kv_quant: str = "off",
                page_size: int = 0, page_pool_pages: Optional[int] = None,
                spec: str = "off", spec_k: Optional[int] = None,
                draft_layers: Optional[int] = None,
                device="cuda") -> ServeEngine:
    """Continuous batching: drain the synthetic request stream through a
    :class:`ServeEngine`; returns the drained engine."""
    eng = make_queue_engine(arch, smoke=smoke, slots=slots,
                            prompt_len=prompt_len, gen=gen, chunk=chunk,
                            seed=seed, temperature=temperature, top_k=top_k,
                            device=device, kv_quant=kv_quant,
                            page_size=page_size,
                            page_pool_pages=page_pool_pages, spec=spec,
                            spec_k=spec_k, draft_layers=draft_layers)
    eng.run(synth_requests(arch, smoke=smoke, requests=requests,
                           prompt_len=prompt_len, gen=gen, seed=seed,
                           shared_prefix=shared_prefix))
    return eng


def _assert_identical(eng: ServeEngine, ref: ServeEngine, label: str) -> int:
    """``eng``'s non-error completions equal ``ref``'s token for token;
    returns how many were compared."""
    got = {c.uid: c for c in eng.completions}
    want = sorted(c.uid for c in ref.completions)
    if sorted(got) != want:
        raise AssertionError(f"{label}: completion uids {sorted(got)} != "
                             f"{want}")
    checked = 0
    for c in ref.completions:
        g = got[c.uid]
        if g.finish_reason == "error":
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
    args = ap.parse_args()
    layout = dict(kv_quant=args.kv_quant, page_size=args.kv_page_size)
    if args.mode == "queue":
        queue_kw = dict(
            smoke=args.smoke, slots=args.slots, requests=args.requests,
            prompt_len=args.prompt_len, gen=args.gen, chunk=args.chunk,
            seed=args.seed, temperature=args.temperature, top_k=args.top_k,
            shared_prefix=args.shared_prefix,
            page_pool_pages=args.page_pool_pages, device=args.device,
            **layout)
        eng = serve_queue(args.arch, spec=args.spec_decode,
                          spec_k=args.spec_k, **queue_kw)
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
        if args.spec_verify and eng.spec != "off":
            ref = serve_queue(args.arch, spec="off", **queue_kw)
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
