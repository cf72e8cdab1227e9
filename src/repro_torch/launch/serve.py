"""Serving driver: pre-sized cache prefill + fused decode (counterpart:
``repro/launch/serve.py``).

Two decode engines share one pre-sized cache:

  * ``loop``  — one ``decode_step`` and one host sync per generated token;
  * ``fused`` — ``make_generate_step``: ``chunk`` decode steps per host sync.

Greedy tokens of the two are identical. Runs on the card unless asked for
the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch pimref-100m \\
      [--mode batch|queue] [--device cuda|cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_IDS, ModelConfig, get_config
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.launch.steps import make_generate_step, sample_tokens
from repro_torch.models import build_model, init_params, load_jax_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_model(arch: str, *, smoke: bool, seed: int, device,
               cfg: Optional[ModelConfig] = None, params=None):
    """Build the model for ``arch`` (or ``cfg``) on ``device`` with the
    port's own init from ``seed``, or with ``params``: the reference's
    parameter tree as numpy arrays (see ``models/bridge.py``)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch, smoke=smoke)
    model = build_model(cfg, dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model.load_state_dict(init_params(cfg, gen, dev))
    else:
        load_jax_params(model, params)
    return model


def _clone(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in cache.items()}


def serve(arch: str = "pimref-100m", *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          engine: str = "fused", chunk: int = 8, temperature: float = 0.0,
          top_k: int = 0, device="cuda", cfg: Optional[ModelConfig] = None,
          params=None, model=None) -> Dict[str, Any]:
    """Prefill a synthetic batch, then decode ``gen`` tokens per sequence.

    Returns the tokens with timing and dispatch counts: ``prefills`` and
    ``decode_steps`` count every ``model.prefill`` / ``model.decode_step``
    call, the untimed warmup of the decode engine included. ``model`` reuses
    an already built model.
    """
    assert engine in ("fused", "loop"), engine
    if model is None:
        model = load_model(arch, smoke=smoke, seed=seed, device=device,
                           cfg=cfg, params=params)
    dev, cfg = model.device, model.cfg
    max_len = prompt_len + gen
    generate = make_generate_step(model, chunk=chunk, temperature=temperature,
                                  top_k=top_k)
    n_chunks = -(-gen // chunk)

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, max_len=max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    decode_steps = 0

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    eos = -1                       # batch mode: length-only stopping
    # warmup: first-call costs outside the timed region
    spare = torch.Generator(device=dev).manual_seed(seed + 1)
    if engine == "loop":
        model.decode_step(_clone(cache), tok)
        decode_steps += 1
    else:
        generate(_clone(cache), tok, spare, eos)
        decode_steps += chunk
    _sync(dev)

    dispatches = 0
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
    else:
        for _ in range(n_chunks):
            cache, tok, sampler, _done, _n, toks_d, _failed = generate(
                cache, tok, sampler, eos)
            out_tokens.append(toks_d.cpu().numpy())     # host sync, per chunk
            dispatches += 1
            decode_steps += chunk
    toks = np.concatenate(out_tokens, axis=1)[:, :gen]
    t_decode = time.perf_counter() - t0

    return {
        "tokens": toks,
        "device": str(dev),
        "prefill_s": t_prefill,
        "decode_s_per_tok": t_decode / max(gen, 1),
        "throughput_tok_s": batch * gen / max(t_decode, 1e-9),
        "dispatches": dispatches,
        "dispatches_per_token": dispatches / max(gen, 1),
        "prefills": 1,
        "decode_steps": decode_steps,
    }


def make_queue_engine(arch: str = "pimref-100m", *, smoke: bool = True,
                      slots: int = 4, prompt_len: int = 32, gen: int = 16,
                      chunk: int = 8, seed: int = 0, temperature: float = 0.0,
                      top_k: int = 0, eos_id: Optional[int] = None,
                      device="cuda", cfg: Optional[ModelConfig] = None,
                      params=None, model=None) -> ServeEngine:
    """A fresh :class:`ServeEngine` for ``arch`` (contiguous KV layout)."""
    if model is None:
        model = load_model(arch, smoke=smoke, seed=seed, device=device,
                           cfg=cfg, params=params)
    return ServeEngine(model, slots=slots, prompt_len=prompt_len, max_new=gen,
                       chunk=chunk, eos_id=eos_id, temperature=temperature,
                       top_k=top_k, seed=seed)


def synth_requests(arch: str = "pimref-100m", *, smoke: bool = True,
                   requests: int = 10, prompt_len: int = 32, gen: int = 16,
                   seed: int = 0,
                   cfg: Optional[ModelConfig] = None) -> List[Request]:
    """The synthetic mixed-length request stream of queue mode (the same
    stream as the reference's for the same arguments, without its shared
    prefix and repeat options)."""
    cfg = cfg or get_config(arch, smoke=smoke)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(requests):
        n = int(rng.integers(4, prompt_len + 1))
        toks = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        reqs.append(Request(
            uid=i, tokens=toks,
            max_new_tokens=int(rng.integers(max(gen // 2, 1), gen + 1))))
    return reqs


def serve_queue(arch: str = "pimref-100m", *, smoke: bool = True,
                slots: int = 4, requests: int = 10, prompt_len: int = 32,
                gen: int = 16, chunk: int = 8, seed: int = 0,
                temperature: float = 0.0, top_k: int = 0,
                device="cuda") -> ServeEngine:
    """Continuous batching: drain the synthetic request stream through a
    :class:`ServeEngine`; returns the drained engine."""
    eng = make_queue_engine(arch, smoke=smoke, slots=slots,
                            prompt_len=prompt_len, gen=gen, chunk=chunk,
                            seed=seed, temperature=temperature, top_k=top_k,
                            device=device)
    eng.run(synth_requests(arch, smoke=smoke, requests=requests,
                           prompt_len=prompt_len, gen=gen, seed=seed))
    return eng


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
    args = ap.parse_args()
    if args.mode == "queue":
        eng = serve_queue(args.arch, smoke=args.smoke, slots=args.slots,
                          requests=args.requests, prompt_len=args.prompt_len,
                          gen=args.gen, chunk=args.chunk, seed=args.seed,
                          temperature=args.temperature, top_k=args.top_k,
                          device=args.device)
        s = eng.stats
        print(f"device={eng.device} {len(eng.completions)} requests, "
              f"{s['tokens_out']} tokens in {s['wall_seconds']:.3f}s "
              f"({s['tokens_per_second']:.1f} tok/s, "
              f"{s['dispatches_per_token']:.3f} dispatches/token, "
              f"{s['prefills']} prefills)")
        return
    out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, chunk=args.chunk,
                engine=args.engine, temperature=args.temperature,
                top_k=args.top_k, seed=args.seed, device=args.device)
    print(f"device={out['device']} engine={args.engine}  prefill: "
          f"{out['prefill_s'] * 1e3:.2f}ms  decode: "
          f"{out['decode_s_per_tok'] * 1e3:.3f}ms/tok  "
          f"throughput: {out['throughput_tok_s']:.1f} tok/s  "
          f"dispatches/token: {out['dispatches_per_token']:.3f}")
    print("sample tokens:", out["tokens"][0][:10])


if __name__ == "__main__":
    main()
