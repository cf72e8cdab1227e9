#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA GPU; exits non-zero without one. Phases:

1. device: the card's name and power limit, TF32 off for fp32 products;
2. build: every CUDA kernel source of the port, one nvcc each, in parallel;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the main path's shapes and at synthetic edge cases, with the
   tolerance stated; device times of kernel, plain version and the PyTorch
   library call computing the same function;
4. serve: ``pimref-100m`` at full width, batch-mode ``serve()`` with the
   fused and the per-token engine; greedy tokens must be identical and every
   prefill / decode step must have launched the attention kernels once per
   layer;
5. card vs CPU: the same fp32 weights on the card (kernels) and on the CPU
   (plain path), prefill plus teacher-forced decode steps, logits compared;
6. engine: ``ServeEngine`` drains mixed-length requests on 8 slots;
7. profile: ``torch.profiler`` over batch-mode serving (prefill and three
   fused chunks): the device's busy share and the kernels by device time.

The second-to-last line is a JSON object of per-kernel numbers, the last is
``{"ok": true, "device": {...}}``. Any failure raises.

    python3 chip_smoke.py [--seed N] [--phases device,build,kernels,...]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "build", "kernels", "serve", "engine", "profile", "parity")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PARITY_ATOL = 1e-3                  # fp32 logits, card vs CPU
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = {
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_decode_fwd": "src/repro/kernels/flash_attention/kernel.py:174",
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing on the device
# ---------------------------------------------------------------------------
def device_ms(fn, n_sets: int, iters: int, replays: int = 3) -> float:
    """Device time of one ``fn(i)`` call: ``iters`` calls captured in a CUDA
    graph (no host overhead in the measurement), cycling over ``n_sets``
    input sets so the inputs exceed the L2 cache, replayed and timed with
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_sets)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def n_sets_for(nbytes: int) -> int:
    """Input copies needed to stream more than twice the 50 MB L2."""
    return max(1, math.ceil(100e6 / max(nbytes, 1)))


def bound_ms(nbytes: int, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def ring_positions(depths, S, T):
    """(B, S) q positions and (B, T) ring kv positions of slots that hold
    ``depth`` tokens and append S more (slots never written hold -1)."""
    from repro_torch.models.layers import ring_position_ids
    qp = torch.stack([torch.arange(d, d + S, dtype=torch.int32)
                      for d in depths])
    kp = torch.cat([ring_position_ids(1, d + S, T) for d in depths])
    return qp.cuda(), kp.cuda()


def visible_pairs(qp, kp, causal, window) -> int:
    from repro_torch.kernels.flash_attention.ref import visible_mask
    return int(visible_mask(qp, kp, causal=causal, window=window).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build_all()
    log("build", f"{len(build.sources())} source(s) ready in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, rec in info.items():
        log("build", f"{name}: nvcc {rec['seconds']:.2f}s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("build", "  " + line.strip())


def _check(name, got, want, tol, what="out"):
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    ok = err <= tol
    log("kernels", f"{name} {what}: max_abs_err={err:.3e} (tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: max abs err {err} > {tol}")
    return err


def phase_kernels(seed: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}

    # -- prefill at the main path's shape (model layout, strided views) ----
    B, H, S, D, dt = 8, 12, 512, 64, torch.bfloat16
    q, k, v = (randn(gen, (B, S, H, D), dt) for _ in range(3))
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
    split = lambda x: x.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4)
    r_out, r_lse = ref.flash_attention_fwd_ref(
        split(q), k.transpose(1, 2), v.transpose(1, 2), pos, pos, causal=True)
    err = _check("prefill B8 H12 S=T=512 D64 bf16", out,
                 r_out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D), TOL[dt])
    _check("prefill B8 H12 S=T=512 D64 bf16", lse, r_lse, TOL[dt], "lse")
    n_sets = n_sets_for(4 * q.nbytes)
    sets = [[randn(gen, (B, S, H, D), dt) for _ in range(3)]
            for _ in range(n_sets)]
    t_k = device_ms(lambda i: ops.flash_attention_gqa_fwd(*sets[i]),
                    n_sets, 20)
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, causal=True), n_sets, 4)
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], is_causal=True), n_sets, 20)
    del sets, sets4, sets5
    nbytes = 4 * q.nbytes + lse.nbytes + 2 * pos.nbytes
    flops = 4.0 * D * H * visible_pairs(pos, pos, True, 0)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_attention_fwd"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=t_l)
    log("kernels", f"prefill times: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"sdpa {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
        f"{flops:.3e} FLOP)")

    # -- prefill edge cases (kernel layout): G=4, D=128, odd S/T, window,
    #    softcap, -1 q rows and kv slots; out and lse ---------------------
    for dt in (torch.float32, torch.bfloat16):
        B2, H2, G2, S2, T2, D2 = 2, 3, 4, 77, 203, 128
        q5 = randn(gen, (B2, H2, G2, S2, D2), dt)
        k4, v4 = (randn(gen, (B2, H2, T2, D2), dt) for _ in range(2))
        qp = (torch.arange(S2, dtype=torch.int32) + 126).repeat(B2, 1)
        qp[1, :5] = -1
        kp = torch.arange(T2, dtype=torch.int32).repeat(B2, 1)
        kp[0, 64:140] = -1
        kp[1, ::7] = -1
        qp, kp = qp.cuda(), kp.cuda()
        kw = dict(causal=True, window=48, softcap=20.0)
        o, l = fk.flash_attention_fwd(q5, k4, v4, qp, kp, **kw)
        ro, rl = ref.flash_attention_fwd_ref(q5, k4, v4, qp, kp, **kw)
        name = f"prefill G4 D128 S77 T203 window softcap -1 {str(dt)[6:]}"
        _check(name, o, ro, TOL[dt])
        _check(name, l, rl, TOL[dt], "lse")

    # -- decode: mixed per-slot depths, -1 ring slots, S in {1, 4} ---------
    B, H, T, D = 8, 12, 576, 64
    depths = [17, 100, 511, 575, 300, 572, 40, 250]
    for dt in (torch.bfloat16, torch.float32):
        for S in (1, 4):
            q = randn(gen, (B, S, H, D), dt)
            k, v = (randn(gen, (B, T, H, D), dt) for _ in range(2))
            qp, kp = ring_positions(depths, S, T)
            o = ops.flash_decode(q, k, v, qp, kp, causal=True)
            ro = ref.flash_decode_fwd_ref(
                q.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4),
                k.transpose(1, 2), v.transpose(1, 2), qp, kp, causal=True)
            e = _check(f"decode B8 H12 T576 S{S} D64 mixed depths "
                       f"{str(dt)[6:]}", o,
                       ro.permute(0, 3, 1, 2, 4).reshape(B, S, H, D), TOL[dt])
            if dt == torch.bfloat16 and S == 1:
                dec_err = e
    # G*S = 16 rows (two row tiles), D=128, window and softcap
    q5 = randn(gen, (3, 2, 4, 4, 128), torch.float32)
    k4, v4 = (randn(gen, (3, 2, 300, 128), torch.float32) for _ in range(2))
    qp, kp = ring_positions([10, 150, 400], 4, 300)
    kw = dict(causal=True, window=100, softcap=30.0)
    _check("decode G4 S4 D128 T300 window softcap ring-wrap fp32",
           fk.flash_decode_fwd(q5, k4, v4, qp, kp, **kw),
           ref.flash_decode_fwd_ref(q5, k4, v4, qp, kp, **kw),
           TOL[torch.float32])

    # -- decode timing at the main path's shape: S=1, bf16, cache layout ---
    dt, S = torch.bfloat16, 1
    qp, kp = ring_positions([575 - 8 * b for b in range(B)], S, T)
    kv_bytes = 2 * B * T * H * D * 2
    n_sets = n_sets_for(kv_bytes)
    sets = [(randn(gen, (B, S, H, D), dt), randn(gen, (B, T, H, D), dt),
             randn(gen, (B, T, H, D), dt)) for _ in range(n_sets)]
    t_k = device_ms(lambda i: ops.flash_decode(*sets[i], qp, kp), n_sets, 50)
    sets5 = [(a.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4),
              b.transpose(1, 2), c.transpose(1, 2)) for a, b, c in sets]
    t_p = device_ms(lambda i: ref.flash_decode_fwd_ref(*sets5[i], qp, kp),
                    n_sets, 10)
    from repro_torch.kernels.flash_attention.ref import visible_mask
    mask = visible_mask(qp, kp, causal=True, window=0)[:, None]  # (B,1,S,T)
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], attn_mask=mask), n_sets, 50)
    del sets, sets4, sets5
    valid_rows = int((kp >= 0).sum())
    nbytes = (2 * 2 * valid_rows * H * D      # K and V rows that hold tokens
              + 2 * B * S * H * D * 2         # q in, out
              + qp.nbytes + kp.nbytes)
    flops = 4.0 * D * H * visible_pairs(qp, kp, True, 0)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_decode_fwd"] = dict(max_abs_err=dec_err, ms=t_k, plain_ms=t_p,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=t_l)
    log("kernels", f"decode times: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"sdpa {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
        f"{flops:.3e} FLOP); splits {fk.decode_splits(B, H, T)}")
    return rows


def _reset():
    from repro_torch.kernels.flash_attention import LAUNCHES
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_launches(phase, n_layers, prefills, decode_steps) -> dict:
    from repro_torch.kernels.flash_attention import LAUNCHES
    got = dict(LAUNCHES)
    want = {"flash_attention_fwd": n_layers * prefills,
            "flash_decode_fwd": n_layers * decode_steps}
    log(phase, f"launches {got} (want {want}: {n_layers} layers x "
        f"{prefills} prefills / {decode_steps} decode steps)")
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != {want}")
    return got


def phase_serve(model, smi: str) -> dict:
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    kw = dict(batch=8, prompt_len=512, gen=64, chunk=8, seed=0)
    serve(model=model, engine="fused", **{**kw, "gen": 8})   # first-call costs
    runs, launches = {}, {}
    for engine in ("fused", "loop"):
        _reset()
        out = serve(model=model, engine=engine, **kw)
        launches[engine] = _check_launches(f"serve/{engine}", cfg.num_layers,
                                           out["prefills"],
                                           out["decode_steps"])
        toks = out["tokens"]
        if toks.shape != (kw["batch"], kw["gen"]) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"serve/{engine}: bad tokens {toks.shape} "
                                 f"[{toks.min()}, {toks.max()}]")
        log(f"serve/{engine}", f"{smi}: prefill {out['prefill_s'] * 1e3:.3f} "
            f"ms (B=8 x 512), decode {out['decode_s_per_tok'] * 1e3:.4f} "
            f"ms/token-step, {out['throughput_tok_s']:.1f} tokens/s, "
            f"{out['dispatches']} host syncs")
        runs[engine] = out
    same = np.array_equal(runs["fused"]["tokens"], runs["loop"]["tokens"])
    log("serve", f"fused == loop tokens: {same}")
    if not same:
        raise AssertionError("fused and loop greedy tokens differ")
    return launches["fused"]


def phase_parity(seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, init_params
    cfg = get_config("pimref-100m").replace(compute_dtype="float32")
    state = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    cpu = TransformerLM(cfg, device="cpu")
    cpu.load_state_dict(state)
    gpu = TransformerLM(cfg, device="cuda")
    gpu.load_state_dict(state)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                              .astype(np.int32))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    lc, cc = cpu.prefill(prompt, max_len=72)
    lg, cg = gpu.prefill(prompt.cuda(), max_len=72)
    pairs = [(lc, lg)]
    for i in range(feed.shape[1]):
        lc, cc = cpu.decode_step(cc, feed[:, i:i + 1])
        lg, cg = gpu.decode_step(cg, feed[:, i:i + 1].cuda())
        pairs.append((lc, lg))
    errs = [(c - g.cpu()).abs().max().item() for c, g in pairs]
    agree = np.mean([float((c.argmax(-1) == g.cpu().argmax(-1)).all())
                     for c, g in pairs])
    kv = max((cc[n] - cg[n].cpu()).abs().max().item() for n in ("k", "v"))
    log("parity", f"fp32 logits card vs CPU, prefill 64 + 8 decode steps: "
        f"max_abs_err per call {['%.2e' % e for e in errs]}, cache "
        f"{kv:.2e}, top-1 agreement {agree:.3f} (tol {PARITY_ATOL:.0e})")
    if max(errs) > PARITY_ATOL or kv > PARITY_ATOL:
        raise AssertionError(f"card vs CPU logits differ by {max(errs)}")


def phase_engine(model, seed: int) -> None:
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import make_queue_engine
    cfg = model.cfg
    rng = np.random.default_rng(seed + 7)
    reqs = [Request(uid=i, tokens=rng.integers(
        1, cfg.vocab_size, int(rng.integers(4, 257))).astype(np.int32),
        max_new_tokens=int(rng.integers(16, 65))) for i in range(24)]
    eng = make_queue_engine(model=model, slots=8, prompt_len=256, gen=64,
                            chunk=8, seed=seed)
    _reset()
    comps = eng.run(list(reqs))
    torch.cuda.synchronize()
    s = eng.stats
    _check_launches("engine", cfg.num_layers, s["prefills"], s["decode_steps"])
    by_uid = {}
    for c in comps:
        if c.uid in by_uid:
            raise AssertionError(f"engine: two completions for {c.uid}")
        by_uid[c.uid] = c
    if sorted(by_uid) != [r.uid for r in reqs]:
        raise AssertionError(f"engine: completions {sorted(by_uid)}")
    for r in reqs:
        c = by_uid[r.uid]
        t = np.asarray(c.tokens)
        if c.finish_reason not in ("length", "eos") or len(t) == 0 \
                or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"engine: bad completion {c}")
        if c.finish_reason == "length" and len(t) != r.max_new_tokens:
            raise AssertionError(f"engine: request {r.uid} got {len(t)} of "
                                 f"{r.max_new_tokens} tokens")
    log("engine", f"{len(comps)} completions for {len(reqs)} requests "
        f"({sorted({c.finish_reason for c in comps})}), "
        f"{s['tokens_out']} tokens in {s['wall_seconds']:.3f} s "
        f"({s['tokens_per_second']:.1f} tokens/s), {s['prefills']} prefills, "
        f"{s['decode_dispatches']} chunks")


def phase_profile(model, smi: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    kw = dict(model=model, engine="fused", batch=8, prompt_len=512, gen=16,
              chunk=8, seed=0)
    serve(**kw)                                   # allocator and cuBLAS warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    log("profile", f"{smi}: serve B=8 prompt 512, prefill + 3 chunks of 8: "
        f"wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({busy_us / 1e4 / wall:.1f}% busy), {launches} kernel launches "
        f"of {len(kern)} kernels")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log("profile", f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_device()
    if "build" in phases:
        phase_build()
    rows = phase_kernels(args.seed) if "kernels" in phases else {}
    launches = {}
    if {"serve", "engine", "profile"} & set(phases):
        from repro_torch.launch.serve import load_model
        t0 = time.perf_counter()
        model = load_model("pimref-100m", smoke=False, seed=args.seed,
                           device="cuda")
        n = sum(p.numel() for p in model.parameters())
        log("serve", f"pimref-100m full width: {n} params, compute "
            f"{model.cfg.compute_dtype}, built in "
            f"{time.perf_counter() - t0:.2f}s")
        if "serve" in phases:
            launches = phase_serve(model, smi)
        if "engine" in phases:
            phase_engine(model, args.seed)
        if "profile" in phases:
            phase_profile(model, smi)
        del model
        torch.cuda.empty_cache()
    if "parity" in phases:
        phase_parity(args.seed)

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches.get(name),
                    **rows.get(name, {})) for name in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
