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
   fused and the per-token engine, in every KV layout (contiguous, Proteus
   int8 / int4 / auto codes, pages of 16, pages of 16 holding int8 codes);
   greedy tokens of the two engines must be identical and every prefill /
   decode step must have launched the prefill kernel and the layout's
   decode kernel once per layer, and no other;
5. card vs CPU: the same fp32 weights on the card (kernels) and on the CPU
   (plain path), prefill plus teacher-forced decode steps, logits compared,
   through the contiguous, the paged and the int8 cache;
6. engine: ``ServeEngine`` drains mixed-length requests with a shared
   prefix on 8 slots, contiguous, paged and paged int8: one completion per
   request, prefix sharing, every page back in the pool at the end;
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
# int8 cache: a K/V element that lands on a rounding boundary may take the
# neighbouring code on one side (the card's fp32 sums run in another order);
# one code step moves the element by max|row| / 127, the int8 grid's own
# resolution, so the logits are held to the grid's error, not to fp32 noise
PARITY_INT8_ATOL = 2e-2
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = {
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_decode_fwd": "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_quant_fwd": "src/repro/kernels/flash_attention/kernel.py:262",
    "flash_decode_paged_fwd": "src/repro/kernels/flash_attention/kernel.py:359",
    "flash_decode_paged_quant_fwd":
        "src/repro/kernels/flash_attention/kernel.py:443",
}
# the serving layouts: (kv_quant, page_size, the decode kernel of each step)
LAYOUTS = {
    "contiguous": ("off", 0, "flash_decode_fwd"),
    "int8": ("int8", 0, "flash_decode_quant_fwd"),
    "int4": ("int4", 0, "flash_decode_quant_fwd"),
    "auto": ("auto", 0, "flash_decode_quant_fwd"),
    "paged16": ("off", 16, "flash_decode_paged_fwd"),
    "paged16_int8": ("int8", 16, "flash_decode_paged_quant_fwd"),
}
# the layout whose serve run gives each kernel's launches in the JSON line
MAIN_LAYOUT = {"flash_attention_fwd": "contiguous",
               "flash_decode_fwd": "contiguous",
               "flash_decode_quant_fwd": "int8",
               "flash_decode_paged_fwd": "paged16",
               "flash_decode_paged_quant_fwd": "paged16_int8"}
NO_LIBRARY = ("no single PyTorch call computes attention over quantized "
              "codes or through a page table")
DEVICE = "cuda"


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
    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(dtype)


def ring_positions(depths, S, T):
    """(B, S) q positions and (B, T) ring kv positions of slots that hold
    ``depth`` tokens and append S more (slots never written hold -1)."""
    from repro_torch.models.layers import ring_position_ids
    qp = torch.stack([torch.arange(d, d + S, dtype=torch.int32)
                      for d in depths])
    kp = torch.cat([ring_position_ids(1, d + S, T) for d in depths])
    return qp.to(DEVICE), kp.to(DEVICE)


def page_table(gen, kp, ps: int, share: int = 0,
               trash_slots=()) -> torch.Tensor:
    """(B, NP) int32 table over a pool of 1 + B * NP pages: a random
    permutation (not the identity); slot 1 shares its first ``share``
    physical pages with slot 0; the pages of ``trash_slots`` that hold no
    position point at the trash page 0."""
    B, T = kp.shape
    NP = T // ps
    perm = torch.randperm(B * NP, generator=gen, device=DEVICE) + 1
    table = perm.reshape(B, NP).to(torch.int32)
    if share:
        table[1, :share] = table[0, :share]
    empty = (kp.reshape(B, NP, ps) < 0).all(dim=-1)
    for b in trash_slots:
        table[b][empty[b]] = 0
    return table.contiguous()


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

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rows = {}

    # -- prefill at the main path's shape (model layout, strided views) ----
    B, H, S, D, dt = 8, 12, 512, 64, torch.bfloat16
    q, k, v = (randn(gen, (B, S, H, D), dt) for _ in range(3))
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
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
        qp, kp = qp.to(DEVICE), kp.to(DEVICE)
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
    rows.update(kernels_kv_layouts(gen))
    return rows


def _identical(name, got, want) -> None:
    same = torch.equal(got, want)
    log("kernels", f"{name}: bitwise identical {same}")
    if not same:
        raise AssertionError(f"{name}: not bitwise identical")


def _check_layouts_case(gen, dt, B, H, G, S, T, D, ps, depths, kw,
                        share=0) -> dict:
    """Kernels 3-5 against their plain versions in the kernel layout, and
    the two identities: paged == dense and paged-quant == quant on the
    pages gathered through the table. Returns the max errors by kernel."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models.layers import kv_quantize
    label = (f"B{B} H{H} G{G} S{S} T{T} D{D} ps{ps} w{kw['window']} "
             f"cap{kw['softcap']:g} {str(dt)[6:]}")
    q5 = randn(gen, (B, H, G, S, D), dt)
    qp, kp = ring_positions(depths, S, T)
    table = page_table(gen, kp, ps, share=share, trash_slots=(0,))
    P = 1 + B * (T // ps)
    gather = ref.gather_pages
    errs = {}
    kpool, vpool = (randn(gen, (P, ps, H, D), dt) for _ in range(2))
    o = fk.flash_decode_paged_fwd(q5, kpool, vpool, table, qp, kp, **kw)
    errs["flash_decode_paged_fwd"] = _check(
        f"paged {label}", o, ref.flash_decode_paged_fwd_ref(
            q5, kpool, vpool, table, qp, kp, **kw), TOL[dt])
    _identical(f"paged == dense on gathered pages {label}", o,
               fk.flash_decode_fwd(q5, gather(kpool, table),
                                   gather(vpool, table), qp, kp, **kw))
    for mode in ("int8", "int4"):
        kq, vq = (kv_quantize(randn(gen, (P, ps, H, D), torch.float32), mode)
                  for _ in range(2))
        pq = (kq.codes, kq.scale, vq.codes, vq.scale)
        o = fk.flash_decode_paged_quant_fwd(q5, *pq, table, qp, kp, **kw)
        e = _check(f"paged {mode} {label}", o,
                   ref.flash_decode_paged_quant_fwd_ref(q5, *pq, table, qp,
                                                        kp, **kw), TOL[dt])
        errs["flash_decode_paged_quant_fwd"] = max(
            e, errs.get("flash_decode_paged_quant_fwd", 0.0))
        gq = tuple(gather(x, table) for x in pq)
        oq = fk.flash_decode_quant_fwd(q5, *gq, qp, kp, **kw)
        _identical(f"paged {mode} == {mode} on gathered pages {label}", o, oq)
        e = _check(f"{mode} {label}", oq,
                   ref.flash_decode_quant_fwd_ref(q5, *gq, qp, kp, **kw),
                   TOL[dt])
        errs["flash_decode_quant_fwd"] = max(
            e, errs.get("flash_decode_quant_fwd", 0.0))
    return errs


def kernels_kv_layouts(gen) -> dict:
    """The decode kernels over Proteus codes and pages: checks at the main
    path's shape and at edge cases, then device times at the main path's
    shape (S = 1, bf16, int8 codes, pages of 16)."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.layers import kv_quantize
    rows = {}
    B, H, T, D, ps = 8, 12, 576, 64, 16
    depths = [17, 100, 511, 575, 300, 572, 40, 250]
    plain = dict(window=0, softcap=0.0)
    for dt in (torch.bfloat16, torch.float32):
        errs = _check_layouts_case(gen, dt, B, H, 1, 1, T, D, ps, depths,
                                   dict(causal=True, **plain), share=3)
        if dt == torch.bfloat16:
            main_err = errs
    # edge cases: G 4 with S 4 verify rows and D 128, window and softcap,
    # ring wrap (depth past T), slots with -1 rows, page sizes 8 / 32 / 64
    for dt in (torch.float32, torch.bfloat16):
        _check_layouts_case(gen, dt, 3, 2, 4, 4, 320, 128, 32, [10, 150, 400],
                            dict(causal=True, window=100, softcap=30.0),
                            share=2)
        _check_layouts_case(gen, dt, 4, 3, 2, 1, 256, 64, 8, [0, 63, 255, 700],
                            dict(causal=True, **plain), share=5)
        _check_layouts_case(gen, dt, 2, 2, 1, 2, 128, 64, 64, [5, 200],
                            dict(causal=True, window=0, softcap=10.0))
    # model layout through ops (strided views of the (B, T, H, Dc) cache),
    # int4 at the main path's shape
    dt = torch.bfloat16
    q = randn(gen, (B, 1, H, D), dt)
    qp, kp = ring_positions(depths, 1, T)
    to5 = lambda x: x.reshape(B, 1, H, 1, D).permute(0, 2, 3, 1, 4)
    for mode in ("int8", "int4", "auto"):
        kq, vq = (kv_quantize(randn(gen, (B, T, H, D), dt), mode)
                  for _ in range(2))
        o = ops.flash_decode_quant(q, kq.codes, kq.scale, vq.codes, vq.scale,
                                   qp, kp)
        r = ref.flash_decode_quant_fwd_ref(
            to5(q), kq.codes.transpose(1, 2), kq.scale.transpose(1, 2),
            vq.codes.transpose(1, 2), vq.scale.transpose(1, 2), qp, kp)
        _check(f"ops.flash_decode_quant {mode} B8 H12 T576 S1 D64 bf16", o,
               r.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D), TOL[dt])

    # -- device times at the main path's shape ------------------------------
    qp, kp = ring_positions([575 - 8 * b for b in range(B)], 1, T)
    NP = T // ps
    table = page_table(gen, kp, ps)
    valid_rows = int((kp >= 0).sum())
    flops = 4.0 * D * H * visible_pairs(qp, kp, True, 0)
    base_bytes = 2 * B * H * D * 2 + qp.nbytes + kp.nbytes   # q, out, positions
    P = 1 + B * NP

    def quant_set(lead, mode):
        kq, vq = (kv_quantize(randn(gen, lead + (H, D), dt), mode)
                  for _ in range(2))
        return kq.codes, kq.scale, vq.codes, vq.scale

    cases = {
        # name: (make one input set, kernel call, plain call, bytes)
        "flash_decode_quant_fwd": (
            lambda: (randn(gen, (B, 1, H, D), dt),) + quant_set((B, T), "int8"),
            lambda s: ops.flash_decode_quant(*s, qp, kp),
            lambda s: ref.flash_decode_quant_fwd_ref(
                to5(s[0]), *(x.transpose(1, 2) for x in s[1:]), qp, kp),
            valid_rows * H * (2 * D + 2 * 4)),
        "flash_decode_paged_fwd": (
            lambda: (randn(gen, (B, 1, H, D), dt), randn(gen, (P, ps, H, D), dt),
                     randn(gen, (P, ps, H, D), dt)),
            lambda s: ops.flash_decode_paged(*s, table, qp, kp),
            lambda s: ref.flash_decode_paged_fwd_ref(to5(s[0]), *s[1:], table,
                                                     qp, kp),
            valid_rows * H * 2 * D * 2 + table.nbytes),
        "flash_decode_paged_quant_fwd": (
            lambda: (randn(gen, (B, 1, H, D), dt),) + quant_set((P, ps), "int8"),
            lambda s: ops.flash_decode_paged_quant(*s, table, qp, kp),
            lambda s: ref.flash_decode_paged_quant_fwd_ref(to5(s[0]), *s[1:],
                                                           table, qp, kp),
            valid_rows * H * (2 * D + 2 * 4) + table.nbytes),
    }
    for name, (make, kern, plain_fn, kv_bytes) in cases.items():
        sample = make()
        n_sets = n_sets_for(sum(x.nbytes for x in sample))
        sets = [sample] + [make() for _ in range(n_sets - 1)]
        t_k = device_ms(lambda i: kern(sets[i]), n_sets, 50)
        t_p = device_ms(lambda i: plain_fn(sets[i]), n_sets, 10)
        del sets
        nbytes = kv_bytes + base_bytes
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        rows[name] = dict(max_abs_err=main_err[name], ms=t_k, plain_ms=t_p,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        what = {"flash_decode_quant_fwd": "int8 codes",
                "flash_decode_paged_fwd": f"pages of {ps}",
                "flash_decode_paged_quant_fwd": f"int8 codes in pages of {ps}"}
        log("kernels", f"{name} times (B8 H12 T576 S1 D64 bf16, {what[name]}"
            f"): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP); library: "
            f"none ({NO_LIBRARY})")
    return rows


def _reset():
    from repro_torch.kernels.flash_attention import LAUNCHES
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_launches(phase, n_layers, prefills, decode_steps,
                    decode_kernel="flash_decode_fwd") -> dict:
    """Every prefill launched the prefill kernel and every decode step the
    layout's decode kernel, once per layer; no other kernel ran."""
    from repro_torch.kernels.flash_attention import LAUNCHES
    got = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    want["flash_attention_fwd"] = n_layers * prefills
    want[decode_kernel] = n_layers * decode_steps
    log(phase, f"launches {got} (want {want}: {n_layers} layers x "
        f"{prefills} prefills / {decode_steps} decode steps)")
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != {want}")
    return got


def phase_serve(model, smi: str) -> dict:
    """Batch serving in every KV layout; returns the launches of each
    layout's fused run."""
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    kw = dict(batch=8, prompt_len=512, gen=64, chunk=8, seed=0)
    launches = {}
    for layout, (kv_quant, page_size, decode_kernel) in LAYOUTS.items():
        lk = dict(kw, kv_quant=kv_quant, page_size=page_size)
        serve(model=model, engine="fused", **{**lk, "gen": 8})  # first calls
        runs = {}
        for engine in ("fused", "loop"):
            _reset()
            out = serve(model=model, engine=engine, **lk)
            got = _check_launches(f"serve/{layout}/{engine}", cfg.num_layers,
                                  out["prefills"], out["decode_steps"],
                                  decode_kernel)
            if engine == "fused":
                launches[layout] = got
            toks = out["tokens"]
            if toks.shape != (kw["batch"], kw["gen"]) or toks.min() < 0 \
                    or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"serve/{layout}/{engine}: bad tokens "
                                     f"{toks.shape} [{toks.min()}, "
                                     f"{toks.max()}]")
            log(f"serve/{layout}/{engine}", f"{smi}: prefill "
                f"{out['prefill_s'] * 1e3:.3f} ms (B=8 x 512), decode "
                f"{out['decode_s_per_tok'] * 1e3:.4f} ms/token-step, "
                f"{out['throughput_tok_s']:.1f} tokens/s, "
                f"{out['dispatches']} host syncs")
            runs[engine] = out
        same = np.array_equal(runs["fused"]["tokens"], runs["loop"]["tokens"])
        log(f"serve/{layout}", f"fused == loop tokens: {same}")
        if not same:
            raise AssertionError(f"{layout}: fused and loop greedy tokens "
                                 "differ")
    return launches


def _cache_diff(cc, cg):
    """(max |CPU - card| over the K/V values or scales, codes that differ,
    largest code difference) of two caches of one layout."""
    from repro_torch.models.layers import PagedKVCache, QKVCache
    err, flips, code_max = 0.0, 0, 0
    for n in ("k", "v"):
        a, b = cc[n], cg[n]
        if isinstance(a, PagedKVCache):
            if not torch.equal(a.table, b.table.cpu()):
                raise AssertionError("parity: page tables differ")
            a, b = a.pages, b.pages
        if isinstance(a, QKVCache):
            d = a.codes.int() - b.codes.cpu().int()
            flips += int((d != 0).sum())
            code_max = max(code_max, int(d.abs().max()))
            a, b = a.scale, b.scale
        err = max(err, (a - b.cpu()).abs().max().item())
    return err, flips, code_max


def phase_parity(seed: int) -> None:
    """fp32 logits and caches, card vs CPU, in the contiguous, paged and
    int8 layouts."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, init_params
    cfg = get_config("pimref-100m").replace(compute_dtype="float32")
    state = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    cpu0 = TransformerLM(cfg, device="cpu")
    cpu0.load_state_dict(state)
    gpu0 = TransformerLM(cfg, device="cuda")
    gpu0.load_state_dict(state)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                              .astype(np.int32))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    for layout in ("contiguous", "paged16", "int8"):
        kv_quant, page_size, _ = LAYOUTS[layout]
        cpu = cpu0.with_kv_layout(kv_quant, page_size)
        gpu = gpu0.with_kv_layout(kv_quant, page_size)
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
        kv, flips, code_max = _cache_diff(cc, cg)
        tol = PARITY_INT8_ATOL if kv_quant != "off" else PARITY_ATOL
        log("parity", f"{layout}: fp32 logits card vs CPU, prefill 64 + 8 "
            f"decode steps: max_abs_err per call "
            f"{['%.2e' % e for e in errs]}, cache {kv:.2e}, codes differing "
            f"{flips} (largest difference {code_max}), top-1 agreement "
            f"{agree:.3f} (tol {tol:.0e})")
        if max(errs) > tol or kv > PARITY_ATOL or code_max > 1:
            raise AssertionError(f"{layout}: card vs CPU differ: logits "
                                 f"{max(errs)}, cache {kv}, code {code_max}")


def _drain(eng, reqs, label, decode_kernel) -> dict:
    """Drain ``reqs`` through ``eng``: exact launches, one completion per
    request, each of the right length; returns the engine's stats."""
    cfg = eng.model.cfg
    _reset()
    comps = eng.run(list(reqs))
    torch.cuda.synchronize()
    s = eng.stats
    _check_launches(label, cfg.num_layers, s["prefills"], s["decode_steps"],
                    decode_kernel)
    by_uid = {}
    for c in comps:
        if c.uid in by_uid:
            raise AssertionError(f"{label}: two completions for {c.uid}")
        by_uid[c.uid] = c
    if sorted(by_uid) != [r.uid for r in reqs]:
        raise AssertionError(f"{label}: completions {sorted(by_uid)}")
    for r in reqs:
        c = by_uid[r.uid]
        t = np.asarray(c.tokens)
        if c.finish_reason not in ("length", "eos") or len(t) == 0 \
                or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"{label}: bad completion {c}")
        if c.finish_reason == "length" and len(t) != r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.uid} got {len(t)} of "
                                 f"{r.max_new_tokens} tokens")
    if eng.paged:
        free = len(eng._alloc.free)
        if (s["kv_pages_in_use"] != 0 or free != eng.n_phys_pages - 1
                or eng._host_table.any() or s["prefix_hits"] <= 0):
            raise AssertionError(
                f"{label}: pages in use {s['kv_pages_in_use']}, free {free} "
                f"of {eng.n_phys_pages - 1}, host table zero "
                f"{not eng._host_table.any()}, prefix hits "
                f"{s['prefix_hits']}")
    log(label, f"{len(comps)} completions for {len(reqs)} requests "
        f"({sorted({c.finish_reason for c in comps})}), "
        f"{s['tokens_out']} tokens in {s['wall_seconds']:.3f} s "
        f"({s['tokens_per_second']:.1f} tokens/s), {s['prefills']} prefills, "
        f"{s['decode_dispatches']} chunks, kv_bytes_per_token "
        f"{s['kv_bytes_per_token']:.1f}"
        + (f", pages peak {s['kv_pages_peak']}, prefix hits "
           f"{s['prefix_hits']}" if eng.paged else ""))
    return s


def phase_engine(model, seed: int) -> None:
    """24 mixed requests with a 64-token shared prefix on 8 slots, in the
    contiguous, paged and paged int8 layouts."""
    from repro_torch.launch.serve import make_queue_engine, synth_requests
    reqs = synth_requests(cfg=model.cfg, requests=24, prompt_len=256, gen=64,
                          seed=seed, shared_prefix=64)
    per_token = {}
    for layout in ("contiguous", "paged16", "paged16_int8"):
        kv_quant, page_size, decode_kernel = LAYOUTS[layout]
        eng = make_queue_engine(model=model, slots=8, prompt_len=256, gen=64,
                                chunk=8, seed=seed, kv_quant=kv_quant,
                                page_size=page_size)
        s = _drain(eng, reqs, f"engine/{layout}", decode_kernel)
        per_token[layout] = s["kv_bytes_per_token"]
    base = per_token["contiguous"]
    log("engine", "kv_bytes_per_token " + ", ".join(
        f"{k} {v:.1f} ({v / base:.3f} of contiguous)"
        for k, v in per_token.items()))


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
                    replaces=REPLACES[name],
                    launches=launches.get(MAIN_LAYOUT[name], {}).get(name),
                    **rows.get(name, {})) for name in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
