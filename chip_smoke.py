#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA GPU; exits non-zero without one. Phases:

1. device: the card's name and power limit, TF32 off for fp32 products;
2. build: every CUDA kernel source of the port, one nvcc each, in parallel;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the main path's shapes and at synthetic edge cases, with the
   tolerance stated (the bf16 prefill route: 2e-2, every element within
   its two roundings by design, lse 1e-4); device times of kernel, plain
   version and the PyTorch library call computing the same function. The
   prefill kernel's bf16 route (the tensor-core kernel) is timed at three
   shapes, each a row of the JSON line: pimref's (B 8, H 12, S = T = 512,
   D 64), Griffin's (``flash_attention_fwd_d256``: B 8, one kv head for ten
   q heads of 256, S = T = 512) and Griffin's long prompt
   (``flash_attention_fwd_d256_long``: B 2, S = T = 2100, window 2048),
   each through ``ops.flash_attention_gqa_fwd`` as a model calls it, with
   the kernel call alone logged beside; its fp32 route (three exact bf16
   parts a value, six pair products on the tensor cores) is checked, two
   calls bitwise equal, and timed beside SDPA on fp32 inputs at pimref's
   shape (row ``flash_attention_fwd_fp32``) and at Griffin's
   (``flash_attention_fwd_fp32_d256``), its bound that of the six bf16
   passes with the fp32 CUDA-core bound logged beside. The RG-LRU kernel
   is checked bit for bit
   against its loop at eight shapes and timed at Griffin's prefill (B 8 x
   T 512) and long prompt (``rglru_scan_long``: B 2 x T 2100). The decode
   kernel (``csrc/flash_decode.cu``) is timed
   at pimref's step (B 8, H 12, T 576, S 1, D 64; and over int8 codes,
   pages of 16 and both) and at Griffin's (``flash_decode_fwd_d256``: B 8,
   one kv head for ten q heads of 256, T 576), each through ``ops`` as a
   model calls it; its layouts are also checked at head_dim 256;
4. serve: ``pimref-100m`` at full width, batch-mode ``serve()`` in every
   KV layout (contiguous, Proteus int8 / int4 / auto codes, pages of 16,
   pages of 16 holding int8 codes) three ways: the fused chunk as one CUDA
   graph replay (the port's path), the same chunk body run eagerly (set
   here by ``eager_chunks``, not a knob of the port) and the per-token
   loop. Greedy tokens of the three must be identical, the graph's decode
   ms per token-step below the eager chunk's, and every prefill / decode
   step must have launched the prefill kernel and the layout's decode
   kernel once per layer, and no other (the prefill kernel's fp32 route
   none: the serving path is bf16); a replay counts the launches of the
   chunk it replays. Logged: the capture's time and the graph's device ms
   per step (back-to-back replays timed by CUDA events);
5. card vs CPU: the same fp32 weights on the card (kernels) and on the CPU
   (plain path), prefill plus teacher-forced decode steps, logits compared,
   through the contiguous, the paged and the int8 cache; every prefill
   launched the prefill kernel's fp32 route once per layer (the launches
   of the fp32 rows);
6. engine: ``ServeEngine`` drains mixed-length requests with a shared
   prefix on 8 slots, contiguous, paged and paged int8: one completion per
   request, prefix sharing, every page back in the pool at the end, one
   graph capture per engine, and the completions of a drain whose engine
   runs the chunk body eagerly;
7. profile: ``torch.profiler`` over batch-mode serving (prefill, the
   warm-up chunk, then two chunks: graph replays, and beside them eager
   chunks): the device's busy share, the kernels by device time, and the
   launches of the prefill, decode and RG-LRU kernels counted from the
   profiler's kernel events against the launch counters;
8. serve_griffin: ``recurrentgemma-2b`` at full width and depth (random
   weights from ``--seed``), batch 8 x prompt 512 x 64 new tokens and one
   long request (batch 2 x prompt 2100 x 32, past the local window of
   2048, so the ring wraps), graph, eager chunk and loop as in phase
   serve: identical tokens, and exact launches: per
   prefill 8 of the prefill kernel (attention layers) and 18 of the RG-LRU
   kernel (recurrent layers), per decode step 8 of the decode kernel;
   then a profile of its serving;
9. engine_griffin: 16 mixed-length requests drained through 8 slots, graph
   against eager body;
10. parity_griffin: card vs CPU fp32 logits and caches at full width with
   the depth cut to 5 layers (one group and the two trailing recurrent
   layers), prefill 64 plus 8 decode steps; its one prefill launched the
   fp32 route once (its one attention layer).

Phases ``robust`` and ``fleet`` run after ``engine``, on full-width
``pimref-100m`` with the engine phase's 24 requests in a 512-token bucket
on 8 slots. ``robust``, in the contiguous, paged16 and paged16-int8
layouts and with an ``ngram`` engine (the NaN hook in the verify block):
a clean drain, then a seeded chaos drain (``nan=2,slow=2,fail=1,pages=4``:
one completion each, the poisoned uids ``nan_logits`` with a prefix of
their clean tokens, the rest byte-identical, a retry, every page back
once the stolen ones are released), ``max_queue`` 4 (exactly 20
``queue_full``), deadlines on an injected clock (partial tokens a prefix
of the clean ones), a persistent failure (every request ``step_failure``,
the engine dead, no decode launch) and a preemption after 2 chunks, its
snapshot in a ``RestartManifest``, restored into a fresh engine (the
union equals the uninterrupted drain); every drain's launches exact (a
hooked replay launches a clean one's, a failed chunk nothing). Shedding
by a straggler stub: bf16 contiguous halves the chunk twice; an fp32
``ngram`` engine (where greedy spec == off) turns speculation off, then
halves the chunk; tokens equal the unshed drain's, each level's capture
logged. The graph's device ms per step with and without the (disarmed)
hook. ``fleet`` (paged16 shards): 1 and 2 in-process shards and 2
spawned workers (each building its engine on the card from the seed)
equal one engine's drain; ``kill=1@2`` fails over in process and by a
real ``terminate()``; ``stall=1@1`` walks LIVE -> SUSPECT -> DEAD;
tokens/s and the workers' start-up seconds logged. ``engine_griffin``
adds a chaos drain (``nan=2,fail=1``) and a snapshot / restore.

Phase ``spec`` runs after the fleet: speculative decoding (k 3, the
``ngram`` and ``draft`` drafters) on full-width ``pimref-100m``, batch 8 x
prompt 512 (rows 0-3 a period-4 tile, rows 4-7 random, from ``--seed``) +
64 new tokens in chunks of 8, in every KV layout, as the captured chunk
and as its eager body: tokens and accepted lengths identical, exact
decode-kernel launches (one verify block through every layer and, for
``draft``, k steps through the first half, per iteration: 96 and 240 a
chunk), also counted from the profiler's kernel events; ms per token-step,
per committed token, accepted length per draft and the graph's device ms
per iteration, beside speculation off. ``serve(spec=...)`` on its own
batch (its ``draft`` drafter must accept drafts) and ``ServeEngine``
drains of the engine phase's requests (one capture, every page back). In
bf16 the tokens against speculation off are recorded (a verify block's
kernel shapes differ from a one-token step's, so a rounding can differ;
``spec_rounding`` logs which results do); in fp32 they must be identical,
in every layout but ``auto``, for the batch and the engine's drains; the
``draft`` drafter through all the layers must accept more than k tokens
an iteration. The kernels phase times
the decode kernel at the verify block's shape (row
``flash_decode_fwd_verify``: B 8, H 12, S 4, T 579, D 64, bf16).

Phases ``train``, ``train_kernels`` and ``train_parity`` run after
``parity``. ``train``: full-width ``pimref-100m`` (163,597,056 parameters,
fp32 weights and AdamW state, bf16 compute, ``remat="block"``) trained
through ``repro_torch.launch.train.train`` on the card, 12 guarded steps
of batch 4 x seq 4096 (the repo's ``train_4k`` sequence; its batch cut
from 256 to 4 so that a step fits one card in one microbatch), warm-up 2,
lr 3e-4, a checkpoint every 4 steps into a temporary directory: every
loss finite, no step skipped, the mean of the last three losses below the
first, exactly 12 x 24 launches of the prefill kernel's bf16 route in the
run (the forward and the remat recompute of 12 layers a step) and no
other kernel; then one profiled step whose kernel events equal the
counters, 24. Logged beside
the card's name and power limit: step wall and the numpy batch's host
share, tokens/s, peak memory, the busy share, the top kernels, the
model-FLOP share (6 N tokens over 989 TFLOP/s) with the attention FLOPs
beside it. ``train_kernels``: the kernel under autograd at the train
shape (B 4, H 12, S = T = 4096, D 64, bf16): out within the bf16 route's
limits and lse 1e-4 of the plain version, dq / dk / dv of the kernel
forward + the plain backward within 3e-2 of the gradient's largest
|value| of the all-plain pair, two calls bitwise equal; times of the
kernel forward, the plain backward, the Function's forward + backward,
the all-plain pair and SDPA (``is_causal``) forward and forward +
backward (row ``flash_attention_fwd_train``: the kernel forward's numbers
in the row's keys; the plain backward, the pairs and their bound in its
extra keys ``grad_max_abs_err``, ``backward_ms``, ``pair_ms``,
``plain_pair_ms``, ``library_pair_ms``, ``pair_bound_ms``, since the
backward is plain PyTorch, the counterpart of the reference's jnp
``_flash_vjp_bwd`` and of no ``pallas_call``). ``train_parity``: fp32 compute, TF32
off, full width with the depth cut to 2 layers, batch 2 x seq 1536 (T
padded to 2048, the padding masked): three guarded AdamW steps on the
card and on the CPU from the same weights, the loss within 1e-5, the
gradient norm, every weight and moment within 1e-4 of their leaf's
largest |value| (weights also by up to lr a step where a gradient is
below the fp32 noise), 2 x 2 launches of the fp32 route a step; then
``verify_resume_identity`` on the card at that size (NaN gradients and a
preemption): stitched losses and final weights byte-identical.

Phase ``proteus`` runs after the train phases and before the Griffin phases: the
Proteus library's entry points on full-width ``pimref-100m`` (random
weights from ``--seed``): ``quant_matmul`` over every projection weight
quantized to int8 and to int4 codes (x 4096 rows, a batch-8 x 512
prefill), against its plain version and against x @ W within the format
error, and at recurrentgemma-2b's MLP shapes; then timed at four shapes,
each a row of the JSON line (pimref's wi_up with fp32 and bf16 x,
recurrentgemma-2b's MLP at prefill and at a decode step), every input of
the kernel and of the ``torch.matmul`` yardstick cycled through full
copies past the L2, each shape's two calls bitwise equal, its bound that
of the route the kernel runs (bf16 tensor-core passes) with the fp32
CUDA-core bound logged beside; ``required_bits`` over the
whole parameter vector as int16-grid codes and over an edge sweep, bitwise
against its plain version; ``pack_int4`` / ``unpack_int4`` over the
vector's int4 codes, bitwise, with an exact round trip; the
``flash_attention_bh`` adapter at BH 96 (8 x 12 heads), S = T = 512 and
500, causal, window 0 and 128, bf16 and fp32 (rows ``flash_attention_bh``
and ``flash_attention_bh_fp32``). Exact launch counts, then device times at
the path's shapes.

The second-to-last line is a JSON object of per-kernel numbers, the last is
``{"ok": true, "device": {...}}``. Any failure raises.

    python3 chip_smoke.py [--seed N] [--phases device,build,kernels,...]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "build", "kernels", "serve", "engine", "robust", "fleet",
          "spec", "profile",
          "parity", "train", "train_kernels", "train_parity", "proteus",
          "serve_griffin", "engine_griffin", "parity_griffin")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the fp32 prefill route's products: q, k, p and v each as three exact bf16
# parts, the six pairs of parts i + j <= 2 (ref.fp32_route_ref)
FP32_ROUTE_PASSES = 6
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the bf16 prefill route, beside TOL's 2e-2: every element of out within
# ref.bf16_route_limit (its two roundings by design: one output ulp,
# 2^-7 |plain|, and p rounded to bf16 before p @ v, 2^-8 of sum p |v| / l),
# and lse, which comes from the fp32 scores, within 1e-4
BF16_LSE_TOL = 1e-4
PARITY_ATOL = 1e-3                  # fp32 logits, card vs CPU
# int8 cache: a K/V element that lands on a rounding boundary may take the
# neighbouring code on one side (the card's fp32 sums run in another order);
# one code step moves the element by max|row| / 127, the int8 grid's own
# resolution, so the logits are held to the grid's error, not to fp32 noise
PARITY_INT8_ATOL = 2e-2
# Griffin, fp32 card vs CPU: a_t close to 1 makes sqrt(1 - a_t^2) turn
# one-ulp differences of exp / sigmoid into ~1e-5 relative differences of
# the RG-LRU input, so caches and states are held to 1e-3 of their largest
# |value| (the CPU tests' limit against the reference); logits (about 0.1
# at full width, soft-capped at 30) to the dense phase's 1e-3
PARITY_GRIFFIN_ATOL = 1e-3
PARITY_GRIFFIN_REL = 1e-3
GRIFFIN_PARITY_LAYERS = 5          # one (r, r, a) group + 2 trailing r
# RG-LRU kernel vs its plain loop: the same rounded multiply and add in the
# same order, so 0 is expected; |h| stays below ~3 for these inputs
RGLRU_TOL = 1e-6
# quant_matmul against its plain version: fp32 summation order (the
# kernel scales each k-block's partial sum, the plain version each code),
# the reference test's tolerance; against x @ W: the format error of the
# reference test, relative to the largest |x @ W|
QMM_ATOL, QMM_RTOL = 1e-3, 1e-4
QMM_FORMAT_ERR = {8: 0.02, 4: 0.25}
QMM_ROWS = 4096                    # batch 8 x prompt 512
QMM_BLOCK_K = 128
# timed shapes (M, K, N) beside pimref's wi_up (M QMM_ROWS): the MLP of
# recurrentgemma-2b at prefill and at a decode step, random weights
QMM_SHAPES = {"quant_matmul_griffin": (4096, 2560, 7680),
              "quant_matmul_decode": (8, 2560, 7680)}
QMM_LABELS = {"quant_matmul": "pimref-100m wi_up",
              "quant_matmul_bf16": "pimref-100m wi_up, bf16 x",
              "quant_matmul_griffin": "recurrentgemma-2b MLP prefill",
              "quant_matmul_decode": "recurrentgemma-2b MLP decode"}
INT16_MAX = 32767                  # bench_proteus_precision's code grid
BH_SHAPE = (96, 64)                # (B * H, D): 8 x 12 heads of 64
BH_LENGTHS = (512, 500)
BH_WINDOWS = (0, 128)
DECODE_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu"
PREFILL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_prefill.cu"
NV_SOURCE = "src/repro_torch/kernels/narrow_value/csrc/narrow_value.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/rglru/csrc/rglru.cu"
QMM_SOURCE = "src/repro_torch/kernels/quant_matmul/csrc/quant_matmul.cu"
SOURCES = {"flash_attention_fwd": PREFILL_SOURCE,
           "flash_attention_fwd_d256": PREFILL_SOURCE,
           "flash_attention_fwd_d256_long": PREFILL_SOURCE,
           "flash_attention_bh": PREFILL_SOURCE,
           "flash_decode_fwd": DECODE_SOURCE,
           "flash_decode_fwd_d256": DECODE_SOURCE,
           "flash_decode_fwd_verify": DECODE_SOURCE,
           "flash_decode_quant_fwd": DECODE_SOURCE,
           "flash_decode_paged_fwd": DECODE_SOURCE,
           "flash_decode_paged_quant_fwd": DECODE_SOURCE,
           "flash_attention_fwd_fp32": PREFILL_SOURCE,
           "flash_attention_fwd_fp32_d256": PREFILL_SOURCE,
           "flash_attention_bh_fp32": PREFILL_SOURCE,
           "rglru_scan": RGLRU_SOURCE, "rglru_scan_long": RGLRU_SOURCE,
           "quant_matmul": QMM_SOURCE, "quant_matmul_bf16": QMM_SOURCE,
           "quant_matmul_griffin": QMM_SOURCE,
           "quant_matmul_decode": QMM_SOURCE,
           "required_bits": NV_SOURCE, "pack_int4": NV_SOURCE,
           "unpack_int4": NV_SOURCE,
           "flash_attention_fwd_train": PREFILL_SOURCE}
REPLACES = {
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_d256":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_d256_long":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_decode_fwd": "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_fwd_d256": "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_fwd_verify":
        "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_quant_fwd": "src/repro/kernels/flash_attention/kernel.py:262",
    "flash_decode_paged_fwd": "src/repro/kernels/flash_attention/kernel.py:359",
    "flash_decode_paged_quant_fwd":
        "src/repro/kernels/flash_attention/kernel.py:443",
    "flash_attention_fwd_fp32":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_fp32_d256":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "rglru_scan": "src/repro/kernels/rglru/kernel.py:44",
    "rglru_scan_long": "src/repro/kernels/rglru/kernel.py:44",
    "flash_attention_bh": "src/repro/kernels/flash_attention/kernel.py:504",
    "flash_attention_bh_fp32":
        "src/repro/kernels/flash_attention/kernel.py:504",
    "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:43",
    "quant_matmul_bf16": "src/repro/kernels/quant_matmul/kernel.py:43",
    "quant_matmul_griffin": "src/repro/kernels/quant_matmul/kernel.py:43",
    "quant_matmul_decode": "src/repro/kernels/quant_matmul/kernel.py:43",
    "required_bits": "src/repro/kernels/narrow_value/kernel.py:30",
    "pack_int4": "src/repro/kernels/narrow_value/kernel.py:62",
    "unpack_int4": "src/repro/kernels/narrow_value/kernel.py:79",
    "flash_attention_fwd_train":
        "src/repro/kernels/flash_attention/kernel.py:126",
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
# the run whose launches each row of the JSON line reports: the graph serve
# run of a layout, or phase parity, parity_griffin or proteus
MAIN_LAYOUT = {"flash_attention_fwd": "contiguous",
               "flash_attention_fwd_d256": "griffin",
               "flash_attention_fwd_d256_long": "griffin_long",
               "flash_decode_fwd": "contiguous",
               "flash_decode_fwd_d256": "griffin",
               "flash_decode_fwd_verify": "spec/contiguous/ngram",
               "flash_decode_quant_fwd": "int8",
               "flash_decode_paged_fwd": "paged16",
               "flash_decode_paged_quant_fwd": "paged16_int8",
               "flash_attention_fwd_fp32": "parity",
               "flash_attention_fwd_fp32_d256": "parity_griffin",
               "rglru_scan": "griffin", "rglru_scan_long": "griffin_long",
               "flash_attention_bh": "proteus",
               "flash_attention_bh_fp32": "proteus",
               "quant_matmul": "proteus", "quant_matmul_bf16": "proteus",
               "quant_matmul_griffin": "proteus",
               "quant_matmul_decode": "proteus", "required_bits": "proteus",
               "pack_int4": "proteus", "unpack_int4": "proteus",
               "flash_attention_fwd_train": "train"}
# rows whose launches are another row's counter: the prefill and decode
# kernels at the Griffin shapes, the RG-LRU kernel at the long prompt, the
# quantized matmul at its other timed shapes, the adapter's fp32 calls
COUNTER = {"flash_attention_fwd_d256": "flash_attention_fwd",
           "flash_attention_fwd_fp32_d256": "flash_attention_fwd_fp32",
           "flash_attention_bh_fp32": "flash_attention_bh",
           "flash_attention_fwd_d256_long": "flash_attention_fwd",
           "flash_decode_fwd_d256": "flash_decode_fwd",
           "flash_decode_fwd_verify": "flash_decode_fwd",
           "rglru_scan_long": "rglru_scan",
           "quant_matmul_bf16": "quant_matmul",
           "quant_matmul_griffin": "quant_matmul",
           "quant_matmul_decode": "quant_matmul",
           "flash_attention_fwd_train": "flash_attention_fwd"}
NO_LIBRARY = ("no single PyTorch call computes attention over quantized "
              "codes or through a page table")
NO_LIBRARY_RGLRU = "no single PyTorch call computes a linear recurrence"
NO_LIBRARY_NARROW = {
    "required_bits": "no single PyTorch call computes a per-block width",
    "pack_int4": "no single PyTorch call packs nibbles",
    "unpack_int4": "no single PyTorch call unpacks nibbles"}
DEVICE = "cuda"
# training (phases train, train_kernels, train_parity): the batch of the
# train_4k shape cut to 4 (its seq 4096 kept), 12 steps, a checkpoint every
# 4; card vs CPU at full width with 2 layers, batch 2 x seq 1536
TRAIN_BATCH = 4
TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 4
TRAIN_PARITY_LAYERS = 2
TRAIN_PARITY_SHAPE = (2, 1536)
TRAIN_PARITY_STEPS = 3
TRAIN_RESUME_STEPS = 6
# the attention of a train step: pimref's heads at the train shape
TRAIN_KERNEL_SHAPE = (TRAIN_BATCH, 12, 4096, 64)
# kernel forward + plain backward against the all-plain pair in bf16: one
# rounding of out (2^-8) carried through delta, and of each gradient; of the
# gradient's largest |value|
TRAIN_GRAD_TOL = 3e-2
# fp32 training, card vs CPU: the loss within 1e-5 relative; gradient
# norms, weights and moments within 1e-4 of a leaf's largest |value| (the
# gradients are ill-conditioned in fp32: the CPU tests find each package
# 3e-5 to 6e-5 from a float64 run); weights also by up to lr a step where a
# gradient is below that noise (AdamW's first steps divide by |g|)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_TREE_RTOL = 1e-4
# speculative decoding (phase spec): the reference's draft length, its two
# drafters; the batch rows 0-3 a period-4 tile, rows 4-7 random
SPEC_K = 3
SPEC_MODES = ("ngram", "draft")


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


def _check(name, got, want, tol, what="out", phase="kernels"):
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    ok = err <= tol
    log(phase, f"{name} {what}: max_abs_err={err:.3e} (tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: max abs err {err} > {tol}")
    return err


def _abs_v_out(q5, k4, v4, qp, kp, **kw):
    """The plain version's fp32 output with v replaced by |v|: the sum of
    p |v| / l that ref.bf16_route_limit takes."""
    from repro_torch.kernels.flash_attention import ref
    return ref.flash_attention_fwd_ref(q5.float(), k4, v4.abs(), qp, kp,
                                       **kw)[0]


def _check_bf16(name, got, want, abs_v_out, lse=None, want_lse=None,
                phase="kernels"):
    """The bf16 prefill route against its plain version: out within TOL's
    2e-2 and every element within ref.bf16_route_limit, lse within
    BF16_LSE_TOL. Returns out's max abs error."""
    from repro_torch.kernels.flash_attention import ref
    err = _check(name, got, want, TOL[torch.bfloat16], phase=phase)
    ratio = ((got.float() - want.float()).abs()
             / ref.bf16_route_limit(want, abs_v_out)).max().item() \
        if got.numel() else 0.0
    ok = ratio <= 1.0
    log(phase, f"{name} out: max err / per-element limit {ratio:.3f} "
        f"(2^-7 |plain| + 2^-8 sum p|v|/l) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} out: err / per-element limit {ratio}")
    if lse is not None:
        _check(name, lse, want_lse, BF16_LSE_TOL, "lse", phase)
    return err


def fp32_route_bound(nbytes: int, flops: float) -> tuple:
    """(bound ms, bound_by) of the fp32 prefill route as the kernel runs it,
    FP32_ROUTE_PASSES bf16 tensor-core passes of the product work, and the
    fp32 CUDA-core bound of the same work (ms, by) to log beside it."""
    return (bound_ms(nbytes, FP32_ROUTE_PASSES * flops, torch.bfloat16),
            bound_ms(nbytes, flops, torch.float32))


def fp32_prefill_row(gen, label, B, Hkv, G, S, D, window) -> dict:
    """The prefill kernel's fp32 route at a main-path shape in the model's
    layout (strided views of (B, S, H, D) projections): out and lse within
    TOL of the plain version, two calls bitwise equal, then device times of
    the kernel call (positions made once), the plain version and SDPA on
    fp32 inputs (K/V expanded to the q heads as views; ``is_causal``, which
    is the same function while S <= window). Returns the row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    H, dt = Hkv * G, torch.float32
    kw = dict(causal=True, window=window)

    def inputs():
        q = randn(gen, (B, S, H, D), dt)
        k, v = (randn(gen, (B, S, Hkv, D), dt) for _ in range(2))
        return (q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4),
                k.transpose(1, 2), v.transpose(1, 2))

    n_sets = n_sets_for(2 * 4 * B * S * (H + Hkv) * D)
    sets5 = [inputs() for _ in range(n_sets)]
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    posc = pos.contiguous()
    name = f"prefill {label} fp32 route"
    o, lse = fk.flash_attention_fwd(*sets5[0], posc, posc, **kw)
    ro, rl = ref.flash_attention_fwd_ref(*sets5[0], pos, pos, **kw)
    err = _check(name, o, ro, TOL[dt])
    _check(name, lse, rl, TOL[dt], "lse")
    o2, lse2 = fk.flash_attention_fwd(*sets5[0], posc, posc, **kw)
    _identical(f"{name} out: two calls", o2, o)
    _identical(f"{name} lse: two calls", lse2, lse)
    del o2, lse2, ro, rl
    t_k = device_ms(lambda i: fk.flash_attention_fwd(*sets5[i], posc, posc,
                                                     **kw), n_sets, 5)
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, **kw), n_sets, 2)
    sets4 = [(q5.reshape(B, H, S, D),
              *(x[:, :, None].expand(B, Hkv, G, S, D).reshape(B, H, S, D)
                for x in (k4, v4))) for q5, k4, v4 in sets5]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], is_causal=True), n_sets, 5)
    split = kernel_split_us(lambda i: fk.flash_attention_fwd(
        *sets5[i], posc, posc, **kw), n_sets)
    del sets4, sets5
    nbytes = 2 * o.nbytes + 2 * 4 * B * S * Hkv * D + lse.nbytes \
        + 2 * pos.nbytes
    flops = 4.0 * D * H * visible_pairs(pos, pos, True, window)
    (b_ms, b_by), (c_ms, c_by) = fp32_route_bound(nbytes, flops)
    log("kernels", f"{name} times: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"sdpa fp32 {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
        f"{FP32_ROUTE_PASSES} bf16 passes of {flops:.3e} FLOP at 989 "
        f"TFLOP/s), fp32 CUDA-core bound {c_ms:.4f} ms ({c_by}, 67 "
        f"TFLOP/s); plan {fk.prefill_plan(G, S, fk.FP32_PREFILL_TILES[D][0])}"
        f"; device us a call by kernel (torch.profiler, kernels overlap): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_l)


def kernel_split_us(fn, n_sets: int, calls: int = 30) -> dict:
    """Device microseconds a call of ``fn(i)`` by kernel name under
    torch.profiler, after a warm-up: where a wrapper launches more than
    one kernel, what each takes."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i % n_sets)
        torch.cuda.synchronize()
    name = lambda key: (re.search(r"(\w+)<", key) or re.search(r"(.{1,40})",
                                                               key)).group(1)
    return {name(e.key): e.self_device_time_total / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


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
    args5 = (split(q), k.transpose(1, 2), v.transpose(1, 2), pos, pos)
    r_out, r_lse = ref.flash_attention_fwd_ref(*args5, causal=True)
    to4 = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    err = _check_bf16("prefill B8 H12 S=T=512 D64 bf16", out, to4(r_out),
                      to4(_abs_v_out(*args5, causal=True)), lse, r_lse)
    n_sets = n_sets_for(4 * q.nbytes)
    sets = [[randn(gen, (B, S, H, D), dt) for _ in range(3)]
            for _ in range(n_sets)]
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    posc = pos.contiguous()
    t_k = device_ms(lambda i: fk.flash_attention_fwd(*sets5[i], posc, posc),
                    n_sets, 20)
    t_ops = device_ms(lambda i: ops.flash_attention_gqa_fwd(*sets[i]),
                      n_sets, 20)
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, causal=True), n_sets, 4)
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], is_causal=True), n_sets, 20)
    del sets, sets4, sets5
    nbytes = 4 * q.nbytes + lse.nbytes + 2 * pos.nbytes
    flops = 4.0 * D * H * visible_pairs(pos, pos, True, 0)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_attention_fwd"] = dict(max_abs_err=err, ms=t_ops,
                                       plain_ms=t_p, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=t_l)
    log("kernels", f"prefill times: kernel {t_ops:.4f} ms (through "
        f"ops.flash_attention_gqa_fwd, which builds the positions, as PR 14 "
        f"timed it; the kernel call alone, positions made once: "
        f"{t_k:.4f} ms), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP)")
    # the fp32 route at the same shape: its own row (the parity phases run
    # it; no serving path does)
    rows["flash_attention_fwd_fp32"] = fp32_prefill_row(
        gen, "B8 H12 S=T=512 D64", B, H, 1, S, D, 0)

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
        if dt == torch.bfloat16:
            _check_bf16(name, o, ro, _abs_v_out(q5, k4, v4, qp, kp, **kw),
                        l, rl)
        else:
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
        f"{flops:.3e} FLOP); plan {fk.decode_plan(B, H, S, T)}")
    rows["flash_decode_fwd_verify"] = kernels_verify(gen)
    rows.update(kernels_kv_layouts(gen))
    rows.update(kernels_griffin(gen))
    return rows


def kernels_griffin(gen) -> dict:
    """recurrentgemma-2b's kernels: the RG-LRU recurrence against its plain
    loop at the prefill shape (B 8, T 512, D 2560 fp32) and at edge shapes,
    with its device times; the prefill and decode kernels at head_dim 256
    with one kv head for ten q heads, against their plain versions across
    the local window of 2048 and a wrapped ring, with device times at the
    serving shapes (B 8, prompt 512, ring of 576); the quantized and paged
    decode layouts at head_dim 256 with their bitwise identities."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_ref
    from repro_torch.kernels.rglru.kernel import plan as rglru_plan

    def ab(B, T, D):
        a = 0.7 + 0.299 * torch.rand((B, T, D), generator=gen, device=DEVICE)
        return a, 0.1 * randn(gen, (B, T, D), torch.float32)

    B, T, D = 8, 512, 2560
    rglru_errs = {}
    for shape in ((B, T, D), (2, 2100, D), (2, 1, D), (2, 3, D),
                  (1, 1000, 100), (1, 17, 100), (3, 5, 2500), (1, 2100, 99)):
        a, b = ab(*shape)
        h = rglru_scan(a, b)
        want = rglru_scan_ref(a, b)
        name = f"rglru_scan B{shape[0]} T{shape[1]} D{shape[2]} fp32"
        rglru_errs[shape] = _check(name, h, want, RGLRU_TOL)
        _identical(f"{name} == the plain loop", h, want)
        _identical(f"{name}: two calls", rglru_scan(a, b), h)
    rows = {}
    for row, (Bt, Tt) in (("rglru_scan", (B, T)),
                          ("rglru_scan_long", (2, 2100))):
        n_sets = n_sets_for(2 * Bt * Tt * D * 4)
        sets = [ab(Bt, Tt, D) for _ in range(n_sets)]
        t_k = device_ms(lambda i: rglru_scan(*sets[i]), n_sets, 20)
        t_p = device_ms(lambda i: rglru_scan_ref(*sets[i]), n_sets, 2)
        del sets
        nbytes = 3 * Bt * Tt * D * 4
        b_ms, b_by = bound_ms(nbytes, 2.0 * Bt * Tt * D, torch.float32)
        rows[row] = dict(max_abs_err=rglru_errs[(Bt, Tt, D)], ms=t_k,
                         plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
        log("kernels", f"rglru_scan times (B{Bt} T{Tt} D{D} fp32, {n_sets} "
            f"input sets): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {2 * Bt * Tt * D:.3e} FLOP; "
            f"{nbytes / (t_k * 1e-3) / 1e12:.3f} TB/s, {b_ms / t_k:.1%} of "
            f"the bound); library: none ({NO_LIBRARY_RGLRU}); plan "
            f"{rglru_plan(Bt, Tt, D)}")

    # -- head_dim 256, MQA: checks across the window and a wrapped ring ------
    G, Dh, W = 10, 256, 2048
    for dt in (torch.float32, torch.bfloat16):
        S = 3072
        q5 = randn(gen, (2, 1, G, S, Dh), dt)
        k4, v4 = (randn(gen, (2, 1, S, Dh), dt) for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=DEVICE).repeat(2, 1)
        qp = pos.clone()
        qp[1, :7] = -1
        o, l = fk.flash_attention_fwd(q5, k4, v4, qp, pos, causal=True,
                                      window=W)
        ro, rl = ref.flash_attention_fwd_ref(q5, k4, v4, qp, pos, causal=True,
                                             window=W)
        name = f"prefill Hkv1 G10 S=T=3072 D256 window 2048 {str(dt)[6:]}"
        if dt == torch.bfloat16:
            _check_bf16(name, o, ro, _abs_v_out(q5, k4, v4, qp, pos,
                                                causal=True, window=W), l, rl)
        else:
            _check(name, o, ro, TOL[dt])
            _check(name, l, rl, TOL[dt], "lse")
        del q5, k4, v4, o, l, ro, rl
        for S in (1, 2):
            q5 = randn(gen, (4, 1, G, S, Dh), dt)
            k4, v4 = (randn(gen, (4, 1, W, Dh), dt) for _ in range(2))
            qp, kp = ring_positions([100, 2047, 2100, 5000], S, W)
            _check(f"decode Hkv1 G10 S{S} T2048 D256 window 2048 wrapped "
                   f"ring {str(dt)[6:]}",
                   fk.flash_decode_fwd(q5, k4, v4, qp, kp, causal=True,
                                       window=W),
                   ref.flash_decode_fwd_ref(q5, k4, v4, qp, kp, causal=True,
                                            window=W), TOL[dt])

    # -- head_dim 256 at the serving shapes: bf16, model layout --------------
    dt, S = torch.bfloat16, 512
    q = randn(gen, (B, S, G, Dh), dt)
    k, v = (randn(gen, (B, S, 1, Dh), dt) for _ in range(2))
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True, window=W)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    split = lambda x: x.reshape(B, S, 1, G, Dh).permute(0, 2, 3, 1, 4)
    args5 = (split(q), k.transpose(1, 2), v.transpose(1, 2), pos, pos)
    r_out, r_lse = ref.flash_attention_fwd_ref(*args5, causal=True, window=W)
    to4 = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, S, G, Dh)
    d256_err = _check_bf16(
        "prefill B8 Hkv1 G10 S=T=512 D256 bf16 (model layout)", out,
        to4(r_out), to4(_abs_v_out(*args5, causal=True, window=W)), lse,
        r_lse)
    n_sets = n_sets_for(q.nbytes + k.nbytes + v.nbytes)
    sets = [(randn(gen, (B, S, G, Dh), dt), randn(gen, (B, S, 1, Dh), dt),
             randn(gen, (B, S, 1, Dh), dt)) for _ in range(n_sets)]
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    posc = pos.contiguous()
    t_k = device_ms(lambda i: fk.flash_attention_fwd(
        *sets5[i], posc, posc, causal=True, window=W), n_sets, 20)
    t_ops = device_ms(lambda i: ops.flash_attention_gqa_fwd(
        *sets[i], causal=True, window=W), n_sets, 20)
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, causal=True, window=W), n_sets, 4)
    sets4 = [(a.transpose(1, 2), b.transpose(1, 2).expand(B, G, S, Dh),
              c.transpose(1, 2).expand(B, G, S, Dh)) for a, b, c in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], is_causal=True), n_sets, 20)
    del sets, sets4, sets5
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes + lse.nbytes + 2 * pos.nbytes
    flops = 4.0 * Dh * G * visible_pairs(pos, pos, True, W)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_attention_fwd_d256"] = dict(
        max_abs_err=d256_err, ms=t_ops, plain_ms=t_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_l)
    log("kernels", f"prefill D256 times (B8 Hkv1 G10 S=T=512 bf16): kernel "
        f"{t_ops:.4f} ms (through ops, as PR 14 timed it; the kernel call "
        f"alone: {t_k:.4f} ms), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP)")
    rows["flash_attention_fwd_d256_long"] = kernels_griffin_long(gen)
    rows["flash_attention_fwd_fp32_d256"] = fp32_prefill_row(
        gen, "B8 Hkv1 G10 S=T=512 D256 window 2048", B, 1, G, S, Dh, W)

    T = 576
    qp, kp = ring_positions([575 - 8 * b for b in range(B)], 1, T)
    q = randn(gen, (B, 1, G, Dh), dt)
    k, v = (randn(gen, (B, T, 1, Dh), dt) for _ in range(2))
    to5 = lambda x: x.reshape(B, 1, 1, G, Dh).permute(0, 2, 3, 1, 4)
    d256_dec_err = _check(
        "decode B8 Hkv1 G10 T576 S1 D256 bf16 (model layout)",
        ops.flash_decode(q, k, v, qp, kp, window=W),
        ref.flash_decode_fwd_ref(to5(q), k.transpose(1, 2), v.transpose(1, 2),
                                 qp, kp, window=W
                                 ).permute(0, 3, 1, 2, 4).reshape(B, 1, G, Dh),
        TOL[dt])
    n_sets = n_sets_for(2 * B * T * Dh * 2)
    sets = [(randn(gen, (B, 1, G, Dh), dt), randn(gen, (B, T, 1, Dh), dt),
             randn(gen, (B, T, 1, Dh), dt)) for _ in range(n_sets)]
    t_k = device_ms(lambda i: ops.flash_decode(*sets[i], qp, kp, window=W),
                    n_sets, 50)
    sets5 = [(to5(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    t_p = device_ms(lambda i: ref.flash_decode_fwd_ref(*sets5[i], qp, kp,
                                                       window=W), n_sets, 10)
    from repro_torch.kernels.flash_attention.ref import visible_mask
    mask = visible_mask(qp, kp, causal=True, window=W)[:, None]
    sets4 = [(a.transpose(1, 2), b.transpose(1, 2).expand(B, G, T, Dh),
              c.transpose(1, 2).expand(B, G, T, Dh)) for a, b, c in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], attn_mask=mask), n_sets, 50)
    del sets, sets4, sets5
    valid_rows = int((kp >= 0).sum())
    nbytes = (2 * 2 * valid_rows * Dh + 2 * B * G * Dh * 2 + qp.nbytes
              + kp.nbytes)
    flops = 4.0 * Dh * G * visible_pairs(qp, kp, True, W)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_decode_fwd_d256"] = dict(
        max_abs_err=d256_dec_err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_l)
    log("kernels", f"decode D256 times (B8 Hkv1 G10 T576 S1 bf16): kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP); plan "
        f"{fk.decode_plan(B, 1, G, T)}")
    # the layout kernels at head_dim 256 (one kv head, ten q heads, the
    # window), paged == dense and paged-quant == quant bit for bit
    for dt in (torch.bfloat16, torch.float32):
        _check_layouts_case(gen, dt, 4, 1, G, 1, 576, Dh, 16,
                            [100, 575, 2100, 40],
                            dict(causal=True, window=W, softcap=0.0),
                            share=2)
    return rows


def kernels_griffin_long(gen) -> dict:
    """The prefill kernel at Griffin's long prompt: B 2 x S = T = 2100, one
    kv head for ten q heads of 256, a local window of 2048 that the prompt
    crosses; against its plain version, then device times beside SDPA with
    an explicit boolean mask (the row's library time: it computes the same
    function) and, logged beside it, with ``is_causal=True`` (its flash
    backend, which ignores the window and so does slightly more work).
    Returns the row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, G, Dh, W, dt = 2, 2100, 10, 256, 2048, torch.bfloat16
    q = randn(gen, (B, S, G, Dh), dt)
    k, v = (randn(gen, (B, S, 1, Dh), dt) for _ in range(2))
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True, window=W)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    split = lambda x: x.reshape(B, S, 1, G, Dh).permute(0, 2, 3, 1, 4)
    args5 = (split(q), k.transpose(1, 2), v.transpose(1, 2), pos, pos)
    r_out, r_lse = ref.flash_attention_fwd_ref(*args5, causal=True, window=W)
    to4 = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, S, G, Dh)
    err = _check_bf16(
        "prefill B2 Hkv1 G10 S=T=2100 D256 window 2048 bf16 (model layout)",
        out, to4(r_out), to4(_abs_v_out(*args5, causal=True, window=W)), lse,
        r_lse)
    del r_out, r_lse
    n_sets = n_sets_for(q.nbytes + k.nbytes + v.nbytes)
    sets = [(randn(gen, (B, S, G, Dh), dt), randn(gen, (B, S, 1, Dh), dt),
             randn(gen, (B, S, 1, Dh), dt)) for _ in range(n_sets)]
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    posc = pos.contiguous()
    t_k = device_ms(lambda i: fk.flash_attention_fwd(
        *sets5[i], posc, posc, causal=True, window=W), n_sets, 10)
    t_ops = device_ms(lambda i: ops.flash_attention_gqa_fwd(
        *sets[i], causal=True, window=W), n_sets, 10)
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, causal=True, window=W), n_sets, 2)
    mask = ref.visible_mask(pos, pos, causal=True, window=W)[:, None]
    sets4 = [(a.transpose(1, 2), b.transpose(1, 2).expand(B, G, S, Dh),
              c.transpose(1, 2).expand(B, G, S, Dh)) for a, b, c in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], attn_mask=mask), n_sets, 10)
    t_c = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], is_causal=True), n_sets, 10)
    del sets, sets4, sets5
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes + lse.nbytes + 2 * pos.nbytes
    flops = 4.0 * Dh * G * visible_pairs(pos, pos, True, W)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    log("kernels", f"prefill D256 long times (B2 Hkv1 G10 S=T=2100 window "
        f"2048 bf16): kernel {t_ops:.4f} ms (through ops; the kernel call "
        f"alone: {t_k:.4f} ms), plain {t_p:.4f} ms, sdpa (bool mask) "
        f"{t_l:.4f} ms, sdpa is_causal=True (no window) {t_c:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP)")
    return dict(max_abs_err=err, ms=t_ops, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_l)


def kernels_verify(gen) -> dict:
    """The decode kernel at the speculative verify block's shape: B 8, H 12,
    S = k + 1 = 4 q rows a slot, T 579 (512 + 64 + k ring slots), D 64,
    bf16, mixed depths, through ``ops.flash_decode`` as the model calls it;
    checked against the plain version, timed beside it and SDPA with a
    boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.flash_attention.ref import visible_mask
    B, H, S, T, D, dt = 8, 12, SPEC_K + 1, 512 + 64 + SPEC_K, 64, \
        torch.bfloat16
    qp, kp = ring_positions([T - S - 8 * b for b in range(B)], S, T)
    q = randn(gen, (B, S, H, D), dt)
    k, v = (randn(gen, (B, T, H, D), dt) for _ in range(2))
    split = lambda x: x.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4)
    merge = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    err = _check("decode verify block B8 H12 S4 T579 D64 bf16",
                 ops.flash_decode(q, k, v, qp, kp),
                 merge(ref.flash_decode_fwd_ref(split(q), k.transpose(1, 2),
                                                v.transpose(1, 2), qp, kp)),
                 TOL[dt])
    n_sets = n_sets_for(2 * B * T * H * D * 2)
    sets = [(randn(gen, (B, S, H, D), dt), randn(gen, (B, T, H, D), dt),
             randn(gen, (B, T, H, D), dt)) for _ in range(n_sets)]
    t_k = device_ms(lambda i: ops.flash_decode(*sets[i], qp, kp), n_sets, 50)
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    t_p = device_ms(lambda i: ref.flash_decode_fwd_ref(*sets5[i], qp, kp),
                    n_sets, 10)
    mask = visible_mask(qp, kp, causal=True, window=0)[:, None]  # (B,1,S,T)
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], attn_mask=mask), n_sets, 50)
    del sets, sets4, sets5
    nbytes = (2 * 2 * int((kp >= 0).sum()) * H * D   # K and V rows held
              + 2 * B * S * H * D * 2                # q in, out
              + qp.nbytes + kp.nbytes)
    flops = 4.0 * D * H * visible_pairs(qp, kp, True, 0)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    log("kernels", f"decode at the verify shape: kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes} B, {flops:.3e} FLOP)")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_l)


def _identical(name, got, want, phase="kernels") -> None:
    same = torch.equal(got, want)
    log(phase, f"{name}: bitwise identical {same}")
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


def _counters() -> list:
    """The launch counters of every kernel module."""
    from repro_torch.kernels import launch_counters
    return launch_counters()


def _reset():
    for counter in _counters():
        for name in counter:
            counter[name] = 0


def _layer_counts(cfg) -> tuple:
    """(attention layers, RG-LRU layers) of a model."""
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // 3
        return n_attn, cfg.num_layers - n_attn
    return cfg.num_layers, 0


def _check_launches(phase, cfg, prefills, decode_steps,
                    decode_kernel="flash_decode_fwd", draft_steps=0,
                    draft_layers=0) -> dict:
    """Every prefill launched the prefill kernel once per attention layer
    (its fp32 route too, for a model computing in fp32) and the RG-LRU
    kernel once per recurrent layer, every decode step (one token, or a
    speculative verify block) the layout's decode kernel once per attention
    layer, and every draft step of speculative decoding's ``draft`` mode
    once per layer of its first ``draft_layers``; no other kernel ran."""
    got = {n: c for counter in _counters() for n, c in counter.items()}
    n_attn, n_rec = _layer_counts(cfg)
    want = dict.fromkeys(got, 0)
    want["flash_attention_fwd"] = n_attn * prefills
    if cfg.compute_dtype == "float32":
        want["flash_attention_fwd_fp32"] = n_attn * prefills
    want[decode_kernel] = n_attn * decode_steps + draft_layers * draft_steps
    want["rglru_scan"] = n_rec * prefills
    log(phase, f"launches {got} (want {want}: {n_attn} attention + {n_rec} "
        f"recurrent layers x {prefills} prefills / {decode_steps} decode "
        f"steps" + (f", {draft_layers} layers x {draft_steps} draft steps"
                    if draft_steps else "") + ")")
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != {want}")
    return got


def phase_serve(model, smi: str) -> dict:
    """Batch serving in every KV layout; returns the launches of each
    layout's graph run."""
    return {layout: _serve_engines(model, smi, f"serve/{layout}",
                                   decode_kernel, batch=8, prompt_len=512,
                                   gen=64, chunk=8, seed=0,
                                   kv_quant=kv_quant, page_size=page_size)
            for layout, (kv_quant, page_size, decode_kernel)
            in LAYOUTS.items()}


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


def _check_fp32_prefills(phase, cfg, prefills) -> dict:
    """Every fp32 prefill of the phase launched the prefill kernel's fp32
    route once per attention layer, and no prefill took the bf16 route;
    returns the phase's launches."""
    from repro_torch.kernels.flash_attention import LAUNCHES
    torch.cuda.synchronize()
    got = {n: c for counter in _counters() for n, c in counter.items()}
    want = _layer_counts(cfg)[0] * prefills
    log(phase, f"launches {got} (want flash_attention_fwd = "
        f"flash_attention_fwd_fp32 = {want}: {prefills} fp32 prefills)")
    if not LAUNCHES["flash_attention_fwd"] == \
            LAUNCHES["flash_attention_fwd_fp32"] == want:
        raise AssertionError(f"{phase}: prefill launches {got}, want {want} "
                             "of the fp32 route")
    return got


def phase_parity(seed: int) -> dict:
    """fp32 logits and caches, card vs CPU, in the contiguous, paged and
    int8 layouts; returns the launches of the card's side."""
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
    layouts = ("contiguous", "paged16", "int8")
    _reset()
    for layout in layouts:
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
    return _check_fp32_prefills("parity", cfg, len(layouts))


def _drain(eng, reqs, label, decode_kernel) -> dict:
    """Drain ``reqs`` through ``eng``: exact launches, one completion per
    request, each of the right length; returns the engine's stats."""
    cfg = eng.model.cfg
    _reset()
    comps = eng.run(list(reqs))
    torch.cuda.synchronize()
    s = eng.stats
    _check_launches(label, cfg, s["prefills"], s["decode_steps"],
                    decode_kernel, s["draft_steps"],
                    eng._generate.draft_layers)
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
        f"{s['decode_dispatches']} chunks, {s['graph_captures']} graph "
        f"capture(s) in {s['capture_seconds'] * 1e3:.1f} ms, "
        f"kv_bytes_per_token {s['kv_bytes_per_token']:.1f}"
        + (f", pages peak {s['kv_pages_peak']}, prefix hits "
           f"{s['prefix_hits']}" if eng.paged else "")
        + (f", spec {eng.spec} accepted_len_per_draft "
           f"{s['spec_accepted_len_per_draft']:.4f}, accept hist "
           f"{s['spec_accept_hist']}" if eng.spec != "off" else ""))
    return s


def _completions(eng) -> list:
    return sorted((c.uid, c.finish_reason, np.asarray(c.tokens).tolist())
                  for c in eng.completions)


def _drain_pair(make, reqs, label, decode_kernel) -> tuple:
    """Drain ``reqs`` through an engine from ``make()`` that runs the chunk
    body eagerly, then through one that replays the captured chunk: the
    same completions, one capture for the whole drain; returns the graph
    engine's stats and completions."""
    with eager_chunks():
        eager = make()
        e = _drain(eager, reqs, f"{label}/eager", decode_kernel)
        want, eager_captures = _completions(eager), e["graph_captures"]
        del eager
    eng = make()
    s = _drain(eng, reqs, f"{label}/graph", decode_kernel)
    same = _completions(eng) == want
    log(label, f"graph == eager-body completions: {same}; tokens/s graph "
        f"{s['tokens_per_second']:.1f} (wall {s['wall_seconds']:.3f} s, the "
        f"capture's {s['capture_seconds']:.3f} s included), eager "
        f"{e['tokens_per_second']:.1f}")
    if not same or s["graph_captures"] != 1 or eager_captures != 0:
        raise AssertionError(f"{label}: completions equal {same}, captures "
                             f"{s['graph_captures']} / {eager_captures}")
    return s, want


ENGINE_LAYOUTS = ("contiguous", "paged16", "paged16_int8")


def _engine_requests(model, seed: int) -> list:
    """24 mixed requests with a 64-token shared prefix."""
    from repro_torch.launch.serve import synth_requests
    return synth_requests(cfg=model.cfg, requests=24, prompt_len=256, gen=64,
                          seed=seed, shared_prefix=64)


def _make_engine(model, seed, layout, **kw):
    from repro_torch.launch.serve import make_queue_engine
    kv_quant, page_size, _ = LAYOUTS[layout]
    return make_queue_engine(model=model, slots=8, prompt_len=256, gen=64,
                             chunk=8, seed=seed, kv_quant=kv_quant,
                             page_size=page_size, **kw)


def phase_engine(model, seed: int) -> dict:
    """The requests of ``_engine_requests`` on 8 slots, in the contiguous,
    paged and paged int8 layouts; returns each layout's completions."""
    reqs = _engine_requests(model, seed)
    per_token, completions = {}, {}
    for layout in ENGINE_LAYOUTS:
        s, completions[layout] = _drain_pair(
            lambda: _make_engine(model, seed, layout), reqs,
            f"engine/{layout}", LAYOUTS[layout][2])
        per_token[layout] = s["kv_bytes_per_token"]
    base = per_token["contiguous"]
    log("engine", "kv_bytes_per_token " + ", ".join(
        f"{k} {v:.1f} ({v / base:.3f} of contiguous)"
        for k, v in per_token.items()))
    return completions


# ---------------------------------------------------------------------------
# robust serving and the fleet: the fault model around the captured chunk
# ---------------------------------------------------------------------------
# the engine phase's 24 requests (prompts up to 256, a 64-token shared
# prefix) in a 512-token bucket, so a paged restore's prompt + produced fits
ROBUST_BUCKET = 512
ROBUST_CASES = (("contiguous", "off"), ("paged16", "off"),
                ("paged16_int8", "off"), ("contiguous", "ngram"))
ROBUST_CHAOS = "nan=2,slow=2,fail=1,pages=4"
ROBUST_MAX_QUEUE = 4
FLEET_LAYOUT = "paged16"


class FlagOn:
    """A deterministic stand-in for the engine's StragglerMonitor: flags
    exact chunk indices (the reference's shedding test drives it so)."""

    def __init__(self, steps):
        self.steps, self.flagged = set(steps), []

    def step_start(self):
        pass

    def step_end(self, idx):
        if idx in self.steps:
            self.flagged.append({"step": idx, "seconds": 1.0, "ema": 0.1})
            return self.flagged[-1]
        return None


def _robust_engine(model, seed, layout, spec="off", **kw):
    from repro_torch.launch.serve import make_queue_engine
    kv_quant, page_size, _ = LAYOUTS[layout]
    return make_queue_engine(model=model, slots=8, prompt_len=ROBUST_BUCKET,
                             gen=64, chunk=8, seed=seed, kv_quant=kv_quant,
                             page_size=page_size, spec=spec,
                             spec_k=SPEC_K if spec != "off" else None, **kw)


def _launches_of(label, eng) -> dict:
    """``_check_launches`` over an engine's stats (the draft steps too)."""
    torch.cuda.synchronize()
    s = eng.stats
    return _check_launches(label, eng.model.cfg, s["prefills"],
                           s["decode_steps"], _decode_kernel(eng),
                           s["draft_steps"], eng._generate.draft_layers)


def _decode_kernel(eng) -> str:
    m = eng.model
    if m.kv_quant == "off":
        return "flash_decode_paged_fwd" if m.page_size else "flash_decode_fwd"
    return ("flash_decode_paged_quant_fwd" if m.page_size
            else "flash_decode_quant_fwd")


def _one_each(label, comps, reqs) -> dict:
    by_uid = {}
    for c in comps:
        if c.uid in by_uid:
            raise AssertionError(f"{label}: two completions for {c.uid}")
        by_uid[c.uid] = c
    if sorted(by_uid) != sorted(r.uid for r in reqs):
        raise AssertionError(f"{label}: completions {sorted(by_uid)}")
    return by_uid


def _by_uid(comps) -> dict:
    """uid -> (finish reason, token list) of completions."""
    return {c.uid: (c.finish_reason, np.asarray(c.tokens).tolist())
            for c in comps}


def _prefix_of(label, c, want) -> None:
    """An error completion's partial tokens begin the clean stream."""
    got, ref = np.asarray(c.tokens).tolist(), want[1]
    if got != ref[:len(got)]:
        raise AssertionError(f"{label}: uid {c.uid} ({c.reason}) tokens "
                             f"{got} are not a prefix of {ref}")


def _pages_back(label, eng) -> None:
    free = len(eng._alloc.free)
    if (eng.stats["kv_pages_in_use"] != 0 or free != eng.n_phys_pages - 1
            or eng._host_table.any()):
        raise AssertionError(f"{label}: pages in use "
                             f"{eng.stats['kv_pages_in_use']}, free {free} "
                             f"of {eng.n_phys_pages - 1}")


def _robust_chaos(make, reqs, clean, label, plan=ROBUST_CHAOS,
                  seed=0) -> dict:
    """A seeded chaos drain: one completion each, poisoned uids end
    ``nan_logits`` with a prefix of their clean tokens, every other
    completion equals the clean drain's, a retry happened, exact launches
    (a failed chunk launched nothing: only dispatched chunks' steps count),
    and, paged, every page back once the stolen ones are released."""
    from repro_torch.distributed.chaos import ChaosConfig
    eng = make(chaos=ChaosConfig.parse(plan, seed=seed))
    _reset()
    by_uid = _one_each(label, eng.run(list(reqs)), reqs)
    _launches_of(label, eng)
    ev = eng.chaos_events
    poisoned = {e["uid"] for e in ev if e["kind"] == "nan"}
    reasons = {}
    for uid, c in by_uid.items():
        if c.finish_reason == "error":
            reasons[c.reason] = reasons.get(c.reason, 0) + 1
            _prefix_of(label, c, clean[uid])
        elif (c.finish_reason, np.asarray(c.tokens).tolist()) != clean[uid]:
            raise AssertionError(f"{label}: survivor {uid} differs from the "
                                 "clean drain")
    bad = [u for u in poisoned if by_uid[u].reason != "nan_logits"]
    s = eng.stats
    if len(poisoned) != 2 or bad or s["retries"] < 1:
        raise AssertionError(f"{label}: poisoned {sorted(poisoned)} (not "
                             f"nan_logits: {bad}), retries {s['retries']}")
    if eng.paged:
        eng._chaos.release_pages(eng._alloc)
        _pages_back(label, eng)
    slow = [e["chunk"] for e in ev if e["kind"] == "slow"]
    walls = s["chunk_seconds"]
    log(label, f"chaos {plan} seed {seed}: events "
        f"{[e['kind'] for e in ev]}, poisoned {sorted(poisoned)}, errors "
        f"{reasons}, retries {s['retries']}; {s['tokens_out']} tokens in "
        f"{s['wall_seconds']:.3f} s ({s['tokens_per_second']:.1f} tokens/s); "
        f"slow chunks {slow} walls "
        f"{['%.1f ms' % (walls[i] * 1e3) for i in slow if i < len(walls)]} "
        f"(median chunk {np.median(walls) * 1e3:.1f} ms; a wall starts "
        f"after the injected sleep, the watchdog's window before it), the "
        f"real watchdog ({eng._straggler.threshold:g}x its EMA, "
        f"{eng._straggler.ema * 1e3:.1f} ms at the end): "
        f"{s['straggler_events']} straggler events, {s['shed_events']} "
        f"shed" + (", every page back after the release" if eng.paged
                   else ""))
    return s


def _robust_queue(make, reqs, clean, label) -> None:
    """``max_queue`` 4: the first four submissions accepted, the other 20
    rejected at once with ``queue_full``; the four drain to the clean
    drain's tokens."""
    eng = make(max_queue=ROBUST_MAX_QUEUE)
    accepted = [eng.submit(r) for r in reqs]
    by_uid = _one_each(label, eng.run(), reqs)
    full = sorted(u for u, c in by_uid.items() if c.reason == "queue_full")
    want = [r.uid for r, ok in zip(reqs, accepted) if not ok]
    if accepted[:ROBUST_MAX_QUEUE] != [True] * ROBUST_MAX_QUEUE or \
            full != want or len(full) != len(reqs) - ROBUST_MAX_QUEUE:
        raise AssertionError(f"{label}: accepted {accepted}, queue_full "
                             f"{full}")
    for r in reqs[:ROBUST_MAX_QUEUE]:
        if np.asarray(by_uid[r.uid].tokens).tolist() != clean[r.uid][1]:
            raise AssertionError(f"{label}: uid {r.uid} differs")
    log(label, f"max_queue {ROBUST_MAX_QUEUE}: {len(full)} queue_full of "
        f"{len(reqs)} (exact), queue peak {eng.stats['queue_peak']}, the "
        "accepted drained as the clean drain")


def _robust_deadlines(make, reqs, clean, label) -> None:
    """An injected clock: every third request has a 1 s deadline; after two
    chunks the clock jumps 10 s. Expired active requests end ``deadline``
    with a prefix of their clean tokens, expired queued ones empty, the
    rest as the clean drain."""
    clk = {"t": 1000.0}
    eng = make(clock=lambda: clk["t"])
    dl = {r.uid for r in reqs if r.uid % 3 == 0}
    for r in reqs:
        r2 = type(r)(uid=r.uid, tokens=r.tokens,
                     max_new_tokens=r.max_new_tokens,
                     deadline_ms=1000.0 if r.uid in dl else None)
        eng.submit(r2)
    eng.step()
    eng.step()
    active = {eng._active[s].request.uid for s in eng._active}
    clk["t"] += 10.0
    by_uid = _one_each(label, eng.run(), reqs)
    missed = {u for u, c in by_uid.items() if c.reason == "deadline"}
    part = [u for u in missed if len(by_uid[u].tokens)]
    for u, c in by_uid.items():
        if u in missed:
            _prefix_of(label, c, clean[u])
        elif np.asarray(c.tokens).tolist() != clean[u][1]:
            raise AssertionError(f"{label}: uid {u} differs")
    if not missed <= dl or not part or not (missed - active) or \
            eng.stats["deadline_miss"] != len(missed):
        raise AssertionError(f"{label}: missed {sorted(missed)} of "
                             f"{sorted(dl)}, partial {part}")
    log(label, f"deadlines: {len(missed)} missed ({len(part)} in flight "
        f"with partial tokens, {len(missed) - len(part)} while queued), "
        "the rest as the clean drain")


def _robust_persistent(make, reqs, label) -> None:
    """Every pre-dispatch attempt fails: past the retry budget every
    request ends ``step_failure``, the engine stays dead, nothing was
    dispatched (the admissions' prefills launched, no decode kernel) and a
    dead paged engine wrote no page table."""
    from repro_torch.distributed.chaos import ChaosConfig, TransientStepError
    eng = make(chaos=ChaosConfig(), max_retries=1, retry_backoff_s=0.0)

    def always_fail(idx):
        raise TransientStepError(f"persistent fault at chunk {idx}")

    eng._chaos.on_chunk = always_fail
    writes = []
    if eng.paged:
        put = eng._set_table_row
        eng._set_table_row = lambda *a: (writes.append(a) if eng._dead
                                         else put(*a))
    _reset()
    by_uid = _one_each(label, eng.run(list(reqs)), reqs)
    _launches_of(label, eng)
    reasons = {c.reason for c in by_uid.values()}
    if reasons != {"step_failure"} or eng.step() or writes or \
            eng.stats["decode_steps"] != 0:
        raise AssertionError(f"{label}: reasons {reasons}, table writes "
                             f"{len(writes)}, decode steps "
                             f"{eng.stats['decode_steps']}")
    log(label, f"persistent failure: {len(by_uid)} step_failure, "
        f"{eng.stats['retries']} retries, dead, no decode launch")


def _robust_restore(make, reqs, clean, label) -> None:
    """Preempted after 2 chunks, the snapshot saved as a RestartManifest in
    a temporary directory, restored into a fresh engine and drained: the
    union equals the uninterrupted drain, byte for byte (the restore
    regenerates in-flight requests). Paged, the reference's resume from
    prompt + produced is also run and its agreement recorded."""
    import tempfile
    from repro_torch.launch.serve import restore_serve, save_serve_manifest
    eng = make()
    _reset()
    eng.run(list(reqs), stop=lambda: eng.stats["decode_dispatches"] >= 2)
    _launches_of(f"{label}/preempted", eng)
    snap = eng.snapshot()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.json")
        save_serve_manifest(path, eng, arch=eng.model.cfg.name, smoke=False,
                            slots=eng.slots, prompt_len=eng.prompt_len,
                            gen=eng.max_new, chunk=eng.chunk)
        _reset()
        t0 = time.perf_counter()
        restored = restore_serve(path, model=eng.model)
        wall = time.perf_counter() - t0
        _launches_of(f"{label}/restored", restored)
        resumed = (restore_serve(path, model=eng.model, resume=True)
                   if eng.paged else None)
    if _by_uid(restored.completions) != clean:
        raise AssertionError(f"{label}: restored completions differ from "
                             "the uninterrupted drain")
    if restored.paged:
        _pages_back(label, restored)
    note = ""
    if resumed is not None:
        got = _by_uid(resumed.completions)
        diff = sorted(u for u in clean if got[u] != clean[u])
        note = (f"; the reference's resume from prompt + produced (recorded, "
                f"not gated): {len(clean) - len(diff)} of {len(clean)} "
                f"completions equal the uninterrupted drain's"
                + (f", uids {diff} differ" if diff else ""))
    log(label, f"preempted after 2 chunks ({len(snap['completions'])} done, "
        f"{len(snap['active'])} in flight with "
        f"{sum(len(d['produced']) for d in snap['active'])} tokens, "
        f"{len(snap['queued'])} queued); restored (regenerating) in "
        f"{wall:.3f} s: union == the uninterrupted drain" + note)


def _robust_shed(make, reqs, clean, label) -> list:
    """The straggler stub flags chunks 1 and 2 (``shed_after`` 1): two
    levels shed (speculation off, then the chunk halved; or the chunk
    halved twice), each a new program captured on its first call; tokens
    equal the unshed drain's; launches follow the live programs. Returns
    each level's capture seconds."""
    eng = make(shed_after=1)
    eng._straggler = FlagOn({1, 2})
    _reset()
    eng.run(list(reqs))
    _launches_of(label, eng)
    s = eng.stats
    same = _by_uid(eng.completions) == clean
    log(label, f"shed {s['shed_events']} levels to spec "
        f"{eng._spec_live!r}, chunk {eng._chunk_live}: captures "
        f"{s['graph_captures']} (level 0 {s['capture_seconds']:.3f} s, shed "
        f"levels {['%.3f s' % x for x in s['shed_capture_seconds']]}); "
        f"tokens == the unshed drain: {same}; {s['tokens_per_second']:.1f} "
        "tokens/s")
    if not same or s["shed_events"] != 2 or s["graph_captures"] != 3 \
            or not all(x > 0 for x in s["shed_capture_seconds"]):
        raise AssertionError(f"{label}: shed {s['shed_events']}, captures "
                             f"{s['graph_captures']}, identical {same}")
    return s["shed_capture_seconds"]


def phase_robust(model, smi: str, seed: int) -> None:
    """The reference's fault model around the captured chunk on
    full-width pimref-100m: for each of ROBUST_CASES a clean drain, a
    seeded chaos drain, a bounded queue, deadlines on an injected clock, a
    persistent failure and a preemption / restore; shedding by a straggler
    stub (bf16 contiguous: the chunk halved twice; fp32 contiguous
    ``ngram``: speculation off, then the chunk halved, where greedy spec ==
    off holds); the graph's device ms per step with and without the hook."""
    from repro_torch.distributed.chaos import nan_logits_hook
    reqs = _engine_requests(model, seed)
    rates = {}
    for layout, spec in ROBUST_CASES:
        label = f"robust/{layout}" + (f"/{spec}" if spec != "off" else "")

        def make(_layout=layout, _spec=spec, **kw):
            return _robust_engine(model, seed, _layout, _spec, **kw)
        eng = make()
        s = _drain(eng, reqs, f"{label}/clean", _decode_kernel(eng))
        clean = _by_uid(eng.completions)
        del eng
        c = _robust_chaos(make, reqs, clean, f"{label}/chaos", seed=seed)
        rates[label] = (s["tokens_per_second"], c["tokens_per_second"])
        _robust_queue(make, reqs, clean, f"{label}/queue")
        _robust_deadlines(make, reqs, clean, f"{label}/deadline")
        _robust_persistent(make, reqs, f"{label}/persistent")
        _robust_restore(make, reqs, clean, f"{label}/restore")
        if (layout, spec) == ("contiguous", "off"):
            _robust_shed(make, reqs, clean, f"{label}/shed")
    log("robust", f"{smi}: drain tokens/s clean vs chaos (walls with the "
        "capture): " + ", ".join(f"{k} {a:.1f} vs {b:.1f}"
                                 for k, (a, b) in rates.items()))
    # speculation off then the chunk halved, in fp32 (greedy spec == off)
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_model
    cfg = get_config("pimref-100m").replace(compute_dtype="float32")
    m32 = load_model("pimref-100m", smoke=False, seed=seed, device=DEVICE,
                     cfg=cfg)
    def make32(**kw):
        return _robust_engine(m32, seed, "contiguous", "ngram", **kw)
    e32 = make32()
    s32 = _drain(e32, reqs, "robust/fp32/ngram/clean", "flash_decode_fwd")
    clean32 = _by_uid(e32.completions)
    del e32
    _robust_shed(make32, reqs, clean32, "robust/fp32/ngram/shed")
    log("robust/fp32/ngram", f"unshed {s32['tokens_per_second']:.1f} "
        "tokens/s")
    del m32
    torch.cuda.empty_cache()
    toks = spec_prompts(model.cfg.vocab_size, seed=seed)
    for spec in ("off", "ngram"):
        plain = graph_device_ms(model, toks, 64, 8, spec)[0]
        hooked = graph_device_ms(model, toks, 64, 8, spec,
                                 logits_hook=nan_logits_hook)[0]
        log("robust/hook", f"{smi}: the graph's device ms per "
            f"{'step' if spec == 'off' else 'iteration'} (batch 8 x 512, "
            f"spec {spec}): unhooked {plain:.4f}, hooked and disarmed "
            f"{hooked:.4f} ({hooked / plain:.3f}x)")


def _fleet_check(label, fleet, reqs, want, shards_in_process=True) -> dict:
    """One completion each, every completion the yardstick's; the
    in-process shards' launches exact (a worker's are its own)."""
    by_uid = _one_each(label, fleet.completions, reqs)
    got = sorted((u, c.finish_reason, np.asarray(c.tokens).tolist())
                 for u, c in by_uid.items())
    if got != want:
        raise AssertionError(f"{label}: completions differ from one "
                             "engine's drain")
    if shards_in_process:
        torch.cuda.synchronize()
        st = [sh.eng.stats for sh in fleet.shards]
        _check_launches(label, fleet.shards[0].eng.model.cfg,
                        sum(s["prefills"] for s in st),
                        sum(s["decode_steps"] for s in st),
                        _decode_kernel(fleet.shards[0].eng))
    return fleet.stats


def phase_fleet(model, smi: str, seed: int) -> None:
    """ServeFleet on one card, paged16 shards of 8 slots, the engine
    phase's 24 requests: 1 and 2 in-process shards (sharing the model's
    weights) and 2 spawned workers (each building its engine on the card
    from the seed), each equal to one engine's drain; ``kill=1@2`` fails
    over (in process and a real terminate); a stall walks LIVE -> SUSPECT
    -> DEAD."""
    from repro_torch.distributed.chaos import ShardChaosConfig
    from repro_torch.distributed.fault_tolerance import ShardState
    from repro_torch.launch.serve import make_fleet
    reqs = _engine_requests(model, seed)
    kv_quant, page_size, _ = LAYOUTS[FLEET_LAYOUT]
    ekw = dict(slots=8, prompt_len=ROBUST_BUCKET, gen=64, chunk=8, seed=seed,
               kv_quant=kv_quant, page_size=page_size)
    one = _robust_engine(model, seed, FLEET_LAYOUT)
    _drain(one, reqs, "fleet/one_engine", _decode_kernel(one))
    want = _completions(one)
    rates = {"1 engine": one.stats["tokens_per_second"]}
    del one
    for shards in (1, 2):
        fleet = make_fleet(shards=shards, model=model, **ekw)
        _reset()
        fleet.run(list(reqs))
        st = _fleet_check(f"fleet/inproc{shards}", fleet, reqs, want)
        rates[f"{shards} in-process"] = st["tokens_per_second"]
        log(f"fleet/inproc{shards}", f"== one engine's drain; "
            f"{st['tokens_out']} tokens in {st['wall_seconds']:.3f} s "
            f"({st['tokens_per_second']:.1f} tokens/s), per shard "
            f"{[r['tokens_out'] for r in fleet.per_shard_stats()]} tokens")
    fleet = make_fleet(shards=2, model=model,
                       fleet_chaos=ShardChaosConfig.parse("kill=1@2"), **ekw)
    _reset()
    fleet.run(list(reqs))
    st = _fleet_check("fleet/inproc2/kill", fleet, reqs, want)
    if st["failovers"] != 1 or fleet.monitor.state(1) is not ShardState.DEAD:
        raise AssertionError(f"fleet/inproc2/kill: {st}")
    log("fleet/inproc2/kill", f"kill=1@2: {st['failovers']} failover, "
        f"{st['replays']} replays, one completion each, == one engine")
    fleet = make_fleet(shards=2, model=model, miss_suspect=2, miss_dead=3,
                       fleet_chaos=ShardChaosConfig.parse("stall=1@1"), **ekw)
    _reset()
    fleet.run(list(reqs))
    st = _fleet_check("fleet/inproc2/stall", fleet, reqs, want)
    kinds = [e["kind"] for e in fleet.monitor.events]
    if kinds != ["suspect", "dead"] or st["failovers"] != 1:
        raise AssertionError(f"fleet/inproc2/stall: {kinds}, {st}")
    log("fleet/inproc2/stall", f"stall=1@1: LIVE -> SUSPECT -> DEAD "
        f"({fleet.monitor.events}), {st['heartbeat_misses']} missed "
        "heartbeats, == one engine")
    del fleet
    for chaos in (None, "kill=1@2"):
        label = "fleet/mp2" + ("/kill" if chaos else "")
        t0 = time.perf_counter()
        fleet = make_fleet(shards=2, backend="mp", arch=model.cfg.name,
                           smoke=False, device=DEVICE,
                           fleet_chaos=(ShardChaosConfig.parse(chaos)
                                        if chaos else None), **ekw)
        try:
            start = time.perf_counter() - t0
            info = [sh.info for sh in fleet.shards]
            if not all(i["device"].startswith(DEVICE) for i in info):
                raise AssertionError(f"{label}: workers on {info}")
            fleet.run(list(reqs))
            st = _fleet_check(label, fleet, reqs, want,
                              shards_in_process=False)
            if chaos and (st["failovers"] != 1
                          or fleet.shards[1].proc.is_alive()):
                raise AssertionError(f"{label}: {st}, worker 1 alive "
                                     f"{fleet.shards[1].proc.is_alive()}")
            rates[f"2 workers{' (kill)' if chaos else ''}"] = \
                st["tokens_per_second"]
            log(label, f"{smi}: workers ready in {start:.2f} s (each "
                f"{['%.2f s' % x for x in st['worker_startup_seconds']]}, "
                f"its build {['%.2f s' % i['build_seconds'] for i in info]}, "
                f"on {[i['device'] for i in info]}); == one engine's drain; "
                f"{st['tokens_out']} tokens in {st['wall_seconds']:.3f} s "
                f"({st['tokens_per_second']:.1f} tokens/s)"
                + (f"; kill=1@2 terminated worker 1 (pid "
                   f"{info[1]['pid']}), {st['failovers']} failover, "
                   f"{st['replays']} replays" if chaos else ""))
        finally:
            fleet.close()
    log("fleet", f"{smi}: tokens/s (one card: shards share it, so no "
        "scaling is claimed) " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in rates.items()))


# ---------------------------------------------------------------------------
# speculative decoding: the draft-verify chunk as one graph replay
# ---------------------------------------------------------------------------
def spec_prompts(vocab: int, batch: int = 8, prompt_len: int = 512,
                 seed: int = 0) -> torch.Tensor:
    """Rows 0-3 a period-4 tile (what the n-gram drafter finds), rows 4-7
    random, from ``seed`` (the reference's spec tests mix them so)."""
    rng = np.random.default_rng(seed)
    rows = [np.tile(rng.integers(1, vocab, 4), prompt_len // 4)
            if r < batch // 2 else rng.integers(1, vocab, prompt_len)
            for r in range(batch)]
    return torch.from_numpy(np.stack(rows).astype(np.int32)).to(DEVICE)


def _spec_start(m, toks, spec, gen, chunk, eager=False,
                draft_layers=None, logits_hook=None) -> tuple:
    """Prefill ``toks`` into a cache sized for ``gen`` tokens and a verify
    block's k-ahead writes, the drafter's history seeded with the prompts,
    and the chunk step (captured by ``prepare``, or run eagerly; with
    ``logits_hook``, every slot disarmed)."""
    from repro_torch.launch.steps import make_generate_step
    k = SPEC_K if spec != "off" else 0
    B, P = toks.shape
    step = (eager_step if eager else make_generate_step)(
        m, chunk=chunk, spec=spec, spec_k=k, draft_layers=draft_layers,
        logits_hook=logits_hook)
    logits, cache = m.prefill(toks, max_len=P + gen + k)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    state = ()
    if spec != "off":
        hist = torch.zeros((B, P + gen + step.span), dtype=torch.int32,
                           device=DEVICE)
        hist[:, :P] = toks
        state = (hist, torch.full((B,), P, dtype=torch.int32, device=DEVICE))
    arm = (torch.full((B,), -1, dtype=torch.int32, device=DEVICE)
           if logits_hook is not None else None)
    step.prepare(cache, tok, None, *state, arm=arm)
    torch.cuda.synchronize()
    return step, cache, tok, state


def spec_drain(m, toks, spec, gen=64, chunk=8, eager=False,
               draft_layers=None) -> dict:
    """serve()'s speculative drain on the prompts ``toks``: chunks until
    every row holds ``gen`` tokens, one host read a chunk. Returns the
    first ``gen`` tokens of every row, each chunk's accepted lengths, the
    decode wall, the tokens committed, and the steps run (the warm-up chunk
    included) for the launch check."""
    t_start = time.perf_counter()
    step, cache, tok, state = _spec_start(m, toks, spec, gen, chunk, eager,
                                          draft_layers)
    capture_s = time.perf_counter() - t_start
    B = toks.shape[0]
    rows, accs, chunks, committed = [[] for _ in range(B)], [], 0, 0
    t0 = time.perf_counter()
    while min(len(r) for r in rows) < gen:
        out = step(cache, tok, None, -1, *state)
        tok, n_valid, toks_d = out[1], out[4], out[5]
        cols = [toks_d, n_valid[:, None]] + ([out[8]] if state else [])
        host = torch.cat(cols, dim=1).cpu().numpy()
        span = toks_d.shape[1]
        for r in range(B):
            rows[r].extend(host[r, :host[r, span]].tolist())
        committed += int(host[:, span].sum())
        accs.append(host[:, span + 1:])
        chunks += 1
    wall = time.perf_counter() - t0
    acc = np.concatenate(accs, axis=1)
    live = acc[acc >= 0]
    return dict(tokens=np.asarray([r[:gen] for r in rows], np.int32),
                acc=acc, wall_s=wall, capture_s=capture_s, chunks=chunks,
                committed=committed,
                accepted_len=float(live.mean()) if state else 1.0,
                decode_steps=chunk * (chunks + 1),
                draft_steps=chunk * (chunks + 1) * step.spec_k
                if step.draft_layers else 0,
                draft_layers=step.draft_layers)


def _spec_profile(m, toks, spec, label) -> None:
    """The captured spec chunk under ``torch.profiler``: prefill, warm-up
    and capture, two replays; the prefill and decode kernels' launches by
    the profiler's kernel events equal the counters."""
    from torch.profiler import ProfilerActivity, profile
    _reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step, cache, tok, state = _spec_start(m, toks, spec, 16, 8)
        for _ in range(2):
            tok = step(cache, tok, None, -1, *state)[1]
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    counted = {n: c for counter in _counters() for n, c in counter.items()}
    names = ("flash_attention_fwd", "flash_decode_fwd")
    seen = {n: sum(e.count for e in kern if PROFILED[n] in e.key)
            for n in names}
    want = {n: counted[n] for n in names}
    per_chunk = 8 * (m.cfg.num_layers + SPEC_K * step.draft_layers)
    log(label, f"launches by the profiler's kernel events {seen}, by the "
        f"counters {want} (prefill, warm-up chunk, two replays: "
        f"{per_chunk} decode-kernel launches a chunk)")
    if seen != want or want["flash_decode_fwd"] != 3 * per_chunk:
        raise AssertionError(f"{label}: the profiler counted {seen}, the "
                             f"counters {want}, {per_chunk} a chunk")


def spec_rounding(model, toks) -> None:
    """Where a verify block's bf16 rows part from one-token steps (logged,
    not gated): four greedy tokens fed as one (k + 1)-row decode step and
    as four one-token steps from the same cache, compared bit for bit: the
    logits; the first layer's q projection at M = 4B rows against four
    products of B rows (cuBLAS); and the decode kernel on the block's cache
    (S = 4 against four S = 1 calls on the same K/V and positions)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import clone_cache
    from repro_torch.models.layers import dense, rms_norm
    S = SPEC_K + 1
    logits, cache = model.prefill(toks, max_len=toks.shape[1] + 64 + SPEC_K)
    feed = [torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)]
    singles, one = [], clone_cache(cache)
    for _ in range(S):
        lg, _ = model.decode_step(one, feed[-1])
        singles.append(lg)
        feed.append(torch.argmax(lg[:, -1:], dim=-1).to(torch.int32))
    blk = torch.cat(feed[:S], dim=1)
    block = clone_cache(cache)
    lb, _ = model.decode_step(block, blk)
    ls = torch.cat(singles, dim=1)
    blk0 = model.blocks[0]
    xn = rms_norm(model._embed(blk), blk0.ln1, model.cfg.norm_eps)
    w = model._ws(blk0.attn)["w_q"]
    qa = dense(xn, w, "bsd,dhe->bshe")
    qb = torch.cat([dense(xn[:, i:i + 1], w, "bsd,dhe->bshe")
                    for i in range(S)], dim=1)
    k, v, kp = block["k"][0], block["v"][0], block["pos_ids"]
    qp = cache["pos"][:, None] + torch.arange(S, dtype=torch.int32,
                                              device=DEVICE)
    oa = ops.flash_decode(qa, k, v, qp, kp)
    ob = torch.cat([ops.flash_decode(qa[:, i:i + 1], k, v, qp[:, i:i + 1],
                                     kp) for i in range(S)], dim=1)
    torch.cuda.synchronize()

    def cmp(a, b):
        d = (a.float() - b.float()).abs()
        return (f"{bool(torch.equal(a, b))} ({int((a != b).sum())} of "
                f"{a.numel()} differ, max {d.max().item():.3e})")
    log("spec/rounding", f"a verify block against {S} one-token steps, "
        f"bf16: logits equal {cmp(lb, ls)}; layer 0 q projection (M "
        f"{qa.shape[0] * S} vs {qa.shape[0]}) equal {cmp(qa, qb)}; decode "
        f"kernel S {S} vs S 1 equal {cmp(oa, ob)}")


def _first_differences(got: np.ndarray, want: np.ndarray) -> str:
    """'row@token' of each row of ``got`` that differs from ``want``."""
    diff = np.argwhere(got != want)
    return ", ".join(f"{r}@{diff[diff[:, 0] == r][0, 1]}"
                     for r in sorted(set(diff[:, 0].tolist())))


def _differing_requests(got: list, want: list) -> str:
    """'uid@token' of each completion of ``got`` that differs from
    ``want`` (both as ``_completions`` gives them)."""
    by_uid = {c[0]: c[2] for c in got}
    return ", ".join(
        f"{u}@" + str(next((i for i, (a, b) in enumerate(zip(t, by_uid[u]))
                            if a != b), min(len(t), len(by_uid[u]))))
        for u, _, t in want if t != by_uid[u])


def phase_spec(model, smi: str, seed: int, engine_want=None) -> dict:
    """Speculative decoding (k 3) on full-width pimref-100m, both drafters.

    In the serving dtype (bf16): batch 8 x prompt 512 (``spec_prompts``) +
    64 new tokens in chunks of 8 in every KV layout, the graph replay and
    the eager body (tokens and accepted lengths identical, exact launches,
    96 / 240 a chunk, also by the profiler's kernel events), beside the
    graph with speculation off; serve() with speculation (its draft drafter
    must accept drafts); the engine's drains of the engine phase's requests
    (one capture, every page back). A verify block computes its rows with
    other kernel shapes than one-token steps (``spec_rounding`` logs which
    results differ), so a bf16 rounding may differ and a greedy stream
    part from speculation off: in bf16 that is recorded. Greedy identity
    with speculation off is held in fp32 (``spec_fp32``), whose roundings
    are too small to flip these tokens, while a fault of the speculative
    path would show there too. Every comparison runs; the phase fails at
    its end, naming each that failed. Returns the launches of each graph
    run."""
    from repro_torch.launch.serve import serve
    launches, failed = {}, []
    toks = spec_prompts(model.cfg.vocab_size, seed=seed)
    gen, chunk = 64, 8
    for layout, (kv_quant, page_size, decode_kernel) in LAYOUTS.items():
        m = model.with_kv_layout(kv_quant, page_size)
        _reset()
        off = spec_drain(m, toks, "off", gen, chunk)
        _check_launches(f"spec/{layout}/off", m.cfg, 1, off["decode_steps"],
                        decode_kernel)
        off_dev = graph_device_ms(m, toks, gen, chunk)[0]
        log(f"spec/{layout}/off", f"{smi}: decode "
            f"{off['wall_s'] * 1e3 / gen:.4f} ms/token-step, "
            f"{off['wall_s'] * 1e3 / off['committed']:.4f} ms per committed "
            f"token, device {off_dev:.4f} ms per step")
        for mode in SPEC_MODES:
            label = f"spec/{layout}/{mode}"
            runs = {}
            for name in ("graph", "eager"):
                _reset()
                run = spec_drain(m, toks, mode, gen, chunk,
                                 eager=name == "eager")
                got = _check_launches(f"{label}/{name}", m.cfg, 1,
                                      run["decode_steps"], decode_kernel,
                                      run["draft_steps"],
                                      run["draft_layers"])
                if name == "graph":
                    launches[label] = got
                per_chunk = chunk * (m.cfg.num_layers
                                     + SPEC_K * run["draft_layers"])
                if got[decode_kernel] != per_chunk * (run["chunks"] + 1):
                    raise AssertionError(f"{label}/{name}: {got} is not "
                                         f"{per_chunk} a chunk")
                log(f"{label}/{name}", f"{smi}: {run['chunks']} chunks, "
                    f"decode {run['wall_s'] * 1e3 / gen:.4f} ms/token-step, "
                    f"{run['wall_s'] * 1e3 / run['committed']:.4f} ms per "
                    f"committed token ({run['committed']} committed), "
                    f"accepted_len_per_draft {run['accepted_len']:.4f}, "
                    f"{per_chunk} decode-kernel launches a chunk"
                    + (f", capture {run['capture_s'] * 1e3:.3f} ms (its "
                       "eager warm-up chunk included)"
                       if name == "graph" else ""))
                runs[name] = run
            g, e = runs["graph"], runs["eager"]
            same = (np.array_equal(g["tokens"], e["tokens"])
                    and np.array_equal(g["acc"], e["acc"]))
            as_off = np.array_equal(g["tokens"], off["tokens"])
            dev = graph_device_ms(m, toks, gen, chunk, mode)[0]
            log(label, f"graph == eager body (tokens and accepted lengths): "
                f"{same}; bf16 tokens == speculation off: {as_off}"
                + ("" if as_off else " (rows@first differing token: "
                   + _first_differences(g["tokens"], off["tokens"]) + ")")
                + f"; device {dev:.4f} ms per iteration ({off_dev:.4f} a "
                f"step off), wall {g['wall_s'] * 1e3 / gen:.4f} "
                f"ms/token-step against {off['wall_s'] * 1e3 / gen:.4f} off "
                f"({off['wall_s'] / g['wall_s']:.2f}x)")
            if not same:
                failed.append(f"{label}: graph and eager body differ")
    spec_rounding(model, toks)
    for mode in SPEC_MODES:
        _spec_profile(model, toks, mode, f"spec/profile/{mode}")
    # serve(), the entry point, on its own random batch
    kw = dict(model=model, batch=8, prompt_len=512, gen=64, chunk=8,
              seed=seed)
    want = serve(**kw)["tokens"]
    for mode in SPEC_MODES:
        _reset()
        out = serve(spec=mode, **kw)
        _check_launches(f"spec/serve/{mode}", model.cfg, 1,
                        out["decode_steps"], "flash_decode_fwd",
                        out["draft_steps"], model.cfg.num_layers // 2)
        same = np.array_equal(out["tokens"], want)
        log(f"spec/serve/{mode}", f"{smi}: serve(spec={mode!r}) decode "
            f"{out['decode_s_per_tok'] * 1e3:.4f} ms/token-step, "
            f"accepted_len_per_draft {out['accepted_len_per_draft']:.4f}, "
            f"bf16 tokens == serve() without speculation: {same}"
            + ("" if same else " (" + _first_differences(out["tokens"], want)
               + ")"))
        if mode == "draft" and not out["accepted_len_per_draft"] > 1.0:
            failed.append(f"spec/serve/draft: accepted_len_per_draft "
                          f"{out['accepted_len_per_draft']} <= 1.0")
    # the engine: the engine phase's requests, ngram and draft drains
    reqs = _engine_requests(model, seed)
    for layout in ENGINE_LAYOUTS:
        if engine_want is None or layout not in engine_want:
            off = _make_engine(model, seed, layout)
            _drain(off, reqs, f"spec/engine/{layout}/off",
                   LAYOUTS[layout][2])
            want = _completions(off)
        else:
            want = engine_want[layout]
        for mode in SPEC_MODES:
            label = f"spec/engine/{layout}/{mode}"
            eng = _make_engine(model, seed, layout, spec=mode, spec_k=SPEC_K)
            s = _drain(eng, reqs, label, LAYOUTS[layout][2])
            got = _completions(eng)
            log(label, f"bf16 completions == the spec-off drain's: "
                f"{got == want}"
                + ("" if got == want else " (requests@first differing "
                   "token: " + _differing_requests(got, want) + ")")
                + f"; {s['decode_dispatches']} chunks, "
                f"{s['graph_captures']} capture(s)")
            if s["graph_captures"] != 1:
                failed.append(f"{label}: {s['graph_captures']} captures")
    failed += spec_fp32(smi, seed)
    if failed:
        raise AssertionError("spec: " + "; ".join(failed))
    return launches


def spec_fp32(smi: str, seed: int) -> list:
    """Greedy identity with speculation off, in fp32 compute (TF32 off):
    the batch of ``spec_prompts`` in every layout (``auto`` recorded: its
    grid is chosen over each whole write, a verify block's rejected drafts
    included), both drafters, the graph replay; the engine's drains in
    its three layouts. Then the ``draft`` drafter with every layer (its
    drafts are the model's own greedy tokens): it must accept more than k
    tokens an iteration on average. Returns the checks that failed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_model
    failed = []
    cfg = get_config("pimref-100m").replace(compute_dtype="float32")
    model = load_model("pimref-100m", smoke=False, seed=seed, device=DEVICE,
                       cfg=cfg)
    toks = spec_prompts(cfg.vocab_size, seed=seed)
    offs = {}
    for layout, (kv_quant, page_size, decode_kernel) in LAYOUTS.items():
        m = model.with_kv_layout(kv_quant, page_size)
        off = offs[layout] = spec_drain(m, toks, "off")
        for mode in SPEC_MODES:
            label = f"spec_fp32/{layout}/{mode}"
            g = spec_drain(m, toks, mode)
            same = np.array_equal(g["tokens"], off["tokens"])
            log(label, f"{smi}: fp32 tokens == speculation off: {same}"
                + ("" if same else " (" + _first_differences(
                    g["tokens"], off["tokens"]) + ")")
                + f"; accepted_len_per_draft {g['accepted_len']:.4f}, "
                f"decode {g['wall_s'] * 1e3 / 64:.4f} ms/token-step "
                f"({off['wall_s'] * 1e3 / 64:.4f} off)")
            if not same and kv_quant != "auto":
                failed.append(f"{label}: fp32 greedy tokens differ from "
                              "speculation off")
    step_all = spec_drain(model, toks, "draft", draft_layers=cfg.num_layers)
    same = np.array_equal(step_all["tokens"], offs["contiguous"]["tokens"])
    log("spec_fp32/contiguous/draft_all_layers", f"draft through all "
        f"{cfg.num_layers} layers: accepted_len_per_draft "
        f"{step_all['accepted_len']:.4f}, tokens == speculation off: {same}")
    if not same:
        failed.append("spec_fp32/draft_all_layers: fp32 greedy tokens "
                      "differ from speculation off")
    if not step_all["accepted_len"] > SPEC_K:
        failed.append(f"spec_fp32/draft_all_layers: accepted_len_per_draft "
                      f"{step_all['accepted_len']} <= {SPEC_K}")
    reqs = _engine_requests(model, seed)
    for layout in ENGINE_LAYOUTS:
        off = _make_engine(model, seed, layout)
        off.run(list(reqs))
        want = _completions(off)
        for mode in SPEC_MODES:
            label = f"spec_fp32/engine/{layout}/{mode}"
            eng = _make_engine(model, seed, layout, spec=mode, spec_k=SPEC_K)
            eng.run(list(reqs))
            got = _completions(eng)
            drained = not eng.paged or (eng.stats["kv_pages_in_use"] == 0
                                        and not eng._host_table.any())
            log(label, f"fp32 completions == the spec-off drain's: "
                f"{got == want}" + ("" if got == want else " (" +
                                    _differing_requests(got, want) + ")")
                + f"; accepted_len_per_draft "
                f"{eng.stats['spec_accepted_len_per_draft']:.4f}"
                + ("; every page back" if eng.paged and drained else ""))
            if not drained:
                failed.append(f"{label}: pages left in use")
            if got != want:
                failed.append(f"{label}: fp32 completions differ from "
                              "speculation off")
    del model
    torch.cuda.empty_cache()
    return failed


# ---------------------------------------------------------------------------
# the decode chunk: a CUDA graph replay against its eager body
# ---------------------------------------------------------------------------
ENGINES = ("graph", "eager", "loop")


def eager_step(model, **kw):
    """A ``GenerateStep`` that runs the fused chunk's body eagerly on the
    card instead of replaying its graph: the yardstick the graph is checked
    and timed against (the port has no knob for it)."""
    from repro_torch.launch.steps import GenerateStep

    class EagerChunk(GenerateStep):
        def prepare(self, cache, tok, generator, hist=None, hist_len=None, *,
                    arm=None):
            self._warm_up(cache, tok, self._state(hist, hist_len),
                          self._arm(arm))

        def __call__(self, cache, tok, generator, eos_id, hist=None,
                     hist_len=None, *, arm=None):
            return self._eager(cache, tok, generator, eos_id,
                               *self._state(hist, hist_len),
                               arm=self._arm(arm))

    return EagerChunk(model, **kw)


@contextlib.contextmanager
def eager_chunks():
    """Inside, ``serve()`` and ``ServeEngine`` run the fused chunk's body
    eagerly (``eager_step``) instead of replaying its graph."""
    from repro_torch.launch import engine, serve
    saved = serve.make_generate_step, engine.make_generate_step
    serve.make_generate_step = engine.make_generate_step = eager_step
    try:
        yield
    finally:
        serve.make_generate_step, engine.make_generate_step = saved


def _serve_as(name: str, **kw) -> dict:
    """``serve()`` with one of ENGINES."""
    from repro_torch.launch.serve import serve
    with eager_chunks() if name == "eager" else contextlib.nullcontext():
        return serve(engine="loop" if name == "loop" else "fused", **kw)


def graph_device_ms(m, toks, gen, chunk, spec="off",
                    logits_hook=None) -> tuple:
    """Device ms per iteration (a token-step without speculation) of the
    captured chunk (with ``logits_hook``: hooked, every slot disarmed): the
    prompts ``toks`` prefilled, the chunk captured on their cache, then
    back-to-back replays (the first alone, then ``gen // chunk - 1``) timed
    by CUDA events. Returns (ms per iteration of the later replays, ms of
    the first replay, which uploads the graph to the card)."""
    step = _spec_start(m, toks, spec, gen, chunk,
                       logits_hook=logits_hook)[0]
    graph = step._captured.graph      # the replays alone, no host work between
    replays = gen // chunk - 1
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    graph.replay()
    ev[1].record()
    for _ in range(replays):
        graph.replay()
    ev[2].record()
    torch.cuda.synchronize()
    return (ev[1].elapsed_time(ev[2]) / (replays * chunk),
            ev[0].elapsed_time(ev[1]))


def _serve_engines(model, smi, label, decode_kernel="flash_decode_fwd",
                   **kw) -> dict:
    """Batch serving with each of ENGINES after a short warm-up run: exact
    launches, tokens in range, graph == eager chunk == loop tokens, the
    graph's decode ms per token-step below the eager chunk's; logs the
    graph's device ms per step; returns the graph run's launches."""
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    serve(model=model, engine="fused", **{**kw, "gen": 8})   # first calls
    runs, launches = {}, None
    for name in ENGINES:
        _reset()
        out = _serve_as(name, model=model, **kw)
        got = _check_launches(f"{label}/{name}", cfg, out["prefills"],
                              out["decode_steps"], decode_kernel)
        if name == "graph":
            launches = got
        toks = out["tokens"]
        if toks.shape != (kw["batch"], kw["gen"]) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label}/{name}: bad tokens {toks.shape} "
                                 f"[{toks.min()}, {toks.max()}]")
        log(f"{label}/{name}", f"{smi}: prefill "
            f"{out['prefill_s'] * 1e3:.3f} ms (B={kw['batch']} x "
            f"{kw['prompt_len']}), decode "
            f"{out['decode_s_per_tok'] * 1e3:.4f} ms/token-step, "
            f"{out['throughput_tok_s']:.1f} tokens/s, "
            f"{out['dispatches']} host syncs"
            + (f", capture {out['capture_s'] * 1e3:.3f} ms (its eager "
               "warm-up chunk included)" if name == "graph" else ""))
        runs[name] = out
    same = all(np.array_equal(runs["graph"]["tokens"], runs[n]["tokens"])
               for n in ENGINES[1:])
    log(label, f"graph == eager chunk == loop tokens: {same}")
    if not same:
        raise AssertionError(f"{label}: greedy tokens of {ENGINES} differ")
    m = model.with_kv_layout(kw.get("kv_quant", "off"),
                             kw.get("page_size", 0))
    rng = np.random.default_rng(kw["seed"])        # serve()'s prompts
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (kw["batch"], kw["prompt_len"])).astype(
            np.int32)).to(DEVICE)
    dev, first = graph_device_ms(m, toks, kw["gen"], kw["chunk"])
    g, e = (runs[n]["decode_s_per_tok"] * 1e3 for n in ("graph", "eager"))
    log(label, f"{smi}: decode ms per token-step: graph {g:.4f}, its device "
        f"time {dev:.4f} (wall / device {g / dev:.2f}; a first replay "
        f"{first:.3f} ms, {first / kw['chunk']:.4f} a step); eager chunk "
        f"{e:.4f} ({e / g:.2f}x the graph)")
    if not g < e:
        raise AssertionError(f"{label}: the graph's decode ({g:.4f} ms per "
                             f"token-step) is not below the eager chunk's "
                             f"({e:.4f})")
    return launches


def phase_serve_griffin(model, smi: str) -> dict:
    """recurrentgemma-2b batch serving at B 8 x 512 + 64, then one long
    request (B 2 x 2100 + 32) whose prompt crosses the local window, so the
    prefill keeps the last 2048 positions and every decode write wraps the
    ring. Returns the launches of the two graph runs."""
    launches = _serve_engines(model, smi, "serve_griffin", batch=8,
                              prompt_len=512, gen=64, chunk=8, seed=0)
    W = model.cfg.local_window
    if model.cache_len(2100 + 32) != W:
        raise AssertionError(f"long request: ring of "
                             f"{model.cache_len(2132)} slots, not {W}")
    long = _serve_engines(model, smi, "serve_griffin/long", batch=2,
                          prompt_len=2100, gen=32, chunk=8, seed=1)
    return launches, long


def phase_engine_griffin(model, seed: int) -> None:
    """16 mixed-length requests through 8 slots of one contiguous cache,
    graph against eager body; then a seeded chaos drain (``nan=2,fail=1``)
    and a snapshot / restore (contiguous: regenerated) against the graph
    drain."""
    from repro_torch.launch.serve import make_queue_engine, synth_requests
    reqs = synth_requests(cfg=model.cfg, requests=16, prompt_len=256, gen=64,
                          seed=seed)

    def make(**kw):
        return make_queue_engine(model=model, slots=8, prompt_len=256,
                                 gen=64, chunk=8, seed=seed, **kw)
    _, want = _drain_pair(make, reqs, "engine_griffin", "flash_decode_fwd")
    clean = {uid: (finish, toks) for uid, finish, toks in want}
    _robust_chaos(make, reqs, clean, "engine_griffin/chaos",
                  plan="nan=2,fail=1", seed=seed)
    _robust_restore(make, reqs, clean, "engine_griffin/restore")


def _rel_err(c, g) -> float:
    """max |CPU - card| over max |CPU| (at least 1)."""
    return ((c - g.cpu()).abs().max() / c.abs().max().clamp(min=1)).item()


def phase_parity_griffin(seed: int) -> dict:
    """recurrentgemma-2b at full width, depth cut to 5 layers, fp32: logits
    of a 64-token prefill and 8 decode steps, and the caches, card vs CPU;
    returns the launches of the card's side."""
    from repro_torch.configs import get_config
    from repro_torch.models import GriffinLM, init_params
    full = get_config("recurrentgemma-2b")
    cfg = full.replace(num_layers=GRIFFIN_PARITY_LAYERS,
                       compute_dtype="float32")
    print(f"parity_griffin depth cut: {full.name} {full.num_layers} -> "
          f"{cfg.num_layers} layers (one (rec, rec, local attention) group "
          "+ 2 trailing rec), full width d_model 2560, 10 q / 1 kv heads x "
          "256, d_ff 7680, vocab 256000, fp32", flush=True)
    state = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    cpu = GriffinLM(cfg, device="cpu")
    cpu.load_state_dict(state)
    gpu = GriffinLM(cfg, device=DEVICE)
    gpu.load_state_dict(state)
    del state
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                              .astype(np.int32))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    lc, cc = cpu.prefill(prompt, max_len=72)
    _reset()
    lg, cg = gpu.prefill(prompt.to(DEVICE), max_len=72)
    pairs = [(lc, lg)]
    for i in range(feed.shape[1]):
        lc, cc = cpu.decode_step(cc, feed[:, i:i + 1])
        lg, cg = gpu.decode_step(cg, feed[:, i:i + 1].to(DEVICE))
        pairs.append((lc, lg))
    errs = [(c - g.cpu()).abs().max().item() for c, g in pairs]
    agree = np.mean([float((c.argmax(-1) == g.cpu().argmax(-1)).all())
                     for c, g in pairs])
    leaves = {f"{n}.{m}": (cc[n][m], cg[n][m]) for n in ("rec1", "rec2")
              for m in ("h", "conv")}
    leaves.update({f"tail.{i}.{m}": (t[m], cg["tail"][i][m])
                   for i, t in enumerate(cc["tail"]) for m in ("h", "conv")})
    leaves.update({n: (cc[n], cg[n]) for n in ("k", "v")})
    rel = {n: _rel_err(c, g) for n, (c, g) in leaves.items()}
    same_pos = all(torch.equal(cc[n], cg[n].cpu()) for n in ("pos_ids", "pos"))
    log("parity_griffin", f"fp32 logits card vs CPU, prefill 64 + 8 decode "
        f"steps: max_abs_err per call {['%.2e' % e for e in errs]} (tol "
        f"{PARITY_GRIFFIN_ATOL:.0e}), logit scale "
        f"{pairs[0][0].abs().max().item():.3e}, top-1 agreement {agree:.3f}; "
        f"cache error / max |value| "
        f"{ {n: float('%.2e' % e) for n, e in rel.items()} } (tol "
        f"{PARITY_GRIFFIN_REL:.0e}); positions equal {same_pos}")
    if max(errs) > PARITY_GRIFFIN_ATOL or max(rel.values()) > \
            PARITY_GRIFFIN_REL or not same_pos:
        raise AssertionError(f"parity_griffin: card vs CPU differ: logits "
                             f"{max(errs)}, cache {max(rel.values())}, "
                             f"positions equal {same_pos}")
    return _check_fp32_prefills("parity_griffin", cfg, 1)


# counter -> the kernel whose launches the profiler counts for it
PROFILED = {"flash_attention_fwd": "flash_prefill_kernel<",
            "flash_decode_fwd": "flash_decode_kernel<",
            "rglru_scan": "rglru_scan_kernel<"}


def phase_profile(model, smi: str, label: str = "profile") -> None:
    """``torch.profiler`` over one batch-mode serve (B 8 x 512, prefill, the
    warm-up chunk and two chunks of 8) with the graph and with the eager
    chunk: busy share, kernels by device time, and the launches of the
    prefill, decode and RG-LRU kernels by the profiler's kernel events
    against the launch counters."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    kw = dict(model=model, batch=8, prompt_len=512, gen=16, chunk=8, seed=0)
    serve(engine="fused", **kw)                   # allocator and cuBLAS warm
    torch.cuda.synchronize()
    for name in ("graph", "eager"):
        _reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = _serve_as(name, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in kern)
        launches = sum(e.count for e in kern)
        tag = f"{label}/{name}"
        log(tag, f"{smi}: {model.cfg.name} serve B=8 prompt 512, prefill + "
            f"warm-up chunk + 2 chunks of 8: wall {wall * 1e3:.3f} ms (the "
            f"capture {out['capture_s'] * 1e3:.3f} ms), device busy "
            f"{busy_us / 1e3:.3f} ms ({busy_us / 1e4 / wall:.1f}% busy; "
            f"{busy_us / 1e4 / (wall - out['capture_s']):.1f}% of the wall "
            f"outside the capture), {launches} kernel launches of "
            f"{len(kern)} kernels; decode "
            f"{out['decode_s_per_tok'] * 1e3:.4f} ms/token-step")
        counted = {n: c for counter in _counters() for n, c in counter.items()}
        seen = {n: sum(e.count for e in kern if k in e.key)
                for n, k in PROFILED.items()}
        want = {n: counted[n] for n in PROFILED}
        log(tag, f"launches by the profiler's kernel events {seen}, by the "
            f"counters {want}")
        if seen != want:
            raise AssertionError(f"{tag}: the profiler counted {seen}, the "
                                 f"counters {want}")
        ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
        # the top twelve, and every attention and RG-LRU kernel of the port
        for e in ranked[:12] + [e for e in ranked[12:]
                                if "flash_" in e.key or "rglru_" in e.key]:
            log(tag, f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x  {e.key[:90]}")


# ---------------------------------------------------------------------------
# Proteus: the quantized matmul, narrow values, int4 packing, the adapter
# ---------------------------------------------------------------------------
def _projections(model) -> dict:
    """Every projection weight of a dense model as a (K, N) matrix: q / k / v
    (d, H * Dh), out (H * Dh, d), gate / up (d, F), down (F, d)."""
    out = {}
    for name, p in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w_q", "w_k", "w_v"):
            out[name] = p.reshape(p.shape[0], -1)
        elif leaf == "w_o":
            out[name] = p.reshape(-1, p.shape[-1])
        elif leaf in ("wi_gate", "wi_up", "wo"):
            out[name] = p
    return out


def _qmm_check(name, got, want) -> float:
    """|got - want| <= QMM_ATOL + QMM_RTOL |want| everywhere; returns the
    max abs error."""
    err = (got - want).abs()
    excess = (err - QMM_RTOL * want.abs()).max().item()
    if excess > QMM_ATOL:
        raise AssertionError(f"quant_matmul {name}: |kernel - plain| exceeds "
                             f"{QMM_ATOL} + {QMM_RTOL} |plain| by {excess}")
    return err.max().item()


def _edge_sweep(block: int) -> torch.Tensor:
    """One edge value per block among zeros: 0, +-1, +-(2^k - 1), +-2^k,
    +-(2^k + 1) for k <= 30, INT32_MAX, INT32_MIN."""
    mags = {0, 1} | {v for k in range(31) for v in (2 ** k - 1, 2 ** k,
                                                    2 ** k + 1)}
    vals = sorted(mags | {-m for m in mags} | {2 ** 31 - 1, -2 ** 31})
    x = torch.zeros(len(vals), block, dtype=torch.int64)
    x[:, block // 2] = torch.tensor(vals, dtype=torch.int64)
    return x.reshape(-1).to(torch.int32).to(DEVICE)


def _proteus_drive(model, gen) -> tuple:
    """The Proteus entry points once each where the path calls them, every
    result checked; returns (max errors by kernel, calls by kernel, the
    timed quant_matmul shapes, the parameter vector's int16-grid codes)."""
    from repro_torch.core import proteus
    from repro_torch.kernels import narrow_value as nv
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    errs, calls = {}, dict.fromkeys(REPLACES, 0)
    calls["flash_attention_fwd_fp32"] = 0

    # -- quant_matmul: every projection weight as int8 and int4 codes -------
    weights = _projections(model)
    xs, worst = {}, {}
    for name, w in weights.items():
        K, N = w.shape
        if K not in xs:
            xs[K] = randn(gen, (QMM_ROWS, K), torch.float32)
        x = xs[K]
        exact = x @ w
        for bits in (8, 4):
            codes, scales = qm.quantize_weights(w, block_k=QMM_BLOCK_K,
                                                bits=bits)
            got = qm.quant_matmul(x, codes, scales, block_k=QMM_BLOCK_K)
            calls["quant_matmul"] += 1
            e = _qmm_check(f"{name} int{bits}", got,
                           qm.quant_matmul_ref(x, codes, scales))
            fmt = ((got - exact).abs().max() / exact.abs().max()).item()
            if not fmt < QMM_FORMAT_ERR[bits]:
                raise AssertionError(f"quant_matmul {name} int{bits}: format "
                                     f"error {fmt} >= {QMM_FORMAT_ERR[bits]}")
            key = (name.rsplit(".", 1)[-1], tuple(w.shape), bits)
            we, wf = worst.get(key, (0.0, 0.0))
            worst[key] = (max(we, e), max(wf, fmt))
    for (leaf, shape, bits), (e, fmt) in worst.items():
        log("proteus", f"quant_matmul {leaf} {shape} int{bits} x "
            f"({QMM_ROWS}, {shape[0]}) fp32, {model.cfg.num_layers} layers: "
            f"max |kernel - plain| {e:.3e} (tol {QMM_ATOL:.0e} + "
            f"{QMM_RTOL:.0e} |plain|), format error vs x @ W {fmt:.4f} "
            f"(< {QMM_FORMAT_ERR[bits]})")
    del xs
    w_up = next(w for n, w in weights.items() if n.endswith("mlp.wi_up"))
    shape_up = (QMM_ROWS,) + tuple(w_up.shape)
    shapes = {"quant_matmul": (shape_up, w_up, torch.float32),
              "quant_matmul_bf16": (shape_up, w_up, torch.bfloat16)}
    for row, (M, K, N) in QMM_SHAPES.items():
        shapes[row] = ((M, K, N), randn(gen, (K, N), torch.float32)
                       / math.sqrt(K), torch.float32)
    timed = {}
    for row, ((M, K, N), w, xdt) in shapes.items():
        codes, scales = qm.quantize_weights(w, block_k=QMM_BLOCK_K, bits=8)
        x = randn(gen, (M, K), xdt)
        got = qm.quant_matmul(x, codes, scales, block_k=QMM_BLOCK_K)
        calls["quant_matmul"] += 1
        e = _qmm_check(row, got, qm.quant_matmul_ref(x, codes, scales))
        errs[row] = e
        if row == "quant_matmul":
            errs[row] = max(e, max(v[0] for v in worst.values()))
        timed[row] = ((M, K, N), w, xdt)
        log("proteus", f"quant_matmul {QMM_LABELS[row]} (M {M}, K {K}, N "
            f"{N}, x {str(xdt)[6:]}) int8: max |kernel - plain| {e:.3e}")

    # -- required_bits: the parameter vector at int16 granularity, edges ----
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in model.parameters()])
    pad = (-flat.numel()) % 256
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mx = flat.abs().max().clamp(min=1e-20)
    codes32 = torch.round(flat / mx * INT16_MAX).to(torch.int32)
    widths = nv.required_bits(codes32, 256)
    calls["required_bits"] += 1
    _identical(f"required_bits over {flat.numel()} int16-grid codes "
               f"({pad} zeros of padding)", widths,
               nv.required_bits_ref(codes32, 256), "proteus")
    edges = _edge_sweep(256)
    edge_w = nv.required_bits(edges, 256)
    calls["required_bits"] += 1
    _identical(f"required_bits edge sweep ({edges.numel() // 256} blocks)",
               edge_w, nv.required_bits_ref(edges, 256), "proteus")
    log("proteus", "required_bits edge widths (value: bits) " + ", ".join(
        f"{v}: {b}" for v, b in zip(edges.reshape(-1, 256)[:, 128].tolist(),
                                    edge_w.tolist())
        if v in (0, 1, 2 ** 21 + 1, 2 ** 23, 2 ** 24 + 1, 2 ** 31 - 1,
                 -2 ** 31)))
    wf = widths.float()
    pct = {q: torch.quantile(wf, q / 100).item() for q in (25, 50, 75, 95)}
    log("proteus", f"{model.cfg.name} weights as int16-grid codes, "
        f"{widths.numel()} blocks of 256: required bits "
        + ", ".join(f"p{q} {v:g}" for q, v in pct.items())
        + f" of 16; blocks <= 8 bits {(widths <= 8).float().mean().item():.6f}")
    errs["required_bits"] = 0.0

    # -- pack_int4 / unpack_int4 over the vector's int4 codes ---------------
    qt = proteus.quantize(flat, bits=4, block=256)
    c4 = qt.values.reshape(-1)
    pad4 = (-c4.numel()) % 512
    if pad4:
        c4 = torch.cat([c4, c4.new_zeros(pad4)])
    packed = nv.pack_int4(c4)
    calls["pack_int4"] += 1
    _identical(f"pack_int4 over {c4.numel()} int4 codes ({pad4} zeros of "
               "padding)", packed, nv.pack_int4_ref(c4), "proteus")
    unpacked = nv.unpack_int4(packed)
    calls["unpack_int4"] += 1
    _identical(f"unpack_int4 over {packed.numel()} bytes", unpacked,
               nv.unpack_int4_ref(packed), "proteus")
    _identical("int4 round trip unpack(pack(codes)) == codes", unpacked, c4,
               "proteus")
    errs["pack_int4"] = errs["unpack_int4"] = 0.0

    # -- flash_attention_bh at 8 x 12 heads of 64 ---------------------------
    BH, D = BH_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        for S in BH_LENGTHS:
            for window in BH_WINDOWS:
                q, k, v = (randn(gen, (BH, S, D), dt) for _ in range(3))
                o = fk.flash_attention_bh(q, k, v, causal=True, window=window)
                calls["flash_attention_bh"] += 1
                calls["flash_attention_fwd_fp32"] += dt == torch.float32
                name = (f"flash_attention_bh BH{BH} S=T={S} D{D} causal "
                        f"window {window} {str(dt)[6:]}")
                want = ref.attention_ref_bh(q, k, v, causal=True,
                                            window=window)
                if dt == torch.bfloat16:
                    e = _check_bf16(name, o, want, ref.attention_ref_bh(
                        q.float(), k, v.abs(), causal=True, window=window),
                        phase="proteus")
                else:
                    e = _check(name, o, want, TOL[dt], phase="proteus")
                if (S, window) == (BH_LENGTHS[0], 0):
                    errs["flash_attention_bh" if dt == torch.bfloat16
                         else "flash_attention_bh_fp32"] = e
    return errs, calls, timed, codes32, c4, packed


def phase_proteus(model, seed: int) -> tuple:
    """The Proteus library on the card; returns (rows, launches) of its
    kernels."""
    import torch.nn.functional as F
    from repro_torch.kernels import narrow_value as nv
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    _reset()
    errs, calls, timed, codes32, c4, packed = _proteus_drive(model, gen)
    torch.cuda.synchronize()
    got = {n: c for counter in _counters() for n, c in counter.items()}
    want = dict.fromkeys(got, 0)
    want.update({n: calls[n] for n in ("quant_matmul", "required_bits",
                                       "pack_int4", "unpack_int4",
                                       "flash_attention_bh")})
    want["flash_attention_fwd"] = calls["flash_attention_bh"]
    want["flash_attention_fwd_fp32"] = calls["flash_attention_fwd_fp32"]
    log("proteus", f"launches {got} (want {want}: one per call, the adapter's "
        "through the prefill kernel, its fp32 calls through the fp32 "
        "route)")
    if got != want:
        raise AssertionError(f"proteus: launches {got} != {want}")
    launches = {n: got[n] for n in ("quant_matmul", "required_bits",
                                    "pack_int4", "unpack_int4",
                                    "flash_attention_bh")}
    rows = {}

    # -- device times: every input of the kernel (x, codes, scales) and of
    #    the yardstick (x, the dequantized fp32 weight) cycles through
    #    n_sets full copies, so none of them is read from the L2 ----------
    for row, ((M, K, N), w, xdt) in timed.items():
        esize = torch.tensor([], dtype=xdt).element_size()
        nkb = K // QMM_BLOCK_K
        n_sets = n_sets_for(M * K * esize + K * N + nkb * N * 4)
        sets = []
        for j in range(n_sets):
            wj = w if j == 0 else randn(gen, (K, N), torch.float32) / math.sqrt(K)
            sets.append((randn(gen, (M, K), xdt),
                         *qm.quantize_weights(wj, block_k=QMM_BLOCK_K,
                                              bits=8)))
        x0, c0, s0 = sets[0]
        first = qm.quant_matmul(x0, c0, s0, block_k=QMM_BLOCK_K)
        again = qm.quant_matmul(x0, c0, s0, block_k=QMM_BLOCK_K)
        _identical(f"quant_matmul {QMM_LABELS[row]}: two calls on the same "
                   "inputs", again, first, "proteus")
        del first, again
        iters = 5 if M * K * N > 1e10 else 20
        t_k = device_ms(lambda j: qm.quant_matmul(
            *sets[j], block_k=QMM_BLOCK_K), n_sets, iters)
        t_p = device_ms(lambda j: qm.quant_matmul_ref(*sets[j]), n_sets,
                        iters)
        # fp32 x and weight built before the timing: only the product is
        # timed
        lib = [(x.float(), qm.dequantize_ref(c, sc)) for x, c, sc in sets]
        t_l = device_ms(lambda j: torch.matmul(*lib[j]), n_sets, iters)
        del sets, lib
        nbytes = M * K * esize + K * N + nkb * N * 4 + M * N * 4
        flops = 2.0 * M * N * K
        # the route: bf16 tensor-core passes (three exact bf16 parts of an
        # fp32 x, one of a bf16 x); the fp32 CUDA-core bound beside it
        passes = 3 if xdt == torch.float32 else 1
        b_ms, b_by = bound_ms(nbytes, passes * flops, torch.bfloat16)
        b32_ms, b32_by = bound_ms(nbytes, flops, torch.float32)
        log("proteus", f"quant_matmul times, {QMM_LABELS[row]} (M {M}, K {K}, "
            f"N {N}, x {str(xdt)[6:]}, int8 codes, block_k {QMM_BLOCK_K}, "
            f"{n_sets} input sets): kernel {t_k:.4f} ms "
            f"({flops / t_k / 1e9:.2f} TFLOP/s of the product), plain "
            f"{t_p:.4f} ms, torch.matmul of fp32 x and the pre-dequantized "
            f"fp32 weight "
            f"{t_l:.4f} ms (4x the weight bytes, no scales; a yardstick, not "
            f"a port), bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {passes} x "
            f"{flops:.3e} FLOP at 989 TFLOP/s bf16; {b_ms / t_k:.1%} of it), "
            f"fp32 CUDA-core bound {b32_ms:.4f} ms ({b32_by}); plan "
            f"{qm.plan(M, N, K, QMM_BLOCK_K, xdt)}")
        rows[row] = dict(max_abs_err=errs[row], ms=t_k, plain_ms=t_p,
                         bound_ms=b_ms, bound_by=b_by, library_ms=t_l)

    narrow = {
        # name: (kernel call, plain call, input, bytes in + out)
        "required_bits": (lambda t: nv.required_bits(t, 256),
                          lambda t: nv.required_bits_ref(t, 256), codes32,
                          codes32.nbytes + codes32.numel() // 256 * 4),
        "pack_int4": (nv.pack_int4, nv.pack_int4_ref, c4,
                      c4.nbytes + c4.numel() // 2),
        "unpack_int4": (nv.unpack_int4, nv.unpack_int4_ref, packed,
                        packed.nbytes + 2 * packed.numel()),
    }
    for name, (kern, plain, t, nbytes) in narrow.items():
        n_sets = n_sets_for(t.nbytes)
        sets = [t] + [t.clone() for _ in range(n_sets - 1)]
        t_k = device_ms(lambda j: kern(sets[j]), n_sets, 20)
        t_p = device_ms(lambda j: plain(sets[j]), n_sets, 5)
        del sets
        b_ms, b_by = bound_ms(nbytes, 0.0, torch.float32)
        rows[name] = dict(max_abs_err=errs[name], ms=t_k, plain_ms=t_p,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log("proteus", f"{name} times ({t.numel()} {str(t.dtype)[6:]} in): "
            f"kernel {t_k:.4f} ms ({nbytes / (t_k * 1e-3) / 1e12:.3f} TB/s), "
            f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B); "
            f"library: none ({NO_LIBRARY_NARROW[name]})")

    BH, D = BH_SHAPE
    S = BH_LENGTHS[0]
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE)[None]
    flops = 4.0 * D * BH * visible_pairs(pos, pos, True, 0)
    for row, dt in (("flash_attention_bh", torch.bfloat16),
                    ("flash_attention_bh_fp32", torch.float32)):
        nbytes = 4 * BH * S * D * (2 if dt == torch.bfloat16 else 4)
        n_sets = n_sets_for(nbytes)
        sets = [tuple(randn(gen, (BH, S, D), dt) for _ in range(3))
                for _ in range(n_sets)]
        t_k = device_ms(lambda j: fk.flash_attention_bh(*sets[j],
                                                        causal=True),
                        n_sets, 20)
        t_p = device_ms(lambda j: ref.attention_ref_bh(*sets[j], causal=True),
                        n_sets, 4)
        # as (1, BH, S, D): SDPA takes its flash backend for 4-D inputs only
        t_l = device_ms(lambda j: F.scaled_dot_product_attention(
            *(t[None] for t in sets[j]), is_causal=True), n_sets, 20)
        del sets
        if dt == torch.bfloat16:
            (b_ms, b_by), core = bound_ms(nbytes, flops, dt), ""
        else:
            (b_ms, b_by), (c_ms, c_by) = fp32_route_bound(nbytes, flops)
            core = (f"; {FP32_ROUTE_PASSES} bf16 passes; fp32 CUDA-core bound "
                    f"{c_ms:.4f} ms ({c_by})")
        rows[row] = dict(max_abs_err=errs[row], ms=t_k, plain_ms=t_p,
                         bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        log("proteus", f"flash_attention_bh times (BH {BH}, S=T={S}, D {D}, "
            f"{str(dt)[6:]}, causal): kernel {t_k:.4f} ms, plain {t_p:.4f} "
            f"ms, sdpa {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
            f"{flops:.3e} FLOP{core})")
    return rows, launches


# ---------------------------------------------------------------------------
# training: pimref-100m through the port's train(), the kernel under
# autograd at the train shape, card vs CPU steps and bitwise resume
# ---------------------------------------------------------------------------
def _flat_counts() -> dict:
    return {n: c for counter in _counters() for n, c in counter.items()}


def _event_ms(fn, iters: int) -> float:
    """Host-launched ``fn()`` (autograd work a graph does not capture here)
    timed by CUDA events over ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_time_us(e) -> float:
    """An op event's device time including its children's kernels."""
    return getattr(e, "device_time_total", None) or \
        getattr(e, "cuda_time_total", 0.0)


def _attention_train_flops(B, H, D, pairs, L=1) -> tuple:
    """(forward, forward + backward) attention FLOPs over the visible
    (q, kv) pairs: the forward's two products, the backward's five (the
    scores recomputed, dp, dv, dq, dk)."""
    fwd = 4.0 * B * H * D * pairs * L
    return fwd, fwd * (1 + 10 / 4)


def phase_train(smi: str, seed: int) -> dict:
    """pimref-100m trained through ``repro_torch.launch.train.train`` on the
    card: 12 guarded AdamW steps of batch 4 x seq 4096, bf16 compute,
    ``remat="block"``, a checkpoint every 4 steps; then one profiled step.
    Returns the launches of the run."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import TRAIN_4K, RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import make_optimizer
    cfg = get_config("pimref-100m")
    B, S, L = TRAIN_BATCH, TRAIN_4K.seq_len, cfg.num_layers
    n_params = count_params(cfg)
    run = RunConfig(warmup_steps=2, learning_rate=3e-4, microbatches=1,
                    total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
                    seed=seed)
    log("train", f"{smi}: pimref-100m full width ({n_params} params, param "
        f"{cfg.param_dtype}, compute {cfg.compute_dtype}, remat "
        f"{cfg.remat!r}, AdamW), batch {B} x seq {S}: the sequence of the "
        f"repo's {TRAIN_4K.name} shape, its batch cut from "
        f"{TRAIN_4K.global_batch} to {B} so that a step fits one card in one "
        f"microbatch within the smoke's time; {TRAIN_STEPS} steps, warm-up "
        f"{run.warmup_steps}, lr {run.learning_rate}, a checkpoint every "
        f"{run.checkpoint_every}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        t0 = time.perf_counter()
        out = train("pimref-100m", smoke=False, steps=TRAIN_STEPS, batch=B,
                    seq=S, run=run, checkpoint_dir=d, device=DEVICE,
                    log_every=1)
        wall = time.perf_counter() - t0
        total = _flat_counts()
        saved = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(out["losses"])
    log("train", f"losses {[float('%.4f' % x) for x in losses]}; skipped "
        f"{out['skipped_steps']}; checkpoints kept {saved}; {wall:.2f} s for "
        f"the run (checkpoint writes and the first step's warm-up included); "
        f"peak device memory {peak / 1e9:.2f} GB")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or out["skipped_steps"]:
        raise AssertionError(f"train: losses {losses}, skipped "
                             f"{out['skipped_steps']}")
    if not losses[-3:].mean() < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    want = dict.fromkeys(total, 0)
    want["flash_attention_fwd"] = 2 * L * TRAIN_STEPS
    if total != want:
        raise AssertionError(f"train: launches {total}, want {want} (forward "
                             f"and recompute of {L} layers in each of "
                             f"{TRAIN_STEPS} steps, bf16 route)")
    log("train", f"launches {total} in {TRAIN_STEPS} steps: {2 * L} a step "
        f"(the bf16 route: forward + the remat recompute per layer; the "
        f"profiled step below holds one step to exactly that)")

    # host share: the numpy batch at S 4096 (a Python loop over positions)
    bf = make_batch_fn(cfg, ShapeConfig("custom", S, B, "train"), seed=seed)
    t0 = time.perf_counter()
    for i in range(2):
        bf(TRAIN_STEPS + i)
    batch_s = (time.perf_counter() - t0) / 2
    secs = np.asarray(out["step_seconds"][1:])
    step_s = float(np.median(secs))
    tokens = B * S
    fwd_attn, train_attn = _attention_train_flops(B, cfg.num_heads,
                                                  cfg.resolved_head_dim,
                                                  S * (S + 1) // 2, L)
    model_flops = 6.0 * n_params * tokens
    log("train", f"{smi}: step wall (host clock, step start to loss read) median "
        f"{step_s * 1e3:.1f} ms of steps 1-{TRAIN_STEPS - 1} "
        f"({', '.join('%.1f' % (x * 1e3) for x in secs)} ms; step 0 "
        f"{out['step_seconds'][0] * 1e3:.1f} ms); the numpy batch {batch_s * 1e3:.1f} "
        f"ms a step on the host ({batch_s / step_s:.1%} of the step); "
        f"{tokens / step_s:.1f} tokens/s; model-FLOP share 6 N tokens / "
        f"(step s x 989e12) = {model_flops / (step_s * 989e12):.2%} (N "
        f"{n_params}, {model_flops:.3e} FLOP a step); attention beside it "
        f"{train_attn:.3e} FLOP a step (forward {fwd_attn:.3e}, causal pairs "
        f"only; the plain backward computes every tile), "
        f"{(model_flops + train_attn) / (step_s * 989e12):.2%} with it")

    # one profiled step from the trained state
    model = build_model(cfg, DEVICE)
    step_fn = make_train_step(model, make_optimizer(cfg.optimizer, run), run,
                              guard=True)
    b = {k: torch.from_numpy(v).to(DEVICE)
         for k, v in bf(TRAIN_STEPS).items()}
    params, opt = out["params"], out["opt_state"]
    del out
    torch.cuda.synchronize()
    _reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        loss = m["loss"].item()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kern)
    counted = _flat_counts()
    seen = {n: sum(e.count for e in kern if k in e.key)
            for n, k in PROFILED.items()}
    log("train/profile", f"{smi}: one step (loss {loss:.4f}): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / 1e4 / wall:.1f}%), {sum(e.count for e in kern)} kernel "
        f"launches of {len(kern)} kernels; launches by the profiler's kernel "
        f"events {seen}, by the counters "
        f"{ {n: counted[n] for n in PROFILED} }")
    if seen != {n: counted[n] for n in PROFILED} or \
            seen["flash_attention_fwd"] != 2 * L:
        raise AssertionError(f"train/profile: the profiler counted {seen}, "
                             f"the counters {counted}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log("train/profile", f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    for e in avg:
        if "FlashAttentionFn" in e.key or e.key in ("aten::embedding_dense_backward",):
            log("train/profile", f"  op {e.key}: {e.count}x, device "
                f"{_device_time_us(e) / 1e3:.3f} ms (its kernels included)")
    del params, opt, model, b
    torch.cuda.empty_cache()
    return total


def phase_train_kernels(seed: int) -> dict:
    """The prefill kernel under autograd at the train shape (B 4, H 12,
    S = T = 4096, D 64, bf16): the kernel's out and lse against its plain
    version, the gradients of the kernel forward + the plain backward
    against the all-plain forward and backward, two calls bitwise equal;
    device times of the kernel forward, the plain backward, both through
    the Function, the all-plain pair and SDPA (``is_causal``) forward and
    forward + backward on the same inputs. Returns the row: the forward
    kernel's numbers in its keys, the backward's and the pairs' in extra
    keys."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.flash_attention.autograd import (
        flash_attention_bwd_ref, flash_attention_train)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    (B, H, S, D), dt = TRAIN_KERNEL_SHAPE, torch.bfloat16
    cq, ck = 512, 1024
    q, k, v, do = (randn(gen, (B, S, H, D), dt) for _ in range(4))
    label = f"B{B} H{H} S=T={S} D{D} bf16"
    # -- forward: the kernel against its plain version ------------------
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    split = lambda x: x.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4)
    args5 = (split(q), k.transpose(1, 2), v.transpose(1, 2), pos, pos)
    r_out, r_lse = ref.flash_attention_fwd_ref(*args5, causal=True)
    to4 = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    err = _check_bf16(f"train attention {label} forward", out, to4(r_out),
                      to4(_abs_v_out(*args5, causal=True)), lse, r_lse,
                      phase="train_kernels")
    plain_out, plain_lse = to4(r_out).contiguous(), r_lse
    del r_out, r_lse

    # -- gradients: kernel forward + plain backward vs all plain ---------
    def kernel_pair():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention_train(*xs, causal=True, chunk_q=cq, chunk_kv=ck)
        return (o.detach(),) + torch.autograd.grad(o, xs, do)

    def plain_bwd(o, l):
        five = lambda t: t.reshape(B, S, H, 1, D)
        dq, dk_, dv_ = flash_attention_bwd_ref(
            five(q), k, v, five(o), l, five(do), causal=True, window=0,
            softcap=0.0, cq=cq, ck=ck)
        return dq.reshape(B, S, H, D), dk_, dv_

    before = _flat_counts()["flash_attention_fwd"]
    got = kernel_pair()
    if _flat_counts()["flash_attention_fwd"] != before + 1:
        raise AssertionError("train_kernels: the Function did not launch the "
                             "prefill kernel once")
    want = plain_bwd(plain_out, plain_lse)
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want):
        scale = w.float().abs().max().item()
        errs.append(_check(f"train attention {label} {name} (kernel forward "
                           f"+ plain backward vs all plain; "
                           f"{TRAIN_GRAD_TOL} x max|plain| = "
                           f"{TRAIN_GRAD_TOL * scale:.3e})", g, w,
                           TRAIN_GRAD_TOL * scale, phase="train_kernels"))
    again = kernel_pair()
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, again):
        _identical(f"train attention {name}: two calls", b, a,
                   "train_kernels")
    del got, again, want

    # -- times -----------------------------------------------------------
    posc = pos.contiguous()
    q5, k4, v4 = split(q), k.transpose(1, 2), v.transpose(1, 2)
    t_fwd = device_ms(lambda i: ops.flash_attention_gqa_fwd(
        q, k, v, causal=True), 1, 4)
    t_fwd_alone = device_ms(lambda i: fk.flash_attention_fwd(
        q5, k4, v4, posc, posc), 1, 4)
    t_plain_fwd = _event_ms(lambda: ref.flash_attention_fwd_ref(
        q5, k4, v4, pos, pos, causal=True), 2)
    t_bwd = _event_ms(lambda: plain_bwd(out, lse), 3)
    t_pair = _event_ms(kernel_pair, 3)
    def plain_pair():
        o, l = ref.flash_attention_fwd_ref(q5, k4, v4, pos, pos, causal=True)
        return plain_bwd(to4(o), l)

    t_plain_pair = _event_ms(plain_pair, 2)
    q4, k4s, v4s, do4 = (x.transpose(1, 2).contiguous()
                         for x in (q, k, v, do))
    t_sdpa = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, k4s, v4s, is_causal=True), 1, 4)

    def sdpa_pair():
        xs = [x.detach().requires_grad_(True) for x in (q4, k4s, v4s)]
        o = F.scaled_dot_product_attention(*xs, is_causal=True)
        return torch.autograd.grad(o, xs, do4)

    t_sdpa_pair = _event_ms(sdpa_pair, 5)
    pairs = S * (S + 1) // 2
    f_fwd, f_pair = _attention_train_flops(B, H, D, pairs)
    nbytes_fwd = 4 * q.nbytes + lse.nbytes + 2 * pos.nbytes
    # the pair: q, k, v, do read, out, lse, dq, dk, dv written, once each
    nbytes_pair = 8 * q.nbytes + lse.nbytes
    b_fwd, by_fwd = bound_ms(nbytes_fwd, f_fwd, dt)
    b_pair, by_pair = bound_ms(nbytes_pair, f_pair, dt)
    log("train_kernels", f"{label} causal times: kernel forward {t_fwd:.4f} "
        f"ms through ops (the kernel call alone {t_fwd_alone:.4f}), plain "
        f"forward {t_plain_fwd:.4f} ms, sdpa forward {t_sdpa:.4f} ms, bound "
        f"{b_fwd:.4f} ms ({by_fwd}: {nbytes_fwd} B, {f_fwd:.3e} FLOP); plain "
        f"backward (fp32 tiles {cq} x {ck}, every tile) {t_bwd:.4f} ms; "
        f"forward + backward: the Function (kernel forward + plain "
        f"backward) {t_pair:.4f} ms, all plain {t_plain_pair:.4f} ms, sdpa "
        f"forward + backward {t_sdpa_pair:.4f} ms, bound {b_pair:.4f} ms "
        f"({by_pair}: {nbytes_pair} B, {f_pair:.3e} FLOP); the plain "
        f"backward is {t_bwd / max(t_sdpa_pair - t_sdpa, 1e-9):.1f}x sdpa's "
        f"backward (its forward + backward less its forward)")
    rows = {
        "flash_attention_fwd_train": dict(
            max_abs_err=err, ms=t_fwd, plain_ms=t_plain_fwd, bound_ms=b_fwd,
            bound_by=by_fwd, library_ms=t_sdpa, grad_max_abs_err=max(errs),
            backward_ms=t_bwd, pair_ms=t_pair, plain_pair_ms=t_plain_pair,
            library_pair_ms=t_sdpa_pair, pair_bound_ms=b_pair),
    }
    del q, k, v, do, out, lse, plain_out, plain_lse
    torch.cuda.empty_cache()
    return rows


def phase_train_parity(smi: str, seed: int) -> dict:
    """Card vs CPU in fp32 compute (TF32 off): three guarded AdamW steps of
    full-width pimref-100m with the depth cut to 2 layers, batch 2 x seq
    1536 (``ck`` 1024 pads T to 2048, the padding masked by ``kv_len``):
    loss, gradient norm, weights and optimizer state within their limits,
    two fp32-route launches per layer a step; then the resume-identity gate
    on the card at that size with NaN gradients and a preemption. Returns
    the launches of the card's steps."""
    import tempfile
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batch_fn
    from repro_torch.distributed import TrainChaosConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import initial_params, verify_resume_identity
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaves_with_path
    cfg = get_config("pimref-100m").replace(
        num_layers=TRAIN_PARITY_LAYERS, compute_dtype="float32")
    B, S = TRAIN_PARITY_SHAPE
    run = RunConfig(total_steps=TRAIN_PARITY_STEPS, warmup_steps=1,
                    microbatches=1, seed=seed)
    bf = make_batch_fn(cfg, ShapeConfig("custom", S, B, "train"), seed=seed)
    state, metrics = {}, {}
    launches = None
    for side, dev in (("cpu", "cpu"), ("card", DEVICE)):
        opt = make_optimizer(cfg.optimizer, run)
        step = make_train_step(build_model(cfg, dev), opt, run, guard=True)
        p = initial_params(cfg, seed, dev)
        s = opt.init(p)
        ms = []
        t0 = time.perf_counter()
        for i in range(TRAIN_PARITY_STEPS):
            _reset()
            p, s, m = step(p, s, {k: torch.from_numpy(v).to(dev)
                                  for k, v in bf(i).items()})
            ms.append({k: float(v) for k, v in m.items()})
            if side == "card":
                got = _flat_counts()
                want = dict.fromkeys(got, 0)
                want["flash_attention_fwd"] = \
                    want["flash_attention_fwd_fp32"] = 2 * cfg.num_layers
                if got != want:
                    raise AssertionError(f"train_parity: step {i} launches "
                                         f"{got}, want {want}")
                launches = got
        log("train_parity", f"{side}: {TRAIN_PARITY_STEPS} steps in "
            f"{time.perf_counter() - t0:.2f} s; losses "
            f"{[m['loss'] for m in ms]}")
        state[side] = {"params": p, "opt": s}
        metrics[side] = ms
    for mc, mg in zip(metrics["cpu"], metrics["card"]):
        for k, tol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_TREE_RTOL)):
            rel = abs(mg[k] - mc[k]) / abs(mc[k])
            if rel > tol or mg["skipped"] or mc["skipped"]:
                raise AssertionError(f"train_parity: {k} card {mg[k]} cpu "
                                     f"{mc[k]} (rel {rel:.2e} > {tol})")
    n = TRAIN_PARITY_STEPS
    worst = {}
    for (path, c), (_, g) in zip(leaves_with_path(state["cpu"]),
                                 leaves_with_path(state["card"])):
        if c.dtype == torch.int32:
            if not torch.equal(c, g.cpu()):
                raise AssertionError(f"train_parity: {path} differs")
            continue
        d = (g.cpu() - c).abs()
        tight = TRAIN_TREE_RTOL * c.abs().max().item()
        slack = n * run.learning_rate if "params" in path else \
            (n - 1) * TRAIN_TREE_RTOL * c.abs().max().item()
        over = (d > tight).float().mean().item()
        worst[path] = (d.max().item() / max(c.abs().max().item(), 1e-30),
                       over)
        if d.max().item() > tight + slack or over > 1e-3:
            raise AssertionError(f"train_parity: {path}: max |card - cpu| "
                                 f"{d.max().item():.3e} (tight {tight:.3e} + "
                                 f"{slack:.3e}), {over:.2e} past tight")
    top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:4]
    log("train_parity", f"{smi}: card vs CPU over {n} steps: losses within "
        f"{TRAIN_LOSS_RTOL}, grad_norm within {TRAIN_TREE_RTOL} relative; "
        f"every weight and moment within {TRAIN_TREE_RTOL} of its leaf's "
        f"largest |value| (weights: plus {n} x lr where a gradient is below "
        f"the fp32 noise, at most 1e-3 of the elements); largest "
        f"(err / max, share past tight): "
        + ", ".join(f"{p} {e:.2e} {o:.1e}" for p, (e, o) in top))
    del state
    torch.cuda.empty_cache()

    # bitwise resume on the card: preempted and NaN-poisoned, restarted
    chaos = TrainChaosConfig(seed=seed, nan=1, preempt=2)
    rrun = RunConfig(total_steps=TRAIN_RESUME_STEPS, warmup_steps=1,
                     microbatches=1, checkpoint_every=3, seed=seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        t0 = time.perf_counter()
        res = verify_resume_identity(
            "pimref-100m", steps=TRAIN_RESUME_STEPS, work_dir=d, chaos=chaos,
            max_restarts=2, smoke=False, batch=B, seq=S, run=rrun,
            device=DEVICE, cfg=cfg, log_every=100)
    log("train_parity", f"resume identity on the card ({TRAIN_RESUME_STEPS} "
        f"steps, chaos nan=1 preempt=2): identical={res['identical']} "
        f"(losses {res['losses_match']}, params {res['params_match']}), "
        f"{res['restarts']} restart(s), {res['skipped_steps']} skipped, "
        f"events {res['out']['chaos_events']}; "
        f"{time.perf_counter() - t0:.2f} s")
    if not res["identical"] or res["restarts"] < 1 \
            or res["skipped_steps"] < 1:
        raise AssertionError(f"train_parity: resume identity failed: "
                             f"{ {k: res[k] for k in res if k not in ('out', 'ref')} }")
    return launches


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
    if {"serve", "engine", "robust", "fleet", "spec", "profile"} & \
            set(phases):
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
        engine_want = None
        if "engine" in phases:
            engine_want = phase_engine(model, args.seed)
        if "robust" in phases:
            t0 = time.perf_counter()
            phase_robust(model, smi, args.seed)
            log("robust", f"phase took {time.perf_counter() - t0:.1f} s")
        if "fleet" in phases:
            t0 = time.perf_counter()
            phase_fleet(model, smi, args.seed)
            log("fleet", f"phase took {time.perf_counter() - t0:.1f} s")
        if "spec" in phases:
            launches.update(phase_spec(model, smi, args.seed, engine_want))
        if "profile" in phases:
            phase_profile(model, smi)
        del model
        torch.cuda.empty_cache()
    if "parity" in phases:
        launches["parity"] = phase_parity(args.seed)
    if "train" in phases:
        launches["train"] = phase_train(smi, args.seed)
    if "train_kernels" in phases:
        rows.update(phase_train_kernels(args.seed))
    if "train_parity" in phases:
        launches["train_parity"] = phase_train_parity(smi, args.seed)
    if "proteus" in phases:
        from repro_torch.launch.serve import load_model
        model = load_model("pimref-100m", smoke=False, seed=args.seed,
                           device=DEVICE)
        p_rows, launches["proteus"] = phase_proteus(model, args.seed)
        rows.update(p_rows)
        del model
        torch.cuda.empty_cache()
    if {"serve_griffin", "engine_griffin"} & set(phases):
        from repro_torch.launch.serve import load_model
        t0 = time.perf_counter()
        model = load_model("recurrentgemma-2b", smoke=False, seed=args.seed,
                           device="cuda")
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        log("serve_griffin", f"recurrentgemma-2b full width and depth: {n} "
            f"params ({model.cfg.num_layers} layers), compute "
            f"{model.cfg.compute_dtype}, built in "
            f"{time.perf_counter() - t0:.2f}s; device memory "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        if "serve_griffin" in phases:
            launches["griffin"], launches["griffin_long"] = \
                phase_serve_griffin(model, smi)
            if "profile" in phases:
                phase_profile(model, smi, "profile_griffin")
        if "engine_griffin" in phases:
            phase_engine_griffin(model, args.seed)
        del model
        torch.cuda.empty_cache()
    if "parity_griffin" in phases:
        launches["parity_griffin"] = phase_parity_griffin(args.seed)

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name],
                    launches=launches.get(MAIN_LAYOUT[name], {}).get(
                        COUNTER.get(name, name)),
                    **rows.get(name, {})) for name in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
