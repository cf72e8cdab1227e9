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
``pimref-100m`` (``robust`` at 6 of 12 layers, ``CUT_PIMREF_LAYERS``) with
the engine phase's 24 requests in a 512-token bucket on 8 slots. ``robust``, in the contiguous, paged16 and paged16-int8
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
``ngram`` and ``draft`` drafters) on full-width ``pimref-100m`` at 6 of 12
layers (``CUT_PIMREF_LAYERS``; ``spec_fp32`` too), batch 8 x
prompt 512 (rows 0-3 a period-4 tile, rows 4-7 random, from ``--seed``) +
16 new tokens (``SPEC_GEN``) in chunks of 8, in every KV layout, as the
captured chunk
and as its eager body: tokens and accepted lengths identical, exact
decode-kernel launches (one verify block through every layer and, for
``draft``, k steps through the first half, per iteration: 48 and 120 a
chunk at 6 layers), also counted from the profiler's kernel events; ms per token-step,
per committed token, accepted length per draft and the graph's device ms
per iteration, beside speculation off. ``serve(spec=...)`` on its own
batch (its ``draft`` drafter must accept drafts) and ``ServeEngine``
drains of the engine phase's requests against the same model's drains
with speculation off (one capture, every page back). In
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

Phases ``archs``, ``parity_archs``, ``moe``, ``parity_moe``, ``vlm`` and
``parity_vlm`` run last: the other families of ``TransformerLM``, random
weights from ``--seed``, at full width with depth cut to fit one card (fp32
weights and their bf16 copies, 6 bytes a weight). ``archs``:
``stablelm-1.6b`` (D 64) and ``internlm2-1.8b`` (D 128, G 2) at 4 of 24
layers, ``stablelm-3b`` (D 80, 32 heads) at full depth, batch 8 x 512 + 64,
three ways with exact launches; stablelm-3b also in the int4 and
paged16-int8 layouts three ways, its engine drained graph against eager
body (contiguous, paged16) and a profile whose kernel events equal the
counters; then ``kimi-k2-1t-a32b`` (D 112, 64 q heads on 8 kv heads) at
full width and 1 of its 61 layers (all 384 experts, bf16 weights, 38.8 GB;
its peak under 75 GB), batch 8 x 512 + 64 three ways in contiguous and
graph against eager chunk in int4, paged16 and paged16-int8, a profile.
``parity_archs``: stablelm-3b at 2 layers of full width, fp32 card against
CPU as ``parity_moe`` below (contiguous and int8). The kernels phase checks
every route and layout at D 80 and 112 at these shapes (rows ``*_d80``,
``*_d112``). ``moe``: ``mixtral-8x7b`` at 1 of 32
layers (8 experts, top 2, capacity factor 1.25, window 4096), batch 8 x
512 + 64 in the contiguous, int8, paged16 and paged16-int8 layouts and one
long request (2 x 4200 + 32, past the window, so the ring wraps), three
ways each: identical tokens, exact launches, the graph's device ms a step
against its byte bound (``step_bytes``: every expert's weights each step);
the engine phase's requests drained graph against eager body (contiguous,
paged16); a profile. ``vlm``: ``pixtral-12b`` at 2 of 40 layers, batch 8 x
512 (256 patch embeddings + 256 tokens) + 64, contiguous and paged16, and
2 x 2048 with the full 1024-row patch prefix, three ways; ``serve(spec=
"ngram")`` against speculation off (bf16 recorded, fp32 identical);
drains of 24 patch-prefixed requests (no prefix sharing) and a malformed
patch extra (``bad_request``, nothing launched). ``parity_moe`` /
``parity_vlm``: 2 layers at full width, fp32, TF32 off, prefill 64 (after
32 patch rows for pixtral) + 8 decode steps, card against CPU, contiguous
and paged16: every MoE layer's routing (``idx``, ``pos``, ``keep``) equal,
a flip reported with its router margin, logits within 1e-3. The kernels
phase checks the on-path kernels at the MoE / VLM shape (32 q heads on 8
kv heads of 128, window 4096) and times rows ``flash_attention_fwd_d128``
(B 8 x S = T = 512) and ``flash_decode_fwd_d128`` (B 8, T 576, S 1)
beside SDPA with ``enable_gqa``.

Phases ``encdec``, ``parity_encdec`` and ``xlstm`` run after
``parity_vlm``: the last two architectures of the reference, random
weights from ``--seed``. ``encdec``: ``seamless-m4t-large-v2`` at full
width (d_model 1024, 16 heads of 64, d_ff 8192, vocab 256206), 2 of 24
encoder and 2 of 24 decoder layers (full depth has 2,034,784,256
parameters), ``serve()`` of batch 8 x
512 tokens over 512 source frames + 64 new in the contiguous, int8,
paged16 and paged16-int8 layouts as the graph replay and the eager chunk
(the per-token loop too in the contiguous layout): identical tokens, exact
launches (72 of the prefill kernel a prefill: the encoder's self-attention
and each decoder layer's self- and cross-attention, 0 of its fp32 route;
per step 24 of the self cache's decode kernel and 24 of the cross cache's,
contiguous always, over codes when the layout quantizes), the graph's
device ms a step against its byte bound (the decoder's weights but the
cross K / V projections, the head, both caches); 24 requests with their
source frames drained graph against eager body (contiguous, paged16; no
prefix hits); a misshaped source extra (``bad_request``, nothing
launched); a profile. ``parity_encdec``: 2 + 2 layers at full width,
fp32, card against CPU, 64 tokens over 64 frames + 8 decode steps,
contiguous / paged16 logits within 1e-3, int8 within 2e-2 (codes within
one step), every prefill 6 launches of the fp32 route. ``xlstm``:
``xlstm-125m`` (12 layers, 9 mLSTM and 3 sLSTM, d_model 768, 4 heads,
vocab 50304; 74,106,696 parameters), ``prefill`` of 8 x 512 then 64
tokens by the captured chunk, its eager body and a per-token
``decode_step`` loop: identical tokens, no kernel launched (the blocks
are plain PyTorch, as the reference's are jnp); prefill ms, ms a
token-step, the graph's device ms; then fp32 card against CPU at full
depth (2 x 512, two mLSTM chunks, + 8 steps): logits and every block's
states within 5e-4 of their largest |value|, the card's also within it of
a float64 run of the port (each fp32 side lies up to ~2e-4 from it: the
model is ill-conditioned in fp32). The kernels phase checks
both attention kernels with ``causal=False`` at the encoder-decoder's
shapes: the prefill at S = T = 512 and S 500 over T 512 (bf16 and fp32),
the decode kernels over the cross cache (values, codes, pages), and times
rows ``flash_attention_fwd_noncausal``, ``flash_attention_fwd_fp32_noncausal``,
``flash_decode_fwd_cross`` and ``flash_decode_quant_fwd_cross``.

Phases ``train_families`` and ``train_families_parity`` run after
``train_parity``. ``train_families``: each non-dense family trained
through ``train()`` on the card at full width, bf16 compute, guarded AdamW
(warm-up 2, lr 3e-4), one warm-up step and four more, the batch with the
family's extras: ``xlstm-125m`` 6 of 12 layers at 8 x 512, seamless 6 +
6 of 24 + 24 at 4 x 512 over 512 frames, ``pixtral-12b`` 2 of 40 layers
at 2 x 2048 (1024 patches + 1024 tokens), ``mixtral-8x7b`` 1 of 32 at 4 x
1024, Griffin 14 of 26 layers at 1 x 4096 (past its 2048 window); mixtral's and
pixtral's depths cut to keep a family's 16 bytes a weight (fp32 weights,
gradients, both moments: the model holds none) under 75 GB, the xLSTM's
and seamless's for the run's time limit (phase ``paper``), and all but the
xLSTM's again for it (stablelm-3b's and kimi-k2's phases). Every loss finite, none skipped, exact
launches a step (the prefill kernel twice per attention layer, the RG-LRU
kernel three times per grouped recurrent layer and twice per tail layer),
one profiled step whose kernel events equal the counters (not for the
xLSTM, which launches none); step wall, the numpy batch's share, tokens
a second, the model-FLOP share and the peak memory logged.
``train_families_parity``: fp32 card against CPU at full width and cut
depth (Griffin 5 layers, pixtral 2, mixtral 1, seamless 1 + 1, xLSTM 4
with an sLSTM block), batch 2 x 64, three guarded steps on the card with
the CPU's loss and gradients at the card's weights before each (before
the first only for mixtral and pixtral, for the time limit; loss 1e-5
relative, gradients 1e-4 of a leaf's largest |value|, Griffin 1e-3,
xLSTM 5e-4), MoE routing equal; the host also takes the xLSTM's three
AdamW steps and seamless's first from its own gradients, the card's
weights and moments after each held to the limits (a weight whose update
is set by gradient noise within 2 lr more), and the xLSTM's gradients
against a float64 run of the port. ``train_kernels`` adds the kernel under autograd at the families'
train shapes (rows ``flash_attention_fwd_train_d256``, ``_d128``,
``_noncausal``, ``_cross``) and the RG-LRU backward (row
``rglru_scan_bwd``: the kernel over the reversed sequences, bit for bit
``rglru_scan_bwd_ref``, at 1 x 4096 x 2560).

Phase ``paper`` runs last: DaPPA's five patterns and the reference's
distributed pipelines over 2^26 fp32 on the card against the CPU (streams
bitwise, sums within 32 ulps of sum |v|) and on a one-rank NCCL mesh
(equal to the local run), each timed beside its bytes over 3.35 TB/s;
MIMDRAM's plans for every arch the card runs x the four shape cells on a
one-device CUDA ``DeviceMesh`` equal to the mesh-less plans; DAMOV's rows
(``core/damov.py``): eight archs counted on ``meta`` at full width and
depth by worker processes started at the build, their H100 rooflines as
a table, pimref-100m's beside what phases serve and train measured; and a
pimref step (2 layers) counted on the card equal to its ``meta`` count,
the kernels' reports equal to the launches.

Phase ``distributed`` runs after it, on a one-rank mesh over ``("pod",)``
(NCCL for the card's tensors, gloo for the host's: one card cannot host two
NCCL ranks, so every multi-rank result comes from the CPU tests on gloo
ranks): ``proteus_psum`` of 2^24 fp32 at 8 and 4 bits, card == CPU
bitwise; three AdamW steps of ``make_train_step_proteus`` on full-width
pimref-100m at 4 x 4096, bitwise equal to the plain step whose gradients
pass through ``quantize`` / ``dequantize`` (losses, parameters, state), 24
prefill launches a step each, both timed, with the quantize pass's cost;
``pipelined_forward`` of pimref's 12 blocks over 4 microbatches of 2 x 512
at one stage, bitwise equal to the stack run microbatch by microbatch and
within the bf16 limit of the whole-batch stack; the dry-run's cells
(pimref-100m train / prefill / decode / long_500k on the (16, 16) mesh,
mixtral-8x7b train_4k with Proteus and long_500k on (2, 16, 16);
stablelm-3b's and kimi-k2's train, prefill and decode cells, D 80 and 112,
on one mesh or the other, kimi-k2's long_500k; ``DIST_CELLS``), counted
on ``meta`` by worker processes started at the build, ``OK`` or ``SKIP``
where the reference skips; and the dry-run's predicted peak for the
Proteus step's own one-device problem beside the card's.

The second-to-last line is a JSON object of per-kernel numbers, the last is
``{"ok": true, "device": {...}}``. Any failure raises.

    python3 chip_smoke.py [--seed N] [--phases device,build,kernels,...]
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
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
          "parity", "train", "train_kernels", "train_parity",
          "train_families", "train_families_parity", "proteus",
          "serve_griffin", "engine_griffin", "parity_griffin", "archs",
          "parity_archs", "moe", "parity_moe", "vlm", "parity_vlm", "encdec", "parity_encdec",
          "xlstm", "paper", "distributed")
# the H100 SXM's figures (NVIDIA data sheet), one copy for every bound of
# the run: repro_torch.core.damov's
from repro_torch.core.damov import H100_SXM  # noqa: E402

HBM_BYTES_PER_S = H100_SXM.hbm_bytes_per_s
PEAK_FLOPS = {torch.bfloat16: H100_SXM.peak_flops_bf16,
              torch.float32: H100_SXM.peak_flops_fp32}
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
# the attention kernels' code (the .cu beside each holds the design note and
# the C entry point; flash_*.d<D>.cu instantiate it a head dim at a time)
DECODE_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_decode.cuh"
PREFILL_SOURCE = (
    "src/repro_torch/kernels/flash_attention/csrc/flash_prefill.cuh")
NV_SOURCE = "src/repro_torch/kernels/narrow_value/csrc/narrow_value.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/rglru/csrc/rglru.cu"
QMM_SOURCE = "src/repro_torch/kernels/quant_matmul/csrc/quant_matmul.cu"
SOURCES = {"flash_attention_fwd": PREFILL_SOURCE,
           "flash_attention_fwd_d256": PREFILL_SOURCE,
           "flash_attention_fwd_d256_long": PREFILL_SOURCE,
           "flash_attention_fwd_d128": PREFILL_SOURCE,
           "flash_attention_bh": PREFILL_SOURCE,
           "flash_decode_fwd": DECODE_SOURCE,
           "flash_decode_fwd_d256": DECODE_SOURCE,
           "flash_decode_fwd_verify": DECODE_SOURCE,
           "flash_decode_fwd_d128": DECODE_SOURCE,
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
           "flash_attention_fwd_train": PREFILL_SOURCE,
           "flash_attention_fwd_noncausal": PREFILL_SOURCE,
           "flash_attention_fwd_fp32_noncausal": PREFILL_SOURCE,
           "flash_decode_fwd_cross": DECODE_SOURCE,
           "flash_decode_quant_fwd_cross": DECODE_SOURCE,
           "flash_attention_fwd_train_d256": PREFILL_SOURCE,
           "flash_attention_fwd_train_d128": PREFILL_SOURCE,
           "flash_attention_fwd_train_noncausal": PREFILL_SOURCE,
           "flash_attention_fwd_train_cross": PREFILL_SOURCE,
           "rglru_scan_bwd": RGLRU_SOURCE}
REPLACES = {
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_d256":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_d256_long":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_d128":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_decode_fwd": "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_fwd_d256": "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_fwd_verify":
        "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_fwd_d128": "src/repro/kernels/flash_attention/kernel.py:174",
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
    "flash_attention_fwd_noncausal":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_fp32_noncausal":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_decode_fwd_cross": "src/repro/kernels/flash_attention/kernel.py:174",
    "flash_decode_quant_fwd_cross":
        "src/repro/kernels/flash_attention/kernel.py:262",
    "flash_attention_fwd_train_d256":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_train_d128":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_train_noncausal":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "flash_attention_fwd_train_cross":
        "src/repro/kernels/flash_attention/kernel.py:126",
    "rglru_scan_bwd": "src/repro/kernels/rglru/kernel.py:44",
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
               "flash_attention_fwd_d128": "moe/contiguous",
               "flash_decode_fwd_d128": "moe/contiguous",
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
               "flash_attention_fwd_train": "train",
               # the encoder-decoder's non-causal calls: its prefills (a
               # third of them cross-attention, a third the encoder's); the
               # cross cache's decode kernel in the paged layouts, where the
               # contiguous kernels read the cross cache alone
               "flash_attention_fwd_noncausal": "encdec/contiguous",
               "flash_attention_fwd_fp32_noncausal": "parity_encdec",
               "flash_decode_fwd_cross": "encdec/paged16",
               "flash_decode_quant_fwd_cross": "encdec/paged16_int8",
               # the train runs of phase train_families
               "flash_attention_fwd_train_d256":
                   "train_families/recurrentgemma-2b",
               "flash_attention_fwd_train_d128": "train_families/pixtral-12b",
               "flash_attention_fwd_train_noncausal":
                   "train_families/seamless-m4t-large-v2",
               "flash_attention_fwd_train_cross":
                   "train_families/seamless-m4t-large-v2",
               "rglru_scan_bwd": "train_families/recurrentgemma-2b"}
# rows whose launches are another row's counter: the prefill and decode
# kernels at the Griffin shapes, the RG-LRU kernel at the long prompt, the
# quantized matmul at its other timed shapes, the adapter's fp32 calls
COUNTER = {"flash_attention_fwd_d256": "flash_attention_fwd",
           "flash_attention_fwd_fp32_d256": "flash_attention_fwd_fp32",
           "flash_attention_bh_fp32": "flash_attention_bh",
           "flash_attention_fwd_d256_long": "flash_attention_fwd",
           "flash_decode_fwd_d256": "flash_decode_fwd",
           "flash_decode_fwd_verify": "flash_decode_fwd",
           "flash_attention_fwd_d128": "flash_attention_fwd",
           "flash_decode_fwd_d128": "flash_decode_fwd",
           "rglru_scan_long": "rglru_scan",
           "quant_matmul_bf16": "quant_matmul",
           "quant_matmul_griffin": "quant_matmul",
           "quant_matmul_decode": "quant_matmul",
           "flash_attention_fwd_train": "flash_attention_fwd",
           "flash_attention_fwd_noncausal": "flash_attention_fwd",
           "flash_attention_fwd_fp32_noncausal": "flash_attention_fwd_fp32",
           "flash_decode_fwd_cross": "flash_decode_fwd",
           "flash_decode_quant_fwd_cross": "flash_decode_quant_fwd",
           "flash_attention_fwd_train_d256": "flash_attention_fwd",
           "flash_attention_fwd_train_d128": "flash_attention_fwd",
           "flash_attention_fwd_train_noncausal": "flash_attention_fwd",
           "flash_attention_fwd_train_cross": "flash_attention_fwd"}
# the rows at head dims 80 and 112 (kernels_head_dims): the base row's
# kernel with the suffix, and the run whose launches it reports: phase
# archs' graph serve of the layout (paged16 at D 80: the graph engine's
# drain), the fp32 route's phase parity_archs; kimi-k2 runs in fp32 on no
# path (at one layer its fp32 weights, 77.6 GB, fit neither card nor host)
HEAD_DIM_RUNS = {
    "_d80": {"flash_attention_fwd": "archs/stablelm-3b",
             "flash_attention_fwd_fp32": "parity_archs",
             "flash_decode_fwd": "archs/stablelm-3b",
             "flash_decode_quant_fwd": "archs/stablelm-3b/int4",
             "flash_decode_paged_fwd": "archs/stablelm-3b/engine_paged16",
             "flash_decode_paged_quant_fwd":
                 "archs/stablelm-3b/paged16_int8"},
    "_d112": {"flash_attention_fwd": "archs/kimi-k2-1t-a32b",
              "flash_attention_fwd_fp32": None,
              "flash_decode_fwd": "archs/kimi-k2-1t-a32b",
              "flash_decode_quant_fwd": "archs/kimi-k2-1t-a32b/int4",
              "flash_decode_paged_fwd": "archs/kimi-k2-1t-a32b/paged16",
              "flash_decode_paged_quant_fwd":
                  "archs/kimi-k2-1t-a32b/paged16_int8"}}
for _sfx, _runs in HEAD_DIM_RUNS.items():
    for _base, _run in _runs.items():
        SOURCES[_base + _sfx] = SOURCES[_base]
        REPLACES[_base + _sfx] = REPLACES[_base]
        MAIN_LAYOUT[_base + _sfx] = _run
        COUNTER[_base + _sfx] = _base
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
# training of the non-dense families (phase train_families): full width,
# bf16 compute, AdamW, guarded, one warm-up step and four more; depth cut
# where a family's 16 bytes a weight (fp32 weights, gradients and both
# AdamW moments) with the step's transients pass TRAIN_FAMILIES_PEAK
# (mixtral, pixtral), and to pay for phase paper's ~30 s within the run's
# time limit (the xLSTM 12 -> 6 layers, ~15 s of its 5.5 s steps; seamless
# 24 + 24 -> 12 + 12, ~15 s of its steps and profiled step); then, for
# stablelm-3b's and kimi-k2's phases, seamless 6 + 6, pixtral 2,
# mixtral 1 and Griffin 14 of 26 layers (four (r, r, a) groups and the two
# trailing recurrent layers; 28.4 s of the phase at 26)
# arch: (decoder layers, encoder layers or None, batch, seq)
TRAIN_FAMILIES = {
    "xlstm-125m": (6, None, 8, 512),
    "seamless-m4t-large-v2": (6, 6, 4, 512),
    "pixtral-12b": (2, None, 2, 2048),
    "mixtral-8x7b": (1, None, 4, 1024),
    "recurrentgemma-2b": (14, None, 1, 4096),
}
TRAIN_FAMILIES_STEPS = 5
TRAIN_FAMILIES_PEAK = 75e9
# fp32 card vs CPU (phase train_families_parity): full width, these depths,
# batch 2 x seq 64, three guarded steps. The host's memory would hold seq
# 256 (its peak was 37 GB at seq 64), its time would not: its forward and
# backward at full width take most of the phase (mixtral's ~11 s a step at
# seq 64, about four times that at 256), and the run has a time limit
TRAIN_FAMILIES_PARITY = {
    "xlstm-125m": (4, None),               # layer 3 an sLSTM block
    # seamless and mixtral at one layer for the run's time limit: the
    # host's full-width forward and backward set the time
    "seamless-m4t-large-v2": (1, 1),
    "pixtral-12b": (2, None),
    "mixtral-8x7b": (1, None),
    "recurrentgemma-2b": (5, None),        # one (r, r, a) group + 2 tail
}
TRAIN_FAMILIES_PARITY_SHAPE = (2, 64)
ADAMW_EPS = 1e-8                     # optim.adamw's eps
TRAIN_FAMILIES_PARITY_STEPS = 3
# the first n steps that the host also takes (AdamW from the CPU's own
# gradients at the card's weights), its weights and moments held against
# the card's: the host's AdamW takes ~23 ns a weight (73 s a mixtral step),
# so the xLSTM (50 M weights) takes every step and seamless (651 M, leaves
# of 262 M elements updated in pieces) the first
TRAIN_FAMILIES_HOST_STEPS = {"xlstm-125m": 3, "seamless-m4t-large-v2": 1}
# the steps before which the CPU computes the loss and the gradients at the
# card's weights (every step where not named): mixtral's and pixtral's
# host forward and backward (~11 s and ~5 s a step) and the copies of
# their weights (12.7 and 7.5 GB) fit the time limit once
TRAIN_FAMILIES_GRAD_STEPS = {"mixtral-8x7b": 1, "pixtral-12b": 1}
# per family, of a leaf's largest |value|: the gradients and the gradient
# norm (and the xLSTM's weights and moments); Griffin's sqrt(1 - a^2) as in
# its serving parity (PARITY_GRIFFIN_REL); the xLSTM's as its serving parity
# (XLSTM_PARITY_REL, set from a float64 run), held by both sides
# against a float64 run of the port as well
TRAIN_FAMILIES_REL = {"xlstm-125m": 5e-4, "recurrentgemma-2b": 1e-3}
# the prefill kernel under autograd at the families' train shapes (phase
# train_kernels): (B, S, T, Hq, Hkv, D, causal, window)
TRAIN_ATTN_SHAPES = {
    "flash_attention_fwd_train_d256": (1, 4096, 4096, 10, 1, 256, True, 2048),
    "flash_attention_fwd_train_d128": (2, 2048, 2048, 32, 8, 128, True, 0),
    "flash_attention_fwd_train_noncausal": (4, 512, 512, 16, 16, 64, False,
                                            0),
    "flash_attention_fwd_train_cross": (4, 512, 768, 16, 16, 64, False, 0),
}
TRAIN_ATTN_LABELS = {
    "flash_attention_fwd_train_d256": "recurrentgemma-2b local MQA",
    "flash_attention_fwd_train_d128": "pixtral-12b GQA",
    "flash_attention_fwd_train_noncausal": "seamless encoder",
    "flash_attention_fwd_train_cross": "seamless cross-attention, S != T",
}
RGLRU_BWD_SHAPE = (1, 4096, 2560)      # Griffin's train batch, d_model
# speculative decoding (phase spec): the reference's draft length, its two
# drafters; the batch rows 0-3 a period-4 tile, rows 4-7 random
SPEC_K = 3
SPEC_MODES = ("ngram", "draft")
# new tokens of a spec drain: 16 keeps the run inside its time limit (64,
# with every other phase as it is, ran past it on the H100)
SPEC_GEN = 16
# decode steps of a chunk in the profiled serves and the spec profile: 2
# for the time limit too (8 ran past it; at 4 stablelm-3b's profile at 32
# layers took 34 s, most of it the trace's processing)
PROFILE_CHUNK = 2
# pimref-100m's depth in phases robust, spec and spec_fp32 (full width):
# 6 of 12 layers, for the run's time limit on slower hosts (with phase
# paper and these phases at 12 layers the run took 1245.9 s on one H100
# host); serve, engine, profile and fleet keep 12. Not fewer: at 4 layers
# the draft drafter (2 layers) accepted no draft on serve()'s batch (1.0
# on the H100; the phase's gate is > 1.0)
CUT_PIMREF_LAYERS = 6
T_START = time.perf_counter()
# what the serving and training phases measured, by label, for the paper
# phase's DAMOV rows: {"prefill_ms", "decode_ms", "decode_device_ms"} of a
# serve label's graph run, {"step_ms", "batch", "seq"} of "train"
READINGS: dict = {}


def log(phase: str, msg: str) -> None:
    """A line of the run's log, after the seconds since the script
    started (the phases' share of the time limit)."""
    print(f"{time.perf_counter() - T_START:7.1f}s [{phase}] {msg}",
          flush=True)


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
        log("build", f"{name}: nvcc {rec['seconds']:.2f}s -> {rec['path']}"
            + (f" (translation units: " + ", ".join(
                f"{u} {sec:.1f}s" for u, sec in rec["parts"].items()) + ")"
               if len(rec["parts"]) > 1 else ""))
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


def fp32_prefill_row(gen, label, B, Hkv, G, S, D, window,
                     causal=True) -> dict:
    """The prefill kernel's fp32 route at a main-path shape in the model's
    layout (strided views of (B, S, H, D) projections): out and lse within
    TOL of the plain version, two calls bitwise equal, then device times of
    the kernel call (positions made once), the plain version and SDPA on
    fp32 inputs (K/V expanded to the q heads as views; ``is_causal``, which
    is the same function while S <= window; none with ``causal=False``).
    Returns the row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    H, dt = Hkv * G, torch.float32
    kw = dict(causal=causal, window=window)

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
        *sets4[i], is_causal=causal), n_sets, 5)
    split = kernel_split_us(lambda i: fk.flash_attention_fwd(
        *sets5[i], posc, posc, **kw), n_sets)
    del sets4, sets5
    nbytes = 2 * o.nbytes + 2 * 4 * B * S * Hkv * D + lse.nbytes \
        + 2 * pos.nbytes
    flops = 4.0 * D * H * visible_pairs(pos, pos, causal, window)
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


# a trace's lead-in: after the profiler's warm-up step, TRACE_LEAD_KERNELS
# lgamma kernels (a kernel that no served path launches), each run to its
# end and TRACE_LEAD_GAP_S apart, so that the traced block starts 2.5 s
# after the trace does. The profiler drops the device records it dates
# before the trace's start, and that span grows with the time since the
# process's first trace (about 1.45 ms a second on the H100: 0.34 s of the
# lead-in lost at 323 s, all of a 1 s lead-in at 754 s; ROADMAP §C), so
# the check logs how many lead kernels each trace kept (``lead_kept``).
# TRACE_PAD_S of idle time follows the block.
TRACE_LEAD_KERNELS = 50
# the families' train traces follow a run of train() (tens of GB allocated
# and freed): runs on the H100 kept 8-10 of 50 lead kernels there, so they
# take a longer lead-in; so do the serving profiles (``phase_profile``),
# one to three of which kept 0 of 50 a run on the H100 (Griffin's, the
# archs', mixtral's, seamless's: a different set each run)
TRAIN_TRACE_LEAD = 120
TRACE_LEAD_GAP_S = 0.05
TRACE_PAD_S = 0.1
LEAD_KERNEL = "lgamma"
# (lead kernels, seconds of the lead-in) of every trace of the run
LEAD_IN = []


@contextlib.contextmanager
def traced(lead: int = TRACE_LEAD_KERNELS):
    """``torch.profiler`` (CPU and CUDA activities) over the block, started
    through one warm-up step of the profiler's schedule and a lead-in of
    ``lead`` kernels, so that the block's kernels lie well inside the
    trace's window (ROADMAP §C)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        prof.step()
        x = torch.full((1,), 2.0, device=DEVICE)
        t0 = time.perf_counter()
        for _ in range(lead):
            x.lgamma_()
            torch.cuda.synchronize()
            time.sleep(TRACE_LEAD_GAP_S)
        LEAD_IN.append((lead, time.perf_counter() - t0))
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def lead_kept(kern) -> int:
    """How many of ``traced``'s lead kernels the trace's kernel events
    list."""
    return sum(e.count for e in kern if LEAD_KERNEL in e.key)


def kernel_events(averages) -> list:
    """The device kernels of a ``traced`` trace's ``key_averages()``: the
    schedule's step annotation (``ProfilerStep*``, a device-side range as
    long as the step) left out."""
    return [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def _profiled_launches(label, prof, kern, seen, want,
                       lead: int = TRACE_LEAD_KERNELS) -> None:
    """The profiler's kernel events ``seen`` must equal the counters
    ``want``; the lead kernels the trace kept are logged beside them. On a
    disagreement the trace's records of the counted kernels are logged in
    launch order (A prefill, D decode, R RG-LRU), with the trace's device
    records in all, before it raises (ROADMAP §C)."""
    log(label, f"launches by the profiler's kernel events {seen}, by the "
        f"counters {want}; the trace kept {lead_kept(kern)} of its "
        f"{lead} lead kernels")
    if seen == want:
        return
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    ours = sorted((e for e in raw
                   if any(k in e.name() for k in PROFILED.values())),
                  key=lambda e: e.start_ns())
    code = {PROFILED["flash_attention_fwd"]: "A",
            PROFILED["flash_decode_fwd"]: "D", PROFILED["rglru_scan"]: "R"}
    seq = "".join(next(c for k, c in code.items() if k in e.name())
                  for e in ours)
    log(label, f"the trace's {len(raw)} device records hold the counted "
        f"kernels in this order: {seq[:160]}{'...' if len(seq) > 160 else ''}")
    raise AssertionError(f"{label}: the profiler counted {seen}, the "
                         f"counters {want}")


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
    rows.update(kernels_d128(gen))
    rows.update(kernels_head_dims(gen))
    rows.update(kernels_noncausal(gen))
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


# the MoE and VLM models' attention (mixtral-8x7b, pixtral-12b): 32 q heads
# on 8 kv heads of 128, mixtral's window 4096
D128_HEADS = (8, 4, 128)            # (Hkv, G, D)
D128_WINDOW = 4096


def _attention_rows(gen, Hkv, G, D, window, sfx, label) -> dict:
    """The bf16 prefill at B 8 x S = T = 512 and a decode step over a ring
    of 576, Hkv kv heads of D with G q heads each, ``window`` (0: none),
    through ``ops`` as the models call them, against their plain versions:
    the prefill's out within 2e-2 and ``ref.bf16_route_limit``, lse 1e-4,
    the decode within 2e-2, two calls of each bitwise equal; device times
    beside the plain versions and SDPA (``enable_gqa`` where G > 1: q head
    h reads kv head h // G, the models' grouping). Rows
    ``flash_attention_fwd`` and ``flash_decode_fwd`` with the suffix
    ``sfx``; ``label`` names the shape in the log."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.flash_attention.ref import visible_mask
    B, S, T, dt = 8, 512, 576, torch.bfloat16
    H, W = Hkv * G, window
    gqa = dict(enable_gqa=True) if G > 1 else {}
    split = lambda x: x.reshape(B, -1, Hkv, G, D).permute(0, 2, 3, 1, 4)  # noqa: E731
    to4 = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, -1, H, D)  # noqa: E731
    rows = {}

    # -- prefill, bf16 route: B 8 x S = T = 512 -------------------------------
    q = randn(gen, (B, S, H, D), dt)
    k, v = (randn(gen, (B, S, Hkv, D), dt) for _ in range(2))
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True, window=W)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    args5 = (split(q), k.transpose(1, 2), v.transpose(1, 2), pos, pos)
    r_out, r_lse = ref.flash_attention_fwd_ref(*args5, causal=True, window=W)
    err = _check_bf16(f"prefill {label} S=T=512 bf16 (model layout)", out,
                      to4(r_out), to4(_abs_v_out(*args5, causal=True,
                                                 window=W)), lse, r_lse)
    o2, l2 = ops.flash_attention_gqa_fwd(q, k, v, causal=True, window=W)
    _identical(f"prefill {label} bf16 out: two calls", o2, out)
    _identical(f"prefill {label} bf16 lse: two calls", l2, lse)
    del o2, l2, r_out, r_lse
    n_sets = n_sets_for(q.nbytes + k.nbytes + v.nbytes)
    sets = [(randn(gen, (B, S, H, D), dt), randn(gen, (B, S, Hkv, D), dt),
             randn(gen, (B, S, Hkv, D), dt)) for _ in range(n_sets)]
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    t_ops = device_ms(lambda i: ops.flash_attention_gqa_fwd(
        *sets[i], causal=True, window=W), n_sets, 20)
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, causal=True, window=W), n_sets, 4)
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], is_causal=True, **gqa), n_sets, 20)
    del sets, sets4, sets5
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes + lse.nbytes + 2 * pos.nbytes
    flops = 4.0 * D * H * visible_pairs(pos, pos, True, W)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_attention_fwd" + sfx] = dict(
        max_abs_err=err, ms=t_ops, plain_ms=t_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_l)
    log("kernels", f"prefill {label} S=T=512 bf16 times: kernel {t_ops:.4f} "
        f"ms (through ops), plain {t_p:.4f} ms, sdpa (is_causal"
        f"{', enable_gqa' if gqa else ''}) {t_l:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B, {flops:.3e} FLOP); plan "
        f"{fk.prefill_plan(G, S)}")
    del q, k, v, out, lse

    # -- decode: one step over a ring of 576 ---------------------------------
    qp, kp = ring_positions([575 - 8 * b for b in range(B)], 1, T)
    q = randn(gen, (B, 1, H, D), dt)
    k, v = (randn(gen, (B, T, Hkv, D), dt) for _ in range(2))
    o = ops.flash_decode(q, k, v, qp, kp, window=W)
    dec_err = _check(
        f"decode {label} T576 S1 bf16 (model layout)", o,
        to4(ref.flash_decode_fwd_ref(split(q), k.transpose(1, 2),
                                     v.transpose(1, 2), qp, kp, window=W)),
        TOL[dt])
    _identical(f"decode {label} bf16: two calls",
               ops.flash_decode(q, k, v, qp, kp, window=W), o)
    n_sets = n_sets_for(2 * B * T * Hkv * D * 2)
    sets = [(randn(gen, (B, 1, H, D), dt), randn(gen, (B, T, Hkv, D), dt),
             randn(gen, (B, T, Hkv, D), dt)) for _ in range(n_sets)]
    t_k = device_ms(lambda i: ops.flash_decode(*sets[i], qp, kp, window=W),
                    n_sets, 50)
    sets5 = [(split(a), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    t_p = device_ms(lambda i: ref.flash_decode_fwd_ref(*sets5[i], qp, kp,
                                                       window=W), n_sets, 10)
    mask = visible_mask(qp, kp, causal=True, window=W)[:, None]
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(
        *sets4[i], attn_mask=mask, **gqa), n_sets, 50)
    del sets, sets4, sets5
    valid_rows = int((kp >= 0).sum())
    nbytes = (2 * 2 * valid_rows * Hkv * D + 2 * B * H * D * 2 + qp.nbytes
              + kp.nbytes)
    flops = 4.0 * D * H * visible_pairs(qp, kp, True, W)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_decode_fwd" + sfx] = dict(
        max_abs_err=dec_err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_l)
    log("kernels", f"decode {label} T576 S1 bf16 times: kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, sdpa (mask{', enable_gqa' if gqa else ''}) "
        f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
        f"{flops:.3e} FLOP); plan {fk.decode_plan(B, Hkv, G, T)}")
    return rows


def kernels_d128(gen) -> dict:
    """The prefill and decode kernels at the MoE / VLM shape: B 8, 32 q
    heads on 8 kv heads (G 4) of 128, bf16, mixtral's window of 4096
    (``_attention_rows``); then the quantized and paged layouts at this
    shape with their bitwise identities. Returns the rows
    ``flash_attention_fwd_d128`` and ``flash_decode_fwd_d128``."""
    Hkv, G, D = D128_HEADS
    rows = _attention_rows(gen, Hkv, G, D, D128_WINDOW, "_d128",
                           f"B8 Hkv{Hkv} G{G} D{D} window {D128_WINDOW}")
    # the layout kernels at this shape (and the verify block's S 4), paged
    # == dense and paged-quant == quant bit for bit
    for dt in (torch.bfloat16, torch.float32):
        for S in (1, SPEC_K + 1):
            _check_layouts_case(gen, dt, 4, Hkv, G, S, 576, D, 16,
                                [100, 575 - S, 2100, 40],
                                dict(causal=True, window=D128_WINDOW,
                                     softcap=0.0),
                                share=2)
    return rows


# the head dims the kernels took last: stablelm-3b's 32 heads of 80
# (MHA: 2560 / 32) and kimi-k2's 64 q heads on 8 kv heads of 112, at the
# serving shapes (B 8, prompt 512, a ring of 576): (Hkv, G, D) by row suffix
HEAD_DIM_SHAPES = {"_d80": (32, 1, 80), "_d112": (8, 8, 112)}
HEAD_DIM_LABELS = {"_d80": "stablelm-3b", "_d112": "kimi-k2-1t-a32b"}


def kernels_head_dims(gen) -> dict:
    """Every kernel route at head dims 80 and 112 (HEAD_DIM_SHAPES), B 8:
    the prefill's bf16 route and a decode step (``_attention_rows``, no
    window), the prefill's fp32 route at S = T = 512 (2e-5, two calls
    bitwise equal), and the quantized and paged layouts (int8 and int4
    codes, pages of 16; S 1 and the verify block's S 4, bf16 and fp32, a
    wrapped ring) against their plain versions with paged == dense and
    paged-quant == quant bit for bit; device times beside the plain
    versions and SDPA. Rows ``flash_attention_fwd``,
    ``flash_attention_fwd_fp32``, ``flash_decode_fwd``,
    ``flash_decode_quant_fwd`` (int4 codes, the layout the archs phase
    serves), ``flash_decode_paged_fwd`` and
    ``flash_decode_paged_quant_fwd`` with the suffix ``_d80`` / ``_d112``."""
    rows = {}
    B, S, T, dt = 8, 512, 576, torch.bfloat16
    for sfx, (Hkv, G, D) in HEAD_DIM_SHAPES.items():
        label = f"B{B} Hkv{Hkv} G{G} D{D} ({HEAD_DIM_LABELS[sfx]})"
        rows.update(_attention_rows(gen, Hkv, G, D, 0, sfx, label))
        rows["flash_attention_fwd_fp32" + sfx] = fp32_prefill_row(
            gen, f"{label} S=T=512", B, Hkv, G, S, D, 0)
        # the layouts: checks at the serving shape and at the verify
        # block's, bf16 and fp32, then times at the serving shape
        errs = _check_layouts_case(gen, dt, B, Hkv, G, 1, T, D, 16,
                                   [575 - 8 * b for b in range(B)],
                                   dict(causal=True, window=0, softcap=0.0),
                                   share=3)
        for cdt in (torch.bfloat16, torch.float32):
            _check_layouts_case(gen, cdt, 4, Hkv, G, SPEC_K + 1, T, D, 16,
                                [100, T - SPEC_K - 1, 2100, 40],
                                dict(causal=True, window=0, softcap=0.0),
                                share=2)
        rows.update(_layout_rows(gen, B, Hkv, G, T, D, 16, errs, sfx,
                                 quant="int4"))
    return rows


# the encoder-decoder's attention: seamless-m4t-large-v2's 16 heads of 64
# (G 1), a 512-token prompt over a 512-frame source
ENCDEC_ATTN = (8, 16, 512, 64)       # (B, H, S = T, D)


def kernels_noncausal(gen) -> dict:
    """The kernels with ``causal=False``, as the encoder-decoder calls
    them: the prefill (the encoder's self-attention and the decoder's
    cross-attention) at B 8, S = T = 512, 16 heads of 64, bf16 (model
    layout, every kv tile live) and its fp32 route (the parity phase's),
    both also at S 500 over T 512 (a partial last kv tile); the decode
    kernel of the cross cache, one q row a slot over every source row (B 8,
    T 512), over values and int8 codes; the paged kernels non-causal at
    that shape with their bitwise identities. Checked against the plain
    versions, timed beside them and SDPA (no mask: every pair visible).
    Returns the rows ``flash_attention_fwd_noncausal``,
    ``flash_attention_fwd_fp32_noncausal``, ``flash_decode_fwd_cross`` and
    ``flash_decode_quant_fwd_cross``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.layers import kv_quantize
    B, H, S, D = ENCDEC_ATTN
    dt = torch.bfloat16
    rows = {}
    split = lambda x, n: x.reshape(B, n, H, 1, D).permute(0, 2, 3, 1, 4)
    to4 = lambda x, n: x.permute(0, 3, 1, 2, 4).reshape(B, n, H, D)

    # -- prefill: S = T = 512 and S 500 over T 512, bf16 and fp32 -----------
    for S_q in (S, 500):
        for pdt in (torch.bfloat16, torch.float32):
            q = randn(gen, (B, S_q, H, D), pdt)
            k, v = (randn(gen, (B, S, H, D), pdt) for _ in range(2))
            out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=False)
            qp = torch.arange(S_q, dtype=torch.int32,
                              device=DEVICE).expand(B, S_q)
            kp = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
            args5 = (split(q, S_q), k.transpose(1, 2), v.transpose(1, 2), qp,
                     kp)
            r_out, r_lse = ref.flash_attention_fwd_ref(*args5, causal=False)
            name = (f"prefill non-causal B8 H16 S{S_q} T{S} D64 "
                    f"{str(pdt)[6:]} (model layout)")
            if pdt == torch.bfloat16:
                e = _check_bf16(name, out, to4(r_out, S_q),
                                to4(_abs_v_out(*args5, causal=False), S_q),
                                lse, r_lse)
                if S_q == S:
                    err = e
            else:
                _check(name, out, to4(r_out, S_q), TOL[pdt])
                _check(name, lse, r_lse, TOL[pdt], "lse")
    n_sets = n_sets_for(4 * B * S * H * D * 2)
    sets = [[randn(gen, (B, S, H, D), dt) for _ in range(3)]
            for _ in range(n_sets)]
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    sets5 = [(split(a, S), b.transpose(1, 2), c.transpose(1, 2))
             for a, b, c in sets]
    t_k = device_ms(lambda i: ops.flash_attention_gqa_fwd(*sets[i],
                                                          causal=False),
                    n_sets, 20)
    t_p = device_ms(lambda i: ref.flash_attention_fwd_ref(
        *sets5[i], pos, pos, causal=False), n_sets, 4)
    sets4 = [tuple(x.transpose(1, 2).contiguous() for x in st) for st in sets]
    t_l = device_ms(lambda i: F.scaled_dot_product_attention(*sets4[i]),
                    n_sets, 20)
    del sets, sets4, sets5
    q_bytes = B * S * H * D * 2
    nbytes = 4 * q_bytes + B * H * S * 4 + 2 * pos.nbytes
    flops = 4.0 * D * H * visible_pairs(pos, pos, False, 0)
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    rows["flash_attention_fwd_noncausal"] = dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_l)
    log("kernels", f"prefill non-causal times (B8 H16 S=T=512 D64 bf16): "
        f"kernel {t_k:.4f} ms (through ops), plain {t_p:.4f} ms, sdpa "
        f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
        f"{flops:.3e} FLOP)")
    rows["flash_attention_fwd_fp32_noncausal"] = fp32_prefill_row(
        gen, "non-causal B8 H16 S=T=512 D64", B, H, 1, S, D, 0,
        causal=False)

    # -- decode over the cross cache: q position 0, every source row --------
    T = S
    qp = torch.zeros((B, 1), dtype=torch.int32, device=DEVICE)
    kp = torch.arange(T, dtype=torch.int32, device=DEVICE).expand(B, T) \
        .contiguous()
    to5 = lambda x: x.reshape(B, 1, H, 1, D).permute(0, 2, 3, 1, 4)
    merge = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D)
    flops = 4.0 * D * H * B * T
    base_bytes = 2 * B * H * D * 2 + qp.nbytes + kp.nbytes   # q, out, pos

    def quant_set():
        kq, vq = (kv_quantize(randn(gen, (B, T, H, D), dt), "int8")
                  for _ in range(2))
        return (randn(gen, (B, 1, H, D), dt), kq.codes, kq.scale, vq.codes,
                vq.scale)

    cases = {
        # name: (make one input set, kernel call, plain call, library call,
        #        K / V bytes)
        "flash_decode_fwd_cross": (
            lambda: (randn(gen, (B, 1, H, D), dt),
                     randn(gen, (B, T, H, D), dt),
                     randn(gen, (B, T, H, D), dt)),
            lambda st: ops.flash_decode(*st, qp, kp, causal=False),
            lambda st: merge(ref.flash_decode_fwd_ref(
                to5(st[0]), st[1].transpose(1, 2), st[2].transpose(1, 2),
                qp, kp, causal=False)),
            lambda st: F.scaled_dot_product_attention(st[0], st[1], st[2]),
            2 * B * T * H * D * 2),
        "flash_decode_quant_fwd_cross": (
            quant_set,
            lambda st: ops.flash_decode_quant(*st, qp, kp, causal=False),
            lambda st: merge(ref.flash_decode_quant_fwd_ref(
                to5(st[0]), *(x.transpose(1, 2) for x in st[1:]), qp, kp,
                causal=False)),
            None,
            B * T * H * (2 * D + 2 * 4)),
    }
    for name, (make, kern, plain_fn, lib_fn, kv_bytes) in cases.items():
        sample = make()
        e = _check(f"{name} B8 H16 T512 S1 D64 bf16 non-causal",
                   kern(sample), plain_fn(sample), TOL[dt])
        n_sets = n_sets_for(sum(x.nbytes for x in sample))
        sets = [sample] + [make() for _ in range(n_sets - 1)]
        t_k = device_ms(lambda i: kern(sets[i]), n_sets, 50)
        t_p = device_ms(lambda i: plain_fn(sets[i]), n_sets, 10)
        t_l = None
        if lib_fn is not None:
            sets4 = [tuple(x.transpose(1, 2).contiguous() for x in st)
                     for st in sets]
            t_l = device_ms(lambda i: lib_fn(sets4[i]), n_sets, 50)
            del sets4
        del sets
        nbytes = kv_bytes + base_bytes
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        rows[name] = dict(max_abs_err=e, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                          bound_by=b_by, library_ms=t_l)
        log("kernels", f"{name} times (B8 H16 T512 S1 D64 bf16, non-causal)"
            f": kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            + (f"sdpa (no mask) {t_l:.4f} ms" if t_l is not None
               else f"library: none ({NO_LIBRARY})")
            + f", bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP)")
    # the paged kernels non-causal at this shape: full and partly empty
    # slots, paged == dense and paged-quant == quant bit for bit
    for cdt in (torch.bfloat16, torch.float32):
        _check_layouts_case(gen, cdt, B, H, 1, 1, T, D, 16,
                            [511, 100, 511, 300, 511, 0, 511, 450],
                            dict(causal=False, window=0, softcap=0.0),
                            share=3)
    return rows


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

    rows.update(_layout_rows(gen, B, H, 1, T, D, ps, main_err))
    return rows


def _layout_rows(gen, B, Hkv, G, T, D, ps, errs, suffix="",
                 quant="int8") -> dict:
    """Device times of the quantized and paged decode kernels at a main
    path's shape, one token a slot (bf16, a ring of T, slots 575 - 8 b
    deep): codes of ``quant`` (contiguous), pages of ``ps``, pages of int8
    codes, through ``ops`` as a model calls them, each beside its plain
    version; rows ``flash_decode_quant_fwd``, ``flash_decode_paged_fwd``
    and ``flash_decode_paged_quant_fwd`` plus ``suffix``, their errors from
    ``errs`` (``_check_layouts_case``'s at this shape)."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.layers import kv_quantize
    dt, H = torch.bfloat16, Hkv * G
    qp, kp = ring_positions([575 - 8 * b for b in range(B)], 1, T)
    NP = T // ps
    table = page_table(gen, kp, ps)
    valid_rows = int((kp >= 0).sum())
    flops = 4.0 * D * H * visible_pairs(qp, kp, True, 0)
    base_bytes = 2 * B * H * D * 2 + qp.nbytes + kp.nbytes   # q, out, positions
    P = 1 + B * NP
    to5 = lambda x: x.reshape(B, 1, Hkv, G, D).permute(0, 2, 3, 1, 4)  # noqa: E731
    code_bytes = {"int8": D, "int4": D // 2}

    def quant_set(lead, mode):
        kq, vq = (kv_quantize(randn(gen, lead + (Hkv, D), dt), mode)
                  for _ in range(2))
        return kq.codes, kq.scale, vq.codes, vq.scale

    rows = {}
    cases = {
        # name: (make one input set, kernel call, plain call, bytes, what)
        "flash_decode_quant_fwd": (
            lambda: (randn(gen, (B, 1, H, D), dt),) + quant_set((B, T), quant),
            lambda s: ops.flash_decode_quant(*s, qp, kp),
            lambda s: ref.flash_decode_quant_fwd_ref(
                to5(s[0]), *(x.transpose(1, 2) for x in s[1:]), qp, kp),
            valid_rows * Hkv * (2 * code_bytes[quant] + 2 * 4),
            f"{quant} codes"),
        "flash_decode_paged_fwd": (
            lambda: (randn(gen, (B, 1, H, D), dt),
                     randn(gen, (P, ps, Hkv, D), dt),
                     randn(gen, (P, ps, Hkv, D), dt)),
            lambda s: ops.flash_decode_paged(*s, table, qp, kp),
            lambda s: ref.flash_decode_paged_fwd_ref(to5(s[0]), *s[1:], table,
                                                     qp, kp),
            valid_rows * Hkv * 2 * D * 2 + table.nbytes, f"pages of {ps}"),
        "flash_decode_paged_quant_fwd": (
            lambda: (randn(gen, (B, 1, H, D), dt),) + quant_set((P, ps),
                                                                "int8"),
            lambda s: ops.flash_decode_paged_quant(*s, table, qp, kp),
            lambda s: ref.flash_decode_paged_quant_fwd_ref(to5(s[0]), *s[1:],
                                                           table, qp, kp),
            valid_rows * Hkv * (2 * D + 2 * 4) + table.nbytes,
            f"int8 codes in pages of {ps}"),
    }
    for name, (make, kern, plain_fn, kv_bytes, what) in cases.items():
        sample = make()
        n_sets = n_sets_for(sum(x.nbytes for x in sample))
        sets = [sample] + [make() for _ in range(n_sets - 1)]
        t_k = device_ms(lambda i: kern(sets[i]), n_sets, 50)
        t_p = device_ms(lambda i: plain_fn(sets[i]), n_sets, 10)
        del sets
        nbytes = kv_bytes + base_bytes
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        rows[name + suffix] = dict(max_abs_err=errs[name], ms=t_k,
                                   plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                   library_ms=None)
        log("kernels", f"{name + suffix} times (B{B} Hkv{Hkv} G{G} T{T} S1 "
            f"D{D} bf16, {what}): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops:.3e} FLOP); "
            f"library: none ({NO_LIBRARY})")
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
    """(attention layers, RG-LRU layers) of a model: the layers that hold
    a KV cache (an encoder-decoder's decoder layers), the decode kernel's
    launches of a step in the cache's layout."""
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // 3
        return n_attn, cfg.num_layers - n_attn
    if cfg.family == "ssm":
        return 0, 0
    return cfg.num_layers, 0


def _prefill_attentions(cfg) -> int:
    """Prefill-kernel launches of one prefill: one per attention layer; an
    encoder-decoder's encoder layers and each decoder layer's self- and
    cross-attention."""
    if cfg.family == "audio":
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return _layer_counts(cfg)[0]


def _cross_kernel(decode_kernel: str) -> str:
    """The decode kernel of an encoder-decoder's cross cache beside the self
    cache's ``decode_kernel``: contiguous always, codes when the self cache
    holds codes."""
    return ("flash_decode_quant_fwd" if "quant" in decode_kernel
            else "flash_decode_fwd")


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
    n_pre = _prefill_attentions(cfg)
    want = dict.fromkeys(got, 0)
    want["flash_attention_fwd"] = n_pre * prefills
    if cfg.compute_dtype == "float32":
        want["flash_attention_fwd_fp32"] = n_pre * prefills
    want[decode_kernel] = n_attn * decode_steps + draft_layers * draft_steps
    if cfg.family == "audio":
        want[_cross_kernel(decode_kernel)] += n_attn * decode_steps
    want["rglru_scan"] = n_rec * prefills
    log(phase, f"launches {got} (want {want}: {n_pre} prefill attentions + "
        f"{n_rec} recurrent layers x {prefills} prefills, {n_attn} "
        + ("self + cross " if cfg.family == "audio" else "")
        + f"attention layers x {decode_steps} decode steps"
        + (f", {draft_layers} layers x {draft_steps} draft steps"
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
    largest code difference) of two caches of one layout (an
    encoder-decoder's cross cache too)."""
    from repro_torch.models.layers import PagedKVCache, QKVCache
    err, flips, code_max = 0.0, 0, 0
    for n in ("k", "v", "xk", "xv"):
        if n not in cc:
            continue
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
    want = _prefill_attentions(cfg) * prefills
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


def _drain(eng, reqs, label, decode_kernel, prefix_hits=True) -> dict:
    """Drain ``reqs`` through ``eng``: exact launches, one completion per
    request, each of the right length, every page back (and, with
    ``prefix_hits``, shared prompt pages); returns the engine's stats."""
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
                or eng._host_table.any()
                or (s["prefix_hits"] > 0) != prefix_hits):
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


def _drain_pair(make, reqs, label, decode_kernel, prefix_hits=True,
                keep=False) -> tuple:
    """Drain ``reqs`` through an engine from ``make()`` that runs the chunk
    body eagerly, then through one that replays the captured chunk: the
    same completions, one capture for the whole drain; returns the graph
    engine's stats and completions (and, with ``keep``, the engine)."""
    with eager_chunks():
        eager = make()
        e = _drain(eager, reqs, f"{label}/eager", decode_kernel, prefix_hits)
        want, eager_captures = _completions(eager), e["graph_captures"]
        del eager
    eng = make()
    s = _drain(eng, reqs, f"{label}/graph", decode_kernel, prefix_hits)
    same = _completions(eng) == want
    log(label, f"graph == eager-body completions: {same}; tokens/s graph "
        f"{s['tokens_per_second']:.1f} (wall {s['wall_seconds']:.3f} s, the "
        f"capture's {s['capture_seconds']:.3f} s included), eager "
        f"{e['tokens_per_second']:.1f}")
    if not same or s["graph_captures"] != 1 or eager_captures != 0:
        raise AssertionError(f"{label}: completions equal {same}, captures "
                             f"{s['graph_captures']} / {eager_captures}")
    return (s, want, eng) if keep else (s, want)


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


def phase_engine(model, seed: int) -> None:
    """The requests of ``_engine_requests`` on 8 slots, in the contiguous,
    paged and paged int8 layouts."""
    reqs = _engine_requests(model, seed)
    per_token = {}
    for layout in ENGINE_LAYOUTS:
        s, _ = _drain_pair(
            lambda: _make_engine(model, seed, layout), reqs,
            f"engine/{layout}", LAYOUTS[layout][2])
        per_token[layout] = s["kv_bytes_per_token"]
    base = per_token["contiguous"]
    log("engine", "kv_bytes_per_token " + ", ".join(
        f"{k} {v:.1f} ({v / base:.3f} of contiguous)"
        for k, v in per_token.items()))


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
    from repro_torch.launch.serve import load_model
    m32 = load_model("pimref-100m", smoke=False, seed=seed, device=DEVICE,
                     cfg=model.cfg.replace(compute_dtype="float32"))
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
                draft_layers=None, logits_hook=None, extras=None) -> tuple:
    """Prefill ``toks`` (after a vlm model's ``extras``, its patch prefix)
    into a cache sized for ``gen`` tokens and a verify block's k-ahead
    writes, the drafter's history seeded with the prompts, and the chunk
    step (captured by ``prepare``, or run eagerly; with ``logits_hook``,
    every slot disarmed)."""
    from repro_torch.launch.steps import make_generate_step
    k = SPEC_K if spec != "off" else 0
    extras = extras or {}
    B, P = toks.shape
    n = P + (extras["patch_embeds"].shape[1] if "patch_embeds" in extras
             else 0)
    step = (eager_step if eager else make_generate_step)(
        m, chunk=chunk, spec=spec, spec_k=k, draft_layers=draft_layers,
        logits_hook=logits_hook)
    logits, cache = m.prefill(toks, max_len=n + gen + k, **extras)
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
    """The captured spec chunk (``PROFILE_CHUNK`` iterations) under
    ``torch.profiler``: prefill, warm-up and capture, two replays; the
    prefill and decode kernels' launches by the profiler's kernel events
    equal the counters."""
    chunk = PROFILE_CHUNK
    _reset()
    with traced() as prof:
        step, cache, tok, state = _spec_start(m, toks, spec, 16, chunk)
        for _ in range(2):
            tok = step(cache, tok, None, -1, *state)[1]
        torch.cuda.synchronize()
    kern = kernel_events(prof.key_averages())
    counted = {n: c for counter in _counters() for n, c in counter.items()}
    names = ("flash_attention_fwd", "flash_decode_fwd")
    seen = {n: sum(e.count for e in kern if PROFILED[n] in e.key)
            for n in names}
    want = {n: counted[n] for n in names}
    per_chunk = chunk * (m.cfg.num_layers + SPEC_K * step.draft_layers)
    if want["flash_decode_fwd"] != 3 * per_chunk:
        raise AssertionError(f"{label}: the counters {want}, not "
                             f"{per_chunk} decode launches a chunk")
    _profiled_launches(f"{label} (prefill, warm-up chunk, two replays: "
                       f"{per_chunk} decode-kernel launches a chunk)", prof,
                       kern, seen, want)


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


def phase_spec(model, smi: str, seed: int) -> dict:
    """Speculative decoding (k 3) on full-width pimref-100m, both drafters.

    In the serving dtype (bf16): batch 8 x prompt 512 (``spec_prompts``) +
    ``SPEC_GEN`` new tokens in chunks of 8 in every KV layout, the graph
    replay and
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
    gen, chunk = SPEC_GEN, 8
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
        off = _make_engine(model, seed, layout)
        _drain(off, reqs, f"spec/engine/{layout}/off", LAYOUTS[layout][2])
        want = _completions(off)
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
    cfg = get_config("pimref-100m").replace(num_layers=CUT_PIMREF_LAYERS,
                                            compute_dtype="float32")
    model = load_model("pimref-100m", smoke=False, seed=seed, device=DEVICE,
                       cfg=cfg)
    toks = spec_prompts(cfg.vocab_size, seed=seed)
    offs = {}
    for layout, (kv_quant, page_size, decode_kernel) in LAYOUTS.items():
        m = model.with_kv_layout(kv_quant, page_size)
        off = offs[layout] = spec_drain(m, toks, "off", SPEC_GEN)
        for mode in SPEC_MODES:
            label = f"spec_fp32/{layout}/{mode}"
            g = spec_drain(m, toks, mode, SPEC_GEN)
            same = np.array_equal(g["tokens"], off["tokens"])
            log(label, f"{smi}: fp32 tokens == speculation off: {same}"
                + ("" if same else " (" + _first_differences(
                    g["tokens"], off["tokens"]) + ")")
                + f"; accepted_len_per_draft {g['accepted_len']:.4f}, "
                f"decode {g['wall_s'] * 1e3 / SPEC_GEN:.4f} ms/token-step "
                f"({off['wall_s'] * 1e3 / SPEC_GEN:.4f} off)")
            if not same and kv_quant != "auto":
                failed.append(f"{label}: fp32 greedy tokens differ from "
                              "speculation off")
    step_all = spec_drain(model, toks, "draft", SPEC_GEN,
                          draft_layers=cfg.num_layers)
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
                    logits_hook=None, extras=None) -> tuple:
    """Device ms per iteration (a token-step without speculation) of the
    captured chunk (with ``logits_hook``: hooked, every slot disarmed): the
    prompts ``toks`` prefilled, the chunk captured on their cache, then
    back-to-back replays (the first alone, then ``gen // chunk - 1``) timed
    by CUDA events. Returns (ms per iteration of the later replays, ms of
    the first replay, which uploads the graph to the card)."""
    step = _spec_start(m, toks, spec, gen, chunk,
                       logits_hook=logits_hook, extras=extras)[0]
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


def step_bytes(model, batch: int, depth: int, src: int = 0) -> int:
    """The bytes a decode step of ``batch`` rows must move at least: every
    weight once in the compute dtype (the embedding's ``batch`` rows only,
    unless it is also the head; an MoE layer's experts all, since the
    batch's choices reach every expert at these shapes), and the K/V rows
    each row holds at ``depth`` positions (the window's at most) in the
    model's KV layout (int8 / int4 codes with an fp32 scale a row and
    head). Norm scales count at 4 bytes. An encoder-decoder's step reads its
    decoder (the cross-attention's K / V projections not: the cross cache
    holds their products), its head, and beside the self cache its cross
    cache of ``src`` rows."""
    cfg = model.cfg
    es = torch.finfo(model.cdtype).bits // 8
    n = 0
    for name, p in model.named_parameters():
        if name.startswith("enc_") or ".cross_attn.w_k" in name \
                or ".cross_attn.w_v" in name:
            continue
        if name == "embed" and (not cfg.tie_embeddings
                                or cfg.family == "audio"):
            n += batch * cfg.d_model * es
        else:
            n += p.numel() * (4 if p.dtype == torch.float32 and p.ndim == 1
                              else es)
    depth = min(depth, model.cache_len(depth))
    row = {"off": cfg.resolved_head_dim * es,
           "int8": cfg.resolved_head_dim + 4,
           "int4": cfg.resolved_head_dim // 2 + 4}.get(model.kv_quant,
                                                       cfg.resolved_head_dim)
    n_attn = _layer_counts(cfg)[0]
    return n + 2 * n_attn * batch * (depth + src) * cfg.num_kv_heads * row


def _serve_engines(model, smi, label, decode_kernel="flash_decode_fwd",
                   engines=ENGINES, **kw) -> dict:
    """Batch serving with each of ``engines`` (ENGINES, or the first two)
    after a short warm-up run: exact launches, tokens in range, the same
    tokens from every engine, the graph's decode ms per token-step below
    the eager chunk's; logs the graph's device ms per step; returns the
    graph run's launches."""
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    serve(model=model, engine="fused", **{**kw, "gen": 8})   # first calls
    runs, launches = {}, None
    for name in engines:
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
               for n in engines[1:])
    log(label, f"{' == '.join(engines)} tokens: {same}")
    if not same:
        raise AssertionError(f"{label}: greedy tokens of {engines} differ")
    from repro_torch.launch.serve import serve_batch
    m = model.with_kv_layout(kw.get("kv_quant", "off"),
                             kw.get("page_size", 0))
    toks, extras = serve_batch(cfg, kw["batch"], kw["prompt_len"], kw["seed"],
                               DEVICE)                 # serve()'s prompts
    dev, first = graph_device_ms(m, toks, kw["gen"], kw["chunk"],
                                 extras=extras)
    g, e = (runs[n]["decode_s_per_tok"] * 1e3 for n in ("graph", "eager"))
    src = extras.get("src_embeds")
    nbytes = step_bytes(m, kw["batch"], kw["prompt_len"] + kw["gen"] // 2,
                        0 if src is None else src.shape[1])
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(label, f"{smi}: decode ms per token-step: graph {g:.4f}, its device "
        f"time {dev:.4f} (wall / device {g / dev:.2f}; a first replay "
        f"{first:.3f} ms, {first / kw['chunk']:.4f} a step); eager chunk "
        f"{e:.4f} ({e / g:.2f}x the graph); the step's byte bound "
        f"{b_ms:.4f} ms ({nbytes} B: the weights in the compute dtype and "
        f"the K/V held at the mean depth, at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s; device / bound {dev / b_ms:.2f})")
    READINGS[label] = dict(prefill_ms=runs["graph"]["prefill_s"] * 1e3,
                           decode_ms=g, decode_device_ms=dev)
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


# ---------------------------------------------------------------------------
# the MoE and VLM families and the other dense architectures
# ---------------------------------------------------------------------------
# depth cuts that fit one 80 GB card: ServingLM holds fp32 weights and a bf16
# copy, 6 bytes a weight (mixtral 6 of 32 layers: 8.97 G parameters, 53.8 GB;
# pixtral 20 of 40: 6.79 G, 40.8 GB); cut again to 2 and 4 so that
# the run with the families' training stays inside its time limit, and to
# 1 and 2 (stablelm-3b's and kimi-k2's phases); widths,
# experts, top-k, capacity,
# window, heads and vocab are the published ones
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 1
VLM_ARCH, VLM_LAYERS = "pixtral-12b", 2
FAMILY_PARITY_LAYERS = 2
MOE_LAYOUTS = ("contiguous", "int8", "paged16", "paged16_int8")
VLM_LAYOUTS = ("contiguous", "paged16")
FAMILY_ENGINE_LAYOUTS = ("contiguous", "paged16")
# full width: stablelm-1.6b (D 64, 32 heads = kv heads) and internlm2-1.8b
# (D 128, G 2) at ARCHS_LAYERS of their 24 (cut to pay for
# stablelm-3b's and kimi-k2's runs within the time limit), stablelm-3b (D
# 80, MHA; 2.80 G parameters, 16.8 GB at 6 bytes a weight) at full depth
ARCHS = ("stablelm-1.6b", "internlm2-1.8b", "stablelm-3b")
ARCHS_LAYERS = {"stablelm-1.6b": 4, "internlm2-1.8b": 4}
# stablelm-3b's layouts beside contiguous, served three ways too: BITS 4
# and, through pages of 16, 8; its engine drains run contiguous and paged16
# over D80_REQUESTS requests (one wave of the 8 slots, for the time limit:
# the eager drain takes ~100 ms a step at 32 layers)
D80_LAYOUTS = ("int4", "paged16_int8")
D80_REQUESTS = dict(requests=8, prompt_len=256, gen=32, shared_prefix=64)
# kimi-k2 (D 112, 64 q heads on 8 kv heads) at full width and 1 of its 61
# layers: all 384 experts, top 8, bf16 weights as its config holds them
# (19.4 G parameters, 38.8 GB); its depth does not fit one card. Served
# three ways in contiguous, graph and eager chunk in the other layouts
KIMI_ARCH, KIMI_LAYERS = "kimi-k2-1t-a32b", 1
KIMI_LAYOUTS = ("contiguous", "int4", "paged16", "paged16_int8")
KIMI_PEAK = 75e9
# stablelm-3b fp32 card against CPU (phase parity_archs): 2 layers of full
# width (0.42 G parameters), prefill 64 + 8 decode steps
D80_PARITY_LAYOUTS = ("contiguous", "int8")


def _load_cut(arch, layers, seed, **replace):
    """``arch`` at full width, its depth cut to ``layers``, on the card,
    weights drawn in place from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_model
    full = get_config(arch)
    cfg = full.replace(num_layers=layers, **replace)
    t0 = time.perf_counter()
    model = load_model(arch, smoke=False, seed=seed, device=DEVICE, cfg=cfg)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    cut = (f"depth cut {full.num_layers} -> {layers} layers"
           if layers < full.num_layers else f"{layers} layers (full depth)")
    log(arch, f"{arch} {cut}, full "
        f"width (d_model {cfg.d_model}, {cfg.num_heads} q / "
        f"{cfg.num_kv_heads} kv heads of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, experts {cfg.num_experts} top-{cfg.experts_per_token}, "
        f"vocab {cfg.vocab_size}, window {cfg.sliding_window if cfg.attention_kind == 'sliding' else 0}"
        f"): {n} params, compute {cfg.compute_dtype}, built in "
        f"{time.perf_counter() - t0:.2f}s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    return model


def _fp32_view(model):
    """``model``'s weights (held in fp32) computing in fp32: no copy."""
    m = copy.copy(model)
    m.cfg = model.cfg.replace(compute_dtype="float32")
    m.cdtype = torch.float32
    m._cast = {}
    return m


def _family_drains(model, smi, label, seed, reqs, prefix_hits) -> dict:
    """The graph against the eager body over ``reqs`` in the contiguous and
    paged16 layouts (8 slots, a 512 bucket, up to 64 new tokens); returns
    each layout's graph engine."""
    from repro_torch.launch.serve import make_queue_engine
    engines = {}
    for layout in FAMILY_ENGINE_LAYOUTS:
        kv_quant, page_size, decode_kernel = LAYOUTS[layout]

        def make():
            return make_queue_engine(model=model, slots=8, prompt_len=512,
                                     gen=64, chunk=8, seed=seed,
                                     kv_quant=kv_quant, page_size=page_size)
        s, _, eng = _drain_pair(make, reqs, f"{label}/{layout}",
                                decode_kernel, prefix_hits, keep=True)
        log(f"{label}/{layout}", f"{smi}: drain {s['tokens_per_second']:.1f} "
            f"tokens/s ({s['tokens_out']} tokens, wall "
            f"{s['wall_seconds']:.3f} s with the capture's "
            f"{s['capture_seconds']:.3f} s)")
        engines[layout] = eng
    return engines


def phase_moe(smi: str, seed: int) -> dict:
    """mixtral-8x7b at full width, MOE_LAYERS of 32 layers: batch 8 x 512 + 64 in
    four layouts and 2 x 4200 + 32 past the window, three ways each, exact
    launches; the engine phase's requests drained graph against eager body;
    a profile. Returns the launches of the graph runs."""
    model = _load_cut(MOE_ARCH, MOE_LAYERS, seed)
    launches = {}
    for layout in MOE_LAYOUTS:
        kv_quant, page_size, decode_kernel = LAYOUTS[layout]
        launches[f"moe/{layout}"] = _serve_engines(
            model, smi, f"moe/{layout}", decode_kernel, batch=8,
            prompt_len=512, gen=64, chunk=8, seed=0, kv_quant=kv_quant,
            page_size=page_size)
    W = model.cfg.sliding_window
    if model.cache_len(4200 + 32) != W:
        raise AssertionError(f"moe long: ring of {model.cache_len(4232)} "
                             f"slots, not the window {W}")
    launches["moe/long"] = _serve_engines(model, smi, "moe/long", batch=2,
                                          prompt_len=4200, gen=32, chunk=8,
                                          seed=1)
    _family_drains(model, smi, "engine_moe", seed,
                   _engine_requests(model, seed), prefix_hits=True)
    phase_profile(model, smi, "profile_moe")
    del model
    torch.cuda.empty_cache()
    return launches


def _vlm_requests(model, seed: int) -> list:
    """24 mixed requests, each with its 256-row patch prefix (the 512
    bucket's), prompts up to the 256-token field."""
    from repro_torch.launch.serve import synth_requests
    return synth_requests(cfg=model.cfg, requests=24, prompt_len=512, gen=64,
                          seed=seed)


def phase_vlm(smi: str, seed: int) -> dict:
    """pixtral-12b at full width, VLM_LAYERS of 40 layers: batch 8 x 512 (256
    patches + 256 tokens) + 64, contiguous and paged16, and 2 x 2048 with
    the full 1024-patch prefix, three ways each, exact launches;
    ``serve(spec="ngram")`` against speculation off (bf16 recorded, fp32
    gated); drains of patch-prefixed requests (no prefix hits) and a
    malformed extra. Returns the launches of the graph runs."""
    from repro_torch.launch.engine import Request
    model = _load_cut(VLM_ARCH, VLM_LAYERS, seed)
    launches = {}
    kw = dict(batch=8, prompt_len=512, gen=64, chunk=8, seed=0)
    for layout in VLM_LAYOUTS:
        kv_quant, page_size, decode_kernel = LAYOUTS[layout]
        launches[f"vlm/{layout}"] = _serve_engines(
            model, smi, f"vlm/{layout}", decode_kernel, kv_quant=kv_quant,
            page_size=page_size, **kw)
    launches["vlm/long"] = _serve_engines(model, smi, "vlm/long", batch=2,
                                          prompt_len=2048, gen=32, chunk=8,
                                          seed=1)
    cfg = model.cfg
    for m, dtype in ((model, "bf16"), (_fp32_view(model), "fp32")):
        label = f"vlm/spec_{dtype}"
        off = _serve_as("graph", model=m, **kw)
        _reset()
        on = _serve_as("graph", model=m, spec="ngram", spec_k=SPEC_K, **kw)
        _check_launches(label, m.cfg, on["prefills"], on["decode_steps"])
        same = np.array_equal(on["tokens"], off["tokens"])
        log(label, f"{smi}: serve(spec='ngram') tokens == speculation off: "
            f"{same}" + ("" if same else " (" + _first_differences(
                on["tokens"], off["tokens"]) + ")")
            + f"; accepted_len_per_draft {on['accepted_len_per_draft']:.4f}"
            f", decode {on['decode_s_per_tok'] * 1e3:.4f} ms/token-step "
            f"({off['decode_s_per_tok'] * 1e3:.4f} off)")
        if dtype == "fp32" and not same:
            raise AssertionError(f"{label}: fp32 greedy tokens with "
                                 "speculation differ from speculation off")
    engines = _family_drains(model, smi, "engine_vlm", seed,
                             _vlm_requests(model, seed), prefix_hits=False)
    eng = engines["contiguous"]
    P = eng._prefix_len
    bad = Request(uid=999, tokens=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=4, extras={"patch_embeds": np.zeros(
                      (1, P - 1, cfg.d_model), np.float32)})
    _reset()
    c = eng.run([bad])[-1]
    counted = sum(n for counter in _counters() for n in counter.values())
    log("engine_vlm", f"a patch prefix of {P - 1} rows (the bucket's {P}): "
        f"{c.finish_reason} / {c.reason} ({c.error}); launches {counted}")
    if c.uid != 999 or c.reason != "bad_request" or counted:
        raise AssertionError(f"engine_vlm: malformed extra gave {c}, "
                             f"{counted} launches")
    del model, engines, eng
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def recorded_routing(calls: list):
    """Inside, every MoE layer's routing (probs, gate, idx, pos, keep) is
    appended to ``calls``, copied to the host (eager runs only)."""
    from repro_torch.models import moe
    route = moe.route

    def recording(cfg, router, xt):
        out = route(cfg, router, xt)
        calls.append(tuple(t.detach().cpu() for t in out))
        return out
    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def _routing_diff(label, cpu_calls, gpu_calls) -> None:
    """idx, pos and keep of every MoE call equal, card against CPU; a flip
    is reported with its router margin (the CPU's gap between the k-th and
    the next probability of that token)."""
    if len(cpu_calls) != len(gpu_calls):
        raise AssertionError(f"{label}: {len(cpu_calls)} MoE calls on the "
                             f"CPU, {len(gpu_calls)} on the card")
    flips = []
    margins = []
    for i, (c, g) in enumerate(zip(cpu_calls, gpu_calls)):
        probs = c[0]
        top = torch.sort(probs, dim=-1, descending=True).values
        K = c[2].shape[1]
        gap = top[:, K - 1] - top[:, K]
        margins.append(gap.min().item())
        for name, j in (("idx", 2), ("pos", 3), ("keep", 4)):
            bad = (c[j] != g[j]).any(-1).nonzero().flatten().tolist()
            if bad:
                flips.append(f"call {i} {name} tokens {bad[:6]} (router "
                             f"margin {gap[bad[0]].item():.3e})")
    log(label, f"routing card vs CPU over {len(cpu_calls)} MoE calls "
        f"({sum(c[2].shape[0] for c in cpu_calls)} tokens): equal "
        f"{not flips}; smallest router margin (k-th minus next probability) "
        f"{min(margins):.3e}" + ("" if not flips else "; " + "; ".join(flips)))
    if flips:
        raise AssertionError(f"{label}: routing differs: {flips}")


def _parity_family(label, arch, seed, patch_rows=0, src_rows=0,
                   layouts=FAMILY_ENGINE_LAYOUTS) -> dict:
    """``arch`` at full width, FAMILY_PARITY_LAYERS layers (an
    encoder-decoder's encoder too), fp32 (TF32 off): logits of a 64-token
    prefill (after ``patch_rows`` patch embeddings; over ``src_rows``
    source frames) and 8 decode steps, card against CPU, in ``layouts``,
    within PARITY_ATOL (an int8 cache: PARITY_INT8_ATOL, codes within one
    step); an MoE model's routing equal. Returns the card side's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_model
    from repro_torch.models import build_model
    full = get_config(arch)
    cfg = full.replace(num_layers=FAMILY_PARITY_LAYERS,
                       compute_dtype="float32")
    if cfg.is_encoder_decoder:
        cfg = cfg.replace(num_encoder_layers=FAMILY_PARITY_LAYERS)
    t0 = time.perf_counter()
    # drawn on the card (the host's generator takes ~25 s for mixtral's
    # 3.2 G parameters), copied to the host
    gpu0 = load_model(arch, smoke=False, seed=seed, device=DEVICE, cfg=cfg)
    cpu0 = build_model(cfg, "cpu")
    cpu0.load_state_dict(gpu0.state_dict())
    n = sum(p.numel() for p in cpu0.parameters())
    log(label, f"{arch} depth cut {full.num_layers} -> "
        f"{cfg.num_layers} layers" + (
            f" (encoder {full.num_encoder_layers} -> "
            f"{cfg.num_encoder_layers})" if cfg.is_encoder_decoder else "")
        + f", full width, fp32: {n} params "
        f"({4 * n / 1e9:.1f} GB on the host and on the card), built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                              .astype(np.int32))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    extras = {}
    if patch_rows:
        extras["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, patch_rows, cfg.d_model)).astype(np.float32))
    if src_rows:
        extras["src_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, src_rows, cfg.d_model)).astype(np.float32))
    max_len = 64 + patch_rows + 8
    _reset()
    for layout in layouts:
        kv_quant, page_size, _ = LAYOUTS[layout]
        cpu = cpu0.with_kv_layout(kv_quant, page_size)
        gpu = gpu0.with_kv_layout(kv_quant, page_size)
        rc, rg = [], []
        with recorded_routing(rc):
            lc, cc = cpu.prefill(prompt, max_len=max_len, **extras)
            pc = [lc]
            for i in range(feed.shape[1]):
                lc, cc = cpu.decode_step(cc, feed[:, i:i + 1])
                pc.append(lc)
        with recorded_routing(rg):
            lg, cg = gpu.prefill(prompt.to(DEVICE), max_len=max_len,
                                 **{k: x.to(DEVICE) for k, x in extras.items()})
            pg = [lg]
            for i in range(feed.shape[1]):
                lg, cg = gpu.decode_step(cg, feed[:, i:i + 1].to(DEVICE))
                pg.append(lg)
        if cfg.num_experts:
            _routing_diff(f"{label}/{layout}", rc, rg)
        errs = [(c - g.cpu()).abs().max().item() for c, g in zip(pc, pg)]
        agree = np.mean([float((c.argmax(-1) == g.cpu().argmax(-1)).all())
                         for c, g in zip(pc, pg)])
        kv, flips, code_max = _cache_diff(cc, cg)
        tol = PARITY_INT8_ATOL if kv_quant != "off" else PARITY_ATOL
        log(f"{label}/{layout}", f"fp32 logits card vs CPU, prefill "
            f"{patch_rows} patches + 64 tokens" + (
                f" over {src_rows} source frames" if src_rows else "")
            + f", 8 decode steps: max_abs_err per call "
            f"{['%.2e' % e for e in errs]} (tol {tol:.0e}), logit scale "
            f"{pc[0].abs().max().item():.3e}, cache {kv:.2e}, codes "
            f"differing {flips} (largest difference {code_max}), top-1 "
            f"agreement {agree:.3f}")
        if max(errs) > tol or kv > PARITY_ATOL or code_max > 1:
            raise AssertionError(f"{label}/{layout}: card vs CPU differ: "
                                 f"logits {max(errs)}, cache {kv}, code "
                                 f"{code_max}")
    launches = _check_fp32_prefills(label, cfg, len(layouts))
    del cpu0, gpu0
    torch.cuda.empty_cache()
    return launches


ENCDEC_ARCH = "seamless-m4t-large-v2"
# 2 of its 24 encoder and 24 decoder layers: the run with the families'
# training (at 4 layers) and stablelm-3b's and kimi-k2's phases stays
# inside its time limit
ENCDEC_LAYERS = 2
ENCDEC_LAYOUTS = ("contiguous", "int8", "paged16", "paged16_int8")
ENCDEC_PARITY_LAYOUTS = ("contiguous", "paged16", "int8")


def phase_encdec(smi: str, seed: int) -> dict:
    """seamless-m4t-large-v2 at full width, ``ENCDEC_LAYERS`` of its 24
    encoder and 24 decoder layers: batch 8 x 512 tokens over 512 source
    frames + 64 in four layouts, graph and eager chunk (and the per-token
    loop, contiguous), identical tokens (3 x ENCDEC_LAYERS prefill launches
    a prefill; per step the self cache's decode kernel and the cross
    cache's contiguous one, ENCDEC_LAYERS each), the graph's device ms a
    step against its byte bound; 24
    requests with their source frames drained graph against eager body
    (contiguous, paged16; no prefix hits), a misshaped source extra
    (``bad_request``, nothing launched); a profile. Returns the launches of
    the graph runs."""
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import synth_requests
    model = _load_cut(ENCDEC_ARCH, ENCDEC_LAYERS, seed,
                      num_encoder_layers=ENCDEC_LAYERS)
    launches = {}
    for layout in ENCDEC_LAYOUTS:
        kv_quant, page_size, decode_kernel = LAYOUTS[layout]
        # the per-token loop (5 s a layout) in the contiguous layout only:
        # the run's time limit (the CPU tests hold loop == fused in six)
        launches[f"encdec/{layout}"] = _serve_engines(
            model, smi, f"encdec/{layout}", decode_kernel,
            engines=ENGINES if layout == "contiguous" else ENGINES[:2],
            batch=8, prompt_len=512, gen=64, chunk=8, seed=0,
            kv_quant=kv_quant, page_size=page_size)
    cfg = model.cfg
    reqs = synth_requests(cfg=cfg, requests=24, prompt_len=512, gen=64,
                          seed=seed)
    engines = _family_drains(model, smi, "engine_encdec", seed, reqs,
                             prefix_hits=False)
    eng = engines["contiguous"]
    src = eng._batch_template["src_embeds"].shape
    bad = Request(uid=999, tokens=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=4, extras={"src_embeds": np.zeros(
                      (1, src[1] - 1, cfg.d_model), np.float32)})
    _reset()
    c = eng.run([bad])[-1]
    counted = sum(n for counter in _counters() for n in counter.values())
    log("engine_encdec", f"source frames {src[1] - 1} (the bucket's "
        f"{src[1]}): {c.finish_reason} / {c.reason} ({c.error}); launches "
        f"{counted}")
    if c.uid != 999 or c.reason != "bad_request" or counted:
        raise AssertionError(f"engine_encdec: malformed extra gave {c}, "
                             f"{counted} launches")
    del engines, eng
    # the graph serve only, chunks of 4: reading a trace takes ~0.7 ms a
    # launch (the eager serve's 61,866 took ~60 s; 8-step chunks' ~48 s)
    phase_profile(model, smi, "profile_encdec", engines=("graph",), chunk=4)
    del model
    torch.cuda.empty_cache()
    return launches


XLSTM_ARCH = "xlstm-125m"
XLSTM_SHAPE = (8, 512, 64)          # batch, prompt, new tokens
XLSTM_PARITY_SHAPE = (2, 512, 8)    # two mLSTM chunks, then decode steps
# fp32 card vs CPU, and the card against a float64 run of the port on the
# CPU: of a tensor's largest |value| (logits; each block's C / n / m or c /
# n / m / h). Not the 1e-4 of the smoke-size CPU tests: at full width the
# model is ill-conditioned in fp32 (an mLSTM's denominator max(|q.n|,
# exp(-m)) divides by a dot product that cancels; 12 layers over 512
# steps), and each fp32 side lies up to ~2e-4 from the float64 run (the
# phase logs both distances; the H100 read 2.2e-4 for the card, 1.8e-4
# for the CPU, 2.3e-4 card against CPU)
XLSTM_PARITY_REL = 5e-4


def _xlstm_tokens(cfg, batch, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, n))
                            .astype(np.int32)).to(DEVICE)


def _xlstm_run(model, toks, gen, chunk, how) -> tuple:
    """``gen`` greedy tokens after a prefill of ``toks``: ``graph`` (the
    captured chunk, captured before the timed region), ``eager`` (its body)
    or ``loop`` (one ``decode_step`` a token). Returns (tokens, prefill s,
    decode s, capture s)."""
    from repro_torch.launch.steps import make_generate_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    cap = 0.0
    out = []
    if how == "loop":
        t0 = time.perf_counter()
        for _ in range(gen):
            out.append(tok.cpu().numpy())
            logits, cache = model.decode_step(cache, tok)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
    else:
        step = (eager_step if how == "eager" else make_generate_step)(
            model, chunk=chunk)
        t0 = time.perf_counter()
        step.prepare(cache, tok, None)
        torch.cuda.synchronize()
        cap = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(gen // chunk):
            o = step(cache, tok, None, -1)
            tok = o[1]
            out.append(o[5].cpu().numpy())
    t_dec = time.perf_counter() - t0
    return np.concatenate(out, axis=1), t_pre, t_dec, cap


@contextlib.contextmanager
def float64_port(model):
    """A float64 run of the port's xLSTM on the CPU: a float64 copy of
    ``model`` (weights, compute dtype, the recurrent states: the serving
    cache's and a training forward's zero states) with the model code's
    fp32 upcasts (``Tensor.float``) promoted to float64 while inside. The
    yardstick of the fp32 parity's tolerance."""
    from repro_torch.models import recurrent_lm, xlstm
    m = copy.deepcopy(model).double()
    m.cdtype, m._cast = torch.float64, {}
    inits = {(mod, n): getattr(mod, n) for mod in (recurrent_lm, xlstm)
             for n in ("init_mlstm_state", "init_slstm_state")}
    upcast = torch.Tensor.float
    torch.Tensor.float = lambda t: t.to(torch.float64)
    for (mod, n), f in inits.items():
        setattr(mod, n, lambda *a, f=f, **k: {
            name: v.double() for name, v in f(*a, **k).items()})
    try:
        yield m
    finally:
        torch.Tensor.float = upcast
        for (mod, n), f in inits.items():
            setattr(mod, n, f)


def phase_xlstm(smi: str, seed: int) -> dict:
    """xlstm-125m at full size (12 layers: 9 mLSTM, 3 sLSTM): ``prefill``
    8 x 512, then 64 greedy tokens by the captured chunk, its eager body
    and a per-token ``decode_step`` loop: identical tokens, no kernel
    launched; prefill ms, ms a token-step and the graph's device ms a step.
    Then fp32 card against CPU at full depth (2 x 512, two mLSTM chunks,
    then 8 decode steps): logits and every block's states within
    XLSTM_PARITY_REL of their largest |value|, and the card's within it of
    a float64 run of the port (both fp32 sides' distances logged)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import clone_cache, make_generate_step
    from repro_torch.models import build_model, init_params_
    model = _load_cut(XLSTM_ARCH, get_config(XLSTM_ARCH).num_layers, seed)
    cfg = model.cfg
    B, P, gen = XLSTM_SHAPE
    chunk = 8
    toks = _xlstm_tokens(cfg, B, P, seed)
    _xlstm_run(model, toks, chunk, chunk, "graph")          # first calls
    runs = {}
    for how in ENGINES:
        _reset()
        runs[how] = _xlstm_run(model, toks, gen, chunk, how)
        counted = {n: c for counter in _counters()
                   for n, c in counter.items() if c}
        t, t_pre, t_dec, cap = runs[how]
        log(f"xlstm/{how}", f"{smi}: prefill {t_pre * 1e3:.3f} ms (B={B} x "
            f"{P}), decode {t_dec / gen * 1e3:.4f} ms/token-step"
            + (f", capture {cap * 1e3:.3f} ms (its eager warm-up chunk "
               "included)" if how == "graph" else "")
            + f"; kernel launches {counted or 0}")
        if counted:
            raise AssertionError(f"xlstm/{how}: launched {counted}")
        if t.shape != (B, gen) or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"xlstm/{how}: bad tokens {t.shape}")
    same = all(np.array_equal(runs["graph"][0], runs[n][0])
               for n in ENGINES[1:])
    log("xlstm", f"graph == eager chunk == loop tokens: {same}")
    if not same:
        raise AssertionError("xlstm: greedy tokens of the three ways differ")
    # the graph's device time a step: back-to-back replays
    logits, cache = model.prefill(toks)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    step = make_generate_step(model, chunk=chunk)
    step.prepare(cache, tok, None)
    graph = step._captured.graph
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    graph.replay()
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(gen // chunk):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    dev = ev[0].elapsed_time(ev[1]) / gen
    g = runs["graph"][2] / gen * 1e3
    e = runs["eager"][2] / gen * 1e3
    nbytes = sum(p.numel() * (4 if p.ndim == 1 else 2)
                 for p in model.parameters()) \
        + 2 * sum(t.nbytes for st in cache["blocks"] for t in st.values())
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log("xlstm", f"{smi}: decode ms per token-step: graph {g:.4f}, its "
        f"device time {dev:.4f}; eager chunk {e:.4f} ({e / g:.2f}x the "
        f"graph); the step's byte bound {b_ms:.4f} ms ({nbytes} B: the "
        f"weights in bf16 (the tied embedding read whole as the head), the "
        f"states read and written in fp32; device / bound {dev / b_ms:.2f})")
    del step, graph, cache, model
    torch.cuda.empty_cache()

    # -- fp32, card against CPU, full depth ----------------------------------
    cfg32 = get_config(XLSTM_ARCH).replace(compute_dtype="float32")
    gpu = build_model(cfg32, DEVICE)
    init_params_(gpu, torch.Generator(device=DEVICE).manual_seed(seed))
    cpu = build_model(cfg32, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    B, P, steps = XLSTM_PARITY_SHAPE
    prompt = _xlstm_tokens(cfg32, B, P, seed + 1).cpu()
    feed = _xlstm_tokens(cfg32, B, steps, seed + 2).cpu()

    def drive(m):
        """Logits of the prefill and each step; states after both."""
        lg, c = m.prefill(prompt.to(m.device))
        logits, states = [lg], [clone_cache(c)]
        for i in range(steps):
            lg, c = m.decode_step(c, feed[:, i:i + 1].to(m.device))
            logits.append(lg)
        return logits, states + [c]

    t0 = time.perf_counter()
    pc, sc = drive(cpu)
    t_cpu = time.perf_counter() - t0
    pg, sg = drive(gpu)
    with float64_port(cpu) as cpu64:
        p64, s64 = drive(cpu64)

    def rel(c, g):
        c, g = c.double(), g.double().cpu()
        return ((c - g).abs().max() / c.abs().max().clamp(min=1e-30)).item()

    def dists(a, b, sa, sb):
        """(logit distance per call, worst state and its distance)."""
        st = {f"{when} {i}.{k}": rel(x["blocks"][i][k], y["blocks"][i][k])
              for when, x, y in zip(("prefill", "last step"), sa, sb)
              for i in range(cfg32.num_layers) for k in x["blocks"][i]}
        worst = max(st, key=st.get)
        return [rel(x, y) for x, y in zip(a, b)], worst, st[worst]
    errs, worst, w_err = dists(pc, pg, sc, sg)
    log("xlstm/parity", f"fp32 card vs CPU, full depth, prefill {B} x {P} "
        f"+ {steps} decode steps (CPU side {t_cpu:.1f} s): logits error / "
        f"largest |logit| per call {['%.1e' % e for e in errs]} (largest "
        f"|logit| {pc[0].abs().max().item():.3e}); states after the prefill "
        f"and the last step, worst: {worst} {w_err:.2e} of its largest "
        f"|value| (tol {XLSTM_PARITY_REL:.0e})")
    far = {}
    for side, lo, so in (("card", pg, sg), ("CPU", pc, sc)):
        e64, w64, we64 = dists(p64, lo, s64, so)
        far[side] = max(max(e64), we64)
        log("xlstm/parity", f"fp32 {side} vs a float64 run of the port (on "
            f"the CPU): logits per call {['%.1e' % e for e in e64]}, states "
            f"worst {w64} {we64:.2e}")
    if max(max(errs), w_err, far["card"]) > XLSTM_PARITY_REL:
        raise AssertionError(f"xlstm parity: card vs CPU logits "
                             f"{max(errs)}, states {worst} {w_err}; card vs "
                             f"float64 {far['card']}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return {}


def phase_archs(smi: str, seed: int) -> dict:
    """The dense archs at full width (ARCHS, ARCHS_LAYERS), batch 8 x 512 +
    64, three ways, exact launches; stablelm-3b (D 80) also in
    D80_LAYOUTS three ways, its engine drains (contiguous, paged16) and a
    profile whose kernel events equal the counters; then kimi-k2 (D 112,
    ``phase_kimi``). Returns the graph runs' launches (and the paged16
    graph drain's, ``archs/stablelm-3b/engine_paged16``)."""
    from repro_torch.configs import get_config
    launches = {}
    kw = dict(batch=8, prompt_len=512, gen=64, chunk=8, seed=0)
    for arch in ARCHS:
        model = _load_cut(arch, ARCHS_LAYERS.get(
            arch, get_config(arch).num_layers), seed)
        label = f"archs/{arch}"
        launches[label] = _serve_engines(model, smi, label, **kw)
        if arch == "stablelm-3b":
            for layout in D80_LAYOUTS:
                kv_quant, page_size, decode_kernel = LAYOUTS[layout]
                launches[f"{label}/{layout}"] = _serve_engines(
                    model, smi, f"{label}/{layout}", decode_kernel,
                    kv_quant=kv_quant, page_size=page_size, **kw)
            from repro_torch.launch.serve import synth_requests
            _family_drains(model, smi, f"{label}/engine", seed,
                           synth_requests(cfg=model.cfg, seed=seed,
                                          **D80_REQUESTS), prefix_hits=True)
            # the counters hold the last drain's: paged16's graph engine
            launches[f"{label}/engine_paged16"] = {
                n: c for counter in _counters() for n, c in counter.items()}
            phase_profile(model, smi, f"profile_{label}", engines=("graph",))
        del model
        torch.cuda.empty_cache()
    launches.update(phase_kimi(smi, seed))
    return launches


def phase_kimi(smi: str, seed: int) -> dict:
    """kimi-k2 at full width and KIMI_LAYERS of its 61 layers (bf16
    weights): batch 8 x 512 + 64 in KIMI_LAYOUTS (contiguous three ways,
    the others graph and eager chunk), exact launches, a profile whose
    kernel events equal the counters; its peak device memory under
    KIMI_PEAK. Returns the graph runs' launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _load_cut(KIMI_ARCH, KIMI_LAYERS, seed)
    label = f"archs/{KIMI_ARCH}"
    launches = {}
    for layout in KIMI_LAYOUTS:
        kv_quant, page_size, decode_kernel = LAYOUTS[layout]
        tag = label if layout == "contiguous" else f"{label}/{layout}"
        launches[tag] = _serve_engines(
            model, smi, tag, decode_kernel,
            engines=ENGINES if layout == "contiguous" else ENGINES[:2],
            batch=8, prompt_len=512, gen=64, chunk=8, seed=0,
            kv_quant=kv_quant, page_size=page_size)
    phase_profile(model, smi, f"profile_{label}", engines=("graph",))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(label, f"{smi}: peak device memory {peak / 1e9:.2f} GB (limit "
        f"{KIMI_PEAK / 1e9:.0f} GB)")
    if peak > KIMI_PEAK:
        raise AssertionError(f"{label}: peak {peak / 1e9:.2f} GB over "
                             f"{KIMI_PEAK / 1e9:.0f} GB")
    del model
    torch.cuda.empty_cache()
    return launches


# counter -> the kernel whose launches the profiler counts for it
PROFILED = {"flash_attention_fwd": "flash_prefill_kernel<",
            "flash_decode_fwd": "flash_decode_kernel<",
            "rglru_scan": "rglru_scan_kernel<"}


def phase_profile(model, smi: str, label: str = "profile",
                  engines=("graph", "eager"),
                  chunk: int = PROFILE_CHUNK) -> None:
    """``torch.profiler`` over one batch-mode serve (B 8 x 512, prefill, the
    warm-up chunk and two chunks of ``chunk``) with the graph and with the eager
    chunk: busy share, kernels by device time, and the launches of the
    prefill, decode and RG-LRU kernels by the profiler's kernel events
    against the launch counters; ``engines`` names the runs profiled,
    ``chunk`` the chunk's steps; each trace takes TRAIN_TRACE_LEAD lead
    kernels."""
    from repro_torch.launch.serve import serve
    kw = dict(model=model, batch=8, prompt_len=512, gen=2 * chunk,
              chunk=chunk, seed=0)
    serve(engine="fused", **kw)                   # allocator and cuBLAS warm
    torch.cuda.synchronize()
    for name in engines:
        tag = f"{label}/{name}"
        _reset()
        with traced(TRAIN_TRACE_LEAD) as prof:
            t0 = time.perf_counter()
            out = _serve_as(name, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = kernel_events(prof.key_averages())
        busy_us = sum(e.self_device_time_total for e in kern)
        launches = sum(e.count for e in kern)
        log(tag, f"{smi}: {model.cfg.name} serve B=8 prompt 512, "
            f"prefill + warm-up chunk + 2 chunks of {chunk}: wall "
            f"{wall * 1e3:.3f} ms (the capture "
            f"{out['capture_s'] * 1e3:.3f} ms), device busy "
            f"{busy_us / 1e3:.3f} ms ({busy_us / 1e4 / wall:.1f}% busy; "
            f"{busy_us / 1e4 / (wall - out['capture_s']):.1f}% of the "
            f"wall outside the capture), {launches} kernel launches of "
            f"{len(kern)} kernels; decode "
            f"{out['decode_s_per_tok'] * 1e3:.4f} ms/token-step")
        counted = {n: c for counter in _counters()
                   for n, c in counter.items()}
        seen = {n: sum(e.count for e in kern if k in e.key)
                for n, k in PROFILED.items()}
        want = {n: counted[n] for n in PROFILED}
        _profiled_launches(tag, prof, kern, seen, want, TRAIN_TRACE_LEAD)
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
    READINGS["train"] = dict(step_ms=step_s * 1e3, batch=B, seq=S)
    log("train", f"{smi}: step wall (host clock, step start to loss read) median "
        f"{step_s * 1e3:.1f} ms of steps 1-{TRAIN_STEPS - 1} "
        f"({', '.join('%.1f' % (x * 1e3) for x in secs)} ms; step 0 "
        f"{out['step_seconds'][0] * 1e3:.1f} ms); the numpy batch {batch_s * 1e3:.1f} "
        f"ms a step on the host ({batch_s / step_s:.1%} of the step); "
        f"{tokens / step_s:.1f} tokens/s; model-FLOP share 6 N tokens / "
        f"(step s x 989e12) = "
        f"{model_flops / (step_s * PEAK_FLOPS[torch.bfloat16]):.2%} (N "
        f"{n_params}, {model_flops:.3e} FLOP a step); attention beside it "
        f"{train_attn:.3e} FLOP a step (forward {fwd_attn:.3e}, causal pairs "
        f"only; the plain backward computes every tile), "
        f"{(model_flops + train_attn) / (step_s * PEAK_FLOPS[torch.bfloat16]):.2%}"
        " with it")

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
    with traced() as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        loss = m["loss"].item()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = kernel_events(avg)
    busy_us = sum(e.self_device_time_total for e in kern)
    counted = _flat_counts()
    seen = {n: sum(e.count for e in kern if k in e.key)
            for n, k in PROFILED.items()}
    log("train/profile", f"{smi}: one step (loss {loss:.4f}): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / 1e4 / wall:.1f}%), {sum(e.count for e in kern)} kernel "
        f"launches of {len(kern)} kernels; launches by the profiler's kernel "
        f"events {seen}, by the counters "
        f"{ {n: counted[n] for n in PROFILED} }; the trace kept "
        f"{lead_kept(kern)} of its {TRACE_LEAD_KERNELS} lead kernels")
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


# ---------------------------------------------------------------------------
# training of the non-dense families
# ---------------------------------------------------------------------------
def _family_cfg(arch, layers, enc_layers=None, **kw):
    """``arch`` at full width with ``layers`` decoder layers (and
    ``enc_layers`` encoder layers)."""
    from repro_torch.configs import get_config
    rep = dict(num_layers=layers, **kw)
    if enc_layers is not None:
        rep["num_encoder_layers"] = enc_layers
    return get_config(arch).replace(**rep)


def _depth(cfg) -> str:
    from repro_torch.configs import get_config
    full = get_config(cfg.name)
    d = f"{cfg.num_layers} of {full.num_layers} layers"
    if cfg.family == "audio":
        d = (f"{cfg.num_encoder_layers} of {full.num_encoder_layers} "
             f"encoder + {d}")
    return d


def _train_step_launches(cfg, nm: int = 1) -> dict:
    """Launches of one train step, remat per block: the prefill kernel twice
    per attention layer (forward, recompute); the RG-LRU kernel three times
    per recurrent layer of a recomputed group (forward, recompute, the
    reversed backward) and twice per tail layer, which the reference does
    not recompute; of those, the backward's once per recurrent layer
    (``rglru_scan_bwd``); nothing else."""
    want = dict.fromkeys(_flat_counts(), 0)
    want["flash_attention_fwd"] = nm * 2 * _prefill_attentions(cfg)
    if cfg.family == "hybrid":
        groups = cfg.num_layers // 3
        want["rglru_scan"] = nm * (3 * 2 * groups
                                   + 2 * (cfg.num_layers - 3 * groups))
        want["rglru_scan_bwd"] = nm * _layer_counts(cfg)[1]
    return want


def _device_tree(cfg, seed):
    """``cfg``'s weights drawn on the card from ``seed`` (the port's init
    kinds), as the reference's tree."""
    from repro_torch.models import init_params, reference_tree
    from repro_torch.models.model import model_class
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return reference_tree(init_params(cfg, gen, DEVICE),
                          model_class(cfg).LISTS)


def _active_params(cfg, n: int) -> int:
    """Weights a token reads: an MoE layer's experts at k of E."""
    if cfg.num_experts <= 0:
        return n
    experts = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * cfg.num_layers
    return int(n - experts * (1 - cfg.experts_per_token / cfg.num_experts))


def phase_train_families(smi: str, seed: int) -> dict:
    """Every non-dense family trained through
    ``repro_torch.launch.train.train`` on the card at full width: one
    warm-up step and four more, guarded AdamW, bf16 compute, remat per
    block, the batch with the family's extras; then one profiled step.
    Returns the launches of each run."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import count_params
    from repro_torch.models.model import training_model
    from repro_torch.optim import make_optimizer
    n_steps = TRAIN_FAMILIES_STEPS
    launches = {}
    for arch, (layers, enc, B, S) in TRAIN_FAMILIES.items():
        label = f"train_families/{arch}"
        cfg = _family_cfg(arch, layers, enc)
        n = count_params(cfg)
        run = RunConfig(warmup_steps=2, learning_rate=3e-4, microbatches=1,
                        total_steps=n_steps, seed=seed)
        shape = ShapeConfig("custom", S, B, "train")
        extras = {k: tuple(v.shape) for k, v in make_batch_fn(
            cfg, ShapeConfig("custom", 8, 1, "train"), seed)(0).items()
            if k not in ("tokens", "labels")}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset()
        t0 = time.perf_counter()
        out = train(arch, cfg=cfg, steps=n_steps, batch=B, seq=S, run=run,
                    device=DEVICE, params=_device_tree(cfg, seed),
                    log_every=n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _flat_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = np.asarray(out["losses"])
        log(label, f"{smi}: {arch} full width, {_depth(cfg)}, {n} params "
            f"({n * 16 / 1e9:.1f} GB of fp32 weights, gradients and AdamW "
            f"moments), compute {cfg.compute_dtype}, batch {B} x seq {S} "
            f"(extras at seq 8: {extras}); {n_steps} steps in {wall:.2f} s "
            f"(init and the first step's warm-up included); losses "
            f"{[float('%.4f' % x) for x in losses]}; skipped "
            f"{out['skipped_steps']}; peak device memory {peak / 1e9:.2f} GB")
        if len(losses) != n_steps or not np.isfinite(losses).all() \
                or out["skipped_steps"]:
            raise AssertionError(f"{label}: losses {losses}, skipped "
                                 f"{out['skipped_steps']}")
        if peak > TRAIN_FAMILIES_PEAK:
            raise AssertionError(f"{label}: peak {peak / 1e9:.2f} GB over "
                                 f"{TRAIN_FAMILIES_PEAK / 1e9:.0f} GB: cut "
                                 "the depth")
        step_want = _train_step_launches(cfg)
        want = {k: v * n_steps for k, v in step_want.items()}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        # host share: the numpy batch of a step
        bf = make_batch_fn(cfg, shape, seed=seed)
        t0 = time.perf_counter()
        host_batch = bf(n_steps)
        batch_s = time.perf_counter() - t0
        secs = np.asarray(out["step_seconds"][1:])
        step_s = float(np.median(secs))
        positions = B * S + (B * int(S * cfg.src_len_ratio)
                             if cfg.family == "audio" else 0)
        active = _active_params(cfg, n)
        mfu = 6.0 * active * positions / (step_s * PEAK_FLOPS[torch.bfloat16])
        log(label, f"{smi}: step wall (host clock) median {step_s * 1e3:.1f} "
            f"ms of steps 1-{n_steps - 1} ({', '.join('%.1f' % (x * 1e3) for x in secs)} "
            f"ms; step 0 {out['step_seconds'][0] * 1e3:.1f} ms); the numpy "
            f"batch {batch_s * 1e3:.1f} ms ({batch_s / step_s:.1%} of a "
            f"step); {positions / step_s:.1f} positions/s ({positions} a "
            f"step{', encoder frames included' if cfg.family == 'audio' else ''}); "
            f"model-FLOP share 6 N_active positions / (step s x 989e12) "
            f"= {mfu:.2%} (N_active {active}); launches "
            f"{ {k: v for k, v in counts.items() if v} }: "
            f"{ {k: v for k, v in step_want.items() if v} } a step")
        launches[label] = counts
        if not any(step_want.values()):
            # the xLSTM reaches none of the port's kernels (nor does the
            # reference's reach a Pallas kernel): its counters read 0, and
            # a profile of its step (~210,000 kernel events, two minutes of
            # the profiler's processing) would compare 0 with 0
            log(label, "no port kernel on this path: the profiled step is "
                "left out")
            del out
            torch.cuda.empty_cache()
            continue
        # one profiled step from the trained state
        step_fn = make_train_step(training_model(cfg),
                                  make_optimizer(cfg.optimizer, run), run,
                                  guard=True)
        b = {k: torch.from_numpy(v).to(DEVICE) for k, v in host_batch.items()}
        params, opt = out["params"], out["opt_state"]
        del out
        torch.cuda.synchronize()
        _reset()
        with traced(TRAIN_TRACE_LEAD) as prof:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, b)
            loss = m["loss"].item()
            pwall = time.perf_counter() - t0
        kern = kernel_events(prof.key_averages())
        busy_us = sum(e.self_device_time_total for e in kern)
        counted = _flat_counts()
        seen = {k: sum(e.count for e in kern if name in e.key)
                for k, name in PROFILED.items()}
        log(label, f"{smi}: profiled step (loss {loss:.4f}, skipped "
            f"{bool(m['skipped'])}): wall {pwall * 1e3:.1f} ms, device busy "
            f"{busy_us / 1e3:.1f} ms ({busy_us / 1e4 / pwall:.1f}%), "
            f"{sum(e.count for e in kern)} kernel launches")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
            log(label, f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x  {e.key[:90]}")
        if counted != step_want or bool(m["skipped"]):
            raise AssertionError(f"{label}: profiled step launches "
                                 f"{counted}, want {step_want}")
        _profiled_launches(label, prof, kern, seen,
                           {k: counted[k] for k in PROFILED},
                           TRAIN_TRACE_LEAD)
        del params, opt, b, step_fn, prof, kern
        torch.cuda.empty_cache()
    return launches


def _rel_dist(a, b) -> float:
    """max |a - b| relative to b's largest |value|."""
    return (a.float() - b.float()).abs().max().item() / max(
        b.float().abs().max().item(), 1e-30)


def _grads_close(label, step, got, want, rel) -> float:
    """Every gradient leaf on the card within ``rel`` of the CPU's largest
    |value| in it (compared on the card); returns the largest reading."""
    from repro_torch.tree import leaves_with_path
    worst = 0.0
    for (path, g), (_, c) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        c = c.to(DEVICE)
        r = (g - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
        worst = max(worst, r)
        if r > rel:
            raise AssertionError(f"{label}: step {step} gradient {path}: "
                                 f"max |card - cpu| {r:.3e} of its largest "
                                 f"|value| > {rel}")
    return worst


def _state_close(label, step, card, cpu, rel, run) -> tuple:
    """The card's parameters and AdamW state after a step against the
    CPU's from the same state: every element within the per-family limit
    of its leaf's largest |value| (``tight``; nu, which holds g^2, twice
    it). Two exceptions. A weight whose AdamW update is set by noise may
    differ by up to tight + 2 lr: its momentum within the gradients' noise
    (|mu| <= 2 rel of the leaf's largest |mu|; the first step's mu is
    (1 - b1) g), or its gradient scale sqrt(nu / (1 - b2^t)) within 100
    times the update's eps, which the update's division amplifies. A
    moment may have at most 1e-3 of its elements past tight, none past
    twice it. Returns (the largest reading by leaf group, the weights past
    tight that the noise rule let through, the weights it covers)."""
    from repro_torch.tree import leaves_with_path
    mu = dict(leaves_with_path(cpu["opt"]["mu"]))
    nu = dict(leaves_with_path(cpu["opt"]["nu"]))
    bc2 = 1 - run.b2 ** int(cpu["opt"]["step"])
    lr = run.learning_rate
    worst, exempted, noisy = {}, 0, 0
    for (path, c), (_, g) in zip(leaves_with_path(cpu),
                                 leaves_with_path(card)):
        c = c.to(DEVICE)
        if c.dtype == torch.int32:
            if not torch.equal(c, g):
                raise AssertionError(f"{label}: {path} differs")
            continue
        d = (g - c).abs()
        scale = max(c.abs().max().item(), 1e-30)
        tight = rel * scale * (2 if "['nu']" in path else 1)
        past = d > tight
        if path.startswith("['params']"):
            key = path[len("['params']"):]
            m = mu[key].to(DEVICE).abs()
            noise = (m <= 2 * rel * m.max()) | (
                torch.sqrt(nu[key].to(DEVICE) / bc2) <= 100 * ADAMW_EPS)
            noisy += int(noise.sum().item())
            exempted += int((past & noise).sum().item())
            bad = (past & ~noise).sum().item() \
                + (d > tight + 2 * lr).sum().item()
        else:
            bad = (d > 2 * tight).sum().item() \
                + int(past.float().mean().item() > 1e-3)
        key = path.split("]")[1] + "]"
        worst[key] = max(worst.get(key, 0.0), d.max().item() / scale)
        if bad:
            raise AssertionError(
                f"{label}: step {step} {path}: max |card - cpu| "
                f"{d.max().item():.3e} (tight {tight:.3e}), "
                f"{past.float().mean().item():.2e} of the elements past "
                f"tight, {bad} outside the limits")
    return worst, exempted, noisy


def _family_step_launches(label, cfg, i, metrics) -> None:
    """A card step of phase train_families_parity launched exactly a train
    step's kernels (the prefill kernel on its fp32 route) and was not
    skipped."""
    got = _flat_counts()
    want = _train_step_launches(cfg)
    want["flash_attention_fwd_fp32"] = want["flash_attention_fwd"]
    if got != want or bool(metrics["skipped"]) or \
            not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"{label}: step {i} launches {got}, want "
                             f"{want}, skipped {bool(metrics['skipped'])}, "
                             f"loss {float(metrics['loss'])}")


def phase_train_families_parity(smi: str, seed: int) -> dict:
    """Card against CPU in fp32 (TF32 off) for each non-dense family at full
    width and cut depth, over three guarded AdamW steps on the card: before
    each step the CPU computes the loss and the gradients at the card's
    weights, held against the card's (the loss within 1e-5 relative, the
    gradient norm and every gradient within the family's limit of a leaf's
    largest |value|; mixtral and pixtral before the first step only,
    ``TRAIN_FAMILIES_GRAD_STEPS``); MoE routing equal card vs CPU. In its first
    ``TRAIN_FAMILIES_HOST_STEPS`` steps the CPU also takes the AdamW step
    from its own gradients, and the card's weights and moments after the
    step are held to the limits (``_state_close``); the xLSTM's gradients
    are also held against a float64 run of the port. Weights are drawn on
    the card. Returns the card's launches of a step."""
    import resource

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    from repro_torch.models.model import training_model
    from repro_torch.optim import global_norm, make_optimizer
    from repro_torch.tree import tree_map
    B, S = TRAIN_FAMILIES_PARITY_SHAPE
    n_steps = TRAIN_FAMILIES_PARITY_STEPS
    launches = {}
    for arch, (layers, enc) in TRAIN_FAMILIES_PARITY.items():
        label = f"train_families_parity/{arch}"
        cfg = _family_cfg(arch, layers, enc, compute_dtype="float32")
        rel = TRAIN_FAMILIES_REL.get(arch, TRAIN_TREE_RTOL)
        host_steps = TRAIN_FAMILIES_HOST_STEPS.get(arch, 0)
        grad_steps = TRAIN_FAMILIES_GRAD_STEPS.get(arch, n_steps)
        run = RunConfig(total_steps=n_steps, warmup_steps=1, microbatches=1,
                        seed=seed)
        bf = make_batch_fn(cfg, ShapeConfig("custom", S, B, "train"),
                           seed=seed)
        model = training_model(cfg)
        opt = make_optimizer(cfg.optimizer, run)
        step = make_train_step(model, opt, run, guard=True)
        t0 = time.perf_counter()
        p_card = _device_tree(cfg, seed)
        s_card = opt.init(p_card)
        worst = {}
        if cfg.family == "ssm":
            worst.update(_xlstm_f64_reading(label, cfg, model, tree_map(
                lambda t: t.cpu(), p_card), bf, rel))
        t_card = t_cpu = 0.0
        to_cpu = lambda t: t.to("cpu", copy=True)
        for i in range(n_steps):
            b = bf(i)
            bc = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
            if i >= grad_steps:
                # the card's step alone: finite, not skipped, its launches
                t1 = time.perf_counter()
                _reset()
                p_card, s_card, m_card = step(p_card, s_card, bc)
                torch.cuda.synchronize()
                t_card += time.perf_counter() - t1
                _family_step_launches(label, cfg, i, m_card)
                continue
            p_cpu = tree_map(to_cpu, p_card)
            routes = {"card": [], "cpu": []}
            t1 = time.perf_counter()
            with recorded_routing(routes["cpu"]):
                l_cpu, g_cpu = _loss_and_grads(model, p_cpu, {
                    k: torch.from_numpy(v) for k, v in b.items()}, 1)
            t_cpu += time.perf_counter() - t1
            t1 = time.perf_counter()
            with recorded_routing(routes["card"]):
                l_card, g_card = _loss_and_grads(model, p_card, bc, 1)
            if cfg.num_experts > 0 and i == 0:
                _routing_diff(label, routes["cpu"], routes["card"])
            for k, a, c, tol in (
                    ("loss", l_card, l_cpu, TRAIN_LOSS_RTOL),
                    ("grad_norm", global_norm(g_card), global_norm(g_cpu),
                     rel)):
                r = abs(float(a) - float(c)) / abs(float(c))
                worst[f"{k}"] = max(worst.get(k, 0.0), r)
                if r > tol or not np.isfinite(float(c)):
                    raise AssertionError(f"{label}: step {i} {k} card "
                                         f"{float(a)} cpu {float(c)} (rel "
                                         f"{r:.2e} > {tol})")
            worst["grads"] = max(worst.get("grads", 0.0), _grads_close(
                label, i, g_card, g_cpu, rel))
            del g_card
            if i >= host_steps:
                del g_cpu
            _reset()
            p_card, s_card, m_card = step(p_card, s_card, bc)
            torch.cuda.synchronize()
            t_card += time.perf_counter() - t1
            _family_step_launches(label, cfg, i, m_card)
            if i < host_steps:
                # the state the card's step started from: fresh at step 0,
                # else the card's (its weights p_cpu are copied above)
                t1 = time.perf_counter()
                s_cpu = opt.init(p_cpu) if i == 0 else s_prev
                s_prev = None
                opt.update_(g_cpu, s_cpu, p_cpu, None)
                t_cpu += time.perf_counter() - t1
                del g_cpu
                w, exempted, noisy = _state_close(
                    label, i, {"params": p_card, "opt": s_card},
                    {"params": p_cpu, "opt": s_cpu}, rel, run)
                log(label, f"step {i}: weights and moments after the card's "
                    f"and the host's AdamW step within the limits; "
                    f"{exempted} weights past tight let through by the "
                    f"noise rule (of {noisy} it covers); largest readings "
                    + ", ".join(f"{k} {v:.2e}" for k, v in w.items()))
                for k, v in w.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                del s_cpu
            if i + 1 < host_steps:
                s_prev = tree_map(to_cpu, s_card)
            del p_cpu
        peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        host = (f" and its own AdamW step{'s' if host_steps > 1 else ''} "
                f"{', '.join(str(j + 1) for j in range(host_steps))}"
                if host_steps else "")
        got = _flat_counts()
        launches[label] = got
        at = ("each" if grad_steps >= n_steps else
              f"the first {grad_steps}" if grad_steps > 1 else "the first")
        log(label, f"{smi}: {arch} full width, {_depth(cfg)}, fp32, batch "
            f"{B} x seq {S}: {n_steps} guarded AdamW steps on the card, CPU "
            f"loss and gradients at {at}{host}"
            f": card {t_card:.1f} s, CPU {t_cpu:.1f} s "
            f"({time.perf_counter() - t0:.1f} s in all); limit {rel} of a "
            f"leaf's largest |value| (loss {TRAIN_LOSS_RTOL}); largest "
            "readings " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(
                worst.items(), key=lambda kv: -kv[1])[:7])
            + f"; host peak RSS {peak_rss:.1f} GB; launches a step "
            f"{ {k: v for k, v in got.items() if v} }")
        del p_card, s_card
        torch.cuda.empty_cache()
    return launches


def _xlstm_f64_reading(label, cfg, model, p, bf, rel) -> dict:
    """The xLSTM's first-step gradients on the card and the CPU (fp32)
    against a float64 run of the port from the same weights ``p`` (on the
    CPU): each side's distance from it, and the limit held against
    both."""
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.tree import leaves, tree_map
    b = bf(0)
    grads = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        _, g = _loss_and_grads(model, tree_map(lambda t: t.to(dev), p), {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()}, 1)
        grads[side] = tree_map(lambda t: t.cpu(), g)
    with float64_port(model) as m64:
        _, g64 = _loss_and_grads(m64, tree_map(lambda t: t.double(), p), {
            k: (torch.from_numpy(v).double() if v.dtype == np.float32
                else torch.from_numpy(v)) for k, v in b.items()}, 1)
    out = {f"{side} vs float64": max(
        _rel_dist(a, w) for a, w in zip(leaves(grads[side]), leaves(g64)))
        for side in ("card", "cpu")}
    out["card vs cpu"] = max(_rel_dist(a, w) for a, w in zip(
        leaves(grads["card"]), leaves(grads["cpu"])))
    log(label, f"xLSTM gradients: card {out['card vs float64']:.2e} and CPU "
        f"{out['cpu vs float64']:.2e} from a float64 run of the port (of a "
        f"leaf's largest |value|), card vs CPU {out['card vs cpu']:.2e}; "
        f"limit {rel}")
    if max(out.values()) > rel:
        raise AssertionError(f"{label}: xLSTM gradients {out} over {rel}")
    return out


def _attention_train_row(gen, name) -> dict:
    """The prefill kernel under autograd at one of TRAIN_ATTN_SHAPES: out
    and lse against the plain version, dq / dk / dv of the kernel forward +
    plain backward against the all-plain pair, two calls bitwise equal;
    device times of the kernel forward, the plain backward, both through
    the Function, the all-plain pair and SDPA forward and forward +
    backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.flash_attention.autograd import (
        flash_attention_bwd_ref, flash_attention_train)
    B, S, T, Hq, Hkv, D, causal, window = TRAIN_ATTN_SHAPES[name]
    G, dt = Hq // Hkv, torch.bfloat16
    cq, ck = min(512, S), min(1024, T)
    kw = dict(causal=causal, window=window)
    q, do = (randn(gen, (B, S, Hq, D), dt) for _ in range(2))
    k, v = (randn(gen, (B, T, Hkv, D), dt) for _ in range(2))
    label = (f"{TRAIN_ATTN_LABELS[name]}: B{B} {Hq} q / {Hkv} kv heads "
             f"S{S} T{T} D{D} {'causal' if causal else 'non-causal'}"
             f"{f' window {window}' if window else ''} bf16")
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, **kw)
    qp = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S)
    kp = torch.arange(T, dtype=torch.int32, device=DEVICE).expand(B, T)
    q5 = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
    to4 = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    r_out, r_lse = ref.flash_attention_fwd_ref(q5, k4, v4, qp, kp, **kw)
    err = _check_bf16(f"train attention {label} forward", out, to4(r_out),
                      to4(_abs_v_out(q5, k4, v4, qp, kp, **kw)), lse, r_lse,
                      phase="train_kernels")
    plain_out, plain_lse = to4(r_out).contiguous(), r_lse
    del r_out, r_lse

    def kernel_pair():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention_train(*xs, chunk_q=cq, chunk_kv=ck, **kw)
        return (o.detach(),) + torch.autograd.grad(o, xs, do)

    def plain_bwd(o, l):
        five = lambda t: t.reshape(B, S, Hkv, G, D)
        dq, dk_, dv_ = flash_attention_bwd_ref(
            five(q), k, v, five(o), l, five(do), softcap=0.0, cq=cq, ck=ck,
            **kw)
        return dq.reshape(B, S, Hq, D), dk_, dv_

    before = _flat_counts()["flash_attention_fwd"]
    got = kernel_pair()
    if _flat_counts()["flash_attention_fwd"] != before + 1:
        raise AssertionError(f"train_kernels {name}: the Function did not "
                             "launch the prefill kernel once")
    want = plain_bwd(plain_out, plain_lse)
    errs = []
    for g_name, g, w in zip(("dq", "dk", "dv"), got[1:], want):
        scale = w.float().abs().max().item()
        errs.append(_check(f"train attention {label} {g_name} (kernel "
                           f"forward + plain backward vs all plain; "
                           f"{TRAIN_GRAD_TOL} x max|plain| = "
                           f"{TRAIN_GRAD_TOL * scale:.3e})", g, w,
                           TRAIN_GRAD_TOL * scale, phase="train_kernels"))
    for g_name, a, b in zip(("out", "dq", "dk", "dv"), got, kernel_pair()):
        _identical(f"train attention {name} {g_name}: two calls", b, a,
                   "train_kernels")
    del got, want
    t_fwd = device_ms(lambda i: ops.flash_attention_gqa_fwd(q, k, v, **kw),
                      1, 4)
    t_plain_fwd = _event_ms(lambda: ref.flash_attention_fwd_ref(
        q5, k4, v4, qp, kp, **kw), 2)
    t_bwd = _event_ms(lambda: plain_bwd(out, lse), 2)
    t_pair = _event_ms(kernel_pair, 2)

    def plain_pair():
        o, l = ref.flash_attention_fwd_ref(q5, k4, v4, qp, kp, **kw)
        return plain_bwd(to4(o), l)

    t_plain_pair = _event_ms(plain_pair, 2)
    qs, ks, vs, dos = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    mask = None
    if window:
        i = torch.arange(S, device=DEVICE)[:, None]
        j = torch.arange(T, device=DEVICE)[None, :]
        mask = (j <= i) & (j > i - window)
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None,
                   enable_gqa=G > 1)
    t_sdpa = device_ms(lambda i: F.scaled_dot_product_attention(
        qs, ks, vs, **sdpa_kw), 1, 4)

    def sdpa_pair():
        xs = [x.detach().requires_grad_(True) for x in (qs, ks, vs)]
        o = F.scaled_dot_product_attention(*xs, **sdpa_kw)
        return torch.autograd.grad(o, xs, dos)

    t_sdpa_pair = _event_ms(sdpa_pair, 3)
    f_fwd, f_pair = _attention_train_flops(
        B, Hq, D, visible_pairs(qp[:1], kp[:1], causal, window))
    nbytes_fwd = 2 * q.nbytes + k.nbytes + v.nbytes + lse.nbytes
    # the pair: q, k, v, do read; out, lse, dq, dk, dv written, once each
    nbytes_pair = 4 * q.nbytes + 2 * (k.nbytes + v.nbytes) + lse.nbytes
    b_fwd, by_fwd = bound_ms(nbytes_fwd, f_fwd, dt)
    b_pair, by_pair = bound_ms(nbytes_pair, f_pair, dt)
    log("train_kernels", f"{label}: kernel forward {t_fwd:.4f} ms, plain "
        f"forward {t_plain_fwd:.4f}, sdpa forward {t_sdpa:.4f}, bound "
        f"{b_fwd:.4f} ({by_fwd}: {nbytes_fwd} B, {f_fwd:.3e} FLOP); plain "
        f"backward {t_bwd:.4f}; forward + backward: the Function "
        f"{t_pair:.4f}, all plain {t_plain_pair:.4f}, sdpa {t_sdpa_pair:.4f}"
        f" ({'mask' if mask is not None else 'no mask'}"
        f"{', enable_gqa' if G > 1 else ''}), bound {b_pair:.4f} ms "
        f"({by_pair}: {nbytes_pair} B, {f_pair:.3e} FLOP)")
    row = dict(max_abs_err=err, ms=t_fwd, plain_ms=t_plain_fwd,
               bound_ms=b_fwd, bound_by=by_fwd, library_ms=t_sdpa,
               grad_max_abs_err=max(errs), backward_ms=t_bwd, pair_ms=t_pair,
               plain_pair_ms=t_plain_pair, library_pair_ms=t_sdpa_pair,
               pair_bound_ms=b_pair)
    del q, k, v, do, out, lse, plain_out, plain_lse, q5, k4, v4
    torch.cuda.empty_cache()
    return row


def _rglru_bwd_row(gen) -> dict:
    """The RG-LRU recurrence under autograd at Griffin's train shape: the
    backward (the kernel over the reversed sequences, the flips, da and db)
    bit for bit ``rglru_scan_bwd_ref`` and two calls bitwise equal; its
    device time against the byte bound, the plain reversed loop's time."""
    from repro_torch.kernels.rglru import (RglruScanFn, rglru_scan,
                                           rglru_scan_bwd_ref)
    from repro_torch.kernels.rglru.autograd import (grads_from_adjoint,
                                                    reversed_inputs)
    B, T, D = RGLRU_BWD_SHAPE
    a = 0.9 + 0.099 * torch.rand((B, T, D), generator=gen, device=DEVICE)
    b = 0.1 * torch.randn((B, T, D), generator=gen, device=DEVICE)
    dh = torch.randn((B, T, D), generator=gen, device=DEVICE)

    def fn_pair():
        xa, xb = (x.clone().requires_grad_(True) for x in (a, b))
        h = RglruScanFn.apply(xa, xb)
        return (h.detach(),) + torch.autograd.grad(h, (xa, xb), dh)

    before = _flat_counts()
    h, da, db = fn_pair()
    torch.cuda.synchronize()
    after = _flat_counts()
    if after["rglru_scan"] != before["rglru_scan"] + 2 or \
            after["rglru_scan_bwd"] != before["rglru_scan_bwd"] + 1:
        raise AssertionError("train_kernels rglru_scan_bwd: forward and "
                             "backward did not launch the kernel once each")
    wa, wb = rglru_scan_bwd_ref(a, h, dh)
    err = max(_rel_dist(da, wa), _rel_dist(db, wb))
    _identical("rglru_scan_bwd da vs rglru_scan_bwd_ref", da, wa,
               "train_kernels")
    _identical("rglru_scan_bwd db vs rglru_scan_bwd_ref", db, wb,
               "train_kernels")
    for n_, x, y in zip(("h", "da", "db"), fn_pair(), (h, da, db)):
        _identical(f"rglru_scan_bwd {n_}: two calls", x, y, "train_kernels")

    def bwd(i):
        g = torch.flip(rglru_scan(*reversed_inputs(a, dh)), dims=[1])
        return grads_from_adjoint(g, h)

    t_bwd = device_ms(bwd, 1, 4)
    t_kernel = device_ms(lambda i: rglru_scan(a, b), 1, 4)
    t_plain = _event_ms(lambda: rglru_scan_bwd_ref(a, h, dh), 1)
    # the function reads a, h and dh and writes da and db, once each; the
    # port's flips, roll and shift (a twice, dh, g and h, each a read and a
    # write) are its design's, not the function's, so the bound leaves
    # them out, and they are timed in the backward
    nbytes = 5 * a.nbytes
    copies = 10 * a.nbytes
    b_ms, b_by = bound_ms(nbytes, 0.0, torch.float32)
    log("train_kernels", f"rglru_scan_bwd B{B} T{T} D{D} fp32: backward "
        f"{t_bwd:.4f} ms (the forward kernel alone {t_kernel:.4f}), plain "
        f"reversed loop {t_plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes} B: a, h, dh read, da, db written); the backward at "
        f"{b_ms / t_bwd:.1%} of the bound; it also moves {copies} B of "
        f"copies around the kernel ({bound_ms(copies, 0.0, torch.float32)[0]:.4f} "
        f"ms at the memory rate); library: none ({NO_LIBRARY_RGLRU})")
    return dict(max_abs_err=err, ms=t_bwd, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def train_kernels_families(seed: int) -> dict:
    """The rows of the non-dense families' train kernels."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    rows = {name: _attention_train_row(gen, name)
            for name in TRAIN_ATTN_SHAPES}
    rows["rglru_scan_bwd"] = _rglru_bwd_row(gen)
    return rows


# ---------------------------------------------------------------------------
# phase paper: DaPPA, MIMDRAM and DAMOV on the card
# ---------------------------------------------------------------------------
PAPER_N = 1 << 26                    # DaPPA stream elements, fp32 (256 MB)
# an fp32 reduction of n terms, card against CPU: each side sums in a tree
# of log2(n) = 26 levels, so each lies within 26 ulps of sum |v| of the
# exact sum; the limit is 32 ulps of sum |v| (a count is an fp32 sum of
# ones, as the reference's, inexact past 2^24; max and min: exact)
PAPER_REDUCE_ULPS = 32
PAPER_REPS = 3
# the architectures the card runs, counted at full width and depth on meta:
# serving at the serve phases' batch 8 x prompt 512 (pixtral 256 patches +
# 256 tokens, seamless over 512 frames) and a decode step at cache 576;
# training at the train phases' shapes, but for the phase's time: the
# xLSTM at 8 x 64 (8 x 512 in train_families; its sLSTM runs ~600 counted
# ops a position), internlm2 and stablelm, which the card does not train,
# at 4 x 1024 (the plain attention backward's ops grow with S^2), and so
# stablelm-3b and kimi-k2 (D 80 and 112; kimi-k2's 61 layers
# and 384 experts on meta, which no card holds)
PAPER_SERVE = (8, 512, 64)
PAPER_TRAIN = {"pimref-100m": (4, 4096), "recurrentgemma-2b": (1, 4096),
               "mixtral-8x7b": (4, 1024), "pixtral-12b": (2, 2048),
               "seamless-m4t-large-v2": (4, 512), "xlstm-125m": (8, 64),
               "internlm2-1.8b": (4, 1024), "stablelm-1.6b": (4, 1024),
               "stablelm-3b": (4, 1024), "kimi-k2-1t-a32b": (4, 1024)}
# worker processes of the DAMOV counts, which run while the kernels build
# (nvcc leaves most of the host's 8 cores idle after its short sources)
PAPER_WORKERS = 6
# the card == meta check: pimref at full width, 2 layers, B 2 x 64 + 8
PAPER_CHECK = (2, 2, 64, 8)


def _dappa_pipelines(d) -> dict:
    """The five patterns (map, zip, window, filter, reduce) and
    tests/distributed_worker.py's dappa_distributed pipelines, built with
    the DaPPA module ``d``. Stream functions are elementwise, in a fixed
    order, so a stream is the same bits on every device."""
    x, y = d.input_stream("x"), d.input_stream("y")
    prod = x.zip(y).map(lambda t: t[..., 0] * t[..., 1])
    return {
        "map_reduce": x.map(lambda v: v * 2).reduce("sum"),
        "zip_filter_mean": prod.filter(lambda v: v > 0).reduce("mean"),
        "window_sum3": x.window(3, lambda w: w[..., 0] + w[..., 1]
                                + w[..., 2]),
        "filter_fill": x.filter(lambda v: v > 0, fill=-1.0),
        "reductions": {k: y.filter(lambda v: v < 1.5).reduce(k)
                       for k in ("max", "min", "count")},
        "dist_dot": prod.reduce("sum"),
        "dist_moving_max": x.window(4, lambda w: w.amax(-1)),
        "dist_filter_mean": x.filter(lambda v: v > 0).reduce("mean"),
    }


def _reduce_scale(name: str, host: dict) -> float:
    """sum |term| / count of a sum or mean pipeline's terms (float64 on the
    host): the scale of its rounding."""
    x = host["x"].double()
    if name == "map_reduce":
        return float((2 * x).abs().sum())
    p = x * host["y"].double()
    if name == "dist_dot":
        return float(p.abs().sum())
    kept = p[p > 0] if name == "zip_filter_mean" else x[x > 0]
    return float(kept.sum() / max(kept.numel(), 1))


def _paper_dappa(smi, seed, mesh) -> None:
    from repro_torch.core import dappa
    from repro_torch.kernels.accounting import nbytes
    from repro_torch.tree import leaves
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    xs = randn(gen, (PAPER_N,), torch.float32)
    ys = 1.0 + randn(gen, (PAPER_N,), torch.float32).abs()
    host = {"x": xs.cpu(), "y": ys.cpu()}
    for name, out in _dappa_pipelines(dappa).items():
        uses = {"x": xs, "y": ys} if name in ("zip_filter_mean", "dist_dot") \
            else {"y": ys} if name == "reductions" else {"x": xs}
        f = dappa.compile_pipeline(out)
        got = f(**uses)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = f(**{k: host[k] for k in uses})
        cpu_s = time.perf_counter() - t0
        on_mesh = dappa.compile_pipeline(out, mesh=mesh)(**uses)
        worst = 0.0
        for g, w, m, leaf in zip(leaves(got), leaves(want), leaves(on_mesh),
                                 leaves(out)):
            if not torch.equal(g, m):
                raise AssertionError(f"paper/dappa {name}: the one-rank NCCL "
                                     "mesh run differs from the local run")
            if g.dim():                                   # a stream
                if not torch.equal(g.cpu(), w):
                    raise AssertionError(f"paper/dappa {name}: card and CPU "
                                         "streams differ")
                continue
            scale = (float(w) if leaf.kind == "count"
                     else 0.0 if leaf.kind in ("max", "min")
                     else _reduce_scale(name, host))
            tol = PAPER_REDUCE_ULPS * 2.0 ** -23 * scale
            err = abs(float(g) - float(w))
            worst = max(worst, err / tol if tol else err)
            if err > tol:
                raise AssertionError(f"paper/dappa {name} {leaf.kind}: card "
                                     f"{float(g)!r} CPU {float(w)!r}, "
                                     f"|diff| {err:.3e} > {tol:.3e}")
        moved = nbytes(*uses.values()) + nbytes(*leaves(got))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PAPER_REPS):
            f(**uses)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / PAPER_REPS
        log("paper/dappa", f"{smi}: {name} over {PAPER_N} fp32: "
            f"{ms:.3f} ms on the card (eager, CUDA events, mean of "
            f"{PAPER_REPS}) against its bytes {moved} / "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
            f"{moved / HBM_BYTES_PER_S * 1e3:.3f} ms; CPU {cpu_s * 1e3:.0f} "
            f"ms; streams bitwise, reductions within limits (worst "
            f"{worst:.3f} of its limit); == the one-rank NCCL mesh run")
    del xs, ys, host
    torch.cuda.empty_cache()


def _paper_mimdram(mesh) -> None:
    """Every arch the card runs x the four shape cells: the plan on a
    one-device CUDA DeviceMesh equals the plan without a mesh."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.mimdram import (constrain, plan_sharding, use_plan,
                                          vf_report)
    from repro_torch.models import param_pspecs, param_specs
    n = 0
    for arch in PAPER_TRAIN:
        cfg = get_config(arch)
        specs = param_specs(cfg)
        for shape in SHAPES:
            a, b = plan_sharding(cfg, shape, mesh), plan_sharding(cfg, shape)
            for what in ("rules", "notes", "segment_utilization",
                         "segments"):
                if getattr(a, what) != getattr(b, what):
                    raise AssertionError(f"paper/mimdram {arch} {shape.name}"
                                         f": {what} {getattr(a, what)} != "
                                         f"{getattr(b, what)}")
            if param_pspecs(specs, a) != param_pspecs(specs, b):
                raise AssertionError(f"paper/mimdram {arch} {shape.name}: "
                                     "parameter specs differ")
            n += 1
        x = torch.ones(2, 3, device=DEVICE)
        with use_plan(a):
            if constrain(x, "act_batch", "act_embed") is not x:
                raise AssertionError("paper/mimdram: constrain moved a tensor "
                                     "on a one-device mesh")
        log("paper/mimdram", f"{arch}: vf {vf_report(cfg, SHAPES[0])}; "
            f"train_4k notes {b.notes}")
    log("paper/mimdram", f"{n} plans on the one-device CUDA mesh == "
        f"without a mesh (rules, notes, utilization, segments, every "
        f"parameter's spec)")


def _zero_batch(cfg, shape, dev) -> dict:
    """``input_specs``' batch of ``shape`` as zeros on ``dev``."""
    from repro_torch.launch.specs import input_specs
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in input_specs(cfg, shape).items()}


def _count_serve(cfg, dev, serve) -> dict:
    """StepStats of a prefill of ``serve`` = (B, prompt, new) on ``dev``
    and of one decode step after it (cache prompt + new)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.damov import count_step
    from repro_torch.models import build_model
    B, P, G = serve
    m = build_model(cfg, dev)
    batch = _zero_batch(cfg, ShapeConfig("serve", P, B, "prefill"), dev)
    toks = batch.pop("tokens")
    (_, cache), pre = count_step(m.prefill, toks, P + G, **batch)
    _, dec = count_step(m.decode_step, cache, toks[:, :1])
    return {"prefill": pre, "decode": dec}


def _count_train(cfg, dev, train) -> dict:
    """StepStats of an AdamW train step of ``train`` = (B, S) on ``dev``
    (zero weights and batch)."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.core.damov import count_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import param_specs, reference_tree
    from repro_torch.models.model import model_class, training_model
    from repro_torch.optim import make_optimizer
    B, S = train
    params = reference_tree(
        {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
         for n, s in param_specs(cfg).items()}, model_class(cfg).LISTS)
    opt = make_optimizer(cfg.optimizer, RunConfig())
    state = opt.init(params)
    batch = _zero_batch(cfg, ShapeConfig("train", S, B, "train"), dev)
    step = make_train_step(training_model(cfg), opt, RunConfig())
    return {"train": count_step(step, params, state, batch)[1]}


def _damov_task(arch: str, what: str) -> tuple:
    """One arch's serving (``what`` "serve") or training counted on meta at
    full width and depth, in a worker process: (rooflines, log lines,
    seconds, the end on ``time.perf_counter``'s clock, the host's
    monotonic one)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import damov
    from repro_torch.models import count_params
    t0 = time.perf_counter()
    cfg = get_config(arch)
    B, P, G = PAPER_SERVE
    Bt, St = PAPER_TRAIN[arch]
    if what == "serve":
        counts = _count_serve(cfg, "meta", PAPER_SERVE)
        shapes = {"prefill": ShapeConfig(f"prefill {B}x{P}", P, B, "prefill"),
                  "decode": ShapeConfig(f"decode {B}@{P + G}", P + G, B,
                                        "decode")}
    else:
        counts = _count_train(cfg, "meta", PAPER_TRAIN[arch])
        shapes = {"train": ShapeConfig(f"train {Bt}x{St}", St, Bt, "train")}
    active = _active_params(cfg, count_params(cfg))
    rows, lines = [], []
    for mode, st in counts.items():
        r = damov.make_roofline(arch, shapes[mode].name, mode, "1", 1, st,
                                damov.model_flops_for(cfg, shapes[mode],
                                                      active))
        rows.append(r)
        lines.append(
            f"{arch} {shapes[mode].name} ({cfg.num_layers} layers): "
            f"{st.flops:.4e} FLOP ({st.dot_flops:.4e} in matmuls, kernels "
            f"{st.kernels}), {st.bytes:.4e} B, {sum(st.ops.values())} ops; "
            f"roofline {r.step_time_s * 1e3:.4f} ms, {r.bottleneck_class}; "
            f"{damov.what_would_help(r)}")
    return rows, lines, time.perf_counter() - t0, time.perf_counter()


# the DAMOV tasks, the costliest first (the xLSTM's sLSTM steps)
PAPER_TASKS = tuple(sorted(((a, w) for a in PAPER_TRAIN
                            for w in ("train", "serve")),
                           key=lambda t: t[0] != "xlstm-125m"))


def _paper_damov(smi, done, t0) -> None:
    """The DAMOV rows from the worker processes' ``done`` results (one a
    PAPER_TASKS entry, started at ``t0``; those not ready are waited for):
    the H100 rooflines as a table, pimref's beside what phases serve and
    train measured."""
    from repro_torch.core import damov
    tasks = PAPER_TASKS
    done = list(done)
    rows = []
    for (arch, what), (r, lines, secs, _) in zip(tasks, done):
        rows.extend(r)
        for line in lines:
            log("paper/damov", line)
        log("paper/damov", f"{arch} {what}: counted in {secs:.1f} s")
    log("paper/damov", f"{len(tasks)} tasks on {PAPER_WORKERS} worker "
        f"processes, all done {max(d[3] for d in done) - t0:.1f} s after "
        f"they started (at the build)")
    order = {m: i for i, m in enumerate(("prefill", "decode", "train"))}
    rows.sort(key=lambda r: (list(PAPER_TRAIN).index(r.arch),
                             order[r.shape.split()[0]]))
    print(damov.render_table(rows), flush=True)
    by = {(r.arch, r.shape.split()[0]): r for r in rows}
    serve, train = READINGS.get("serve/contiguous"), READINGS.get("train")
    pre, dec, tr = (by[("pimref-100m", m)] for m in
                    ("prefill", "decode", "train"))
    if serve:
        log("paper/damov", f"{smi}: pimref-100m measured by phase serve "
            f"(contiguous, the graph run): prefill {serve['prefill_ms']:.3f} "
            f"ms against its roofline {pre.step_time_s * 1e3:.4f} ms "
            f"({serve['prefill_ms'] / (pre.step_time_s * 1e3):.2f}x); "
            f"decode {serve['decode_ms']:.4f} ms a token-step, device "
            f"{serve['decode_device_ms']:.4f}, against "
            f"{dec.step_time_s * 1e3:.4f} ms "
            f"({serve['decode_device_ms'] / (dec.step_time_s * 1e3):.2f}x)")
    else:
        log("paper/damov", "pimref-100m serving: not measured in this run "
            "(phase serve not run)")
    if train:
        log("paper/damov", f"{smi}: pimref-100m measured by phase train "
            f"({train['batch']} x {train['seq']}): step "
            f"{train['step_ms']:.1f} ms against its roofline "
            f"{tr.step_time_s * 1e3:.4f} ms "
            f"({train['step_ms'] / (tr.step_time_s * 1e3):.2f}x)")
    else:
        log("paper/damov", "pimref-100m training: not measured in this run "
            "(phase train not run)")


def _paper_card_equals_meta() -> None:
    """A pimref step (full width, PAPER_CHECK's depth and batch) counted on
    the card and on meta: the same FLOPs, bytes, op counts and kernel
    reports; the reports equal the launch counters' delta."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import SUBCOUNTS
    L, B, S, G = PAPER_CHECK
    cfg = get_config("pimref-100m").replace(num_layers=L)
    _reset()
    card = {**_count_serve(cfg, DEVICE, (B, S, G)),
            **_count_train(cfg, DEVICE, (B, S))}
    torch.cuda.synchronize()
    launched = {k: v for k, v in _flat_counts().items()
                if v and k not in SUBCOUNTS}
    meta = {**_count_serve(cfg, "meta", (B, S, G)),
            **_count_train(cfg, "meta", (B, S))}
    reports = {}
    for mode in card:
        a, b = (dataclasses.asdict(x[mode]) for x in (card, meta))
        if a != b:
            diff = sorted(k for k in a if a[k] != b[k])
            raise AssertionError(f"paper/damov {mode}: card and meta counts "
                                 f"differ in {diff}")
        for k, v in card[mode].kernels.items():
            reports[k] = reports.get(k, 0) + v
    if reports != launched:
        raise AssertionError(f"paper/damov: kernel reports {reports} != "
                             f"launches {launched}")
    log("paper/damov", f"pimref-100m at {L} layers, B {B} x {S} + {G}: "
        f"prefill, decode step and train step count alike on the card and "
        f"on meta; kernel reports {reports} == the launch counters")
    # outside a counter a kernel entry refuses meta tensors
    from repro_torch.kernels.flash_attention import kernel as fa
    q = torch.zeros((1, 1, 1, 4, 64), device="meta")
    k = torch.zeros((1, 1, 4, 64), device="meta")
    p = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    try:
        fa.flash_attention_fwd(q, k, k, p, p)
    except ValueError as e:
        log("paper/damov", f"meta outside a counter raises: {e}")
    else:
        raise AssertionError("paper/damov: a kernel entry took meta tensors "
                             "outside a counter")


@contextlib.contextmanager
def damov_counts(phases):
    """Phase paper's DAMOV counts (host-only work, on ``meta``) started on
    PAPER_WORKERS worker processes: yields (the results in PAPER_TASKS'
    order, the start time), or None without phase paper. Opened before the
    build, so the counts run while nvcc leaves cores idle."""
    if "paper" not in phases:
        yield None
        return
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(max_workers=PAPER_WORKERS,
                               mp_context=mp.get_context("spawn"))
    try:
        yield pool.map(_damov_task, *zip(*PAPER_TASKS)), time.perf_counter()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def phase_paper(smi: str, seed: int, damov) -> None:
    """DaPPA's patterns on the card against the CPU and on a one-rank NCCL
    mesh, MIMDRAM's plans on a one-device CUDA mesh, a card == meta count,
    and DAMOV's rows of every arch the card runs (``damov``: the counts of
    ``damov_counts``)."""
    t0 = time.perf_counter()
    _paper_on_card(smi, seed)
    t1 = time.perf_counter()
    _paper_damov(smi, *damov)
    log("paper", f"DaPPA, MIMDRAM and card == meta {t1 - t0:.1f} s; the "
        f"DAMOV rows {time.perf_counter() - t1:.1f} s after")


def _paper_on_card(smi: str, seed: int) -> None:
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("data",))
        t0 = time.perf_counter()
        _paper_dappa(smi, seed, mesh)
        t1 = time.perf_counter()
        _paper_mimdram(mesh)
        t2 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    _paper_card_equals_meta()
    log("paper", f"dappa {t1 - t0:.1f} s, mimdram {t2 - t1:.1f} s, card == "
        f"meta {time.perf_counter() - t2:.1f} s")


# ---------------------------------------------------------------------------
# phase distributed: the Proteus collectives and train step, the pipeline
# and the dry-run, on a one-rank mesh
# ---------------------------------------------------------------------------
DIST_PSUM_N = 1 << 24                # proteus_psum elements, fp32
DIST_PSUM_BLOCK = 256
DIST_STEPS = 3
DIST_PIPE = (4, 2, 512)              # microbatches, rows each, sequence
# the dry-run's cells: (arch, shape, multi-pod, Proteus); the slowest first.
# stablelm-3b (D 80) and kimi-k2 (D 112): kimi-k2's train cell
# on (2, 16, 16), 8 microbatches of 61 layers (~190 s of meta ops on one
# host core); its 16-microbatch (16, 16) cell (~370 s) is held by
# tests/test_torch_dryrun.py alone
DIST_CELLS = (("kimi-k2-1t-a32b", "train_4k", True, False),
              ("mixtral-8x7b", "train_4k", True, True),
              ("stablelm-3b", "train_4k", False, False),
              ("pimref-100m", "train_4k", False, False),
              ("pimref-100m", "prefill_32k", False, False),
              ("pimref-100m", "decode_32k", False, False),
              ("pimref-100m", "long_500k", False, False),
              ("mixtral-8x7b", "long_500k", True, False),
              ("stablelm-3b", "prefill_32k", False, False),
              ("stablelm-3b", "decode_32k", True, False),
              ("kimi-k2-1t-a32b", "prefill_32k", True, False),
              ("kimi-k2-1t-a32b", "decode_32k", False, False),
              ("kimi-k2-1t-a32b", "long_500k", True, False))
# where the reference's skip_reason skips (a full-attention arch at
# long_500k; tests/test_torch_dryrun.py holds the port's to it)
DIST_SKIPS = {("pimref-100m", "long_500k"), ("kimi-k2-1t-a32b", "long_500k")}
DIST_WORKERS = 2
# the card's peak for the Proteus step against the dry-run's prediction:
# "held" within this share (a reading, not a check)
DIST_PEAK_SHARE = 0.15


def _dist_run(seed: int):
    from repro_torch.configs import RunConfig
    return RunConfig(warmup_steps=2, learning_rate=3e-4, microbatches=1,
                     total_steps=DIST_STEPS, proteus_enabled=True,
                     proteus_grad_bits=8, seed=seed)


def _dist_shape():
    from repro_torch.configs import TRAIN_4K, ShapeConfig
    return ShapeConfig("proteus 4x4096", TRAIN_4K.seq_len, TRAIN_BATCH,
                       "train")


def _dryrun_task(arch: str, shape: str, multi: bool, prot: bool) -> dict:
    """One dry-run cell in a worker process (host only, on ``meta``)."""
    torch.set_num_threads(1)
    from repro_torch.configs import RunConfig
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    row = dryrun.run_cell(arch, shape, multi, RunConfig(proteus_enabled=prot),
                          {}, "proteus" if prot else "", verbose=False)
    row["wall_s"] = time.perf_counter() - t0
    row["end"] = time.perf_counter()      # the host's monotonic clock
    return row


def _dryrun_one_device() -> tuple:
    """The dry-run's memory of the phase's own Proteus problem (pimref-100m
    at 4 x 4096, AdamW, a one-rank pod mesh): (memory, Proteus step,
    seconds)."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.mimdram import plan_sharding
    from repro_torch.launch import dryrun
    cfg, shape = get_config("pimref-100m"), _dist_shape()
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        got = dryrun.predict_cell(cfg, shape, plan_sharding(cfg, shape, mesh),
                                  _dist_run(0))
    return got["memory"], got["proteus_step"], got["seconds"]


@contextlib.contextmanager
def dryrun_cells(phases):
    """Phase distributed's dry-run cells and its one-device prediction,
    started on DIST_WORKERS worker processes before the build: yields
    (the cells' futures in DIST_CELLS' order, the prediction's, the start
    time), or None without phase distributed."""
    if "distributed" not in phases:
        yield None
        return
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(max_workers=DIST_WORKERS,
                               mp_context=mp.get_context("spawn"))
    try:
        futs = [pool.submit(_dryrun_task, *c) for c in DIST_CELLS]
        yield futs, pool.submit(_dryrun_one_device), time.perf_counter()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _dist_psum(smi, seed, mesh) -> None:
    """proteus_psum of DIST_PSUM_N fp32 on the card against the same call
    on the host (the mesh's gloo side), at 8 and 4 bits."""
    from repro_torch.core import proteus
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = randn(gen, (DIST_PSUM_N,), torch.float32)
    host = x.cpu()
    for bits in (8, 4):
        got = proteus.proteus_psum(x, "pod", bits=bits,
                                   block=DIST_PSUM_BLOCK, mesh=mesh)
        t0 = time.perf_counter()
        want = proteus.proteus_psum(host, "pod", bits=bits,
                                    block=DIST_PSUM_BLOCK, mesh=mesh)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"distributed/psum {bits}-bit: card and CPU "
                                 "differ")
        # one rank: the exact sum is x, each element within scale / 2 (the
        # reference's bound, n scale / 2 with its 1% for the rounding of
        # code x scale)
        blocks = x.reshape(-1, DIST_PSUM_BLOCK)
        half = blocks.abs().amax(1, keepdim=True) / (2 ** (bits - 1) - 1) / 2
        worst = ((got.reshape(-1, DIST_PSUM_BLOCK) - blocks).abs()
                 / half).max().item()
        if worst > 1.01:
            raise AssertionError(f"distributed/psum {bits}-bit: an element "
                                 f"{worst:.4f} half-scales off")
        ms = _event_ms(lambda: proteus.proteus_psum(
            x, "pod", bits=bits, block=DIST_PSUM_BLOCK, mesh=mesh), 3)
        log("distributed/psum", f"{smi}: proteus_psum {bits}-bit over "
            f"{DIST_PSUM_N} fp32 (block {DIST_PSUM_BLOCK}) on the one-rank "
            f"mesh: card == CPU bitwise; worst error {worst:.4f} of half a "
            f"scale; {ms:.3f} ms on the card (CUDA events, mean of 3, eager, "
            f"the fp32 max all-reduce included), {cpu_ms:.0f} ms on the host")
    del x, host
    torch.cuda.empty_cache()


def _tree_equal(a, b) -> bool:
    from repro_torch.tree import leaves
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _dist_train(smi, seed, mesh, one) -> dict:
    """DIST_STEPS AdamW steps of make_train_step_proteus against the plain
    step with the quantize hook, from the same parameters; returns the
    launches of the Proteus steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.mimdram import plan_sharding
    from repro_torch.core.proteus import quantize_hook
    from repro_torch.data import make_batch_fn
    from repro_torch.kernels.accounting import nbytes
    from repro_torch.launch.steps import (make_train_step,
                                          make_train_step_proteus)
    from repro_torch.launch.train import initial_params
    from repro_torch.models.model import training_model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaves, tree_map
    cfg, shape, run = get_config("pimref-100m"), _dist_shape(), _dist_run(seed)
    L = cfg.num_layers
    plan = plan_sharding(cfg, shape, mesh)
    model = training_model(cfg)
    host = initial_params(cfg, seed, "cpu")
    bf = make_batch_fn(cfg, shape, seed=seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in bf(i).items()}
               for i in range(DIST_STEPS)]

    hook = quantize_hook(run)

    def side(name):
        opt = make_optimizer(cfg.optimizer, run)
        params = tree_map(lambda t: t.to(DEVICE, copy=True), host)
        state = opt.init(params)
        step = (make_train_step_proteus(model, opt, plan, run)
                if name == "proteus" else
                make_train_step(model, opt, run, grad_hook=hook))
        return {"step": step, "params": params, "state": state}

    sides = {"proteus": side("proteus")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = {"proteus": [], "hooked": []}
    peak = None
    total = {}
    for i in range(DIST_STEPS):
        losses = {}
        for name in ("proteus", "hooked"):
            if name not in sides:
                sides[name] = side(name)
            sd = sides[name]
            _reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sd["params"], sd["state"], m = sd["step"](sd["params"],
                                                      sd["state"], batches[i])
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
            counts = {k: v for k, v in _flat_counts().items() if v}
            if counts != {"flash_attention_fwd": 2 * L}:
                raise AssertionError(f"distributed/train {name} step {i}: "
                                     f"launches {counts}, want 2 x {L} of "
                                     "flash_attention_fwd")
            if name == "proteus":
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            if peak is None:
                peak = torch.cuda.max_memory_allocated()
            losses[name] = m["loss"]
        a, b = sides["proteus"], sides["hooked"]
        if not (torch.equal(losses["proteus"], losses["hooked"])
                and _tree_equal(a["params"], b["params"])
                and _tree_equal(a["state"], b["state"])):
            raise AssertionError(f"distributed/train step {i}: the Proteus "
                                 "step and the hooked plain step differ")
        log("distributed/train", f"step {i}: loss "
            f"{losses['proteus'].item():.6f}; losses, parameters and AdamW "
            f"state bitwise equal; {2 * L} prefill launches each")
    quant_ms = _event_ms(lambda: hook(None, a["params"], None), 3)
    n = sum(t.numel() for t in leaves(host))
    med = {k: float(np.median(v[1:])) for k, v in ms.items()}
    log("distributed/train", f"{smi}: pimref-100m full width ({n} params, "
        f"AdamW, bf16 compute) at {TRAIN_BATCH} x {shape.seq_len}, "
        f"{DIST_STEPS} steps a side (CUDA events, the first with its "
        f"warm-up): Proteus step {', '.join('%.1f' % x for x in ms['proteus'])}"
        f" ms, hooked plain step {', '.join('%.1f' % x for x in ms['hooked'])}"
        f" ms; median of steps 1-{DIST_STEPS - 1}: {med['proteus']:.1f} / "
        f"{med['hooked']:.1f} ms; the quantize + dequantize pass over every "
        f"gradient leaf {quant_ms:.2f} ms ({quant_ms / med['hooked']:.2%} of "
        f"the plain step)")
    READINGS["distributed"] = dict(proteus_ms=med["proteus"],
                                   hooked_ms=med["hooked"], quant_ms=quant_ms)
    # the dry-run's prediction for this step's own problem
    own = nbytes(*leaves(a["params"]), *leaves(a["state"]),
                 *batches[0].values())
    extra = nbytes(*(t for bt in batches[1:] for t in bt.values()))
    measured = peak - base - extra
    mem, prot, secs = one.result()
    pred = mem["peak_bytes"]
    share = measured / pred - 1
    log("distributed/peak", f"{smi}: the Proteus step's first step: "
        f"torch.cuda.max_memory_allocated {measured} B over what was live "
        f"before it (its arguments {own} B); the dry-run predicted "
        f"{pred} B (arguments {mem['argument_bytes']}, temporaries "
        f"{mem['temp_bytes']}; its step the "
        f"{'Proteus' if prot else 'plain'} one; {secs:.1f} s on meta): "
        f"{share:+.1%}, {'held' if abs(share) <= DIST_PEAK_SHARE else 'missed'}"
        f" (the prediction: within {DIST_PEAK_SHARE:.0%})")
    if mem["argument_bytes"] != own:
        raise AssertionError(f"distributed/peak: the dry-run's argument "
                             f"bytes {mem['argument_bytes']} != the card's "
                             f"{own}")
    del sides, a, b, batches
    torch.cuda.empty_cache()
    return total


def _dist_pipeline(smi, seed, mesh) -> dict:
    """pimref's 12 blocks as a one-stage pipeline over DIST_PIPE's
    microbatches against the stack run microbatch by microbatch (bitwise)
    and over the whole batch (the bf16 limit)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipelined_forward)
    from repro_torch.launch.train import initial_params
    from repro_torch.models.model import training_model
    from repro_torch.tree import tree_map
    cfg = get_config("pimref-100m")
    L, (M, R, S) = cfg.num_layers, DIST_PIPE
    model = training_model(cfg)
    blocks = tree_map(lambda t: t.to(DEVICE),
                      initial_params(cfg, seed, "cpu")["blocks"])
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    x = randn(gen, (M, R, S, cfg.d_model), torch.bfloat16)
    positions = torch.arange(S, dtype=torch.int32, device=DEVICE)

    def block(p, h):
        return model._tree_block(h, p, positions)

    def stack(h):
        for i in range(L):
            h = block(tree_map(lambda a: a[i], blocks), h)
        return h

    with torch.no_grad():
        _reset()
        t0 = time.perf_counter()
        got = pipelined_forward(block, blocks, x, mesh=mesh, n_stages=1,
                                n_layers=L)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        counts = {k: v for k, v in _flat_counts().items() if v}
        seq = torch.stack([stack(x[m]) for m in range(M)])
        whole = stack(x.reshape(M * R, S, -1)).reshape(x.shape)
    if counts != {"flash_attention_fwd": M * L}:
        raise AssertionError(f"distributed/pipeline: launches {counts}, want "
                             f"{M} x {L} of flash_attention_fwd")
    if not torch.equal(got, seq):
        raise AssertionError("distributed/pipeline: the pipeline differs "
                             "from the stack run microbatch by microbatch")
    rel = ((got.float() - whole.float()).abs().max()
           / whole.float().abs().max()).item()
    if rel > TOL[torch.bfloat16]:
        raise AssertionError(f"distributed/pipeline: {rel:.3e} of the whole "
                             f"batch's max off (limit {TOL[torch.bfloat16]})")
    log("distributed/pipeline", f"{smi}: pimref-100m's {L} blocks, {M} "
        f"microbatches of {R} x {S} (bf16) at 1 stage ({M} ticks, bubble "
        f"{bubble_fraction(1, M):.2f}; the 2-stage schedule on gloo ranks in "
        f"the CPU tests): bitwise == the stack microbatch by microbatch; "
        f"{rel:.2e} of max |out| from the whole-batch stack (limit "
        f"{TOL[torch.bfloat16]}); {counts['flash_attention_fwd']} prefill "
        f"launches; {pipe_s * 1e3:.1f} ms wall")
    del blocks, x, got, seq, whole
    torch.cuda.empty_cache()
    return counts


def _dist_dryrun(smi, futs, t0) -> None:
    """The dry-run's cells from the worker processes: OK, or SKIP where the
    reference skips."""
    rows = [fut.result() for fut in futs]
    for (arch, shape, multi, prot), row in zip(DIST_CELLS, rows):
        want = "SKIP" if (arch, shape) in DIST_SKIPS else "OK"
        label = (f"{arch} x {shape} x {row['mesh']}"
                 f"{' (Proteus)' if prot else ''}")
        if row["status"] != want:
            raise AssertionError(f"distributed/dryrun {label}: "
                                 f"{row['status']}, want {want}: "
                                 f"{row.get('error') or row.get('reason')}")
        if want == "SKIP":
            log("distributed/dryrun", f"{label}: SKIP ({row['reason']})")
            continue
        mem, d = row["memory"], row["damov"]
        log("distributed/dryrun", f"{label}: OK in {row['wall_s']:.1f} s; "
            f"a device's arguments {mem['argument_bytes']} B, temporaries "
            f"{mem['temp_bytes']} B, peak {mem['peak_GB']} GiB (fits 80 GB: "
            f"{mem['fits_80GB']}), microbatches {row['microbatches']}, split "
            f"{row['split']}, Proteus step {row['proteus_step']}; roofline "
            f"compute {d['compute_s']:.4e} s, memory {d['memory_s']:.4e} s, "
            f"collective {d['collective_s']:.4e} s, {d['bottleneck_class']}, "
            f"MF/HF {d['useful_ratio']:.3f}; kernels "
            f"{row['step_cost']['kernels']}")
    log("distributed/dryrun", f"{len(DIST_CELLS)} cells on {DIST_WORKERS} "
        f"worker processes, all done {max(r['end'] for r in rows) - t0:.1f} "
        f"s after they started (at the build)")


def phase_distributed(smi: str, seed: int, cells) -> dict:
    """The Proteus collective and train step and the pipeline on a
    one-rank mesh, the dry-run's cells (``cells``: ``dryrun_cells``'
    futures); returns the launches of the Proteus steps and the
    pipeline."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    futs, one, t_start = cells
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    log("distributed", "one rank, NCCL for the card's tensors and gloo for "
        "the host's, over ('pod',): one card cannot host two NCCL ranks, so "
        "every multi-rank result (proteus_psum on 8 ranks, the Proteus step "
        "on (2, 2, 2), the 2-stage pipeline) comes from the CPU tests on "
        "gloo ranks (tests/test_torch_distributed.py)")
    try:
        mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("pod",))
        t0 = time.perf_counter()
        _dist_psum(smi, seed, mesh)
        t1 = time.perf_counter()
        train = _dist_train(smi, seed, mesh, one)
        t2 = time.perf_counter()
        pipe = _dist_pipeline(smi, seed, mesh)
        t3 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    _dist_dryrun(smi, futs, t_start)
    log("distributed", f"psum {t1 - t0:.1f} s, train {t2 - t1:.1f} s, "
        f"pipeline {t3 - t2:.1f} s, dry-run rows "
        f"{time.perf_counter() - t3:.1f} s")
    return {"distributed": train, "distributed_pipeline": pipe}


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
    with damov_counts(phases) as damov, dryrun_cells(phases) as cells:
        return run_phases(args, phases, smi, damov, cells)


def run_phases(args, phases, smi, damov, cells=None) -> int:
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
        if "engine" in phases:
            phase_engine(model, args.seed)
        cut = None
        if {"robust", "spec"} & set(phases):
            from repro_torch.configs import get_config
            cut = load_model("pimref-100m", smoke=False, seed=args.seed,
                             device="cuda", cfg=get_config(
                                 "pimref-100m").replace(
                                     num_layers=CUT_PIMREF_LAYERS))
        if "robust" in phases:
            t0 = time.perf_counter()
            phase_robust(cut, smi, args.seed)
            log("robust", f"phase took {time.perf_counter() - t0:.1f} s")
        if "fleet" in phases:
            t0 = time.perf_counter()
            phase_fleet(model, smi, args.seed)
            log("fleet", f"phase took {time.perf_counter() - t0:.1f} s")
        if "spec" in phases:
            launches.update(phase_spec(cut, smi, args.seed))
        if "profile" in phases:
            phase_profile(model, smi)
        del model, cut
        torch.cuda.empty_cache()
    if "parity" in phases:
        launches["parity"] = phase_parity(args.seed)
    if "train" in phases:
        launches["train"] = phase_train(smi, args.seed)
    if "train_kernels" in phases:
        rows.update(phase_train_kernels(args.seed))
        rows.update(train_kernels_families(args.seed))
    if "train_parity" in phases:
        launches["train_parity"] = phase_train_parity(smi, args.seed)
    # the other families' training next, while the run is young: the
    # profiler's traces keep their lead-in best early in a run (ROADMAP §C)
    for name, run in (("train_families", phase_train_families),
                      ("train_families_parity", phase_train_families_parity)):
        if name in phases:
            t0 = time.perf_counter()
            launches.update(run(smi, args.seed))
            log(name, f"phase took {time.perf_counter() - t0:.1f} s")
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
    for name, run in (("archs", lambda: phase_archs(smi, args.seed)),
                      ("parity_archs", lambda: {
                          "parity_archs": _parity_family(
                              "parity_archs", "stablelm-3b", args.seed,
                              layouts=D80_PARITY_LAYOUTS)}),
                      ("moe", lambda: phase_moe(smi, args.seed)),
                      ("parity_moe", lambda: {"parity_moe": _parity_family(
                          "parity_moe", MOE_ARCH, args.seed)}),
                      ("vlm", lambda: phase_vlm(smi, args.seed)),
                      ("parity_vlm", lambda: {"parity_vlm": _parity_family(
                          "parity_vlm", VLM_ARCH, args.seed,
                          patch_rows=32)}),
                      ("encdec", lambda: phase_encdec(smi, args.seed)),
                      ("parity_encdec", lambda: {
                          "parity_encdec": _parity_family(
                              "parity_encdec", ENCDEC_ARCH, args.seed,
                              src_rows=64, layouts=ENCDEC_PARITY_LAYOUTS)}),
                      ("xlstm", lambda: phase_xlstm(smi, args.seed)),
                      ("paper", lambda: phase_paper(smi, args.seed, damov)
                       or {}),
                      ("distributed", lambda: phase_distributed(
                          smi, args.seed, cells))):
        if name in phases:
            t0 = time.perf_counter()
            launches.update(run())
            log(name, f"phase took {time.perf_counter() - t0:.1f} s")

    log("run", f"the traces' lead-ins took {sum(t for _, t in LEAD_IN):.1f} s"
        f" ({len(LEAD_IN)} traces; by lead kernels: " + ", ".join(
            f"{n} x{sum(1 for m, _ in LEAD_IN if m == n)} "
            f"{sum(t for m, t in LEAD_IN if m == n):.1f} s"
            for n in sorted({m for m, _ in LEAD_IN})) + ")")
    log("run", f"the whole run took {time.perf_counter() - T_START:.1f} s")
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
