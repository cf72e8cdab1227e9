"""The plans and layouts that the attention wrappers hand the CUDA kernels
(the warp-specialised bf16 prefill at every head dim, the four-warp decode
blocks at D 80, 112 and 128: stablelm-3b's 32 heads of 80, kimi-k2's 64 q
heads on 8 kv heads of 112, mixtral's and pixtral's 4 q heads a kv head of
128), checked on the CPU, and the plain versions at head dims 80 and 112
against the reference's Pallas kernels in interpret mode.

* the bf16 prefill block's shared memory, as ``csrc/flash_prefill.cuh``
  lays it out: two D-80 blocks fit an SM, every head dim's block fits the
  227 KB a block may use; the card test ``test_bf16_prefill_tiles_state_
  the_kernels_layout`` holds the formula to the source's own count;
* the decode plan: all 8 q rows of a kimi-k2 kv head in one block, and the
  split choice (whole 16-row ring stages, at most 128 rows, a function of
  the shapes only);
* the prefill's plain version at D 80 and 112 against the reference, in
  fp32 (the decode layouts' are in test_torch_head_dims.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402

ATOL = 1e-5
# the H100's shared memory a block may use, and an SM's (less 1 KiB a block
# that the runtime keeps)
SMEM_BLOCK_LIMIT = 232448
SMEM_SM_BYTES = 233472


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the bf16 prefill block
# ---------------------------------------------------------------------------
def test_d80_prefill_blocks_two_an_sm():
    """A D-80 block's shared memory (q's 128 rows, four stages of 64-row K
    and V tiles, unpadded, plus positions, headers and mbarriers): two such
    blocks, each with the 1 KiB the runtime keeps, fit an SM's 233,472
    bytes, and so fit 232,448 twice over with room to spare."""
    bk, stages, per_sm = tk.BF16_PREFILL_TILES[80]
    smem = tk.bf16_prefill_smem(80)
    assert per_sm == 2
    assert smem == (128 * 80 * 2 + stages * (2 * bk * 80 * 2 + 4 * bk + 8)
                    + 8 * (1 + 3 * stages) + 1024)
    assert 2 * (smem + 1024) <= SMEM_SM_BYTES
    assert 2 * smem <= SMEM_BLOCK_LIMIT
    # the padded layout the D-80 kernel had (rows as at D 128, BK 128, two
    # stages) fits one block an SM only
    old = 128 * 128 * 2 + 2 * (2 * 128 * 128 * 2 + 128 * 4) + 256 + 1024
    assert 2 * (old + 1024) > SMEM_SM_BYTES


@pytest.mark.parametrize("D", sorted(tk.BF16_PREFILL_TILES))
def test_bf16_prefill_blocks_fit(D):
    """Every head dim's block fits the 227 KB a block may use, and its
    blocks an SM fit the SM; rows are unpadded (q's and the K/V tiles'
    bytes are D columns, not D rounded up to a whole 64-column block), and
    the rest of the block is the ring's positions, headers and mbarriers
    and the base's alignment."""
    bk, stages, per_sm = tk.BF16_PREFILL_TILES[D]
    smem = tk.bf16_prefill_smem(D)
    assert smem <= SMEM_BLOCK_LIMIT
    assert per_sm * (smem + 1024) <= SMEM_SM_BYTES
    assert bk % 32 == 0 and stages >= 2
    tiles = tk.PREFILL_BLOCK_ROWS * D * 2 + stages * 2 * bk * D * 2
    assert 0 < smem - tiles <= stages * (4 * bk + 8) + 8 * (1 + 3 * stages) \
        + 1024


# ---------------------------------------------------------------------------
# the decode plan
# ---------------------------------------------------------------------------
def test_kimi_decode_holds_a_kv_head_in_one_block():
    """kimi-k2's 8 q rows a kv head (G 8, one token) stream each kv split
    once, in one block (so do D 128's, mixtral's and pixtral's 4); D 64's
    one-warp kernel takes 8 rows in two groups of 4."""
    plan = tk.decode_plan(8, 8, 8, 576, D=112)
    assert (plan.rows, plan.groups) == (8, 1)
    assert plan.n_split * plan.split_len >= 576
    assert tk.decode_plan(8, 8, 4, 576, D=128)[:2] == (4, 1)
    assert tk.decode_plan(8, 8, 8, 576, D=64)[:2] == (4, 2)


@pytest.mark.parametrize("D", tk.WIDE_DECODE_DIMS)
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 8, 9, 16, 40])
def test_wide_decode_rows_a_block(D, R):
    """The smallest of 1, 4, 8 q rows a block that holds R, else groups of
    8 (each group streams the split)."""
    plan = tk.decode_plan(4, 2, R, 300, D=D)
    assert plan.rows in tk.WIDE_DECODE_ROWS
    assert plan.rows * plan.groups >= R
    assert plan.rows * (plan.groups - 1) < R
    if R <= 8:
        assert plan.groups == 1 and plan.rows <= 2 * R


@pytest.mark.parametrize("B,H,R,T", [(8, 32, 1, 576), (8, 8, 8, 576),
                                     (4, 2, 1, 577), (1, 1, 1, 5000),
                                     (8, 32, 4, 579), (2, 8, 8, 16)])
def test_wide_decode_splits(B, H, R, T):
    """Splits of whole 16-row ring stages, at most 128 rows, covering T with
    no empty split, and enough of them to give about 264 blocks where T
    allows; stablelm-3b's step takes five splits of 128 rows."""
    plan = tk.decode_plan(B, H, R, T, D=80)
    n, L = plan.n_split, plan.split_len
    assert L % tk.DECODE_SPLIT_MULTIPLE == 0
    assert L <= tk.WIDE_DECODE_MAX_SPLIT
    assert n * L >= T > (n - 1) * L
    assert plan == tk.decode_plan(B, H, R, T, D=80)
    assert tk.decode_plan(B, H, R, T, D=112)[2:] == (n, L)
    blocks = B * H * plan.groups * n
    if L < tk.WIDE_DECODE_MAX_SPLIT and L > tk.DECODE_SPLIT_MULTIPLE:
        assert blocks >= tk.WIDE_DECODE_TARGET_BLOCKS // 2
    if (B, H, R, T) == (8, 32, 1, 576):
        assert (n, L) == (5, 128)


# ---------------------------------------------------------------------------
# the plain versions at D 80 and 112 against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D,Hkv,G", [(80, 3, 1), (112, 2, 8)])
def test_prefill_plain_at_wide_head_dims(D, Hkv, G):
    """The prefill's plain version (the wrapper on CPU tensors) in the
    model's layout against the reference's kernel in interpret mode: out
    and lse, causal, fp32."""
    rng = np.random.default_rng(D + G)
    B, S = 2, 12
    q, k, v = (_np(rng, B, S, Hkv * G, D), _np(rng, B, S, Hkv, D),
               _np(rng, B, S, Hkv, D))
    jo, jl = jops.flash_attention_gqa_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=8, block_k=8, interpret=True)
    to, tl = tops.flash_attention_gqa_fwd(*_t(q, k, v), causal=True)
    _close(to, jo)
    _close(tl, jl)
