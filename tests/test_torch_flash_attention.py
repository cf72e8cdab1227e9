"""The port's flash-attention module (repro_torch.kernels.flash_attention)
against the JAX kernels run in interpret mode, on the same numpy inputs, in
fp32 on the CPU; and the wrappers' checks and the kernel build. The CUDA
kernels themselves are tested on a card by test_torch_kernels_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as jk  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.layers import ring_position_ids  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

ATOL = 1e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ring(depths, S, T):
    """(B, S) q positions and (B, T) ring kv positions (-1 = empty slot)."""
    qp = np.stack([np.arange(d, d + S) for d in depths]).astype(np.int32)
    kp = np.concatenate([np.asarray(ring_position_ids(1, d + S, T))
                         for d in depths]).astype(np.int32)
    return qp, kp


# ---------------------------------------------------------------------------
# prefill: ops.flash_attention_gqa_fwd (out and lse)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 9, 0.0), (True, 0, 5.0), (False, 0, 0.0),
    (True, 9, 5.0),
])
def test_prefill_grid(G, causal, window, cap):
    rng = np.random.default_rng(G * 10 + window)
    B, S, Hkv, D = 2, 24, 2, 16
    q, k, v = _np(rng, B, S, G * Hkv, D), _np(rng, B, S, Hkv, D), \
        _np(rng, B, S, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=cap)
    jo, jl = jops.flash_attention_gqa_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8, block_k=8,
        interpret=True, **kw)
    to, tl = tops.flash_attention_gqa_fwd(*_t(q, k, v), **kw)
    _close(to, jo)
    _close(tl, jl)


@pytest.mark.parametrize("S,T", [(13, 13), (19, 7), (1, 21), (30, 45)])
def test_prefill_odd_lengths(S, T):
    """Any S and T: the reference pads to its blocks, the port does not."""
    rng = np.random.default_rng(S * 100 + T)
    q, k, v = _np(rng, 2, S, 4, 32), _np(rng, 2, T, 2, 32), \
        _np(rng, 2, T, 2, 32)
    jo, jl = jops.flash_attention_gqa_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        block_q=8, block_k=8, interpret=True)
    to, tl = tops.flash_attention_gqa_fwd(*_t(q, k, v), causal=False)
    _close(to, jo)
    _close(tl, jl)


def test_prefill_kernel_layout_masked_rows_and_slots():
    """Kernel layout with explicit positions: -1 q rows give out 0 and lse
    -1e30; -1 kv slots and a fully masked kv tile are skipped."""
    rng = np.random.default_rng(3)
    B, H, G, S, T, D = 2, 2, 2, 16, 32, 16
    q, k, v = _np(rng, B, H, G, S, D), _np(rng, B, H, T, D), \
        _np(rng, B, H, T, D)
    qp = np.tile(np.arange(S, dtype=np.int32) + 20, (B, 1))
    qp[1, :3] = -1
    kp = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kp[0, :16] = -1                  # one whole kv tile of 16 is empty
    kp[1, ::5] = -1
    kw = dict(causal=True, window=12, softcap=0.0)
    jo, jl = jk.flash_attention_fwd(
        *(jnp.asarray(a) for a in (q, k, v, qp, kp)), block_q=8, block_k=16,
        interpret=True, **kw)
    to, tl = tk.flash_attention_fwd(*_t(q, k, v, qp, kp), **kw)
    _close(to, jo)
    _close(tl, jl)
    assert float(tl[1, :, :, :3].max()) == float(np.float32(-1e30))
    assert float(to[1, :, :, :3].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the bf16 prefill route (csrc/flash_prefill.cu): its block plan, and a plain
# emulation of its rounding held against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 2, 4, 8, 10, 12, 64, 100])
@pytest.mark.parametrize("S", [1, 7, 12, 77, 512, 2100])
def test_prefill_plan_covers_every_row_once(G, S):
    """Every (query head, position) of a kv head falls in exactly one block
    row, and no block holds more than 128 rows."""
    plan = tk.prefill_plan(G, S)
    assert 1 <= plan.GG * plan.BQ <= tk.PREFILL_BLOCK_ROWS
    nq = plan.blocks // plan.groups
    seen = {}
    for x in range(plan.blocks):            # the kernel's block_row
        qt, gg = nq - 1 - x // plan.groups, x % plan.groups
        rows = [(gg * plan.GG + gl, qt * plan.BQ + sl)
                for gl, sl in (divmod(r, plan.BQ)
                               for r in range(tk.PREFILL_BLOCK_ROWS))
                if gl < plan.GG]
        rows = [(g, s) for g, s in rows if g < G and s < S]
        assert 0 < len(rows) <= tk.PREFILL_BLOCK_ROWS
        for gs in rows:
            seen[gs] = seen.get(gs, 0) + 1
    assert seen == {(g, s): 1 for g in range(G) for s in range(S)}


def _emulate_bf16_prefill(q, k, v, qp, kp, *, causal, window, softcap, BK):
    """The bf16 kernel's arithmetic in plain torch: kv tiles of BK rows, q.k
    in fp32 from the bf16 operands, the online softmax in fp32, p rounded to
    bf16 before p @ v, l summed from the fp32 p. Returns fp32 (out, lse)
    before the output's rounding."""
    B, H, G, S, D = q.shape
    T = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    mask = ref.visible_mask(qp, kp, causal=causal, window=window)[:, None,
                                                                 None]
    m = torch.full((B, H, G, S), ref.NEG_INF)
    l = torch.zeros(B, H, G, S)
    acc = torch.zeros(B, H, G, S, D)
    for t0 in range(0, T, BK):
        s = torch.einsum("bhgsd,bhtd->bhgst", qf, kf[:, :, t0:t0 + BK]) \
            / np.sqrt(np.float32(D))
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[..., t0:t0 + BK], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(m_new <= ref.NEG_INF / 2, 0.0, m_new)
        alpha = torch.where(m <= ref.NEG_INF / 2, 0.0, torch.exp(m - safe))
        p = torch.exp(s - safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bhtd->bhgsd", p.bfloat16().float(), vf[:, :, t0:t0 + BK])
        m = m_new
    lsafe = torch.where(l == 0, 1.0, l)
    lse = torch.where(m <= ref.NEG_INF / 2, ref.NEG_INF, m + torch.log(lsafe))
    return acc / lsafe[..., None], lse


@pytest.mark.parametrize("D,BK", [(64, 128), (128, 128), (256, 64)])
@pytest.mark.parametrize("G,S,T,window,cap", [
    (1, 40, 300, 0, 0.0), (4, 23, 150, 48, 20.0), (10, 12, 90, 0, 0.0)])
def test_bf16_prefill_rounding_within_quarter_of_limit(D, BK, G, S, T,
                                                       window, cap):
    """Rounding p to bf16 before p @ v (the tensor-core kernel's one
    difference from the reference's fp32 products) moves out by at most a
    quarter of the card's 2e-2 bf16 limit, against the reference's Pallas
    kernel in interpret mode and the port's plain version on the same bf16
    inputs; lse does not move. Rounded to bf16, the emulation stays within
    the limit of the reference kernel run on bf16 inputs, and within the
    per-element limit (``ref.bf16_route_limit``) and the lse limit of 1e-4
    that the card holds the kernel to against the plain version."""
    rng = np.random.default_rng(D + G * 7 + S)
    B, H = 2, 2
    q, k, v = (torch.from_numpy(_np(rng, *shape)).bfloat16() for shape in
               ((B, H, G, S, D), (B, H, T, D), (B, H, T, D)))
    qp = np.tile(np.arange(S, dtype=np.int32) + T - S, (B, 1))
    qp[1, :3] = -1
    kp = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kp[1, ::3] = -1
    kw = dict(causal=True, window=window, softcap=cap)
    qpt, kpt = _t(qp, kp)
    eo, el = _emulate_bf16_prefill(q, k, v, qpt, kpt, BK=BK, **kw)
    f32 = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    jo, jl = jk.flash_attention_fwd(*f32, jnp.asarray(qp), jnp.asarray(kp),
                                    block_q=S, block_k=T, interpret=True,
                                    **kw)
    limit = 2e-2 / 4
    _close(eo, jo, atol=limit)
    _close(el, jl, atol=limit)
    po, pl = ref.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                         qpt, kpt, **kw)
    _close(eo, po.numpy(), atol=limit)
    _close(el, pl.numpy(), atol=limit)
    jo16, _ = jk.flash_attention_fwd(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), jnp.asarray(qp), jnp.asarray(kp),
        block_q=S, block_k=T, interpret=True, **kw)
    _close(eo.bfloat16(), np.asarray(jo16, np.float32), atol=2e-2)
    want, _ = ref.flash_attention_fwd_ref(q, k, v, qpt, kpt, **kw)
    abs_v_out, _ = ref.flash_attention_fwd_ref(q.float(), k, v.abs(), qpt,
                                               kpt, **kw)
    assert bool(((eo.bfloat16().float() - want.float()).abs()
                 <= ref.bf16_route_limit(want, abs_v_out)).all())
    _close(el, pl.numpy(), atol=1e-4)


def test_bf16_route_limits_catch_a_window_off_by_one():
    """The bf16 limits are tight enough to see a kernel that drops one key
    per row: the emulation with its window one short, against the plain
    version with the full window, leaves the lse limit of 1e-4 and the
    per-element out limit."""
    rng = np.random.default_rng(5)
    B, H, G, S, D, W = 1, 2, 2, 300, 64, 256
    q, k, v = (torch.from_numpy(_np(rng, *shape)).bfloat16() for shape in
               ((B, H, G, S, D), (B, H, S, D), (B, H, S, D)))
    pos, = _t(np.arange(S, dtype=np.int32)[None])
    eo, el = _emulate_bf16_prefill(q, k, v, pos, pos, causal=True,
                                   window=W - 1, softcap=0.0, BK=128)
    want, lse = ref.flash_attention_fwd_ref(q, k, v, pos, pos, causal=True,
                                            window=W)
    abs_v_out, _ = ref.flash_attention_fwd_ref(q.float(), k, v.abs(), pos,
                                               pos, causal=True, window=W)
    assert float((el - lse).abs().max()) > 1e-4
    assert not bool(((eo.bfloat16().float() - want.float()).abs()
                     <= ref.bf16_route_limit(want, abs_v_out)).all())


# ---------------------------------------------------------------------------
# the fp32 prefill route (csrc/flash_prefill.cu): its block plan, and a plain
# emulation of its arithmetic (ref.fp32_route_ref) held against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 10])
@pytest.mark.parametrize("S", [1, 77, 512])
def test_fp32_prefill_plan_covers_every_row_once(D, G, S):
    """The fp32 route's plan, with its FP32_PREFILL_TILES rows a block:
    every (query head, position) of a kv head in exactly one block row."""
    rows = tk.FP32_PREFILL_TILES[D][0]
    plan = tk.prefill_plan(G, S, rows)
    assert 1 <= plan.GG * plan.BQ <= rows
    nq = plan.blocks // plan.groups
    seen = {}
    for x in range(plan.blocks):            # the kernel's block_row
        qt, gg = nq - 1 - x // plan.groups, x % plan.groups
        cover = [(gg * plan.GG + r // plan.BQ, qt * plan.BQ + r % plan.BQ)
                 for r in range(rows) if r // plan.BQ < plan.GG]
        cover = [(g, s) for g, s in cover if g < G and s < S]
        assert cover
        for gs in cover:
            seen[gs] = seen.get(gs, 0) + 1
    assert seen == {(g, s): 1 for g in range(G) for s in range(S)}


FP32_ROUTE_LIMIT = 2e-5 / 4     # a quarter of the card's fp32 limit


def _fp32_case(rng, D, G, S, T, spike=80.0):
    """fp32 inputs in the kernel layout: q positions T - S .. T - 1, batch
    row 1 with its first 3 q rows and every third kv slot at -1, and a q
    row 0 of batch row 0 whose scores are -spike |k[:, 0]| (k's first
    column made non-positive): a third of its p underflow past 2^-110
    (where bf16's parts lose bits), while its lse stays near 0."""
    B, H = 2, 2
    q, k, v = (_np(rng, *shape) for shape in
               ((B, H, G, S, D), (B, H, T, D), (B, H, T, D)))
    k[..., 0] = -np.abs(k[..., 0])
    q[0, :, :, 0] = 0.0
    q[0, :, :, 0, 0] = spike * np.sqrt(D)
    qp = np.tile(np.arange(S, dtype=np.int32) + T - S, (B, 1))
    qp[1, :3] = -1
    kp = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kp[1, ::3] = -1
    return q, k, v, qp, kp


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G,S,T,window,cap", [
    (1, 40, 301, 0, 0.0), (4, 23, 150, 48, 20.0), (10, 13, 91, 0, 0.0)])
def test_fp32_route_within_quarter_of_limit(D, G, S, T, window, cap):
    """The fp32 kernel's arithmetic (three exact bf16 parts of q, k, v and
    p, the six pair products i + j <= 2, an fp32 online softmax over its kv
    tiles) stays within a quarter of the card's 2e-5 fp32 limit of the
    reference's Pallas kernel in interpret mode and of the port's plain
    version, out and lse, on the same fp32 inputs; -1 q rows give out 0 and
    lse -1e30, and (without a softcap) the spiked row's p do underflow past
    2^-110."""
    rng = np.random.default_rng(D + G * 7 + S)
    q, k, v, qp, kp = _fp32_case(rng, D, G, S, T)
    kw = dict(causal=True, window=window, softcap=cap)
    args = _t(q, k, v, qp, kp)
    eo, el = ref.fp32_route_ref(*args, block_k=tk.FP32_PREFILL_TILES[D][1],
                                **kw)
    jo, jl = jk.flash_attention_fwd(*(jnp.asarray(a) for a in (q, k, v, qp,
                                                                kp)),
                                    block_q=S, block_k=T, interpret=True, **kw)
    _close(eo, jo, atol=FP32_ROUTE_LIMIT)
    _close(el, jl, atol=FP32_ROUTE_LIMIT)
    po, pl = ref.flash_attention_fwd_ref(*args, **kw)
    _close(eo, po.numpy(), atol=FP32_ROUTE_LIMIT)
    _close(el, pl.numpy(), atol=FP32_ROUTE_LIMIT)
    assert float(eo[1, :, :, :3].abs().max()) == 0.0
    assert float(el[1, :, :, :3].max()) == float(np.float32(ref.NEG_INF))
    if cap == 0:                 # a softcap bounds the scores to +-cap
        seen = ref.visible_mask(*_t(qp, kp), causal=True,
                                window=window)[0, 0].numpy()
        s = np.einsum("hd,htd->ht", q[0, :, 0, 0], k[0])[:, seen] / np.sqrt(D)
        assert (np.exp(s - s.max(axis=-1, keepdims=True)) < 2.0 ** -110).any()


def test_fp32_route_limit_catches_three_pair_products():
    """The quarter limit tells the schemes apart: with three pair products
    (q0 k0 + q0 k1 + q1 k0, and the same for p and v) the emulation leaves
    it against the plain version, at pimref's head_dim over a causal
    512 x 512 attention."""
    rng = np.random.default_rng(7)
    S, D = 512, 64
    q, k, v = (_np(rng, *shape) for shape in
               ((1, 2, 1, S, D), (1, 2, S, D), (1, 2, S, D)))
    pos = np.arange(S, dtype=np.int32)[None]
    args = _t(q, k, v, pos, pos)
    po, _ = ref.flash_attention_fwd_ref(*args, causal=True)
    e3, _ = ref.fp32_route_ref(*args, causal=True, block_k=64,
                               pairs=((1, 0), (0, 1), (0, 0)))
    e6, _ = ref.fp32_route_ref(*args, causal=True, block_k=64)
    assert float((e3 - po).abs().max()) > FP32_ROUTE_LIMIT
    assert float((e6 - po).abs().max()) <= FP32_ROUTE_LIMIT


# ---------------------------------------------------------------------------
# decode: ops.flash_decode against the ring cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 0.0), (0, 5.0)])
def test_decode_ring_mixed_depths(S, G, window, cap):
    rng = np.random.default_rng(S * 7 + G + window)
    B, Hkv, D, T = 4, 2, 16, 40
    depths = [3, 17, 39, 61]         # short, mid, full, wrapped ring
    q = _np(rng, B, S, Hkv * G, D)
    k, v = _np(rng, B, T, Hkv, D), _np(rng, B, T, Hkv, D)
    qp, kp = _ring(depths, S, T)
    kw = dict(causal=True, window=window, softcap=cap)
    want = jops.flash_decode(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                             block_k=16, interpret=True, **kw)
    got = tops.flash_decode(*_t(q, k, v, qp, kp), **kw)
    _close(got, want)


def test_decode_kernel_layout_odd_t():
    """Kernel layout, T not a multiple of any tile: the reference pads to
    its block, the port masks the edge."""
    rng = np.random.default_rng(11)
    B, H, G, S, T, D = 3, 2, 2, 1, 37, 32
    q, k, v = _np(rng, B, H, G, S, D), _np(rng, B, H, T, D), \
        _np(rng, B, H, T, D)
    qp, kp = _ring([5, 36, 80], S, T)
    Tp = 48
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, Tp - T), (0, 0)))
    kpp = np.pad(kp, ((0, 0), (0, Tp - T)), constant_values=-1)
    want = jk.flash_decode_fwd(*(jnp.asarray(a) for a in
                                 (q, pad(k), pad(v), qp, kpp)),
                               block_k=16, interpret=True)
    _close(tk.flash_decode_fwd(*_t(q, k, v, qp, kp)), want)


def test_plain_versions_agree():
    """The decode plain version is the prefill one without lse."""
    rng = np.random.default_rng(12)
    q, k, v = _np(rng, 2, 2, 3, 4, 16), _np(rng, 2, 2, 9, 16), \
        _np(rng, 2, 2, 9, 16)
    qp, kp = _ring([2, 10], 4, 9)
    args = _t(q, k, v, qp, kp)
    assert torch.equal(ref.flash_decode_fwd_ref(*args),
                       ref.flash_attention_fwd_ref(*args)[0])


# ---------------------------------------------------------------------------
# flash_attention_bh: the (BH, S, D) adapter onto the prefill kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,T", [(13, 13), (19, 7), (30, 45), (100, 100),
                                 (1, 21)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 9)])
def test_flash_attention_bh_matches_reference(S, T, causal, window):
    """Odd S and T: the reference pads to its blocks and slices, the port
    runs the prefill path on the exact lengths."""
    rng = np.random.default_rng(S * 100 + T + window)
    q, k, v = _np(rng, 3, S, 32), _np(rng, 3, T, 32), _np(rng, 3, T, 32)
    kw = dict(causal=causal, window=window)
    got = tk.flash_attention_bh(*_t(q, k, v), **kw)
    assert got.shape == (3, S, 32) and got.dtype == torch.float32
    _close(got, jk.flash_attention_bh(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), block_q=8, block_k=8,
                                      interpret=True, **kw))
    want = jref.attention_ref_bh(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    _close(got, want)
    _close(ref.attention_ref_bh(*_t(q, k, v), **kw), want)


def test_flash_attention_bh_bf16_and_launches():
    """bf16 in, bf16 out (one rounding of the fp32 result); the CPU path
    launches nothing and the ops module re-exports the adapter."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_np(rng, 2, 33, 16)).bfloat16()
               for _ in range(3))
    before = dict(tk.LAUNCHES)
    got = tops.flash_attention_bh(q, k, v, causal=True, window=0)
    assert tk.LAUNCHES == before and got.dtype == torch.bfloat16
    want = jref.attention_ref_bh(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) for t in (q, k, v)), causal=True)
    _close(got, np.asarray(want, np.float32), atol=2e-2)


def test_flash_attention_bh_rejects_bad_shapes():
    q = torch.zeros(2, 5, 16)
    with pytest.raises(ValueError):
        tk.flash_attention_bh(q, q[:1], q[:1])          # BH differ
    with pytest.raises(ValueError):
        tk.flash_attention_bh(q[None], q, q)             # not (BH, S, D)
    with pytest.raises(ValueError, match="no kernel"):
        m = torch.zeros(2, 5, 64, device="meta")
        tk.flash_attention_bh(m, m, m)


# ---------------------------------------------------------------------------
# decode over Proteus codes and pages: ops.flash_decode_quant, _paged and
# _paged_quant against the reference's interpret-mode kernels
# ---------------------------------------------------------------------------
def _codes(rng, shape, mode):
    """Reference-quantized K/V: numpy codes (..., Dc) and scales (...)."""
    q = jl.kv_quantize(jnp.asarray(_np(rng, *shape)), mode)
    return np.array(q.codes), np.array(q.scale)


def _table(rng, B, NP, kp, ps):
    """A permuted table over 1 + B * NP pages: slot 1 shares slot 0's first
    page, and slot 0's pages that hold no position sit on the trash page."""
    table = (rng.permutation(B * NP) + 1).astype(np.int32).reshape(B, NP)
    table[1, 0] = table[0, 0]
    table[0][(kp[0].reshape(NP, ps) < 0).all(axis=1)] = 0
    return table


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("S,G,window,cap", [(1, 1, 0, 0.0), (4, 2, 10, 0.0),
                                            (1, 4, 0, 5.0)])
def test_decode_quant_matches_reference(mode, S, G, window, cap):
    rng = np.random.default_rng(S * 5 + G + window)
    B, Hkv, D, T = 4, 2, 16, 40
    q = _np(rng, B, S, Hkv * G, D)
    (kc, ks), (vc, vs) = (_codes(rng, (B, T, Hkv, D), mode) for _ in range(2))
    qp, kp = _ring([3, 17, 39, 61], S, T)
    kw = dict(causal=True, window=window, softcap=cap)
    want = jops.flash_decode_quant(
        *(jnp.asarray(a) for a in (q, kc, ks, vc, vs, qp, kp)), block_k=16,
        interpret=True, **kw)
    got = tops.flash_decode_quant(*_t(q, kc, ks, vc, vs, qp, kp), **kw)
    _close(got, want)


@pytest.mark.parametrize("mode", ["off", "int8", "int4"])
@pytest.mark.parametrize("S,G,window,cap", [(1, 2, 0, 0.0), (4, 1, 12, 5.0)])
def test_decode_paged_matches_reference(mode, S, G, window, cap):
    """Pools read through a permuted table with a shared page and trash
    rows; the paged plain version also equals the dense one on the gathered
    pages."""
    rng = np.random.default_rng(S + G + len(mode))
    B, Hkv, D, ps, NP = 3, 2, 16, 8, 4
    P, T = 1 + B * NP, NP * ps
    q = _np(rng, B, S, Hkv * G, D)
    qp, kp = _ring([2, 20, 40], S, T)
    table = _table(rng, B, NP, kp, ps)
    kw = dict(causal=True, window=window, softcap=cap)
    if mode == "off":
        pools = (_np(rng, P, ps, Hkv, D), _np(rng, P, ps, Hkv, D))
        jfn, tfn = jops.flash_decode_paged, tops.flash_decode_paged
    else:
        pools = (_codes(rng, (P, ps, Hkv, D), mode)
                 + _codes(rng, (P, ps, Hkv, D), mode))
        jfn, tfn = jops.flash_decode_paged_quant, tops.flash_decode_paged_quant
    want = jfn(*(jnp.asarray(a) for a in (q, *pools, table, qp, kp)),
               interpret=True, **kw)
    got = tfn(*_t(q, *pools, table, qp, kp), **kw)
    _close(got, want)
    gathered = [ref.gather_pages(p, torch.from_numpy(table)).transpose(1, 2)
                for p in _t(*pools)]
    dense = (tops.flash_decode(_t(q)[0], *gathered, *_t(qp, kp), **kw)
             if mode == "off" else
             tops.flash_decode_quant(_t(q)[0], *gathered, *_t(qp, kp), **kw))
    assert torch.equal(got, dense)


@pytest.mark.parametrize("layout,mode", [
    ("dense", "int8"), ("dense", "int4"), ("paged", "off"), ("paged", "int8"),
    ("paged", "int4")])
def test_decode_layouts_head_dim_256_match_reference(layout, mode):
    """Griffin's attention shape (one kv head, ten q heads of 256, S 1)
    over codes and pages, which the CUDA kernels take at head_dim 256: the
    plain versions against the reference kernels in interpret mode, within
    ATOL (fp32, summation order)."""
    rng = np.random.default_rng(len(layout) + len(mode))
    B, Hkv, G, D, ps, NP = 2, 1, 10, 256, 8, 3
    T = NP * ps
    q = _np(rng, B, 1, Hkv * G, D)
    qp, kp = _ring([5, 30], 1, T)
    kw = dict(causal=True, window=16, softcap=0.0)
    if layout == "dense":
        ops = (_codes(rng, (B, T, Hkv, D), mode)
               + _codes(rng, (B, T, Hkv, D), mode))
        want = jops.flash_decode_quant(
            *(jnp.asarray(a) for a in (q, *ops, qp, kp)), block_k=8,
            interpret=True, **kw)
        got = tops.flash_decode_quant(*_t(q, *ops, qp, kp), **kw)
    else:
        P = 1 + B * NP
        table = _table(rng, B, NP, kp, ps)
        if mode == "off":
            ops = (_np(rng, P, ps, Hkv, D), _np(rng, P, ps, Hkv, D))
            jfn, tfn = jops.flash_decode_paged, tops.flash_decode_paged
        else:
            ops = (_codes(rng, (P, ps, Hkv, D), mode)
                   + _codes(rng, (P, ps, Hkv, D), mode))
            jfn = jops.flash_decode_paged_quant
            tfn = tops.flash_decode_paged_quant
        want = jfn(*(jnp.asarray(a) for a in (q, *ops, table, qp, kp)),
                   interpret=True, **kw)
        got = tfn(*_t(q, *ops, table, qp, kp), **kw)
    assert got.shape == (B, 1, Hkv * G, D)
    _close(got, want)


def test_dequant_rows_in_fp32():
    """Codes dequantize in fp32 whatever q's dtype, as _dequant_rows does."""
    rng = np.random.default_rng(14)
    kc, ks = _codes(rng, (1, 2, 5, 16), "int4")
    d = ref.dequant_rows(*_t(kc, ks), 16)
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jl.kv_dequantize(
            jl.QKVCache(jnp.asarray(kc), jnp.asarray(ks)), 16, jnp.float32)))


# ---------------------------------------------------------------------------
# wrappers: checks, counters, splits
# ---------------------------------------------------------------------------
def test_cpu_path_launches_nothing():
    before = dict(tk.LAUNCHES)
    rng = np.random.default_rng(13)
    q, k, v = _t(_np(rng, 1, 5, 2, 16), _np(rng, 1, 5, 2, 16),
                 _np(rng, 1, 5, 2, 16))
    tops.flash_attention_gqa_fwd(q, k, v)
    qp, kp = _t(*_ring([4], 1, 5))
    tops.flash_decode(q[:, :1], k, v, qp, kp)
    codes, scale = torch.zeros(1, 5, 2, 8, dtype=torch.int8), torch.ones(1, 5, 2)
    tops.flash_decode_quant(q[:, :1], codes, scale, codes, scale, qp, kp)
    table = torch.ones(1, 1, dtype=torch.int32)
    pool = torch.zeros(2, 5, 2, 16)
    tops.flash_decode_paged(q[:, :1], pool, pool, table, qp, kp)
    tops.flash_decode_paged_quant(q[:, :1], codes[:1].expand(2, -1, -1, -1),
                                  scale.expand(2, -1, -1),
                                  codes[:1].expand(2, -1, -1, -1),
                                  scale.expand(2, -1, -1), table, qp, kp)
    assert tk.LAUNCHES == before


def test_layout_wrappers_reject_bad_operands():
    q = torch.zeros(1, 2, 1, 1, 16)
    qp, kp = torch.zeros(1, 1, dtype=torch.int32), torch.zeros(
        1, 8, dtype=torch.int32)
    codes, scale = torch.zeros(1, 2, 8, 16, dtype=torch.int8), torch.ones(1, 2, 8)
    with pytest.raises(TypeError, match="int8"):
        tk.flash_decode_quant_fwd(q, codes.float(), scale, codes.float(),
                                  scale, qp, kp)
    with pytest.raises(TypeError, match="float32"):
        tk.flash_decode_quant_fwd(q, codes, scale.double(), codes,
                                  scale.double(), qp, kp)
    with pytest.raises(ValueError, match="code width"):
        tk.flash_decode_quant_fwd(q, codes[..., :5], scale, codes[..., :5],
                                  scale, qp, kp)
    with pytest.raises(ValueError, match="scales"):
        tk.flash_decode_quant_fwd(q, codes, scale[:, :1], codes, scale[:, :1],
                                  qp, kp)
    pool = torch.zeros(3, 4, 2, 16)
    table = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tk.flash_decode_paged_fwd(q, pool, pool, table.long(), qp, kp)
    with pytest.raises(ValueError, match="positions"):
        tk.flash_decode_paged_fwd(q, pool, pool, table[:, :1], qp, kp)
    with pytest.raises(ValueError, match="disagree"):
        tk.flash_decode_paged_fwd(q, pool[..., :1, :], pool[..., :1, :],
                                  table, qp, kp)
    with pytest.raises(ValueError, match="code width"):
        tk.flash_decode_paged_quant_fwd(
            q, pool.to(torch.int8)[..., :3], pool[..., 0],
            pool.to(torch.int8)[..., :3], pool[..., 0], table, qp, kp)


@pytest.mark.parametrize("ps,match", [(4, "page size"), (8, "no kernel")])
def test_paged_wrapper_on_other_device(ps, match):
    """Off the CPU the paged kernels take page sizes 8, 16, 32 and 64 only,
    and a tensor that is not on the CPU never takes the plain version."""
    meta = dict(device="meta")
    q = torch.zeros(1, 2, 1, 1, 64, **meta)
    pool = torch.zeros(3, ps, 2, 64, **meta)
    table = torch.zeros(1, 2, dtype=torch.int32, **meta)
    qp = torch.zeros(1, 1, dtype=torch.int32, **meta)
    kp = torch.zeros(1, 2 * ps, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match=match):
        tk.flash_decode_paged_fwd(q, pool, pool, table, qp, kp)


@pytest.mark.parametrize("fn", [tk.flash_attention_fwd, tk.flash_decode_fwd])
def test_wrapper_rejects_bad_shapes(fn):
    q = torch.zeros(1, 2, 1, 3, 16)
    k = torch.zeros(1, 2, 5, 16)
    qp, kp = torch.zeros(1, 3, dtype=torch.int32), torch.zeros(
        1, 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        fn(q, k[:, :1], k[:, :1], qp, kp)              # kv heads differ
    with pytest.raises(ValueError):
        fn(q, k, k, qp[:, :2], kp)                     # q positions (B, S)
    with pytest.raises(TypeError):
        fn(q, k.double(), k.double(), qp, kp)          # dtypes differ


@pytest.mark.parametrize("fn", [tk.flash_attention_fwd, tk.flash_decode_fwd])
def test_wrapper_on_other_device_raises(fn):
    """A tensor that is not on the CPU never takes the plain version."""
    q = torch.zeros(1, 2, 1, 3, 64, device="meta")
    k = torch.zeros(1, 2, 5, 64, device="meta")
    qp = torch.zeros(1, 3, dtype=torch.int32, device="meta")
    kp = torch.zeros(1, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fn(q, k, k, qp, kp)


@pytest.mark.parametrize("B,H,T", [(8, 12, 576), (1, 1, 1), (4, 4, 40),
                                   (1, 12, 4096), (64, 12, 300),
                                   (8, 1, 576), (1, 1, 33000)])
def test_decode_splits_cover_t(B, H, T):
    n_split, split_len = tk.decode_splits(B, H, T)
    assert split_len % tk.DECODE_SPLIT_MULTIPLE == 0
    assert split_len <= tk.DECODE_MAX_SPLIT
    assert (n_split - 1) * split_len < T <= n_split * split_len
    assert tk.decode_splits(B, H, T) == (n_split, split_len)


@pytest.mark.parametrize("B,H,R,T", [(8, 12, 1, 576), (8, 1, 10, 576)])
def test_decode_plan_fills_the_card(B, H, R, T):
    """pimref's decode step (B 8, Hkv 12, one q row) and Griffin's (B 8,
    one kv head, ten q heads): at least one block per SM of the H100's 132
    from the slots, kv heads and splits alone."""
    plan = tk.decode_plan(B, H, R, T)
    assert B * H * plan.n_split >= 132


@pytest.mark.parametrize("B,H,R,T", [
    (8, 12, 1, 576), (8, 1, 10, 576), (8, 12, 4, 576), (3, 2, 16, 300),
    (2, 2, 40, 13), (1, 1, 2, 1), (64, 12, 1, 300), (4, 1, 20, 2048),
    (1, 1, 1, 33000)])
def test_decode_plan_covers_every_row_once(B, H, R, T):
    """The blocks of a plan take every q row and every kv row of a slot and
    kv head exactly once, and every block has a q row and a kv row; the
    row count is one the kernel is built for."""
    plan = tk.decode_plan(B, H, R, T)
    assert plan.rows in tk.DECODE_ROWS
    q_rows = [rg * plan.rows + r for rg in range(plan.groups)
              for r in range(plan.rows) if rg * plan.rows + r < R]
    assert sorted(q_rows) == list(range(R))
    assert all(rg * plan.rows < R for rg in range(plan.groups))
    kv_rows = [x * plan.split_len + t for x in range(plan.n_split)
               for t in range(plan.split_len) if x * plan.split_len + t < T]
    assert sorted(kv_rows) == list(range(T))
    assert all(x * plan.split_len < T for x in range(plan.n_split))
    assert plan.split_len <= tk.DECODE_MAX_SPLIT
    assert tk.decode_plan(B, H, R, T) == plan


def test_build_finds_sources_and_names_missing_nvcc(monkeypatch, tmp_path):
    srcs = build.sources()
    assert "flash_prefill" in srcs
    lib = build.library_path(srcs["flash_prefill"])
    assert lib.parent == build.BUILD_DIR and lib.name.startswith(
        "libflash_prefill-")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    for var in build.CUDA_ROOTS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
