"""The CUDA kernels of repro_torch against their plain PyTorch versions, on
a card. Imports neither jax nor the reference package, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Without a card every test skips."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels.flash_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels import narrow_value as nv  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as qk  # noqa: E402
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_ref  # noqa: E402
from repro_torch.models.layers import (kv_quantize,  # noqa: E402
                                       ring_position_ids)

# fp32: summation order only; bf16: one rounding of the output
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the bf16 prefill route, beside TOL's 2e-2: every element of out within
# ref.bf16_route_limit (one output ulp, and p rounded to bf16 before p @ v),
# and lse, which comes from the fp32 scores, within 1e-4
BF16_LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _assert_bf16_route(o, ro, abs_v_out, lse=None, rl=None):
    assert _err(o, ro) <= TOL[torch.bfloat16]
    assert bool(((o.float() - ro.float()).abs()
                 <= ref.bf16_route_limit(ro, abs_v_out)).all())
    if lse is not None:
        assert _err(lse, rl) <= BF16_LSE_TOL


def _assert_prefill(dtype, o, lse, q, k, v, qp, kp, **kw):
    """The prefill kernel's out and lse against the plain version on the
    same kernel-layout inputs, at the dtype's limits; returns the plain
    version's (out, lse)."""
    ro, rl = ref.flash_attention_fwd_ref(q, k, v, qp, kp, **kw)
    if dtype == torch.bfloat16:
        _assert_bf16_route(o, ro, ref.flash_attention_fwd_ref(
            q.float(), k, v.abs(), qp, kp, **kw)[0], lse, rl)
    else:
        assert _err(o, ro) <= TOL[dtype]
        assert _err(lse, rl) <= TOL[dtype]
    return ro, rl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,T,D,window,cap", [
    (1, 512, 512, 64, 0, 0.0), (4, 77, 203, 128, 48, 20.0),
    (2, 1, 33, 64, 0, 0.0)])
def test_prefill_kernel(cuda, dtype, G, S, T, D, window, cap):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (2, 3, G, S, D), dtype, cuda)
    k = _randn(gen, (2, 3, T, D), dtype, cuda)
    v = _randn(gen, (2, 3, T, D), dtype, cuda)
    qp = (torch.arange(S, dtype=torch.int32, device=cuda) + T - S).repeat(2, 1)
    qp[1, :S // 4] = -1
    kp = torch.arange(T, dtype=torch.int32, device=cuda).repeat(2, 1)
    kp[1, ::3] = -1
    kw = dict(causal=True, window=window, softcap=cap)
    n = tk.LAUNCHES["flash_attention_fwd"]
    o, lse = tk.flash_attention_fwd(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention_fwd"] == n + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    _assert_prefill(dtype, o, lse, q, k, v, qp, kp, **kw)


# ---------------------------------------------------------------------------
# the two prefill routes of flash_prefill.cu, both on the tensor cores: bf16
# operands, and fp32 operands as three exact bf16 parts each
# ---------------------------------------------------------------------------
def _prefill_case(gen, dev, B, H, G, S, T, D, dtype, shift=None):
    """Inputs of one prefill case: q positions T - S .. T - 1 (or + shift),
    batch row 1 with its first S // 4 q rows and every third kv slot at
    -1."""
    q = _randn(gen, (B, H, G, S, D), dtype, dev)
    k = _randn(gen, (B, H, T, D), dtype, dev)
    v = _randn(gen, (B, H, T, D), dtype, dev)
    qp = (torch.arange(S, dtype=torch.int32, device=dev)
          + (T - S if shift is None else shift)).repeat(B, 1)
    kp = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
    if B > 1:
        qp[1, :S // 4] = -1
        kp[1, ::3] = -1
    return q, k, v, qp, kp


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
@pytest.mark.parametrize("G,S,T,window,cap", [
    (1, 77, 203, 0, 0.0),          # ragged: neither BQ nor BK divides S, T
    (2, 1, 33, 0, 0.0),
    (4, 77, 203, 48, 20.0),        # window and softcap
    (10, 100, 150, 0, 0.0),        # 120 of a block's 128 rows used
    (3, 3072, 3072, 2048, 0.0),    # a window the prompt crosses
    (1, 8, 33000, 0, 0.0),         # more kv tiles than one scan holds
])
def test_prefill_bf16_tensor_core_route(cuda, D, G, S, T, window, cap):
    """bf16 prefill on the wgmma kernel against the plain version (fp32
    products; the kernel rounds p to bf16 before p @ v): out within 2e-2
    and every element within its two roundings, lse within 1e-4; -1 q rows
    give out 0 and lse -1e30; the fp32 route is not launched."""
    gen = torch.Generator(device=cuda).manual_seed(D + G + S)
    B = 1 if S > 1000 else 2
    q, k, v, qp, kp = _prefill_case(gen, cuda, B, 2, G, S, T, D,
                                    torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=cap)
    n = dict(tk.LAUNCHES)
    o, lse = tk.flash_attention_fwd(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention_fwd"] == n["flash_attention_fwd"] + 1
    assert tk.LAUNCHES["flash_attention_fwd_fp32"] == \
        n["flash_attention_fwd_fp32"]
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_prefill(torch.bfloat16, o, lse, q, k, v, qp, kp, **kw)
    if B > 1 and S >= 4:
        assert float(o[1, :, :, :S // 4].abs().max()) == 0.0
        assert float(lse[1, :, :, :S // 4].max()) == float(
            torch.tensor(ref.NEG_INF, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
@pytest.mark.parametrize("G,causal", [(1, True), (3, True), (2, False)])
def test_prefill_bf16_masked_rows_in_unmasked_tiles(cuda, D, G, causal):
    """q rows at -1 among valid ones, with no kv slot at -1: the kernel
    skips the mask on tiles where every pair of a valid row is visible, so
    the -1 rows ride through them and must still come out 0 with lse
    -1e30."""
    gen = torch.Generator(device=cuda).manual_seed(D + G)
    B, S = 2, 400
    q, k, v, qp, kp = _prefill_case(gen, cuda, B, 2, G, S, S, D,
                                    torch.bfloat16)
    kp = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    qp = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    dead = [200, 201, 202, 390, 399]
    qp[1, dead] = -1
    kw = dict(causal=causal, window=0, softcap=0.0)
    o, lse = tk.flash_attention_fwd(q, k, v, qp, kp, **kw)
    _assert_prefill(torch.bfloat16, o, lse, q, k, v, qp, kp, **kw)
    assert float(o[1, :, :, dead].abs().max()) == 0.0
    assert float(lse[1, :, :, dead].max()) == float(
        torch.tensor(ref.NEG_INF, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
def test_prefill_bf16_model_layout_and_adapter(cuda, D):
    """Strided views as the model passes them ((B, S, H, D) projections
    transposed), and the flash_attention_bh adapter, on the bf16 route."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device=cuda).manual_seed(D)
    B, S, Hkv, G = 2, 130, 2, 3
    q = _randn(gen, (B, S, Hkv * G, D), torch.bfloat16, cuda)
    k, v = (_randn(gen, (B, S, Hkv, D), torch.bfloat16, cuda)
            for _ in range(2))
    out, lse = ops.flash_attention_gqa_fwd(q, k, v, causal=True)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    q5 = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    _assert_prefill(torch.bfloat16,
                    out.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4), lse,
                    q5, k.transpose(1, 2), v.transpose(1, 2), pos, pos)
    qb, kb, vb = (_randn(gen, (6, 200, D), torch.bfloat16, cuda)
                  for _ in range(3))
    n = dict(tk.LAUNCHES)
    o = tk.flash_attention_bh(qb, kb, vb, causal=True, window=64)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention_fwd_fp32"] == \
        n["flash_attention_fwd_fp32"]
    _assert_bf16_route(
        o, ref.attention_ref_bh(qb, kb, vb, causal=True, window=64),
        ref.attention_ref_bh(qb.float(), kb, vb.abs(), causal=True,
                             window=64))


@pytest.mark.cuda
def test_prefill_bf16_rejects_misaligned_views(cuda):
    """The bf16 route copies 16-byte chunks: a view one element off its row
    start, or rows 65 elements apart, raise ValueError; neither falls back
    to the fp32 route."""
    q = torch.zeros(1, 1, 1, 4, 65, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16, device=cuda)
    qp = torch.arange(4, dtype=torch.int32, device=cuda)[None]
    kp = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    n = dict(tk.LAUNCHES)
    for bad in (q[..., 1:], q[..., :64]):
        with pytest.raises(ValueError, match="aligned"):
            tk.flash_attention_fwd(bad, k, k, qp, kp)
    kbad = torch.zeros(1, 1, 8, 65, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tk.flash_attention_fwd(q[..., :64].contiguous(), kbad[..., 1:], k,
                               qp, kp)
    assert tk.LAUNCHES == n


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 10])
@pytest.mark.parametrize("window,cap,holes", [
    (0, 0.0, False), (48, 20.0, False), (0, 0.0, True)])
def test_prefill_fp32_route(cuda, D, G, window, cap, holes):
    """fp32 prefill on its tensor-core route (q, k, v and p as three exact
    bf16 parts, six pair products) through strided views of the model's
    (B, S, H, D) layout, ragged S and T: out and lse within 2e-5 of the
    plain version, the fp32 route counter +1; with holes, -1 q rows give
    out 0 and lse -1e30 and -1 kv slots are skipped."""
    gen = torch.Generator(device=cuda).manual_seed(D + G + window)
    B, Hkv, S, T = 2, 2, 77, 203
    q = _randn(gen, (B, S, Hkv * G, D), torch.float32, cuda)
    k, v = (_randn(gen, (B, T, Hkv, D), torch.float32, cuda)
            for _ in range(2))
    q5 = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
    qp = (torch.arange(S, dtype=torch.int32, device=cuda) + T - S).repeat(B, 1)
    kp = torch.arange(T, dtype=torch.int32, device=cuda).repeat(B, 1)
    if holes:
        qp[1, :S // 4] = -1
        kp[1, ::3] = -1
        kp[0, 64:140] = -1
    kw = dict(causal=True, window=window, softcap=cap)
    n = dict(tk.LAUNCHES)
    o, lse = tk.flash_attention_fwd(q5, k4, v4, qp, kp, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention_fwd_fp32"] == \
        n["flash_attention_fwd_fp32"] + 1
    assert tk.LAUNCHES["flash_attention_fwd"] == n["flash_attention_fwd"] + 1
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    _assert_prefill(torch.float32, o, lse, q5, k4, v4, qp, kp, **kw)
    if holes:
        assert float(o[1, :, :, :S // 4].abs().max()) == 0.0
        assert float(lse[1, :, :, :S // 4].max()) == float(
            torch.tensor(ref.NEG_INF, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
def test_prefill_fp32_route_is_deterministic(cuda, D):
    """A fixed order of sums and no atomics: two calls on the same inputs
    give the same bits, out and lse."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, qp, kp = _prefill_case(gen, cuda, 2, 2, 10, 300, 300, D,
                                    torch.float32)
    o1, l1 = tk.flash_attention_fwd(q, k, v, qp, kp, window=100)
    o2, l2 = tk.flash_attention_fwd(q, k, v, qp, kp, window=100)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.cuda
def test_prefill_fp32_rejects_misaligned_views(cuda):
    """The fp32 route copies 16-byte chunks too: a view one element off its
    row start, or rows 65 elements apart, raise ValueError and launch
    nothing, through the kernel's wrapper and the adapter."""
    q = torch.zeros(1, 1, 1, 4, 65, device=cuda)
    k = torch.zeros(1, 1, 8, 64, device=cuda)
    qp = torch.arange(4, dtype=torch.int32, device=cuda)[None]
    kp = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    n = dict(tk.LAUNCHES)
    for bad in (q[..., 1:], q[..., :64]):
        with pytest.raises(ValueError, match="aligned"):
            tk.flash_attention_fwd(bad, k, k, qp, kp)
    vbad = torch.zeros(1, 1, 8, 65, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tk.flash_attention_fwd(q[..., :64].contiguous(), k, vbad[..., 1:],
                               qp, kp)
    kb = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tk.flash_attention_bh(torch.zeros(2, 4, 65, device=cuda)[..., 1:],
                              kb, kb)
    assert tk.LAUNCHES == n


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
def test_fp32_prefill_tiles_state_the_kernels_layout(cuda, D):
    """FP32_PREFILL_TILES, which the CPU tests' plan and emulation take,
    are the rows and kv tile the CUDA source launches with, within the
    227 KB a block may use."""
    rows, bk, smem = tk.fp32_layout(D)
    assert (rows, bk) == tk.FP32_PREFILL_TILES[D]
    assert 0 < smem <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,D", [(1, 1, 64), (4, 1, 64), (4, 4, 128)])
def test_decode_kernel(cuda, dtype, S, G, D):
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, H, T = 8, 12, 576
    depths = [17, 100, 511, 575, 300, 572, 40, 250]
    q = _randn(gen, (B, H, G, S, D), dtype, cuda)
    k = _randn(gen, (B, H, T, D), dtype, cuda)
    v = _randn(gen, (B, H, T, D), dtype, cuda)
    qp = torch.stack([torch.arange(d, d + S, dtype=torch.int32)
                      for d in depths]).to(cuda)
    kp = torch.cat([ring_position_ids(1, d + S, T) for d in depths]).to(cuda)
    n = tk.LAUNCHES["flash_decode_fwd"]
    o = tk.flash_decode_fwd(q, k, v, qp, kp)
    again = tk.flash_decode_fwd(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_decode_fwd"] == n + 2
    assert torch.equal(o, again)                 # deterministic combine
    assert _err(o, ref.flash_decode_fwd_ref(q, k, v, qp, kp)) <= TOL[dtype]


def _ring(depths, S, T, dev):
    qp = torch.stack([torch.arange(d, d + S, dtype=torch.int32)
                      for d in depths]).to(dev)
    kp = torch.cat([ring_position_ids(1, d + S, T) for d in depths]).to(dev)
    return qp, kp


def _table(gen, kp, ps):
    """A permuted table over 1 + B * NP pages; slot 1 shares slot 0's first
    page; slot 0's pages that hold no position sit on the trash page 0."""
    B, T = kp.shape
    NP = T // ps
    table = (torch.randperm(B * NP, generator=gen, device=kp.device) + 1
             ).reshape(B, NP).to(torch.int32)
    table[1, 0] = table[0, 0]
    table[0][(kp[0].reshape(NP, ps) < 0).all(dim=-1)] = 0
    return table.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,D,ps,window,cap", [
    (1, 1, 64, 16, 0, 0.0), (4, 4, 128, 8, 100, 30.0), (2, 2, 64, 32, 0, 10.0),
    (1, 1, 128, 64, 0, 0.0), (1, 1, 80, 16, 0, 0.0), (4, 8, 112, 16, 0, 0.0),
    (2, 1, 80, 8, 100, 30.0)])
def test_layout_decode_kernels(cuda, dtype, S, G, D, ps, window, cap):
    """The quantized, paged and paged-quant decode kernels against their
    plain versions, and bitwise against the dense / quant kernels on the
    pages gathered through the table."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, H, T = 8, 12, 576
    depths = [17, 100, 511, 575, 300, 572, 40, 700]     # the last wraps
    qp, kp = _ring(depths, S, T, cuda)
    table = _table(gen, kp, ps)
    P = 1 + B * (T // ps)
    q = _randn(gen, (B, H, G, S, D), dtype, cuda)
    kw = dict(causal=True, window=window, softcap=cap)
    gather = ref.gather_pages
    kpool, vpool = (_randn(gen, (P, ps, H, D), dtype, cuda) for _ in range(2))
    n = dict(tk.LAUNCHES)
    o = tk.flash_decode_paged_fwd(q, kpool, vpool, table, qp, kp, **kw)
    assert _err(o, ref.flash_decode_paged_fwd_ref(q, kpool, vpool, table, qp,
                                                  kp, **kw)) <= TOL[dtype]
    assert torch.equal(o, tk.flash_decode_fwd(q, gather(kpool, table),
                                              gather(vpool, table), qp, kp,
                                              **kw))
    for mode in ("int8", "int4"):
        kq, vq = (kv_quantize(_randn(gen, (P, ps, H, D), torch.float32, cuda),
                              mode) for _ in range(2))
        pq = (kq.codes, kq.scale, vq.codes, vq.scale)
        o = tk.flash_decode_paged_quant_fwd(q, *pq, table, qp, kp, **kw)
        assert _err(o, ref.flash_decode_paged_quant_fwd_ref(
            q, *pq, table, qp, kp, **kw)) <= TOL[dtype]
        gq = tuple(gather(x, table) for x in pq)
        oq = tk.flash_decode_quant_fwd(q, *gq, qp, kp, **kw)
        assert torch.equal(o, oq)
        assert _err(oq, ref.flash_decode_quant_fwd_ref(q, *gq, qp, kp, **kw)
                    ) <= TOL[dtype]
    torch.cuda.synchronize()
    assert {k: tk.LAUNCHES[k] - n[k] for k in n} == {
        "flash_attention_fwd": 0, "flash_attention_fwd_fp32": 0,
        "flash_decode_fwd": 1,
        "flash_decode_quant_fwd": 2, "flash_decode_paged_fwd": 1,
        "flash_decode_paged_quant_fwd": 2, "flash_attention_bh": 0}


@pytest.mark.cuda
def test_paged_kernels_reject_other_page_sizes(cuda):
    q = torch.zeros(1, 1, 1, 1, 64, device=cuda)
    pool = torch.zeros(3, 4, 1, 64, device=cuda)
    table = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    qp = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="page size"):
        tk.flash_decode_paged_fwd(q, pool, pool, table, qp, kp)


@pytest.mark.cuda
def test_kernels_reject_other_head_dims(cuda):
    q = torch.zeros(1, 1, 1, 2, 32, device=cuda)
    k = torch.zeros(1, 1, 4, 32, device=cuda)
    qp = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    for fn in (tk.flash_attention_fwd, tk.flash_decode_fwd):
        with pytest.raises(ValueError, match="head_dim"):
            fn(q, k, k, qp, kp)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,page_size", [("off", 0), ("int4", 0),
                                                ("int8", 16)])
@pytest.mark.parametrize("arch", ["stablelm-3b", "kimi-k2-1t-a32b"])
def test_models_at_published_head_dims_serve_on_card(cuda, arch, kv_quant,
                                                     page_size):
    """stablelm-3b's head_dim 80 (2560 / 32) and kimi-k2's 112, their smoke
    configs at the published head_dim, fp32 compute: the card's prefill
    and greedy decode steps (the kernels: the fp32 prefill route once a
    layer, the layout's decode kernel once a layer a step) give the plain
    path's tokens on the CPU from the same weights."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_model
    full = get_config(arch)
    cfg = get_config(arch, smoke=True).replace(
        head_dim=full.resolved_head_dim, compute_dtype="float32")
    assert cfg.resolved_head_dim in (80, 112)
    kw = dict(smoke=True, seed=0, cfg=cfg, kv_quant=kv_quant,
              page_size=page_size)
    cpu = load_model(arch, device="cpu", **kw)
    card = load_model(arch, device=cuda, **kw)
    with torch.no_grad():
        for (n, pc), (_, pg) in zip(cpu.named_parameters(),
                                    card.named_parameters()):
            pg.copy_(pc)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    decode = {(0, "off"): "flash_decode_fwd",
              (0, "int4"): "flash_decode_quant_fwd",
              (16, "int8"): "flash_decode_paged_quant_fwd"}[
        (page_size, kv_quant)]
    out, steps = {}, 8
    for dev, m in (("cpu", cpu), ("cuda", card)):
        n = dict(tk.LAUNCHES)
        logits, cache = m.prefill(torch.from_numpy(toks).to(dev), max_len=48)
        got = []
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            got.append(tok.cpu().numpy())
            logits, cache = m.decode_step(cache, tok)
        out[dev] = np.concatenate(got, 1)
        if dev == "cuda":
            torch.cuda.synchronize()
            L = cfg.num_layers
            assert {k: tk.LAUNCHES[k] - n[k] for k in n} == {
                **dict.fromkeys(n, 0), "flash_attention_fwd": L,
                "flash_attention_fwd_fp32": L, decode: L * steps}
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


@pytest.mark.cuda
def test_kernels_refuse_an_unported_head_dim(cuda):
    """The attention kernels take D 64, 80, 112, 128 and 256: D 96 raises
    ValueError from every entry, prefill and the four decode layouts, with
    nothing launched and no fallback to the plain path."""
    D, n = 96, dict(tk.LAUNCHES)
    q = torch.zeros(1, 1, 1, 2, D, device=cuda)
    kv = torch.zeros(1, 1, 32, D, device=cuda)
    qp = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 32, dtype=torch.int32, device=cuda)
    codes = torch.zeros(1, 1, 32, D // 2, dtype=torch.int8, device=cuda)
    scale = torch.ones(1, 1, 32, device=cuda)
    pool = torch.zeros(3, 16, 1, D, device=cuda)
    pcodes = torch.zeros(3, 16, 1, D, dtype=torch.int8, device=cuda)
    pscale = torch.ones(3, 16, 1, device=cuda)
    table = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    for call in (lambda: tk.flash_attention_fwd(q, kv, kv, qp, kp),
                 lambda: tk.flash_attention_fwd(q.bfloat16(), kv.bfloat16(),
                                                kv.bfloat16(), qp, kp),
                 lambda: tk.flash_decode_fwd(q, kv, kv, qp, kp),
                 lambda: tk.flash_decode_quant_fwd(q, codes, scale, codes,
                                                   scale, qp, kp),
                 lambda: tk.flash_decode_paged_fwd(q, pool, pool, table, qp,
                                                   kp),
                 lambda: tk.flash_decode_paged_quant_fwd(
                     q, pcodes, pscale, pcodes, pscale, table, qp, kp)):
        with pytest.raises(ValueError, match="head_dim 96"):
            call()
    assert tk.LAUNCHES == n


# ---------------------------------------------------------------------------
# head_dim 256 with MQA (recurrentgemma's local attention)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(3072, 2048), (77, 0)])
def test_prefill_kernel_d256_mqa_window(cuda, dtype, S, window):
    """One kv head, G = 10 q heads, D 256: a long prompt that the local
    window cuts, and a short ragged one."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (1, 1, 10, S, 256), dtype, cuda)
    k = _randn(gen, (1, 1, S, 256), dtype, cuda)
    v = _randn(gen, (1, 1, S, 256), dtype, cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None]
    kw = dict(causal=True, window=window, softcap=0.0)
    o, lse = tk.flash_attention_fwd(q, k, v, pos, pos, **kw)
    _assert_prefill(dtype, o, lse, q, k, v, pos, pos, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2])
def test_decode_kernel_d256_mqa_wrapped_ring(cuda, dtype, S):
    """A ring of 2048 slots under a window of 2048, slots at depths short of
    it, at it and past it (wrapped), G = 10 q heads on one kv head."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, T = 4, 2048
    q = _randn(gen, (B, 1, 10, S, 256), dtype, cuda)
    k = _randn(gen, (B, 1, T, 256), dtype, cuda)
    v = _randn(gen, (B, 1, T, 256), dtype, cuda)
    qp, kp = _ring([100, 2047, 2100, 5000], S, T, cuda)
    kw = dict(causal=True, window=2048)
    o = tk.flash_decode_fwd(q, k, v, qp, kp, **kw)
    assert _err(o, ref.flash_decode_fwd_ref(q, k, v, qp, kp, **kw)
                ) <= TOL[dtype]


@pytest.mark.cuda
def test_layout_kernels_reject_head_dim_256(cuda):
    """The layout kernels take head_dim 256, 80 and 112 now
    (test_decode_streaming_*); they still refuse a head_dim outside 64 / 80
    / 112 / 128 / 256, here 96."""
    q = torch.zeros(1, 1, 1, 1, 96, device=cuda)
    codes = torch.zeros(1, 1, 64, 96, dtype=torch.int8, device=cuda)
    scale = torch.ones(1, 1, 64, device=cuda)
    qp = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tk.flash_decode_quant_fwd(q, codes, scale, codes, scale, qp, kp)
    pool = torch.zeros(3, 16, 1, 96, device=cuda)
    table = torch.ones(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tk.flash_decode_paged_fwd(q, pool, pool, table, qp, kp)


# ---------------------------------------------------------------------------
# the streaming decode kernel (csrc/flash_decode.cu) at every instantiation:
# q dtype x head_dim x K/V source (values, int8, int4; contiguous, paged) x
# q rows a block (1, 2, 4)
# ---------------------------------------------------------------------------
_DECODE_CASES = [
    # G, S, pages, page size, window, softcap, T not a whole number of pages
    (1, 1, 36, 16, 0, 0.0, 577),      # R 1: pimref's step
    (2, 1, 20, 32, 0, 10.0, 577),     # R 2
    (1, 4, 40, 8, 100, 30.0, 300),    # R 4
    (10, 1, 9, 64, 0, 0.0, 577),      # R 10: Griffin's heads, three groups
    (4, 4, 10, 32, 48, 20.0, 300),    # R 16
    (10, 4, 2, 8, 0, 0.0, 13),        # R 40, ten groups; one split
]


def _decode_sources(gen, dev, dtype, lead, D):
    """K/V of every source over rows ``lead``: values of ``dtype``, and
    int8 and int4 codes with their scales."""
    out = {"values": tuple(_randn(gen, lead + (D,), dtype, dev)
                           for _ in range(2))}
    for mode in ("int8", "int4"):
        kq, vq = (kv_quantize(_randn(gen, lead + (D,), torch.float32, dev),
                              mode) for _ in range(2))
        out[mode] = (kq.codes, kq.scale, vq.codes, vq.scale)
    return out


def _decode_call(src, q, ops, qp, kp, table=None, **kw):
    """(kernel out, plain out) of one source, contiguous or through the
    table."""
    if table is None:
        if src == "values":
            return (tk.flash_decode_fwd(q, *ops, qp, kp, **kw),
                    ref.flash_decode_fwd_ref(q, *ops, qp, kp, **kw))
        return (tk.flash_decode_quant_fwd(q, *ops, qp, kp, **kw),
                ref.flash_decode_quant_fwd_ref(q, *ops, qp, kp, **kw))
    if src == "values":
        return (tk.flash_decode_paged_fwd(q, *ops, table, qp, kp, **kw),
                ref.flash_decode_paged_fwd_ref(q, *ops, table, qp, kp, **kw))
    return (tk.flash_decode_paged_quant_fwd(q, *ops, table, qp, kp, **kw),
            ref.flash_decode_paged_quant_fwd_ref(q, *ops, table, qp, kp,
                                                 **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
@pytest.mark.parametrize("G,S,NP,ps,window,cap,T_odd", _DECODE_CASES)
def test_decode_streaming_kernel(cuda, dtype, D, G, S, NP, ps, window, cap,
                                 T_odd):
    """Every source against its plain version (fp32 2e-5, bf16 2e-2);
    paged == dense and paged-quant == quant on the gathered pages bit for
    bit; a T that is no whole number of pages or ring stages; slot 0 with
    every kv row at -1 gives 0; two calls are equal."""
    gen = torch.Generator(device=cuda).manual_seed(D + 10 * G + S)
    B, H = 4, 2
    T = NP * ps
    kw = dict(causal=True, window=window, softcap=cap)
    q = _randn(gen, (B, H, G, S, D), dtype, cuda)
    gather = ref.gather_pages
    for T_kv in (T, T_odd):
        qp, kp = _ring([5, 17, T_kv - 1, T_kv + 50], S, T_kv, cuda)
        kp[0] = -1                                # slot 0: nothing cached
        paged = T_kv == T
        lead = (1 + B * NP, ps, H) if paged else (B, H, T_kv)
        table = _table(gen, kp, ps) if paged else None
        for src, ops in _decode_sources(gen, cuda, dtype, lead, D).items():
            o, want = _decode_call(src, q, ops, qp, kp, table, **kw)
            assert o.dtype == dtype and o.shape == q.shape
            assert _err(o, want) <= TOL[dtype], (src, paged)
            assert float(o[0].abs().max()) == 0.0
            assert torch.equal(o, _decode_call(src, q, ops, qp, kp, table,
                                               **kw)[0])
            if paged:
                dense = tuple(gather(x, table) for x in ops)
                assert torch.equal(o, _decode_call(src, q, dense, qp, kp,
                                                   **kw)[0]), src
    if T <= tk.DECODE_SPLIT_MULTIPLE:             # the kernel writes out itself
        assert tk.decode_plan(B, H, G * S, T).n_split == 1
        assert tk.decode_plan(B, H, G * S, T_odd).n_split == 1


@pytest.mark.cuda
def test_decode_kernel_rejects_misaligned_rows(cuda):
    """The decode kernel copies 16-byte chunks of K/V rows: a view one
    element off its row start raises ValueError, as does a row stride that
    is no multiple of 16 bytes."""
    q = torch.zeros(1, 1, 1, 1, 64, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 1, 8, 65, dtype=torch.bfloat16, device=cuda)
    qp = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    n = dict(tk.LAUNCHES)
    for bad in (k[..., 1:], k[..., :64]):
        with pytest.raises(ValueError, match="aligned"):
            tk.flash_decode_fwd(q, bad, bad, qp, kp)
    assert tk.LAUNCHES == n


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(8, 512, 2560), (1, 1, 64), (2, 3, 100),
                                   (1, 1000, 100), (3, 17, 2560),
                                   (2, 2100, 2560), (1, 2100, 99),
                                   (3, 5, 2500), (1, 33, 4)])
def test_rglru_kernel(cuda, B, T, D):
    """Against the plain sequential loop on the card: the kernel repeats its
    rounded multiply and add in the same order, so the results are equal
    bit for bit, and two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = 0.7 + 0.299 * torch.rand((B, T, D), generator=gen, device=cuda)
    b = 0.1 * torch.randn((B, T, D), generator=gen, device=cuda)
    n = rk.LAUNCHES["rglru_scan"]
    h = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rglru_scan"] == n + 1
    assert h.dtype == torch.float32 and h.shape == (B, T, D)
    assert torch.equal(h, rglru_scan_ref(a, b)), _err(h, rglru_scan_ref(a, b))
    assert torch.equal(rglru_scan(a, b), h)


@pytest.mark.cuda
def test_rglru_kernel_unaligned_views(cuda):
    """Inputs that start off a 16-byte boundary take the 4-byte copy path,
    bit for bit equal to the loop."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    flat_a = 0.7 + 0.299 * torch.rand(2 * 300 * 64 + 1, generator=gen,
                                      device=cuda)
    flat_b = 0.1 * torch.randn(2 * 300 * 64 + 1, generator=gen, device=cuda)
    a, b = flat_a[1:].view(2, 300, 64), flat_b[1:].view(2, 300, 64)
    assert rk.plan(2, 300, 64, aligned=False).vec == 4
    assert torch.equal(rglru_scan(a, b), rglru_scan_ref(a, b))


@pytest.mark.cuda
def test_rglru_plan_states_the_kernels_layout(cuda):
    """The tile, rows, stages and shared memory that the CPU tests check in
    ``plan`` are the ones the CUDA source launches with."""
    p = rk.plan(8, 512, 2560)
    assert rk.layout() == (p.tile, p.rows, p.stages, p.smem)


@pytest.mark.cuda
def test_rglru_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.rand(2, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rk.rglru_scan_kernel(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rk.rglru_scan_kernel(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="card"):
        rk.rglru_scan_kernel(a.cpu(), a)


# ---------------------------------------------------------------------------
# the Proteus kernels: narrow-value widths, int4 packing, quantized matmul,
# and the (BH, S, D) attention adapter
# ---------------------------------------------------------------------------
def _edge_blocks(block, dev):
    """One edge value per block (0, +-1, +-(2^k - 1), +-2^k, +-(2^k + 1)
    for k <= 30, INT32_MAX, INT32_MIN) among zeros."""
    mags = {0, 1} | {v for k in range(31) for v in (2 ** k - 1, 2 ** k,
                                                    2 ** k + 1)}
    vals = sorted(mags | {-m for m in mags} | {2 ** 31 - 1, -2 ** 31})
    x = torch.zeros(len(vals), block, dtype=torch.int64)
    x[:, block // 3] = torch.tensor(vals, dtype=torch.int64)
    return x.reshape(-1).to(torch.int32).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [256, 128, 100])
def test_required_bits_kernel(cuda, block):
    gen = torch.Generator(device=cuda).manual_seed(5)
    n_blocks = 4099
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_blocks, block),
                      generator=gen, device=cuda, dtype=torch.int32)
    shift = torch.randint(0, 32, (n_blocks, 1), generator=gen, device=cuda,
                          dtype=torch.int32)
    x = (x >> shift).reshape(-1)
    n = nv.LAUNCHES["required_bits"]
    for t in (x, _edge_blocks(block, cuda)):
        got = nv.required_bits(t, block)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32
        assert torch.equal(got, nv.required_bits_ref(t, block))
    # a base that is not 16-byte aligned takes the 4-byte loads
    big = torch.cat([x.new_zeros(1), x])
    assert torch.equal(nv.required_bits(big[1:], block),
                       nv.required_bits_ref(x, block))
    assert nv.LAUNCHES["required_bits"] == n + 3


@pytest.mark.cuda
def test_required_bits_kernel_every_int32_magnitude(cuda):
    """Blocks of one element holding every fp32 value an int32 magnitude can
    take: the kernel equals the plain version (and so the reference)."""
    parts = [torch.arange(0, 1 << 24, dtype=torch.int64, device=cuda)]
    for k in range(24, 31):
        parts.append(torch.arange(1 << k, 1 << (k + 1), 1 << (k - 23),
                                  dtype=torch.int64, device=cuda))
    m = torch.cat(parts)
    x = torch.cat([m.to(torch.int32), torch.tensor(
        [-2 ** 31], dtype=torch.int32, device=cuda)])
    got = nv.required_bits(x, 1)
    assert torch.equal(got, nv.required_bits_ref(x, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1 << 20, 6, 100, 4096 + 512])
def test_int4_pack_unpack_kernels(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    v = torch.randint(-128, 128, (n + 1,), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    for codes in (v[:n], v[1:]):                  # aligned, then not
        before = dict(nv.LAUNCHES)
        p = nv.pack_int4(codes)
        assert torch.equal(p, nv.pack_int4_ref(codes))
        u = nv.unpack_int4(p)
        assert torch.equal(u, nv.unpack_int4_ref(p))
        assert torch.equal(nv.unpack_int4(nv.pack_int4(
            ((codes.int() + 8) % 16 - 8).to(torch.int8))),
            ((codes.int() + 8) % 16 - 8).to(torch.int8))
        torch.cuda.synchronize()
        assert nv.LAUNCHES["pack_int4"] == before["pack_int4"] + 2
        assert nv.LAUNCHES["unpack_int4"] == before["unpack_int4"] + 2


@pytest.mark.cuda
def test_narrow_value_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        nv.required_bits(torch.zeros(512, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        nv.pack_int4(torch.zeros(1000, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError):
        nv.unpack_int4(torch.zeros(300, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        nv.pack_int4(torch.zeros(1024, dtype=torch.int8, device=cuda)[::2])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,block_k", [(128, 128, 128, 128),
                                           (256, 512, 128, 128),
                                           (128, 384, 256, 128),
                                           (8, 2560, 7680, 128),
                                           (64, 768, 3072, 64),
                                           (100, 96, 40, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernel(cuda, M, K, N, block_k, dtype, bits):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = _randn(gen, (M, K), dtype, cuda)
    w = _randn(gen, (K, N), torch.float32, cuda)
    codes, scales = qm.quantize_weights(w, block_k=block_k, bits=bits)
    n = qm.LAUNCHES["quant_matmul"]
    got = qm.quant_matmul(x, codes, scales, block_m=min(128, M),
                          block_n=min(128, N), block_k=block_k)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["quant_matmul"] == n + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = qm.quant_matmul_ref(x, codes, scales)
    assert torch.allclose(got, want, atol=1e-3, rtol=1e-4), _err(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 63, 64, 127, 128, 4096])
@pytest.mark.parametrize("K,N,block_k", [(384, 256, 128), (100, 40, 100),
                                         (96, 100, 96), (97, 40, 97),
                                         (96, 128, 96), (192, 256, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernel_routes(cuda, M, K, N, block_k, dtype, bits):
    """Both routes (narrow up to M 64, wide above), k-blocks that are not a
    multiple of 16, rows whose byte stride is not a multiple of 16 (N 40 and
    100 codes, K 97 fp32 and 97 / 100 bf16), aligned rows with k-blocks
    that are not a multiple of 64 (the narrow route's plain copies where
    TMA cannot go): within the reference test's atol / rtol of the plain
    version, and bitwise repeatable."""
    gen = torch.Generator(device=cuda).manual_seed(M * 7 + K + N)
    x = _randn(gen, (M, K), dtype, cuda)
    w = _randn(gen, (K, N), torch.float32, cuda)
    codes, scales = qm.quantize_weights(w, block_k=block_k, bits=bits)
    kw = dict(block_m=min(128, M), block_n=min(128, N), block_k=block_k)
    n = qm.LAUNCHES["quant_matmul"]
    got = qm.quant_matmul(x, codes, scales, **kw)
    again = qm.quant_matmul(x, codes, scales, **kw)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["quant_matmul"] == n + 2
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = qm.quant_matmul_ref(x, codes, scales)
    assert torch.allclose(got, want, atol=1e-3, rtol=1e-4), _err(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_quant_matmul_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(128, 128, device=cuda)
    codes = torch.zeros(128, 128, dtype=torch.int8, device=cuda)
    scales = torch.ones(1, 128, device=cuda)
    with pytest.raises(TypeError):
        qm.quant_matmul_kernel(x.double(), codes, scales)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul_kernel(x.t(), codes, scales)
    with pytest.raises(ValueError, match="on the card"):
        qm.quant_matmul_kernel(x, codes.cpu(), scales)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 32, 33, 64, 65, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_plan_states_the_kernels_layout(cuda, M, dtype):
    """The padded rows, ring stages and shared memory that the CPU tests
    check in ``plan`` are the ones the CUDA source launches with."""
    p = qk.plan(M, 256, 256, 128, dtype)
    assert qk.layout(M, dtype) == (p.mp, p.stages, p.smem)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(512, 0), (500, 128), (77, 0)])
def test_flash_attention_bh(cuda, dtype, S, window):
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (_randn(gen, (24, S, 64), dtype, cuda) for _ in range(3))
    n = dict(tk.LAUNCHES)
    o = tk.flash_attention_bh(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert tk.LAUNCHES["flash_attention_bh"] == n["flash_attention_bh"] + 1
    assert tk.LAUNCHES["flash_attention_fwd"] == n["flash_attention_fwd"] + 1
    want = ref.attention_ref_bh(q, k, v, causal=True, window=window)
    if dtype == torch.bfloat16:
        _assert_bf16_route(o, want, ref.attention_ref_bh(
            q.float(), k, v.abs(), causal=True, window=window))
    else:
        assert _err(o, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# training: the prefill kernel under autograd, one guarded step
# ---------------------------------------------------------------------------
# gradients of the kernel forward + plain backward against the all-plain
# forward and backward, relative to the largest |gradient|: fp32 carries the
# forward's summation-order difference (TOL) through the backward's delta;
# bf16 one rounding of out (2^-8) and of each gradient
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,cap,cq,ck", [
    (2, 1536, 4, 4, 64, 0, 0.0, 512, 1024),      # T padded, kv_len masked
    (1, 700, 8, 2, 128, 256, 20.0, 256, 256),    # GQA, window, softcap
])
def test_flash_attention_train_on_card(cuda, dtype, B, S, Hq, Hkv, D, window,
                                       cap, cq, ck):
    from repro_torch.kernels.flash_attention.autograd import (
        flash_attention_train)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (B, S, Hq, D), dtype, cuda)
    k, v = (_randn(gen, (B, S, Hkv, D), dtype, cuda) for _ in range(2))
    do = _randn(gen, (B, S, Hq, D), dtype, cuda)
    kw = dict(causal=True, window=window, softcap=cap, chunk_q=cq,
              chunk_kv=ck)

    def run(*xs):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        out = flash_attention_train(*xs, **kw)
        return (out.detach(),) + torch.autograd.grad(out, xs, do.to(
            xs[0].device))

    before = tk.LAUNCHES["flash_attention_fwd"]
    got = run(q, k, v)
    assert tk.LAUNCHES["flash_attention_fwd"] == before + 1
    want = run(q.cpu(), k.cpu(), v.cpu())
    assert _err(got[0], want[0].to(cuda)) <= TOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        w = w.to(cuda)
        assert _err(g, w) <= GRAD_TOL[dtype] * w.float().abs().max().item()
    again = run(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal,window,cq,ck", [
    (1, 700, 700, 10, 1, 256, True, 256, 256, 256),   # Griffin: MQA, window
    (1, 512, 512, 32, 8, 128, True, 0, 512, 1024),    # mixtral / pixtral
    (2, 300, 300, 16, 16, 64, False, 0, 512, 1024),   # the encoder
    (2, 300, 450, 16, 16, 64, False, 0, 128, 128),    # cross: T padded
])
def test_flash_attention_train_family_modes_on_card(cuda, dtype, B, S, T,
                                                    Hq, Hkv, D, causal,
                                                    window, cq, ck):
    """The Function in the modes the non-dense families train: the kernel
    forward and plain backward on the card against the all-plain pair on
    the CPU, one launch a call, two calls bitwise equal."""
    from repro_torch.kernels.flash_attention.autograd import (
        flash_attention_train)
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, (B, S, Hq, D), dtype, cuda)
    k, v = (_randn(gen, (B, T, Hkv, D), dtype, cuda) for _ in range(2))
    do = _randn(gen, (B, S, Hq, D), dtype, cuda)
    kw = dict(causal=causal, window=window, chunk_q=cq, chunk_kv=ck)

    def run(*xs):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        out = flash_attention_train(*xs, **kw)
        return (out.detach(),) + torch.autograd.grad(out, xs, do.to(
            xs[0].device))

    before = tk.LAUNCHES["flash_attention_fwd"]
    got = run(q, k, v)
    assert tk.LAUNCHES["flash_attention_fwd"] == before + 1
    want = run(q.cpu(), k.cpu(), v.cpu())
    assert _err(got[0], want[0].to(cuda)) <= TOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        w = w.to(cuda)
        assert _err(g, w) <= GRAD_TOL[dtype] * w.float().abs().max().item()
    again = run(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(1, 4096, 2560), (2, 37, 100), (1, 1, 64),
                                   (3, 513, 2560)])
def test_rglru_backward_on_card_bitwise(cuda, B, T, D):
    """The recurrence under autograd on the card: the forward and the
    backward each launch the kernel once (the backward over the reversed
    sequences, counted under ``rglru_scan_bwd`` as well), and da, db equal ``rglru_scan_bwd_ref`` bit for bit; two
    calls give the same bits."""
    from repro_torch.kernels.rglru import RglruScanFn, rglru_scan_bwd_ref
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = 0.7 + 0.299 * torch.rand((B, T, D), generator=gen, device=cuda)
    b = 0.1 * torch.randn((B, T, D), generator=gen, device=cuda)
    dh = torch.randn((B, T, D), generator=gen, device=cuda)

    def run():
        xa, xb = (x.clone().requires_grad_(True) for x in (a, b))
        h = RglruScanFn.apply(xa, xb)
        return (h.detach(),) + torch.autograd.grad(h, (xa, xb), dh)

    n, n_bwd = rk.LAUNCHES["rglru_scan"], rk.LAUNCHES["rglru_scan_bwd"]
    h, da, db = run()
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rglru_scan"] == n + 2
    assert rk.LAUNCHES["rglru_scan_bwd"] == n_bwd + 1
    wa, wb = rglru_scan_bwd_ref(a, h, dh)
    assert torch.equal(da, wa) and torch.equal(db, wb), (_err(da, wa),
                                                         _err(db, wb))
    assert all(torch.equal(x, y) for x, y in zip(run(), (h, da, db)))


@pytest.mark.cuda
def test_guarded_train_step_card_vs_cpu(cuda):
    """One guarded AdamW step of a two-layer model (head_dim 64, fp32
    compute) on the card and on the CPU from the same weights and batch:
    loss, gradient norm and weights agree; the card ran the prefill
    kernel's fp32 route twice per layer (forward, recompute)."""
    import numpy as np

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import initial_params
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaves

    cfg = get_config("pimref-100m", smoke=True).replace(
        d_model=128, num_heads=2, num_kv_heads=2, compute_dtype="float32")
    run = RunConfig(total_steps=4, warmup_steps=1, microbatches=1)
    batch = make_batch_fn(cfg, ShapeConfig("t", 192, 2, "train"), seed=0)(0)
    out = {}
    for dev in ("cpu", cuda):
        opt = make_optimizer("adamw", run)
        p = initial_params(cfg, 0, dev)
        step = make_train_step(TransformerLM(cfg, dev), opt, run, guard=True)
        tk.LAUNCHES["flash_attention_fwd_fp32"] = 0
        out[str(dev)] = step(p, opt.init(p), {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tk.LAUNCHES["flash_attention_fwd_fp32"] == \
                2 * cfg.num_layers
    (pc, oc, mc), (pg, og, mg) = out["cpu"], out["cuda"]
    assert not bool(mg["skipped"])
    np.testing.assert_allclose(mg["loss"].item(), mc["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(mg["grad_norm"].item(), mc["grad_norm"].item(),
                               rtol=1e-4)
    # every element within 1e-4 of its leaf's largest |value|; a weight
    # also by up to lr where its gradient is below the fp32 noise, but at
    # most 1 in 1000 elements past 1e-4 (a step that left the weights
    # unchanged differs by about lr in nearly every element)
    for got, want, slack in ((pg, pc, run.learning_rate), (og, oc, 0.0)):
        for a, b in zip(leaves(got), leaves(want)):
            if b.dtype == torch.int32:
                assert torch.equal(a.cpu(), b)
                continue
            d = (a.cpu() - b).abs()
            tight = 1e-4 * b.abs().max().item()
            assert d.max().item() <= tight + slack
            assert (d > tight).float().mean().item() <= 1e-3


# ---------------------------------------------------------------------------
# causal=False, as the encoder-decoder calls the kernels: the encoder's
# self-attention and the decoder's cross-attention (prefill, every kv tile
# live, S and T apart), and the cross cache's decode
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,T,D", [
    (1, 512, 512, 64), (1, 500, 512, 64), (1, 512, 333, 64),
    (2, 77, 203, 128), (1, 1, 64, 64), (4, 130, 70, 256)])
def test_prefill_noncausal(cuda, dtype, G, S, T, D):
    """The prefill kernel without the causal mask, S = T and S != T (a
    partial last kv tile; q tiles past the kv length), with and without -1
    rows and slots: out and lse against the plain version at the route's
    limits."""
    gen = torch.Generator(device=cuda).manual_seed(S + T + D)
    kw = dict(causal=False, window=0, softcap=0.0)
    for holes in (False, True):
        q, k, v, qp, kp = _prefill_case(gen, cuda, 2, 2, G, S, T, D, dtype,
                                        shift=0)
        if not holes:
            qp = torch.arange(S, dtype=torch.int32, device=cuda).repeat(2, 1)
            kp = torch.arange(T, dtype=torch.int32, device=cuda).repeat(2, 1)
        n = tk.LAUNCHES["flash_attention_fwd"]
        o, lse = tk.flash_attention_fwd(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["flash_attention_fwd"] == n + 1
        _assert_prefill(dtype, o, lse, q, k, v, qp, kp, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,T,ps", [(1, 64, 512, 16), (2, 128, 203, 8),
                                      (1, 256, 96, 32)])
def test_decode_kernels_noncausal(cuda, dtype, G, D, T, ps):
    """Every decode layout with causal=False, one q row a slot at q
    position 0 (the cross-attention's call) over every source row, and
    over slots partly empty: values, int8 / int4 codes, pages and pages of
    codes against their plain versions, and the paged kernels bitwise
    equal to the dense ones on the gathered pages."""
    gen = torch.Generator(device=cuda).manual_seed(G + D + T)
    B, H = 4, 4
    Tp = -(-T // ps) * ps
    q = _randn(gen, (B, H, G, 1, D), dtype, cuda)
    qp = torch.zeros((B, 1), dtype=torch.int32, device=cuda)
    kp = torch.arange(Tp, dtype=torch.int32, device=cuda).repeat(B, 1)
    kp[:, T:] = -1                       # the source ends inside a page
    kp[2, 5:] = -1                       # a short source
    kw = dict(causal=False, window=0, softcap=0.0)
    k, v = (_randn(gen, (B, H, Tp, D), dtype, cuda) for _ in range(2))
    o = tk.flash_decode_fwd(q, k, v, qp, kp, **kw)
    assert _err(o, ref.flash_decode_fwd_ref(q, k, v, qp, kp, **kw)) \
        <= TOL[dtype]
    table = _table(gen, kp, ps)
    P = 1 + B * (Tp // ps)
    gather = ref.gather_pages
    kpool, vpool = (_randn(gen, (P, ps, H, D), dtype, cuda) for _ in range(2))
    o = tk.flash_decode_paged_fwd(q, kpool, vpool, table, qp, kp, **kw)
    assert _err(o, ref.flash_decode_paged_fwd_ref(q, kpool, vpool, table, qp,
                                                  kp, **kw)) <= TOL[dtype]
    assert torch.equal(o, tk.flash_decode_fwd(q, gather(kpool, table),
                                              gather(vpool, table), qp, kp,
                                              **kw))
    for mode in ("int8", "int4"):
        kq, vq = (kv_quantize(_randn(gen, (B, H, Tp, D), torch.float32,
                                     cuda), mode) for _ in range(2))
        dq = (kq.codes, kq.scale, vq.codes, vq.scale)
        o = tk.flash_decode_quant_fwd(q, *dq, qp, kp, **kw)
        assert _err(o, ref.flash_decode_quant_fwd_ref(q, *dq, qp, kp, **kw)) \
            <= TOL[dtype]
        kq, vq = (kv_quantize(_randn(gen, (P, ps, H, D), torch.float32,
                                     cuda), mode) for _ in range(2))
        pq = (kq.codes, kq.scale, vq.codes, vq.scale)
        o = tk.flash_decode_paged_quant_fwd(q, *pq, table, qp, kp, **kw)
        assert _err(o, ref.flash_decode_paged_quant_fwd_ref(
            q, *pq, table, qp, kp, **kw)) <= TOL[dtype]
        gq = tuple(gather(x, table) for x in pq)
        assert torch.equal(o, tk.flash_decode_quant_fwd(q, *gq, qp, kp,
                                                        **kw))


@pytest.mark.cuda
def test_step_counts_card_equal_meta(cuda):
    """DAMOV's step counter (core/damov.py) over a pimref prefill, decode
    step and AdamW train step at full width and 2 layers: the card's counts
    (FLOPs, bytes, op counts, kernel reports) equal the meta device's, and
    the kernel reports equal the launch counters' delta (less the counters
    that count launches already counted under another name)."""
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.core.damov import count_step
    from repro_torch.kernels import SUBCOUNTS, launch_counters
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, param_specs, reference_tree
    from repro_torch.models.model import model_class, training_model
    from repro_torch.optim import make_optimizer

    cfg = get_config("pimref-100m").replace(num_layers=2)
    B, S, G = 2, 64, 8

    def batch(mode, dev):
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                for k, s in input_specs(cfg, ShapeConfig(
                    "s", S, B, mode)).items()}

    def counts(dev):
        m = build_model(cfg, dev)
        toks = batch("prefill", dev)["tokens"]
        (_, cache), pre = count_step(m.prefill, toks, S + G)
        _, dec = count_step(m.decode_step, cache, toks[:, :1])
        params = reference_tree(
            {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
             for n, s in param_specs(cfg).items()}, model_class(cfg).LISTS)
        opt = make_optimizer(cfg.optimizer, RunConfig())
        step = make_train_step(training_model(cfg), opt, RunConfig())
        _, tr = count_step(step, params, opt.init(params), batch("train", dev))
        return pre, dec, tr

    before = {k: v for c in launch_counters() for k, v in c.items()}
    card = counts("cuda")
    torch.cuda.synchronize()
    after = {k: v for c in launch_counters() for k, v in c.items()}
    meta = counts("meta")
    for c, m in zip(card, meta):
        assert dataclasses.asdict(c) == dataclasses.asdict(m)
    reports = {}
    for c in card:
        for k, v in c.kernels.items():
            reports[k] = reports.get(k, 0) + v
    delta = {k: after[k] - before[k] for k in after
             if after[k] != before[k] and k not in SUBCOUNTS}
    assert reports == delta == {"flash_attention_fwd": 2 + 4,
                                "flash_decode_fwd": 2}
    # outside a counter a kernel entry refuses meta tensors
    q = torch.zeros((1, 1, 1, 4, 64), device="meta")
    k = torch.zeros((1, 1, 4, 64), device="meta")
    p = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.flash_attention_fwd(q, k, k, p, p)


@pytest.mark.cuda
def test_quantizer_scales_card_equal_cpu(cuda):
    """The block scales ``maxabs / qmax`` of ``proteus.quantize`` and
    ``kv_quantize`` and their codes, card == CPU bitwise: the division is
    the correctly rounded one on both (``kernels.common.div_by``; CUDA's
    division by a Python number multiplies by the rounded reciprocal)."""
    from repro_torch.core import proteus
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((1 << 20,), generator=gen)
    for bits in (8, 4):
        a, b = proteus.quantize(x.to(cuda), bits), proteus.quantize(x, bits)
        assert torch.equal(a.scale.cpu(), b.scale)
        assert torch.equal(a.values.cpu(), b.values)
    kv = x.reshape(64, 256, 1, 64)
    for mode in ("int8", "int4"):
        a, b = kv_quantize(kv.to(cuda), mode), kv_quantize(kv, mode)
        assert torch.equal(a.scale.cpu(), b.scale)
        assert torch.equal(a.codes.cpu(), b.codes)
