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
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_ref  # noqa: E402
from repro_torch.models.layers import (kv_quantize,  # noqa: E402
                                       ring_position_ids)

# fp32: summation order only; bf16: one rounding of the output
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
    ro, rl = ref.flash_attention_fwd_ref(q, k, v, qp, kp, **kw)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _err(o, ro) <= TOL[dtype]
    assert _err(lse, rl) <= TOL[dtype]


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
    (1, 1, 128, 64, 0, 0.0)])
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
        "flash_attention_fwd": 0, "flash_decode_fwd": 1,
        "flash_decode_quant_fwd": 2, "flash_decode_paged_fwd": 1,
        "flash_decode_paged_quant_fwd": 2}


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
    ro, rl = ref.flash_attention_fwd_ref(q, k, v, pos, pos, **kw)
    assert _err(o, ro) <= TOL[dtype]
    assert _err(lse, rl) <= TOL[dtype]


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
    """Codes and pages stay at head_dim 64 / 128."""
    q = torch.zeros(1, 1, 1, 1, 256, device=cuda)
    codes = torch.zeros(1, 1, 64, 256, dtype=torch.int8, device=cuda)
    scale = torch.ones(1, 1, 64, device=cuda)
    qp = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tk.flash_decode_quant_fwd(q, codes, scale, codes, scale, qp, kp)


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(8, 512, 2560), (1, 1, 64), (2, 3, 100),
                                   (1, 1000, 100), (3, 17, 2560)])
def test_rglru_kernel(cuda, B, T, D):
    """Against the plain sequential loop on the card: the kernel repeats its
    rounded multiply and add in the same order, so the results agree to
    within 1e-6 (0 is expected) with |h| below ~3."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = 0.7 + 0.299 * torch.rand((B, T, D), generator=gen, device=cuda)
    b = 0.1 * torch.randn((B, T, D), generator=gen, device=cuda)
    n = rk.LAUNCHES["rglru_scan"]
    h = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rglru_scan"] == n + 1
    assert h.dtype == torch.float32 and h.shape == (B, T, D)
    assert _err(h, rglru_scan_ref(a, b)) <= 1e-6


@pytest.mark.cuda
def test_rglru_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.rand(2, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rk.rglru_scan_kernel(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rk.rglru_scan_kernel(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="card"):
        rk.rglru_scan_kernel(a.cpu(), a)
