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
