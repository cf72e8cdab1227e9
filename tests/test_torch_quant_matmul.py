"""The port's block-scaled int8 matmul (repro_torch.kernels.quant_matmul)
against the JAX reference on the CPU: the weight quantizer's codes and
scales, the product against the reference's Pallas kernel in interpret
mode, the format error against the exact product, and the block contract.
The CUDA kernel is held against the plain version on a card by
test_torch_kernels_cuda.py. Inputs are seeded numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quant_matmul as jqm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tkern  # noqa: E402
from repro_torch.kernels.quant_matmul import ref as tref  # noqa: E402

# the reference test's tolerance between its kernel and its oracle: fp32
# summation order (the kernel scales each k-block's partial sum, the plain
# version each code)
ATOL, RTOL = 1e-3, 1e-4
# the reference test's bound on the format error against x @ w, relative to
# the largest |x @ w|
FORMAT_ERR = {8: 0.02, 4: 0.25}


def _xw(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("K,N,block_k", [(128, 128, 128), (512, 128, 128),
                                         (384, 256, 128), (256, 96, 64)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_matches_reference(K, N, block_k, bits):
    _, w = _xw(K + N, 1, K, N)
    w[:block_k, 0] = 0.0                        # an all-zero block: scale 1
    codes, scales = tqm.quantize_weights(torch.from_numpy(w), block_k, bits)
    jc, js = jqm.quantize_weights(jnp.asarray(w), block_k=block_k, bits=bits)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    # the reference's unjitted oracle divides by qmax: one fp32 rounding apart
    _, osc = jqm.quantize_weights_ref(jnp.asarray(w), block_k=block_k,
                                      bits=bits)
    np.testing.assert_allclose(scales.numpy(), np.asarray(osc), rtol=1.2e-7,
                               atol=0)
    qmax = 2 ** (bits - 1) - 1
    assert codes.min() >= -qmax - 1 and codes.max() <= qmax
    np.testing.assert_array_equal(
        tqm.dequantize_ref(codes, scales).numpy(),
        np.asarray(jqm.dequantize_ref(jc, js)))


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 512, 128),
                                   (128, 384, 256), (8, 256, 128)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_matches_reference_kernel(M, K, N, bits):
    x, w = _xw(M * K + N, M, K, N)
    codes, scales = jqm.quantize_weights(jnp.asarray(w), block_k=128,
                                         bits=bits)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), codes, scales,
                                       interpret=True))
    got = tqm.quant_matmul(torch.from_numpy(x),
                           torch.from_numpy(np.array(codes)),
                           torch.from_numpy(np.array(scales)))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    exact = x @ w
    rel = np.abs(got.numpy() - exact).max() / np.abs(exact).max()
    assert rel < FORMAT_ERR[bits]


def test_quant_matmul_bf16_activations():
    """bf16 x is widened to fp32 exactly on both sides."""
    x, w = _xw(7, 128, 256, 128)
    xb = torch.from_numpy(x).bfloat16()
    codes, scales = tqm.quantize_weights(torch.from_numpy(w))
    got = tqm.quant_matmul(xb, codes, scales)
    want = np.asarray(jqm.quant_matmul(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()),
        interpret=True))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("block_k", [64, 256])
def test_block_k_sets_the_scale_granularity(block_k):
    x, w = _xw(block_k, 128, 256, 128)
    codes, scales = tqm.quantize_weights(torch.from_numpy(w), block_k)
    assert scales.shape == (256 // block_k, 128)
    got = tqm.quant_matmul(torch.from_numpy(x), codes, scales,
                           block_k=block_k)
    want = np.asarray(jqm.quant_matmul(
        jnp.asarray(x), jnp.asarray(codes.numpy()),
        jnp.asarray(scales.numpy()), block_k=block_k, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("M,K,N,nkb,kw", [
    (192, 128, 128, 1, {}),                  # M not a multiple of 128
    (128, 128, 200, 1, {}),                  # N not a multiple of 128
    (128, 384, 128, 3, {"block_k": 256}),    # K not a multiple of block_k
    (128, 256, 128, 1, {}),                  # scales for the wrong block_k
])
def test_contract_raises_where_the_reference_asserts(M, K, N, nkb, kw):
    x = np.zeros((M, K), np.float32)
    codes = np.zeros((K, N), np.int8)
    scales = np.ones((nkb, N), np.float32)
    with pytest.raises(AssertionError):
        jqm.quant_matmul(jnp.asarray(x), jnp.asarray(codes),
                         jnp.asarray(scales), interpret=True, **kw)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError):
            tqm.quant_matmul(*(torch.from_numpy(a).to(dev)
                               for a in (x, codes, scales)), **kw)


def test_kernel_refuses_tensors_off_the_card():
    x, codes, scales = (torch.zeros(8, 128), torch.zeros(128, 128,
                        dtype=torch.int8), torch.ones(1, 128))
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="on the card"):
            tqm.quant_matmul_kernel(x.to(dev), codes.to(dev), scales.to(dev))


def test_cpu_path_launches_nothing_and_the_source_exists():
    before = dict(tqm.LAUNCHES)
    tqm.quant_matmul(torch.zeros(8, 128), torch.zeros(128, 128,
                     dtype=torch.int8), torch.ones(1, 128))
    assert tqm.LAUNCHES == before
    assert "quant_matmul" in build.sources()


# ---------------------------------------------------------------------------
# the CUDA kernel's route: exact bf16 parts of x, bf16 codes, the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(-110, -60), (-60, -20), (-20, 0),
                                   (0, 20), (20, 60), (60, 127)])
def test_split_bf16_is_exact(lo, hi):
    """hi + mid + lo == x exactly for 2^-110 <= |x| < 2^127 (below 2^-110
    lo can fall among bf16's subnormals), over 200,000 values a window of
    binades; and for 0."""
    rng = np.random.default_rng(lo + 1000)
    e = rng.uniform(lo, hi, 200_000)
    x = (rng.choice([-1.0, 1.0], e.size) * np.exp2(e)).astype(np.float32)
    x[:3] = [0.0, np.float32(2.0 ** lo), -np.float32(2.0 ** lo)]
    parts = tref.split_bf16(torch.from_numpy(x))
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    np.testing.assert_array_equal(total.numpy(), x.astype(np.float64))


def test_split_bf16_loses_bits_among_subnormals():
    """The stated range is tight on the small side: some x below 2^-126
    need a lo part finer than bf16's subnormals hold."""
    rng = np.random.default_rng(3)
    x = (np.exp2(rng.uniform(-140, -127, 10_000))).astype(np.float32)
    total = sum(p.double() for p in tref.split_bf16(torch.from_numpy(x)))
    assert (total.numpy() != x.astype(np.float64)).any()


def test_every_int8_code_is_exact_in_bf16():
    codes = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(codes.to(torch.bfloat16).float(), codes.float())


@pytest.mark.parametrize("M,K,N,block_k", [(128, 128, 128, 128),
                                           (256, 512, 128, 128),
                                           (128, 384, 256, 128),
                                           (8, 256, 128, 128),
                                           (100, 96, 40, 32)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_emulation_matches_reference_kernel(M, K, N, block_k, bits,
                                                  dtype):
    """The kernel's arithmetic (exact bf16 part x code products, an fp32
    partial per k-block, times the scale) stays within a quarter of the
    reference test's ATOL + RTOL |want| of the reference's Pallas kernel in
    interpret mode."""
    x, w = _xw(M * 3 + K + N + bits, M, K, N)
    xt = torch.from_numpy(x).to(dtype)
    jc, js = jqm.quantize_weights(jnp.asarray(w), block_k=block_k, bits=bits)
    codes, scales = (torch.from_numpy(np.array(jc)),
                     torch.from_numpy(np.array(js)))
    want = np.asarray(jqm.quant_matmul(
        jnp.asarray(xt.float().numpy()).astype(
            jnp.float32 if dtype == torch.float32 else jnp.bfloat16),
        jc, js, block_m=min(128, M), block_n=min(128, N), block_k=block_k,
        interpret=True))
    got = tref.quant_matmul_route_ref(xt, codes, scales).numpy()
    excess = np.abs(got - want) - 0.25 * (ATOL + RTOL * np.abs(want))
    assert excess.max() <= 0, excess.max()


PIMREF = (4096, 3072, 768)            # M, N, K of pimref-100m's wi_up
GRIFFIN_DECODE = (8, 7680, 2560)      # recurrentgemma-2b's MLP at a step
PLAN_SHAPES = [PIMREF, GRIFFIN_DECODE, (4096, 7680, 2560), (1, 40, 100),
               (63, 100, 96), (64, 3072, 768), (65, 40, 97), (127, 256, 384),
               (4096, 256, 384)]


@pytest.mark.parametrize("M,N,K", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_output_and_k_block_once(M, N, K, dtype):
    bk = {100: 100, 96: 96, 97: 97}.get(K, 64 if (M, N, K) == (64, 3072, 768)
                                        else 128)
    p = tkern.plan(M, N, K, bk, dtype)
    nkb = K // bk
    assert p.smem <= tkern.SMEM_LIMIT
    assert p.parts == (3 if dtype == torch.float32 else 1)
    if M <= tkern.NARROW_MAX_M:
        assert p.route == "narrow" and M <= p.mp and p.mp % 8 == 0
        tiles = -(-N // p.bn)
        assert p.blocks == tiles * p.n_split
        seen = np.zeros(nkb, int)
        for s in range(p.n_split):
            lo, hi = tkern.split_kblocks(nkb, p.n_split, s)
            assert hi > lo            # every split has a k-block
            seen[lo:hi] += 1
        np.testing.assert_array_equal(seen, 1)
        cols = np.zeros(tiles * p.bn, int)
        for t in range(tiles):
            cols[t * p.bn:(t + 1) * p.bn] += 1
        assert (cols[:N] == 1).all()
    else:
        assert p.route == "wide" and p.n_split == 1
        assert p.blocks == -(-M // p.bm) * -(-N // p.bn)
        rows = np.zeros(-(-M // p.bm) * p.bm, int)
        for t in range(-(-M // p.bm)):
            rows[t * p.bm:(t + 1) * p.bm] += 1
        assert (rows[:M] == 1).all()
        # the padded k axis: every k-block a whole number of stages
        bkp = -(-bk // tkern.KT) * tkern.KT
        assert p.kp == nkb * bkp and p.kp % tkern.KT == 0
        assert p.np % 8 == 0 and p.np - 8 < N <= p.np


@pytest.mark.parametrize("shape", [PIMREF, GRIFFIN_DECODE])
def test_plan_fills_the_card(shape):
    M, N, K = shape
    for dtype in (torch.float32, torch.bfloat16):
        assert tkern.plan(M, N, K, 128, dtype).blocks >= 132
