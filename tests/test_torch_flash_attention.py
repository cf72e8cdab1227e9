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
    assert tk.LAUNCHES == before


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
                                   (1, 12, 4096), (64, 12, 300)])
def test_decode_splits_cover_t(B, H, T):
    n_split, split_len = tk.decode_splits(B, H, T)
    assert split_len % tk.DECODE_SPLIT_MULTIPLE == 0
    assert (n_split - 1) * split_len < T <= n_split * split_len
    assert tk.decode_splits(B, H, T) == (n_split, split_len)


def test_build_finds_sources_and_names_missing_nvcc(monkeypatch, tmp_path):
    srcs = build.sources()
    assert "flash_attention" in srcs
    lib = build.library_path(srcs["flash_attention"])
    assert lib.parent == build.BUILD_DIR and lib.name.startswith(
        "libflash_attention-")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    for var in build.CUDA_ROOTS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
