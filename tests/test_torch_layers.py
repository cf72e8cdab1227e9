"""Port layers (repro_torch.models.layers) against the JAX reference layers
on the same numpy inputs, in fp32 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-6


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 16)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, s = _np(rng, *shape), _np(rng, shape[-1])
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("D", [16, 64])
def test_rope_half_split(batched, D):
    rng = np.random.default_rng(1)
    B, S, H = 2, 7, 3
    x = _np(rng, B, S, H, D)
    if batched:
        pos = rng.integers(0, 500, (B, S)).astype(np.int32)
    else:
        pos = np.arange(S, dtype=np.int32) + 11
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), atol=2e-5)


def test_dense_and_gated_mlp():
    rng = np.random.default_rng(2)
    # weights scaled by 1/sqrt(fan_in), as initialised, so outputs are O(1)
    x = _np(rng, 2, 5, 32)
    wg, wu = _np(rng, 32, 48) / 32 ** 0.5, _np(rng, 32, 48) / 32 ** 0.5
    wo, wq = _np(rng, 48, 32) / 48 ** 0.5, _np(rng, 32, 4, 8) / 32 ** 0.5
    _close(tl.dense(torch.from_numpy(x), torch.from_numpy(wq), "bsd,dhe->bshe"),
           jl.dense(jnp.asarray(x), jnp.asarray(wq), "bsd,dhe->bshe"))
    t = tl.gated_mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wo)))
    j = jl.gated_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wo)))
    _close(t, j)


def test_softcap_and_slot_isfinite():
    rng = np.random.default_rng(3)
    x = _np(rng, 3, 4, 10) * 30
    _close(tl.softcap(torch.from_numpy(x), 20.0), jl.softcap(jnp.asarray(x),
                                                              20.0), 1e-5)
    x[1, 2, 3] = np.nan
    x[2, 0, 0] = np.inf
    np.testing.assert_array_equal(
        tl.slot_isfinite(torch.from_numpy(x)).numpy(),
        np.asarray(jl.slot_isfinite(jnp.asarray(x))))


@pytest.mark.parametrize("total,cache_len", [(5, 8), (8, 8), (13, 8), (20, 6)])
def test_ring_store_and_position_ids(total, cache_len):
    rng = np.random.default_rng(4)
    k = _np(rng, 2, total, 3, 4)
    _close(tl.ring_cache_store(torch.from_numpy(k), total, cache_len),
           jl.ring_cache_store(jnp.asarray(k), total, cache_len), 0)
    np.testing.assert_array_equal(
        tl.ring_position_ids(2, total, cache_len).numpy(),
        np.asarray(jl.ring_position_ids(2, total, cache_len)))


@pytest.mark.parametrize("S", [1, 3])
def test_ring_cache_update(S):
    rng = np.random.default_rng(5)
    B, T = 3, 8
    cache, new = _np(rng, B, T, 2, 4), _np(rng, B, S, 2, 4)
    pos = np.asarray([2, 7, 13], np.int32)
    slot = (pos[:, None] + np.arange(S, dtype=np.int32)) % T
    if S == 1:
        slot = slot[:, 0]
    want = jl.ring_cache_update(jnp.asarray(cache), jnp.asarray(new),
                                jnp.asarray(slot))
    got = tl.ring_cache_update(torch.from_numpy(cache.copy()),
                               torch.from_numpy(new), torch.from_numpy(slot))
    _close(got, want, 0)


@pytest.mark.parametrize("valid", [False, True])
def test_decode_positions(valid):
    rng = np.random.default_rng(6)
    B, S, T = 3, 2, 10
    q_off = np.asarray([3, 9, 0], np.int32)
    kv = rng.integers(-1, 12, (B, T)).astype(np.int32)
    vl = np.asarray([4, 10, 1], np.int32) if valid else None
    jq, jk = jl._decode_positions(jnp.asarray(q_off), jnp.asarray(kv),
                                  None if vl is None else jnp.asarray(vl),
                                  B, S, T)
    tq, tk = tl._decode_positions(torch.from_numpy(q_off), torch.from_numpy(kv),
                                  None if vl is None else torch.from_numpy(vl),
                                  B, S, T, "cpu")
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("S,T,window,G", [(9, 9, 0, 1), (16, 16, 5, 2),
                                          (1, 12, 0, 4)])
def test_chunked_attention_prefill_dispatch(S, T, window, G):
    """The prefill branch (full causal sequence from position 0) against the
    reference dispatch's jnp path."""
    rng = np.random.default_rng(7)
    B, Hkv, D = 2, 2, 16
    q, k, v = _np(rng, B, S, Hkv * G, D), _np(rng, B, T, Hkv, D), \
        _np(rng, B, T, Hkv, D)
    want = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, window=window, impl="jnp")
    got = tl.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True, window=window)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [1, 4])
def test_chunked_attention_decode_dispatch(S):
    """The positional branch: ring cache with -1 slots, per-slot depths."""
    rng = np.random.default_rng(8)
    B, Hkv, G, D, T = 3, 2, 2, 16, 24
    q, k, v = _np(rng, B, S, Hkv * G, D), _np(rng, B, T, Hkv, D), \
        _np(rng, B, T, Hkv, D)
    pos = np.asarray([3, 20, 31], np.int32)
    kvp = np.stack([tl.ring_position_ids(1, int(p) + S, T)[0].numpy()
                    for p in pos])
    want = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, q_offset=jnp.asarray(pos),
                                kv_positions=jnp.asarray(kvp), impl="jnp")
    got = tl.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               q_offset=torch.from_numpy(pos),
                               kv_positions=torch.from_numpy(kvp))
    _close(got, want, 1e-5)


def test_chunked_attention_rejects_non_tensor_cache():
    q = torch.zeros(1, 1, 2, 16)
    with pytest.raises(TypeError, match="unsupported KV cache leaf"):
        tl.chunked_attention(q, object(), object(), q_offset=0)
