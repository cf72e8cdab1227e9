"""The port's KV-cache layouts (Proteus int8/int4/auto codes, pages, both)
against the JAX reference on the same numpy inputs, in fp32 on the CPU: the
int4 nibble pair, the narrow-value signal of ``auto``, quantization codes
and scales, the paged layout and its writes, and greedy decoding through the
whole model in every layout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core import proteus as jproteus  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import proteus as tproteus  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.models import TransformerLM, load_jax_params  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")
PS = 4


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _eq(t, j):
    np.testing.assert_array_equal(t.detach().cpu().numpy(), np.asarray(j))


def _uniform_rows(rng, shape):
    """Rows of equal magnitude (crest 1): the int4 grid is enough."""
    return (np.sign(rng.standard_normal(shape)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# int4 nibbles and the narrow-value signal
# ---------------------------------------------------------------------------
def test_pack_unpack_int4_match_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (3, 5, 16)).astype(np.int8)
    packed = tcommon.pack_int4(torch.from_numpy(codes))
    _eq(packed, jcommon.pack_int4(jnp.asarray(codes)))
    assert packed.dtype == torch.int8 and packed.shape == (3, 5, 8)
    _eq(tcommon.unpack_int4(packed), codes)
    # even element in the low nibble, odd in the high one
    assert int(tcommon.pack_int4(torch.tensor([[-1, 2]], dtype=torch.int8))
               .view(torch.uint8)) == 0x2F


def test_kv_quant_modes():
    assert tcommon.KV_QUANT_MODES == jcommon.KV_QUANT_MODES
    with pytest.raises(ValueError, match="kv_quant"):
        tcommon.check_kv_quant("fp8")


@pytest.mark.parametrize("n,block", [(1024, 256), (1000, 256), (96, 64)])
def test_narrow_value_signal_matches_reference(n, block):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[7] = 40.0                                    # one spiky block
    x[-3:] = 0.0
    for t, j in zip(tproteus.block_stats(torch.from_numpy(x), block),
                    jproteus.block_stats(jnp.asarray(x), block)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    np.testing.assert_allclose(
        float(tproteus.block_crest(torch.from_numpy(x), block)),
        float(jproteus.block_crest(jnp.asarray(x), block)), rtol=1e-6)
    for rtol in (1e-2, 0.1):
        assert int(tproteus.required_bits_float(torch.from_numpy(x), block,
                                                rtol)) == \
            int(jproteus.required_bits_float(jnp.asarray(x), block, rtol))
    zeros = torch.zeros(block)
    assert float(tproteus.block_crest(zeros, block)) == 1.0


# ---------------------------------------------------------------------------
# quantization: codes and scales equal the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["int8", "int4", "auto"])
@pytest.mark.parametrize("data", ["normal", "uniform", "uniform_spiky"])
def test_kv_quantize_matches_reference(mode, data):
    rng = np.random.default_rng(len(mode) + len(data))
    shape = (2, 7, 3, 16)
    x = (rng.standard_normal(shape).astype(np.float32) if data == "normal"
         else _uniform_rows(rng, shape))
    if data == "uniform_spiky":
        x[1, 4, 2, 5] = 30.0                        # one spiky row
    x[0, 2, 1] = 0.0                                # an all-zero row
    t = tl.kv_quantize(torch.from_numpy(x), mode)
    j = jl.kv_quantize(jnp.asarray(x), mode)
    _eq(t.codes, j.codes)
    _eq(t.scale, j.scale)
    assert t.codes.dtype == torch.int8 and t.scale.dtype == torch.float32
    assert float(t.scale[0, 2, 1]) == 1.0
    if mode == "auto":
        # one grid per tensor: the spiky row moves the whole tensor to int8
        qmax = 7 if data == "uniform" else 127
        assert int(t.codes.abs().max()) == qmax
    deq = tl.kv_dequantize(t, 16)
    np.testing.assert_allclose(deq.numpy(), np.asarray(
        jl.kv_dequantize(j, 16, jnp.float32)), rtol=0, atol=0)


def test_kv_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([[[[2.5, 3.5, -2.5, 7.0, 0.5, -7.0, 1.5, -0.5]]]])
    q = tl.kv_quantize(x, "int4")                  # scale 1: codes = round(x)
    assert float(q.scale) == 1.0
    assert tcommon.unpack_int4(q.codes).flatten().tolist() == \
        [2, 4, -2, 7, 0, -7, 2, 0]
    _eq(q.codes, jl.kv_quantize(jnp.asarray(x.numpy()), "int4").codes)


# ---------------------------------------------------------------------------
# paged layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["off", "int8", "int4"])
def test_paged_round_trip(mode):
    """ring -> pages -> gather is the identity (through the quantizer for
    quantized pools), and pool and table equal the reference's."""
    rng = np.random.default_rng(0)
    ring = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    t = tl.paged_from_ring(torch.from_numpy(ring), PS, mode)
    j = jl.paged_from_ring(jnp.asarray(ring), page_size=PS, mode=mode)
    assert (t.page_size, t.kv_len, t.num_pages, t.num_heads) == \
        (j.page_size, j.kv_len, j.num_pages, j.num_heads) == (PS, 16, 9, 2)
    _eq(t.table, j.table)
    got = tl.paged_gather(t)
    if mode == "off":
        _eq(t.pages, j.pages)
        _eq(got, ring)
    else:
        _eq(t.pages.codes, j.pages.codes)
        _eq(t.pages.scale, j.pages.scale)
        want = tl.kv_quantize(torch.from_numpy(ring), mode)
        _eq(got.codes, want.codes)
        _eq(got.scale, want.scale)


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_paged_update_writes_through_table(mode):
    """kv_cache_update lands the row in the pool page the table points at,
    in place, and a trash-page row absorbs its write without touching live
    pages (tests/test_paged_kv.py's case, plus int8 pools)."""
    cache = tl.kv_cache_init((2, 8, 2, 4), torch.float32, mode, PS)
    jcache = jl.kv_cache_init((2, 8, 2, 4), jnp.float32, mode=mode,
                              page_size=PS)
    _eq(cache.table, jcache.table)
    new = torch.ones((2, 1, 2, 4))
    slot = torch.tensor([1, 5], dtype=torch.int32)  # page 0 off 1 / page 1 off 1
    upd = tl.kv_cache_update(cache, new, slot, mode)
    assert upd is cache
    jupd = jl.kv_cache_update(jcache, jnp.asarray(new.numpy()),
                              jnp.asarray(slot.numpy()), mode=mode)
    dense = tl.paged_gather(upd)
    if mode == "off":
        _eq(upd.pages, jupd.pages)
        assert float(dense[0, 1].sum()) == 8.0 and float(dense[1, 5].sum()) == 8
        assert float(dense.abs().sum()) == 16.0   # nothing else written
    else:
        _eq(upd.pages.codes, jupd.pages.codes)
        _eq(upd.pages.scale, jupd.pages.scale)
        assert int((dense.codes != 0).sum()) == 16
    before = tl.paged_gather(upd)
    trashed = tl.PagedKVCache(upd.pages, upd.table.clone())
    trashed.table[0] = tl.TRASH_PAGE
    tl.kv_cache_update(trashed, 3 * new, slot, mode)
    after = tl.paged_gather(tl.PagedKVCache(trashed.pages, upd.table))
    if mode == "off":
        _eq(after[0], before[0])                  # retired slot's pages intact
        assert float(after[1, 5].sum()) == 24.0   # live slot write landed
        assert float(trashed.pages[tl.TRASH_PAGE, 1].sum()) == 24.0
    else:
        _eq(after.codes[0], before.codes[0])
        _eq(after.scale[0], before.scale[0])
        assert float(after.scale[1, 5].max()) == pytest.approx(3 / 127)


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_paged_update_collisions_write_the_last_row(mode):
    """Slots on the trash page at the same offset (free engine slots, and a
    verify block's rows) collide: gathered by ``paged_last_writers`` (an
    MoE model's decode) every colliding row writes the last one's, so the
    trash row is the reference's sequential scatter's whatever order the
    card runs the writes in; the rest land as before."""
    B, S = 4, 2
    cache = tl.kv_cache_init((B, 8, 2, 4), torch.float32, mode, PS)
    jcache = jl.kv_cache_init((B, 8, 2, 4), jnp.float32, mode=mode,
                              page_size=PS)
    cache.table[[0, 2, 3]] = tl.TRASH_PAGE
    jcache = jl.PagedKVCache(jcache.pages, jnp.asarray(cache.table.numpy()))
    new = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, 2, 4)).astype(np.float32))
    slot = torch.tensor([[1, 2], [5, 6], [1, 2], [5, 1]], dtype=torch.int32)
    last = tl.paged_last_writers(cache, slot)
    assert last.tolist() == [7, 5, 2, 3, 7, 5, 7, 7]
    assert tl.paged_last_writers(cache.pages, slot) is None
    tl.kv_cache_update(cache, new.flatten(0, 1)[last].view_as(new), slot,
                       mode)
    jupd = jl.kv_cache_update(jcache, jnp.asarray(new.numpy()),
                              jnp.asarray(slot.numpy()), mode=mode)
    if mode == "off":
        _eq(cache.pages, jupd.pages)
        # trash offsets 1 ((0,0), (2,0), (3,0), (3,1)) and 2 ((0,1), (2,1))
        _eq(cache.pages[tl.TRASH_PAGE, 1], new[3, 1])
        _eq(cache.pages[tl.TRASH_PAGE, 2], new[2, 1])
    else:
        _eq(cache.pages.codes, jupd.pages.codes)
        _eq(cache.pages.scale, jupd.pages.scale)


def test_cache_helpers_match_reference():
    assert tl.aligned_cache_len(13, PS) == jl.aligned_cache_len(13, PS) == 16
    assert tl.aligned_cache_len(16, PS) == 16
    assert tl.aligned_cache_len(13, 0) == 13
    assert tl.TRASH_PAGE == jl.TRASH_PAGE == 0
    assert tl.KV_QUANT_RTOL == jl.KV_QUANT_RTOL
    assert tl.KV_ERROR_BUDGET == jl.KV_ERROR_BUDGET
    shape = (3, 2, 8, 2, 16)
    for mode in ("off", "int4"):
        for ps in (0, PS):
            t = tl.kv_cache_init(shape, torch.float32, mode, ps)
            j = jl.kv_cache_init(shape, jnp.float32, mode=mode, page_size=ps)
            assert tl.kv_cache_len(t) == jl.kv_cache_len(j) == 8
            for a, b in zip(_leaves(t), jax.tree_util.tree_leaves(j)):
                assert tuple(a.shape) == b.shape
                _eq(a, b)
            assert tl.kv_cast(t, torch.bfloat16) is not None
    with pytest.raises(ValueError, match="multiple of page size"):
        tl.kv_cache_init((2, 6, 2, 4), torch.float32, "off", PS)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tl.PagedKVCache):
        return _leaves(x.pages) + [x.table]
    return [x.codes, x.scale]


def test_kv_cast_keeps_codes():
    q = tl.kv_cache_init((1, 4, 2, 8), torch.float32, "int8")
    assert tl.kv_cast(q, torch.bfloat16) is q
    p = tl.kv_cache_init((1, 4, 2, 8), torch.float32, "off", PS)
    assert tl.kv_cast(p, torch.bfloat16).pages.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the whole model: greedy tokens through every layout
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 2, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, plan, tcfg, np_params


@pytest.mark.parametrize("kv_quant,pages", [
    ("int8", 0), ("int4", 0), ("auto", 0), ("off", PS), ("int8", PS)])
def test_greedy_tokens_match_reference(pair, monkeypatch, kv_quant, pages):
    """Prefill plus greedy decode (a ring wrap included) with the port's
    explicit layout arguments against the reference under the matching
    REPRO_KV_QUANT / REPRO_KV_PAGES knobs: identical tokens, positions and
    page tables."""
    jm, params, plan, tcfg, np_params = pair
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    tm = TransformerLM(tcfg, device="cpu", kv_quant=kv_quant, page_size=pages)
    load_jax_params(tm, np_params)
    max_len, steps = 14, 8
    assert tm.cache_len(max_len) == jm.cache_len(max_len)
    toks = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    with use_plan(plan):
        jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                             max_len=max_len)
        tlg, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len)
        jout, tout = [], []
        for _ in range(steps):
            jt = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
            tt = torch.argmax(tlg[:, -1:], dim=-1).to(torch.int32)
            jout.append(np.asarray(jt))
            tout.append(tt.numpy())
            jlg, jc = decode(params, jc, jt)
            tlg, tc = tm.decode_step(tc, tt)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-3,
                                   rtol=0)
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
    _eq(tc["pos_ids"], jc["pos_ids"])
    _eq(tc["pos"], jc["pos"])
    tk, jk = tc["k"], jc["k"]
    assert type(tk).__name__ == type(jk).__name__
    if pages:
        _eq(tk.table, jk.table)
    if kv_quant != "off":
        tq = tk.pages if pages else tk
        jq = jk.pages if pages else jk
        # fp32 sums of another order may tip a value over a rounding edge
        assert float((tq.codes.numpy() != np.asarray(jq.codes)).mean()) < 1e-3
