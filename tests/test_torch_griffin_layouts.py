"""The port's hybrid Griffin LM (recurrentgemma-2b) served from the
quantized and paged KV layouts (int8, int4 and auto codes, pages of 16,
int8 codes in pages of 16) against the JAX reference under the matching
``REPRO_KV_QUANT`` / ``REPRO_KV_PAGES`` knobs, in fp32 on the CPU with the
same weights: prefill logits and caches, greedy decode across a window
wrap, ``serve()`` fused and per-token, and the continuous-batching engine.
Token streams must be identical.

The reference's paged engine right-pads the prompt bucket, so its
recurrences run over the pads before decoding starts at the true prompt
end: its paged streams differ from its contiguous ones where a prompt is
shorter than the bucket. The port mirrors this (ROADMAP §C)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.steps import make_serving_jits  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.models import GriffinLM, load_jax_params  # noqa: E402
from repro_torch.models.layers import PagedKVCache, QKVCache  # noqa: E402

ARCH = "recurrentgemma-2b"
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")
PS = 16
# name: (kv_quant, page_size)
LAYOUTS = {"int8": ("int8", 0), "int4": ("int4", 0), "auto": ("auto", 0),
           "paged16": ("off", PS), "paged16_int8": ("int8", PS)}
# as tests/test_torch_griffin.py: fp32 through the RG-LRU's sqrt(1 - a^2)
# holds a tensor to 1e-3 of its largest |value| and the logits to 5e-3
REL_TOL = 1e-3
LOGITS_ATOL = 5e-3
# a watchdog threshold no chunk reaches: the engines' statistics must not
# move with the host's load (ROADMAP §C)
NO_WATCHDOG = dict(straggler_threshold=1e9)
STATS = ("prefills", "prefix_hits", "kv_pages_peak", "kv_pages_in_use",
         "kv_hbm_bytes_peak", "kv_bytes_per_token", "tokens_out",
         "decode_dispatches", "error_completions", "admission_blocked")
ENGINE = dict(slots=2, prompt_len=10, max_new=10, chunk=4)


@pytest.fixture(scope="module")
def ref():
    """Mesh-less fp32 smoke reference, its weights, the port model holding
    the same weights, and the port's contiguous engine drain."""
    jcfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    tcfg = tconfigs.get_config(ARCH, smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 64, 4, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tm = GriffinLM(tcfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    contiguous = _port_drain(tm)
    return dict(jcfg=jcfg, plan=plan, jm=jm, params=params, tm=tm,
                contiguous=contiguous)


@pytest.fixture
def layout(monkeypatch):
    """Sets the reference's knobs for a layout; returns the port's
    explicit arguments."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def set_layout(name):
        kv_quant, pages = LAYOUTS[name]
        monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
        monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
        return dict(kv_quant=kv_quant, page_size=pages)
    return set_layout


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(t, j, atol=None):
    """|t - j| within ``atol``, or within REL_TOL of max |j|."""
    j = np.asarray(j)
    tol = atol if atol is not None else REL_TOL * max(1.0, np.abs(j).max())
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=tol)


def _close_kv(t, j):
    """One K or V leaf: the page table equal, codes equal, values and
    scales within REL_TOL of their largest |value|."""
    assert type(t).__name__ == type(j).__name__
    if isinstance(t, PagedKVCache):
        np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
        t, j = t.pages, j.pages
    if isinstance(t, QKVCache):
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        t, j = t.scale, j.scale
    assert tuple(t.shape) == j.shape
    _close(t, j)


def _close_cache(tc, jc):
    for n in ("rec1", "rec2"):
        for m in ("h", "conv"):
            _close(tc[n][m], jc[n][m])
    for t, j in zip(tc["tail"], jc["tail"]):
        for m in ("h", "conv"):
            _close(t[m], j[m])
    for n in ("k", "v"):
        _close_kv(tc[n], jc[n])
    for n in ("pos_ids", "pos"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


def _jax_serve_tokens(r, *, batch, prompt_len, gen, chunk, seed):
    """The JAX fused serving programs on serve()'s synthetic batch."""
    prefill, generate, _, _ = make_serving_jits(
        r["jm"], r["plan"], max_len=prompt_len + gen, chunk=chunk)
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, r["jcfg"].vocab_size,
                                    (batch, prompt_len)), jnp.int32)
    logits, cache = prefill(r["params"], {"tokens": toks})
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    key = jax.random.PRNGKey(seed + 1)
    chunks = []
    for _ in range(-(-gen // chunk)):
        cache, tok, key, _d, _n, out, _f = generate(r["params"], cache, tok,
                                                    key, jnp.int32(-1))
        chunks.append(np.asarray(out))
    return np.concatenate(chunks, axis=1)[:, :gen]


def _requests(cls):
    """tests/test_torch_griffin.py's six requests: prompts of 3 to 10
    tokens in a 10-token bucket (uid 2 fills it)."""
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=rng.integers(
        1, 256, rng.integers(3, ENGINE["prompt_len"] + 1)), max_new_tokens=n)
        for i, n in enumerate([3, 10, 5, 2, 7, 9])]


def _port_engine(tm, **lay):
    return tserve.make_queue_engine(
        model=tm, slots=ENGINE["slots"], prompt_len=ENGINE["prompt_len"],
        gen=ENGINE["max_new"], chunk=ENGINE["chunk"], device="cpu",
        **lay, **NO_WATCHDOG)


def _port_drain(tm, **lay):
    eng = _port_engine(tm, **lay)
    return eng, {c.uid: c for c in eng.run(_requests(Request))}


def _check_drained(eng):
    """Every page back on the free list, no registration, tables on the
    trash page."""
    assert eng.stats["kv_pages_in_use"] == 0 and eng._alloc.used == 0
    assert not eng._alloc.registry
    assert sorted(eng._alloc.free) == list(range(1, eng.n_phys_pages))
    assert not eng._host_table.any()
    assert not eng.cache["k"].table.any() and not eng.cache["v"].table.any()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_reference(ref, layout, name):
    """One layout end to end: the prefill's logits and caches (40 tokens
    past the window of 32, so the stored ring wraps), 16 greedy decode
    steps writing round the ring, ``serve()`` fused == per-token loop ==
    the reference's serving programs, and a six-request engine drain on
    two slots == the reference ``ServeEngine`` byte for byte, with its
    page and byte accounting, every page back."""
    lay = layout(name)
    jm, params, plan = ref["jm"], ref["params"], ref["plan"]
    tm = ref["tm"].with_kv_layout(**lay)
    assert tm.groups is ref["tm"].groups          # the weights are shared
    assert tm.cache_len(56) == jm.cache_len(56) == 32

    toks = _tokens(2, (2, 40))
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=56)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=56)
    _close(tl, jl, LOGITS_ATOL)
    _close_cache(tc, jc)
    decode = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    jout, tout = [], []
    for _ in range(16):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jout.append(np.asarray(jt))
        tout.append(tt.numpy())
        with use_plan(plan):
            jl, jc = decode(params, jc, jt)
        tl, tc = tm.decode_step(tc, tt)
        _close(tl, jl, LOGITS_ATOL)
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
    _close_cache(tc, jc)

    kw = dict(batch=3, prompt_len=20, gen=16, chunk=4, seed=1)
    fused = tserve.serve(engine="fused", device="cpu", model=ref["tm"],
                         **lay, **kw)
    loop = tserve.serve(engine="loop", device="cpu", model=ref["tm"], **lay,
                        **kw)
    np.testing.assert_array_equal(fused["tokens"],
                                  _jax_serve_tokens(ref, **kw))
    np.testing.assert_array_equal(loop["tokens"], fused["tokens"])

    jeng = JServeEngine(jm, params, plan, **ENGINE, **NO_WATCHDOG)
    jcomp = {c.uid: c for c in jeng.run(_requests(JRequest))}
    teng, tcomp = _port_drain(ref["tm"], **lay)
    assert teng.paged == jeng.paged == (lay["page_size"] > 0)
    assert sorted(tcomp) == sorted(jcomp) == list(range(6))
    for uid in jcomp:
        assert tcomp[uid].finish_reason == jcomp[uid].finish_reason \
            == "length"
        np.testing.assert_array_equal(tcomp[uid].tokens, jcomp[uid].tokens)
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["prefills"] == 6
    if lay["page_size"]:
        assert teng.cache_pos_len == jeng.cache_pos_len
        # the pools' leading axis is the model's one attention group
        assert teng.cache["k"].table.shape == (1, 2, teng.n_logical_pages)
        _check_drained(teng)
        # the right-padded bucket: uid 0's 9-token prompt decodes from
        # recurrent states that ran over a pad, so its stream leaves the
        # contiguous layout's; uid 2's prompt fills the bucket and agrees
        _, contiguous = ref["contiguous"]
        assert len(_requests(Request)[0].tokens) == 9
        assert not np.array_equal(tcomp[0].tokens, contiguous[0].tokens)
        assert len(_requests(Request)[2].tokens) == ENGINE["prompt_len"]
        np.testing.assert_array_equal(tcomp[2].tokens, contiguous[2].tokens)
