"""The port's hybrid Griffin LM (repro_torch.models.recurrent_lm.GriffinLM,
recurrentgemma-2b) against the JAX reference with the same weights, in fp32
on the CPU: the config copy, parameter specs, init, the bridge over the
stacked ``groups`` and the ``tail`` list, forward logits, prefill, greedy
decode across a window wrap, batch serving (fused and per-token) and the
continuous-batching engine. Token streams must be identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.configs.base import param_count  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.steps import make_serving_jits  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.models import (GriffinLM, count_params,  # noqa: E402
                                load_jax_params, param_specs)
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.models import init_params as tinit_params  # noqa: E402

ARCH = "recurrentgemma-2b"
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")
# fp32 through five layers of random weights: the RG-LRU's a_t close to 1
# makes sqrt(1 - a_t^2) turn one-ulp differences between XLA's and
# PyTorch's exp / sigmoid into ~1e-5 relative differences of the gated
# input, which the following layers carry on (measured up to ~1.2e-4 of the
# largest |value| of a cache leaf), and the MLPs grow activations into the
# thousands; so a tensor is held to 1e-3 of its largest |value|, and the
# logits (about 2 here; soft-capped at 30) to 5e-3
REL_TOL = 1e-3
LOGITS_ATOL = 5e-3


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _cfgs(**kw):
    jcfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32", **kw)
    tcfg = tconfigs.get_config(ARCH, smoke=True).replace(
        compute_dtype="float32", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ref():
    """Mesh-less fp32 smoke reference, its weights, and the port model
    holding the same weights."""
    jcfg, tcfg = _cfgs()
    plan = plan_sharding(jcfg, ShapeConfig("serve", 64, 4, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm = GriffinLM(tcfg, device="cpu")
    load_jax_params(tm, np_params)
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=np_params, tm=tm)


def _close(t, j, atol=None):
    """|t - j| within ``atol``, or within REL_TOL of max |j|."""
    j = np.asarray(j)
    tol = atol if atol is not None else REL_TOL * max(1.0, np.abs(j).max())
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=tol)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _flat_cache(c, prefix=""):
    """name -> leaf of a nested cache (dicts and lists)."""
    items = c.items() if isinstance(c, dict) else enumerate(c)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat_cache(v, name + "."))
        else:
            out[name] = v
    return out


def _close_cache(tc, jc):
    tf, jf = _flat_cache(tc), _flat_cache(jc)
    assert sorted(tf) == sorted(jf)
    for name, j in jf.items():
        assert tuple(tf[name].shape) == j.shape, name
        if name in ("pos_ids", "pos"):
            np.testing.assert_array_equal(tf[name].numpy(), np.asarray(j))
        else:
            _close(tf[name], j)


# ---------------------------------------------------------------------------
# config, specs, init, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke):
    j = get_config(ARCH, smoke=smoke)
    t = tconfigs.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfigs.param_count(t) == param_count(j)
    if not smoke:
        assert param_count(j) == 3_219_261_440
        # the model itself: recurrent layers have no attention, logits
        # come from the tied embedding
        assert count_params(t) == 2_894_481_920


def _reference_flat_specs(jcfg):
    """name -> (shape, init) of the reference's spec tree, with the group
    axis unrolled and the tail list numbered."""
    specs = build_model(jcfg).param_specs()
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "logical_axes"))[0]:
        keys = [str(p.key) if hasattr(p, "key") else str(p.idx) for p in path]
        if keys[0] == "groups":
            for g in range(s.shape[0]):
                flat[".".join(["groups", str(g)] + keys[1:])] = (
                    s.shape[1:], s.init, s.dtype)
        else:
            flat[".".join(keys)] = (s.shape, s.init, s.dtype)
    return flat


def test_param_specs_match_reference():
    jcfg, tcfg = _cfgs()
    want = {n: (shape, init, np.dtype(dt).name)
            for n, (shape, init, dt) in _reference_flat_specs(jcfg).items()}
    mine = {n: (s.shape, s.init, str(s.dtype).split(".")[-1])
            for n, s in param_specs(tcfg).items()}
    assert mine == want
    m = GriffinLM(tcfg, device="cpu")
    assert sorted(n for n, _ in m.named_parameters()) == sorted(want)


def test_init_params_kinds_and_seed():
    _, tcfg = _cfgs()
    a = tinit_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = tinit_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    lam = a["groups.0.rec1.rec.lam"]
    assert lam.dtype == torch.float32
    u = torch.sigmoid(lam)                   # the decay rate at r = +inf
    assert u.min() >= 0.9 - 1e-6 and u.max() <= 0.999 + 1e-6
    assert u.std() > 0.01                    # spread over the interval
    assert not a["tail.1.rec.conv_b"].any()
    assert torch.equal(a["final_norm"], torch.ones(tcfg.d_model))
    # a bf16 parameter dtype leaves lam in fp32, as the reference does
    c = tinit_params(tcfg.replace(param_dtype="bfloat16"),
                     torch.Generator().manual_seed(3), "cpu")
    assert c["tail.0.rec.lam"].dtype == torch.float32
    assert c["tail.0.rec.w_x"].dtype == torch.bfloat16
    GriffinLM(tcfg, device="cpu").load_state_dict(a)


def test_bridge_over_groups_and_tail(ref):
    tm, npp = ref["tm"], ref["np_params"]
    got = dict(tm.named_parameters())
    np.testing.assert_array_equal(
        got["groups.0.attn.attn.w_q"].numpy(),
        npp["groups"]["attn"]["attn"]["w_q"][0])
    np.testing.assert_array_equal(got["tail.1.rec.lam"].numpy(),
                                  npp["tail"][1]["rec"]["lam"])
    fresh = GriffinLM(ref["tcfg"], device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(fresh, {**npp, "tail": npp["tail"][:1]})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(fresh, {**npp, "tail": npp["tail"] + [npp["tail"][0]]})
    bad_rec = {**npp["tail"][0]["rec"], "lam": np.zeros(3, np.float32)}
    bad = {**npp, "tail": [{**npp["tail"][0], "rec": bad_rec}, npp["tail"][1]]}
    with pytest.raises(ValueError, match="tail.0.rec.lam"):
        load_jax_params(fresh, bad)
    groups = jax.tree_util.tree_map(lambda a: a[:0], npp["groups"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(fresh, {**npp, "groups": groups})


def test_build_model_and_layout_guards():
    """Every KV layout builds (the quantized and paged caches, alone and
    together), ``with_kv_layout`` shares the weights, and an unknown
    quantization mode raises."""
    from repro_torch.models.layers import PagedKVCache, QKVCache
    _, tcfg = _cfgs()
    assert isinstance(tbuild_model(tcfg, "cpu"), GriffinLM)
    m = GriffinLM(tcfg, device="cpu")
    assert m.with_kv_layout() is m
    for kv_quant in ("off", "int8", "int4", "auto"):
        for ps in (0, 16):
            built = tbuild_model(tcfg, "cpu", kv_quant=kv_quant, page_size=ps)
            assert (built.kv_quant, built.page_size) == (kv_quant, ps)
            view = m.with_kv_layout(kv_quant, ps)
            assert (view.kv_quant, view.page_size) == (kv_quant, ps)
            assert view.embed is m.embed and view.groups is m.groups
            assert (m.kv_quant, m.page_size) == ("off", 0)
            k = view.init_cache(2, 20)["k"]
            if ps:
                assert isinstance(k, PagedKVCache) and k.kv_len == 32
                assert k.table.shape == (1, 2, 2)      # group axis first
                k = k.pages
            assert isinstance(k, QKVCache) == (kv_quant != "off")
    for bad in (lambda: tbuild_model(tcfg, "cpu", kv_quant="fp8"),
                lambda: m.with_kv_layout("int2"),
                lambda: tserve.serve(ARCH, batch=1, prompt_len=4, gen=2,
                                     device="cpu", kv_quant="nf4")):
        with pytest.raises(ValueError, match="kv_quant"):
            bad()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GriffinLM(tcfg)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------
def test_forward_matches(ref):
    """40 positions: past the smoke window of 32."""
    toks = _tokens(0, (2, 40))
    with use_plan(ref["plan"]):
        want = ref["jm"].forward(ref["params"], jnp.asarray(toks))
    _close(ref["tm"](torch.from_numpy(toks)), want, LOGITS_ATOL)


@pytest.mark.parametrize("S,max_len,full_logits", [(13, 24, False),
                                                    (40, 56, True)])
def test_prefill_logits_and_cache_match(ref, S, max_len, full_logits):
    toks = _tokens(1, (2, S))
    with use_plan(ref["plan"]):
        jl, jc = ref["jm"].prefill(ref["params"], {"tokens": jnp.asarray(toks)},
                                   max_len=max_len, full_logits=full_logits)
    tl, tc = ref["tm"].prefill(torch.from_numpy(toks), max_len=max_len,
                               full_logits=full_logits)
    assert tl.shape == jl.shape
    _close(tl, jl, LOGITS_ATOL)
    _close_cache(tc, jc)


def test_init_cache_matches(ref):
    jc, tc = ref["jm"].init_cache(3, 40), ref["tm"].init_cache(3, 40)
    tf, jf = _flat_cache(tc), _flat_cache(jc)
    assert sorted(tf) == sorted(jf)
    for name, j in jf.items():
        assert tuple(tf[name].shape) == j.shape, name
        np.testing.assert_array_equal(tf[name].numpy(), np.asarray(j))


def test_greedy_decode_identical_across_window_wrap(ref):
    """Prompt 40 and 16 new tokens against a window of 32: the prefill
    keeps the last 32 positions in a ring of 32 slots and every decode
    write wraps it. Greedy tokens identical, logits and caches close."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], ref["tm"]
    assert tm.cache_len(56) == jm.cache_len(56) == 32
    toks = _tokens(2, (2, 40))
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=56)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=56)
    jout, tout = [], []
    for _ in range(16):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jout.append(np.asarray(jt))
        tout.append(tt.numpy())
        with use_plan(plan):
            jl, jc = jm.decode_step(params, jc, jt)
        tl, tc = tm.decode_step(tc, tt)
        _close(tl, jl, LOGITS_ATOL)
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
    _close_cache(tc, jc)


@pytest.mark.parametrize("S", [2, 5])
def test_decode_block_equals_single_steps(ref, S):
    """An S-token decode block (the recurrences through the scan from the
    cached state) gives the logits and cache of S one-token steps."""
    tm = ref["tm"]
    toks = _tokens(3, (2, 30))
    feed = torch.from_numpy(_tokens(4, (2, S)))
    _, c1 = tm.prefill(torch.from_numpy(toks), max_len=40)
    _, c2 = tm.prefill(torch.from_numpy(toks), max_len=40)
    lb, c1 = tm.decode_step(c1, feed)
    ls = []
    for i in range(S):
        l, c2 = tm.decode_step(c2, feed[:, i:i + 1])
        ls.append(l)
    # other matmul shapes and the h0 fold round in another order: the
    # tolerances of the comparisons with the reference
    _close(lb, torch.cat(ls, 1).numpy(), LOGITS_ATOL)
    f1, f2 = _flat_cache(c1), _flat_cache(c2)
    for name in f1:
        _close(f1[name], f2[name].numpy())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
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


def test_serve_fused_equals_loop_and_reference(ref):
    """Batch serving past the window: fused == per-token loop == the JAX
    fused serving programs."""
    kw = dict(batch=3, prompt_len=20, gen=16, chunk=4, seed=1, device="cpu",
              model=ref["tm"])
    fused = tserve.serve(engine="fused", **kw)
    loop = tserve.serve(engine="loop", **kw)
    want = _jax_serve_tokens(ref, batch=3, prompt_len=20, gen=16, chunk=4,
                             seed=1)
    np.testing.assert_array_equal(fused["tokens"], want)
    np.testing.assert_array_equal(loop["tokens"], fused["tokens"])
    assert fused["dispatches"] == 4 and loop["dispatches"] == 16


def _requests(cls, prompt_len):
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=rng.integers(1, 256,
                                           rng.integers(3, prompt_len + 1)),
                max_new_tokens=n)
            for i, n in enumerate([3, 10, 5, 2, 7, 9])]


def test_engine_drain_matches_reference_engine(ref):
    """A mixed queue through both engines on 2 slots: the recurrent states
    and the ring of each prefill go into a free slot along their batch
    axes; completions identical byte for byte."""
    prompt_len, max_new, chunk, slots = 10, 10, 4, 2
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], slots=slots,
                        prompt_len=prompt_len, max_new=max_new, chunk=chunk)
    teng = tserve.make_queue_engine(model=ref["tm"], slots=slots,
                                    prompt_len=prompt_len, gen=max_new,
                                    chunk=chunk, device="cpu")
    jc = {c.uid: c for c in jeng.run(_requests(JRequest, prompt_len))}
    tc = {c.uid: c for c in teng.run(_requests(Request, prompt_len))}
    assert sorted(tc) == sorted(jc) == list(range(6))
    for uid in jc:
        assert tc[uid].finish_reason == jc[uid].finish_reason == "length"
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens)
    assert teng.stats["prefills"] == 6 > slots


def test_synth_requests_match_reference():
    from repro.launch.serve import synth_requests as jsynth
    want = jsynth(ARCH, requests=5, prompt_len=16, gen=8, seed=2)
    got = tserve.synth_requests(ARCH, requests=5, prompt_len=16, gen=8,
                                seed=2)
    for a, b in zip(got, want):
        assert (a.uid, a.max_new_tokens) == (b.uid, b.max_new_tokens)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_serve_queue_on_cpu():
    eng = tserve.serve_queue(ARCH, requests=5, slots=2, prompt_len=12, gen=6,
                             chunk=3, device="cpu")
    assert sorted(c.uid for c in eng.completions) == list(range(5))
    assert {c.finish_reason for c in eng.completions} == {"length"}
