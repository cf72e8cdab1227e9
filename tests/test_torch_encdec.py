"""The port's encoder-decoder family (``EncDecLM``, seamless-m4t-large-v2 at
smoke size) against the mesh-less JAX reference with the same weights, in
fp32 on the CPU: parameter specs and the bridge both ways, the batch
template, ``encode`` / ``forward`` / ``prefill`` / ``decode_step`` logits
and caches (within 1e-4 of a tensor's largest |value|: two encoder layers
and a cross-attention make the self K reach ~20, where fp32 sums of
another order differ by ~1e-5 of it), greedy tokens of ``serve()`` in six
KV layouts, ``make_generate_step`` outputs and ``ServeEngine`` completions
in four (byte-identical, per layout: the reference's paged engine decodes
otherwise than its contiguous one), the extras' typed errors, the fallback
of speculation, and the non-causal decode of the cross-attention in every
cache layout against the reference's Pallas kernels in interpret mode."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.steps import make_generate_step as jmake  # noqa: E402
from repro.launch.steps import make_serving_jits  # noqa: E402
from repro.launch.steps import spec_config as jspec_config  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.launch.steps import cache_tensors  # noqa: E402
from repro_torch.launch.steps import make_generate_step  # noqa: E402
from repro_torch.launch.steps import spec_config  # noqa: E402
from repro_torch.models import (EncDecLM, count_params,  # noqa: E402
                                param_specs, reference_tree)

ARCH = "seamless-m4t-large-v2"
REL = 1e-4                    # of a tensor's largest |value|
INT8_ATOL = 2e-2              # int8 cache logits (chip_smoke.py's limit)
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
         "REPRO_SPEC_K")
SERVE_LAYOUTS = [("off", 0), ("int8", 0), ("int4", 0), ("auto", 0),
                 ("off", 4), ("int8", 4)]
ENGINE_LAYOUTS = [("off", 0), ("int8", 0), ("off", 4), ("int8", 4)]


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def ref():
    jcfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    tcfg = tconfigs.get_config(ARCH, smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 4, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params))


def _port(r, kv_quant="off", page_size=0):
    return tserve.load_model(ARCH, smoke=True, seed=0, device="cpu",
                             cfg=r["tcfg"], params=r["np_params"],
                             kv_quant=kv_quant, page_size=page_size)


def _rel(t, j, rel=REL):
    """|port - reference| within ``rel`` of the reference's largest
    |value|."""
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().cpu().float().numpy(), j,
                               atol=rel * max(float(np.abs(j).max()), 1e-30),
                               rtol=0)


def _inputs(cfg, seed, batch, n_tok, n_src):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, n_tok)).astype(np.int32)
    src = rng.standard_normal((batch, n_src, cfg.d_model)).astype(np.float32)
    return toks, src


# ---------------------------------------------------------------------------
# configs, specs, the bridge, the batch template
# ---------------------------------------------------------------------------
def test_encdec_specs_and_bridge_round_trip(ref):
    """The port's flat specs are the reference's with both layer stacks
    unrolled (shapes, dtypes, init kinds); the reference's weights load
    and ``reference_tree`` gives its tree back, stacks and all."""
    jspec = ref["jm"].param_specs()
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            jspec, is_leaf=lambda x: hasattr(x, "logical_axes"))[0]:
        name = ".".join(p.key for p in path)
        if name.split(".")[0] in ("enc_blocks", "dec_blocks"):
            top, rest = name.split(".", 1)
            for i in range(s.shape[0]):
                flat[f"{top}.{i}.{rest}"] = (s.shape[1:], s.init)
        else:
            flat[name] = (s.shape, s.init)
    mine = param_specs(ref["tcfg"])
    assert {n: (s.shape, s.init) for n, s in mine.items()} == flat
    assert all(s.dtype == torch.float32 for s in mine.values())
    tm = _port(ref)
    assert isinstance(tm, EncDecLM)
    assert dict(tm.named_parameters()).keys() == mine.keys()
    tree = reference_tree(dict(tm.named_parameters()))
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = jax.tree_util.tree_flatten_with_path(ref["np_params"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_, j) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(p))
    # the full-size count is the reference's model, not its analytic formula
    full = tconfigs.get_config(ARCH)
    assert count_params(full) == 2_034_784_256
    assert count_params(full) == tconfigs.param_count(full) + \
        (full.num_layers + 2) * full.d_model


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_encdec_input_specs_match_reference(mode):
    """The audio template adds ``src_embeds`` (B, int(S * ratio), D)."""
    for ratio in (1.0, 0.5, 1.5):
        for S in (6, 16, 33):
            shape = dict(name="s", seq_len=S, global_batch=2, mode=mode)
            want = jspecs.input_specs(
                get_config(ARCH, smoke=True).replace(src_len_ratio=ratio),
                ShapeConfig(**shape))
            got = tspecs.input_specs(
                tconfigs.get_config(ARCH, smoke=True).replace(
                    src_len_ratio=ratio), tconfigs.ShapeConfig(**shape))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].shape == want[k].shape, (ratio, S, k)
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


# ---------------------------------------------------------------------------
# the model: encode, forward, prefill, decode_step
# ---------------------------------------------------------------------------
def test_encdec_encode_forward_prefill_match(ref):
    """encode, forward (S != src) and prefill (last and every position)
    logits and caches, each within REL of its largest |value|."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], _port(ref)
    toks, src = _inputs(tm.cfg, 0, 3, 9, 13)
    with use_plan(plan):
        jenc = jm.encode(params, jnp.asarray(src))
        jf = jm.forward(params, jnp.asarray(src), jnp.asarray(toks))
    _rel(tm.encode(torch.from_numpy(src)), jenc)
    got = tm(torch.from_numpy(toks), torch.from_numpy(src))
    assert got.shape == (3, 9, tm.cfg.vocab_size)
    _rel(got, jf)
    batch = {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src)}
    for full in (False, True):
        with use_plan(plan):
            jlg, jc = jm.prefill(params, batch, max_len=20, full_logits=full)
        tlg, tc = tm.prefill(torch.from_numpy(toks), max_len=20,
                             full_logits=full,
                             src_embeds=torch.from_numpy(src))
        assert tlg.shape == jlg.shape
        _rel(tlg, jlg)
        for k in ("k", "v", "xk", "xv"):
            assert tuple(tc[k].shape) == jc[k].shape, k
            _rel(tc[k], jc[k])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert "pos_ids" not in tc
    with pytest.raises(ValueError, match="src_embeds"):
        tm.prefill(torch.from_numpy(toks))


@pytest.mark.parametrize("kv_quant,pages", [("off", 0), ("int8", 0),
                                            ("off", 4)])
def test_encdec_decode_steps_match(ref, kv_quant, pages, monkeypatch):
    """Teacher-forced decode steps after the prefill, past the prompt's
    cache length (writes clamp at T - 1): logits within REL (int8: within
    INT8_ATOL, every code within one step of the reference's: an fp32
    difference can tip an element over a rounding edge, which moves it by
    a grid step), self cache written in place (the same tensors),
    positions equal."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    jm, params, plan = ref["jm"], ref["params"], ref["plan"]
    tm = _port(ref, kv_quant, pages)
    toks, src = _inputs(tm.cfg, 1, 2, 7, 10)
    with use_plan(plan):
        jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                      "src_embeds": jnp.asarray(src)},
                             max_len=10)
    tlg, tc = tm.prefill(torch.from_numpy(toks), max_len=10,
                         src_embeds=torch.from_numpy(src))
    ptrs = [t.data_ptr() for t in cache_tensors(tc)]
    decode = jax.jit(jm.decode_step)
    feed = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 6))
    for i in range(feed.shape[1]):         # positions 7 .. 12, T = 12
        f = feed[:, i:i + 1].astype(np.int32)
        with use_plan(plan):
            jlg, jc = decode(params, jc, jnp.asarray(f))
        tlg, tc = tm.decode_step(tc, torch.from_numpy(f))
        if kv_quant == "off":
            _rel(tlg, jlg)
        else:
            np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                       atol=INT8_ATOL, rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if kv_quant != "off":
        for name in ("k", "v", "xk", "xv"):
            d = tc[name].codes.int().numpy() - np.asarray(jc[name].codes)
            assert np.abs(d).max() <= 1, name
    assert ptrs == [t.data_ptr() for t in cache_tensors(tc)]
    if (kv_quant, pages) == ("off", 0):
        _rel(tc["k"], jc["k"])
    with pytest.raises(ValueError, match="one token"):
        tm.decode_step(tc, torch.zeros((2, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# serving: serve(), the fused chunk, the engine
# ---------------------------------------------------------------------------
def _jax_serve_tokens(r, *, batch, prompt_len, gen, chunk, seed):
    """The reference's serving programs on the reference serve()'s audio
    batch: the tokens, then prompt_len source frames from the same draw."""
    cfg = r["jcfg"]
    prefill, generate, _, _ = make_serving_jits(
        r["jm"], r["plan"], max_len=prompt_len + gen, chunk=chunk)
    rng = np.random.default_rng(seed)
    pre = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size,
                                              (batch, prompt_len)), jnp.int32),
           "src_embeds": jnp.asarray(rng.standard_normal(
               (batch, prompt_len, cfg.d_model)), jnp.float32)}
    logits, cache = prefill(r["params"], pre)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    key = jax.random.PRNGKey(seed + 1)
    chunks = []
    for _ in range(-(-gen // chunk)):
        cache, tok, key, _d, _n, out, _f = generate(r["params"], cache, tok,
                                                    key, jnp.int32(-1))
        chunks.append(np.asarray(out))
    return np.concatenate(chunks, axis=1)[:, :gen]


@pytest.mark.parametrize("kv_quant,pages", SERVE_LAYOUTS)
def test_encdec_serve_matches_reference_and_loop(ref, kv_quant, pages,
                                                 monkeypatch):
    """serve()'s greedy tokens, fused and per-token loop, equal the
    reference's serving programs under the matching knobs."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    kw = dict(batch=2, prompt_len=12, gen=10, chunk=4, seed=1, device="cpu",
              cfg=ref["tcfg"], params=ref["np_params"], kv_quant=kv_quant,
              page_size=pages)
    fused = tserve.serve(engine="fused", **kw)
    loop = tserve.serve(engine="loop", **kw)
    want = _jax_serve_tokens(ref, batch=2, prompt_len=12, gen=10, chunk=4,
                             seed=1)
    np.testing.assert_array_equal(fused["tokens"], want)
    np.testing.assert_array_equal(loop["tokens"], fused["tokens"])


@pytest.mark.parametrize("kv_quant,pages", [("off", 0), ("int8", 4)])
def test_encdec_generate_step_matches_reference(ref, kv_quant, pages,
                                                monkeypatch):
    """Three fused chunks after a prefill: tok, done, n_valid, toks and
    failed equal the reference's jitted step (EOS set to a token the
    first chunk emits), positions equal."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    jm, params, plan = ref["jm"], ref["params"], ref["plan"]
    tm = _port(ref, kv_quant, pages)
    toks, src = _inputs(tm.cfg, 2, 3, 8, 8)
    max_len, chunk = 8 + 12, 4
    with use_plan(plan):
        jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                      "src_embeds": jnp.asarray(src)},
                             max_len=max_len)
    tlg, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len,
                         src_embeds=torch.from_numpy(src))
    jtok = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tlg[:, -1:], dim=-1).to(torch.int32)
    jgen = jax.jit(jmake(jm, plan, chunk=chunk))
    step = make_generate_step(tm, chunk=chunk)
    key = jax.random.PRNGKey(0)
    eos = -1
    for c in range(3):
        jo = jgen(params, jc, jtok, key, jnp.int32(eos))
        to = step(tc, ttok, None, eos)
        for i, (t, j) in enumerate(zip((to[1],) + to[3:], (jo[1],) + jo[3:])):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                          err_msg=f"chunk {c} output {i}")
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jo[0]["pos"]))
        if c == 0:
            eos = int(np.asarray(jo[5])[1, 2])   # a later chunk stops there
        jc, jtok, key, ttok = jo[0], jo[1], jo[2], to[1]


def _queue(cfg, prompt_len, budgets, seed=0):
    """Requests of mixed lengths, each with the bucket's source frames."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(budgets):
        t = rng.integers(1, cfg.vocab_size,
                         int(rng.integers(2, prompt_len + 1)))
        src = rng.standard_normal((1, prompt_len, cfg.d_model)).astype(
            np.float32)
        out.append((i, t.astype(np.int32), n, {"src_embeds": src}))
    return out


@pytest.mark.parametrize("kv_quant,pages", ENGINE_LAYOUTS)
def test_encdec_engine_matches_reference(ref, kv_quant, pages, monkeypatch):
    """A mixed queue with source frames through 2 slots: completions and
    the KV byte accounting equal the reference engine's in the same layout;
    no prefix sharing (frames are not in the page key), every page back."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    kw = dict(slots=2, prompt_len=12, max_new=8, chunk=4)
    queue = _queue(ref["tcfg"], 12, [3, 8, 5, 2, 7])
    # both watchdogs off (a threshold no chunk reaches): a loaded host's
    # slow chunks would halve the chunk and move the page accounting
    # (ROADMAP §C)
    off = dict(straggler_threshold=1e9)
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], **kw, **off)
    jc = {c.uid: c for c in jeng.run([JRequest(u, t, n, extras=e)
                                      for u, t, n, e in queue])}
    teng = tserve.make_queue_engine(
        slots=2, prompt_len=12, gen=8, chunk=4, device="cpu",
        cfg=ref["tcfg"], params=ref["np_params"], kv_quant=kv_quant,
        page_size=pages, **off)
    tc = {c.uid: c for c in teng.run([Request(u, t, n, extras=e)
                                      for u, t, n, e in queue])}
    assert sorted(tc) == sorted(jc) == list(range(len(queue)))
    for uid in jc:
        assert tc[uid].finish_reason == jc[uid].finish_reason == "length"
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens,
                                      err_msg=f"request {uid}")
    for k in ("kv_hbm_bytes_peak", "kv_bytes_per_token", "prefills",
              "prefix_hits"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["prefix_hits"] == 0
    if pages:
        assert not teng._share_ok and teng._alloc.used == 0
        assert not teng.cache["xk"].__class__.__name__.startswith("Paged")


def test_encdec_engine_extras_errors_typed_as_reference(ref):
    """A missing or misshaped source extra ends in bad_request, as the
    reference types it, and launches nothing; the engine drains on."""
    cfg = ref["tcfg"]
    ok = np.zeros((1, 12, cfg.d_model), np.float32)
    cases = [(0, np.arange(1, 5), None),
             (1, np.arange(1, 5), {"src_embeds": ok[:, :11]}),
             (2, np.arange(1, 5), {"src_embeds": ok})]
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], slots=2,
                        prompt_len=12, max_new=3, chunk=2)
    teng = tserve.make_queue_engine(slots=2, prompt_len=12, gen=3, chunk=2,
                                    device="cpu", cfg=cfg,
                                    params=ref["np_params"])
    jc = {c.uid: c for c in jeng.run([JRequest(u, t, 3, extras=e)
                                      for u, t, e in cases])}
    tc = {c.uid: c for c in teng.run([Request(u, t, 3, extras=e)
                                      for u, t, e in cases])}
    for uid in range(3):
        assert tc[uid].reason == jc[uid].reason, uid
        assert tc[uid].finish_reason == jc[uid].finish_reason
    assert [tc[u].reason for u in range(2)] == ["bad_request"] * 2
    np.testing.assert_array_equal(tc[2].tokens, jc[2].tokens)
    assert teng.stats["prefills"] == 1


def test_encdec_spec_falls_back_to_off(ref):
    """Speculation is for the decoder-only families: the port warns and
    falls back to off for the enc-dec model, as the reference does."""
    tm = _port(ref)
    for mode in ("ngram", "draft"):
        with pytest.warns(UserWarning, match="falling back"):
            got = spec_config(tm, mode, 3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jspec_config(ref["jm"], mode, 3)
        assert got == want == ("off", 0)
    with pytest.warns(UserWarning):
        out = tserve.serve(batch=1, prompt_len=6, gen=4, chunk=2,
                           device="cpu", cfg=ref["tcfg"],
                           params=ref["np_params"], spec="ngram")
    assert out["tokens"].shape == (1, 4)


# ---------------------------------------------------------------------------
# the cross-attention's non-causal decode in every cache layout
# ---------------------------------------------------------------------------
def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _codes(rng, shape, mode):
    q = jl.kv_quantize(jnp.asarray(_np(rng, *shape)), mode)
    return np.array(q.codes), np.array(q.scale)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("layout", ["dense", "int8", "int4", "paged",
                                    "paged_int8"])
@pytest.mark.parametrize("G", [1, 2])
def test_noncausal_decode_matches_reference_kernels(layout, G):
    """One q row a slot (q position 0, as the cross-attention passes it)
    over every source row, non-causal: the plain version of each decode
    layout against the reference's Pallas kernel in interpret mode, within
    1e-5 (fp32, summation order); T 37 is no multiple of a tile, and the
    paged case reads a permuted table with a trash page past the end."""
    rng = np.random.default_rng(G * 10 + len(layout))
    B, Hkv, D, T, ps = 3, 2, 16, 37, 8
    q = _np(rng, B, 1, Hkv * G, D)
    qp = np.zeros((B, 1), np.int32)
    kw = dict(causal=False, window=0, softcap=0.0)
    if layout in ("dense", "int8", "int4"):
        kp = np.tile(np.arange(T, dtype=np.int32), (B, 1))
        if layout == "dense":
            ops = (_np(rng, B, T, Hkv, D), _np(rng, B, T, Hkv, D))
            jfn, tfn = jops.flash_decode, tops.flash_decode
            extra = dict(block_k=16)
        else:
            ops = (_codes(rng, (B, T, Hkv, D), layout)
                   + _codes(rng, (B, T, Hkv, D), layout))
            jfn, tfn = jops.flash_decode_quant, tops.flash_decode_quant
            extra = dict(block_k=16)
        # the reference kernels take whole tiles: pad T to 48, masked
        pad = 48 - T
        jops_in = [np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
                   for a in ops]
        jkp = np.pad(kp, ((0, 0), (0, pad)), constant_values=-1)
        want = jfn(*(jnp.asarray(a) for a in (q, *jops_in, qp, jkp)),
                   interpret=True, **extra, **kw)
        got = tfn(*_t(q, *ops, qp, kp), **kw)
    else:
        NP = 5
        P = 1 + B * NP
        kp = np.tile(np.arange(NP * ps, dtype=np.int32), (B, 1))
        kp[:, T:] = -1                     # the source ends inside a page
        table = (rng.permutation(B * NP) + 1).astype(np.int32).reshape(B, NP)
        table[0, -1] = 0                   # a page past the end: trash
        if layout == "paged":
            ops = (_np(rng, P, ps, Hkv, D), _np(rng, P, ps, Hkv, D))
            jfn, tfn = jops.flash_decode_paged, tops.flash_decode_paged
        else:
            ops = (_codes(rng, (P, ps, Hkv, D), "int8")
                   + _codes(rng, (P, ps, Hkv, D), "int8"))
            jfn = jops.flash_decode_paged_quant
            tfn = tops.flash_decode_paged_quant
        want = jfn(*(jnp.asarray(a) for a in (q, *ops, table, qp, kp)),
                   interpret=True, **kw)
        got = tfn(*_t(q, *ops, table, qp, kp), **kw)
    assert got.shape == (B, 1, Hkv * G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
