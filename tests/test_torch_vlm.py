"""The port's VLM family (``TransformerLM`` with ``family="vlm"``:
precomputed patch embeddings prepended to the tokens) against the JAX
reference with the same weights, in fp32 on the CPU at ``pixtral-12b``'s
smoke size: the model's logits with patches within 1e-4; greedy tokens of
``serve()`` (its batch cut to ``prompt_len - P`` tokens after ``P`` patches,
as the reference builds it), of the speculative chunk and of
``ServeEngine`` (patches as a request's extras) byte-identical to the
reference's; the engine's extras errors typed as the reference types them.
The reference is built without a mesh."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.steps import make_generate_step as jmake  # noqa: E402
from repro.launch.steps import make_serving_jits  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.launch.steps import make_generate_step  # noqa: E402

ATOL = 1e-4
ARCH = "pixtral-12b"
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
         "REPRO_SPEC_K")
LAYOUTS = [("off", 0), ("int8", 0), ("off", 4)]


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


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _inputs(cfg, seed, batch, n_tok, n_patch):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, n_tok)).astype(np.int32)
    patch = rng.standard_normal((batch, n_patch, cfg.d_model)).astype(
        np.float32)
    return toks, patch


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_match_reference(mode):
    """The batch template: tokens cut to S - P, the patch prefix (P =
    min(num_patches, S // 2)); the decode template is not ported."""
    for arch in (ARCH, "pimref-100m", "mixtral-8x7b"):
        for S in (6, 16, 40):
            shape = dict(name="s", seq_len=S, global_batch=2, mode=mode)
            if mode == "decode":
                with pytest.raises(ValueError, match="decode"):
                    tspecs.input_specs(tconfigs.get_config(arch, smoke=True),
                                       tconfigs.ShapeConfig(**shape))
                continue
            want = jspecs.input_specs(get_config(arch, smoke=True),
                                      ShapeConfig(**shape))
            got = tspecs.input_specs(tconfigs.get_config(arch, smoke=True),
                                     tconfigs.ShapeConfig(**shape))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].shape == want[k].shape, (arch, S, k)
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)


def test_vlm_model_logits_match(ref):
    """forward, prefill (last and every position) and decode steps after a
    patch prefix, within 1e-4; caches and positions equal."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], _port(ref)
    toks, patch = _inputs(tm.cfg, 0, 3, 9, 5)
    batch = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patch)}
    with use_plan(plan):
        want = jm.forward(params, batch["tokens"], batch["patch_embeds"])
    got = tm(torch.from_numpy(toks), patch_embeds=torch.from_numpy(patch))
    assert got.shape == (3, 14, tm.cfg.vocab_size)
    _close(got, want)
    for full in (False, True):
        with use_plan(plan):
            jl, jc = jm.prefill(params, batch, max_len=24, full_logits=full)
        tl, tc = tm.prefill(torch.from_numpy(toks), max_len=24,
                            full_logits=full,
                            patch_embeds=torch.from_numpy(patch))
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for S in (1, 4, 1):
        feed = np.random.default_rng(S).integers(
            0, tm.cfg.vocab_size, (3, S)).astype(np.int32)
        with use_plan(plan):
            jl, jc = jm.decode_step(params, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tc, torch.from_numpy(feed))
        _close(tl, jl)
        np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                      np.asarray(jc["pos_ids"]))


def _jax_serve_tokens(r, *, batch, prompt_len, gen, chunk, seed):
    """The reference's serving programs on the reference serve()'s vlm
    batch: tokens cut to prompt_len - P, patches from the same draw."""
    cfg = r["jcfg"]
    prefill, generate, _, _ = make_serving_jits(
        r["jm"], r["plan"], max_len=prompt_len + gen, chunk=chunk)
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                       jnp.int32)
    npatch = min(cfg.num_patches, prompt_len // 2)
    pre = {"tokens": toks[:, :prompt_len - npatch],
           "patch_embeds": jnp.asarray(
               rng.standard_normal((batch, npatch, cfg.d_model)),
               jnp.float32)}
    logits, cache = prefill(r["params"], pre)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    key = jax.random.PRNGKey(seed + 1)
    chunks = []
    for _ in range(-(-gen // chunk)):
        cache, tok, key, _d, _n, out, _f = generate(r["params"], cache, tok,
                                                    key, jnp.int32(-1))
        chunks.append(np.asarray(out))
    return np.concatenate(chunks, axis=1)[:, :gen]


@pytest.mark.parametrize("kv_quant,pages", LAYOUTS)
def test_vlm_serve_matches_reference_and_loop(ref, kv_quant, pages,
                                              monkeypatch):
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    kw = dict(batch=2, prompt_len=20, gen=12, chunk=4, seed=1, device="cpu",
              cfg=ref["tcfg"], params=ref["np_params"], kv_quant=kv_quant,
              page_size=pages)
    fused = tserve.serve(engine="fused", **kw)
    loop = tserve.serve(engine="loop", **kw)
    want = _jax_serve_tokens(ref, batch=2, prompt_len=20, gen=12, chunk=4,
                             seed=1)
    np.testing.assert_array_equal(fused["tokens"], want)
    np.testing.assert_array_equal(loop["tokens"], fused["tokens"])
    spec = tserve.serve(engine="fused", spec="ngram", spec_k=3, **kw)
    np.testing.assert_array_equal(spec["tokens"], want)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_vlm_spec_chunk_matches_reference(ref, mode):
    """Three spec chunks (k 3) after a patch prefill: every output equal to
    the reference's spec step; the drafter's history holds the tokens
    only."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], _port(ref)
    K, chunk, gen, n_tok, n_patch = 3, 4, 16, 12, 8
    toks, patch = _inputs(tm.cfg, 2, 4, n_tok, n_patch)
    toks[:2] = np.tile(toks[:2, :3], 4)              # rows the drafter finds
    max_len = n_tok + n_patch + gen + K
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                     "patch_embeds": jnp.asarray(patch)},
                            max_len=max_len)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len,
                        patch_embeds=torch.from_numpy(patch))
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    h = np.zeros((4, n_tok + gen + chunk * (K + 1)), np.int32)
    h[:, :n_tok] = toks
    hl = np.full((4,), n_tok, np.int32)
    jh, jhl = jnp.asarray(h), jnp.asarray(hl)
    th, thl = torch.from_numpy(h.copy()), torch.from_numpy(hl.copy())
    jgen = jax.jit(jmake(jm, plan, chunk=chunk, spec=mode, spec_k=K))
    step = make_generate_step(tm, chunk=chunk, spec=mode, spec_k=K)
    key = jax.random.PRNGKey(0)
    for c in range(3):
        jo = jgen(params, jc, jtok, key, jnp.int32(-1), jh, jhl)
        to = step(tc, ttok, None, -1, th, thl)
        for i, (t, j) in enumerate(zip((to[1],) + to[3:],
                                       (jo[1],) + jo[3:])):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                          err_msg=f"chunk {c} output {i}")
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jo[0]["pos"]))
        jc, jtok, key, jh, jhl = jo[0], jo[1], jo[2], jo[6], jo[7]
        ttok = to[1]


def _queue(cfg, prompt_len, budgets, seed=0):
    """Requests with a patch prefix of the bucket's P rows as extras."""
    P = min(cfg.num_patches, prompt_len // 2)
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(budgets):
        t = rng.integers(1, cfg.vocab_size,
                         int(rng.integers(2, prompt_len - P + 1)))
        patch = rng.standard_normal((1, P, cfg.d_model)).astype(np.float32)
        out.append((i, t.astype(np.int32), n, {"patch_embeds": patch}))
    return out


@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("kv_quant,pages", LAYOUTS)
def test_vlm_engine_matches_reference(ref, kv_quant, pages, spec,
                                      monkeypatch):
    """A mixed queue of patch-prefixed prompts through 2 slots: completions
    equal the reference engine's (no prefix sharing: patches are not in the
    page key), every page back."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    kw = dict(slots=2, prompt_len=16, max_new=8, chunk=4)
    queue = _queue(ref["tcfg"], 16, [3, 8, 5, 2, 7])
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], spec=spec,
                        spec_k=3, **kw)
    jc = {c.uid: c for c in jeng.run([JRequest(u, t, n, extras=e)
                                      for u, t, n, e in queue])}
    teng = tserve.make_queue_engine(
        slots=2, prompt_len=16, gen=8, chunk=4, device="cpu",
        cfg=ref["tcfg"], params=ref["np_params"], kv_quant=kv_quant,
        page_size=pages, spec=spec, spec_k=3)
    tc = {c.uid: c for c in teng.run([Request(u, t, n, extras=e)
                                      for u, t, n, e in queue])}
    assert sorted(tc) == sorted(jc) == list(range(len(queue)))
    for uid in jc:
        assert tc[uid].finish_reason == jc[uid].finish_reason == "length"
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens,
                                      err_msg=f"request {uid}")
    if pages:
        assert not teng._share_ok and teng.stats["prefix_hits"] == 0
        assert teng._alloc.used == 0


def test_vlm_engine_extras_errors_typed_as_reference(ref):
    """A missing or misshaped patch extra and an unknown extra end in
    bad_request, a token field past the bucket's in prompt_too_long, as the
    reference types them; the engine drains on."""
    cfg = ref["tcfg"]
    P = min(cfg.num_patches, 16 // 2)
    ok = np.zeros((1, P, cfg.d_model), np.float32)
    cases = [
        (0, np.arange(1, 5), None),                                 # missing
        (1, np.arange(1, 5), {"patch_embeds": ok[:, :P - 1]}),      # shape
        (2, np.arange(1, 16 - P + 2), {"patch_embeds": ok}),        # long
        (3, np.arange(1, 5), {"patch_embeds": ok}),
    ]
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], slots=2,
                        prompt_len=16, max_new=3, chunk=2)
    teng = tserve.make_queue_engine(slots=2, prompt_len=16, gen=3, chunk=2,
                                    device="cpu", cfg=cfg,
                                    params=ref["np_params"])
    jc = {c.uid: c for c in jeng.run([JRequest(u, t, 3, extras=e)
                                      for u, t, e in cases])}
    tc = {c.uid: c for c in teng.run(
        [Request(u, t, 3, extras=e) for u, t, e in cases]
        + [Request(4, np.arange(1, 5), 3,
                   extras={"patch_embeds": ok, "src_embeds": ok})])}
    for uid in range(4):
        assert tc[uid].reason == jc[uid].reason, uid
        assert tc[uid].finish_reason == jc[uid].finish_reason
    assert [tc[u].reason for u in range(3)] == ["bad_request", "bad_request",
                                                "prompt_too_long"]
    np.testing.assert_array_equal(tc[3].tokens, jc[3].tokens)
    assert tc[4].reason == "bad_request"       # the port's difference
