"""The port's MoE family (``repro_torch.models.moe`` and ``TransformerLM``
with ``num_experts > 0``) against the JAX reference with the same weights,
on the CPU at smoke size: the routing (``idx``, ``pos``, ``keep``) exactly,
exact ties included; ``moe_ffn`` within 1e-5 in fp32 (2e-2 in bf16, with the
routing equal); ``moe_ffn_ref`` and ``load_balance_loss``; the model's
logits within 1e-4; greedy tokens of ``serve()``, the speculative chunk and
``ServeEngine`` byte-identical to the reference's in fp32. The reference is
built without a mesh, so its dispatch is one group, as the port's is.
Capacity is shared by every token of a call, so whole batches are compared,
never rows one by one."""
import warnings

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
from repro.launch.steps import make_generate_step as jmake  # noqa: E402
from repro.launch.steps import make_serving_jits  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import dense as jdense  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.launch.steps import make_generate_step  # noqa: E402
from repro_torch.launch.steps import spec_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ATOL = 1e-4
FFN_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
         "REPRO_SPEC_K")
ARCHS = ("mixtral-8x7b", "kimi-k2-1t-a32b")
# the serving layouts the engine tests run: (kv_quant, page_size)
LAYOUTS = [("off", 0), ("int8", 0), ("off", 4)]


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (get_config(arch, smoke=True).replace(**kw),
            tconfigs.get_config(arch, smoke=True).replace(**kw))


_REFS = {}


def _ref(arch):
    """Mesh-less fp32 smoke reference of ``arch`` and its weights as numpy
    arrays (built once per arch)."""
    if arch not in _REFS:
        jcfg, tcfg = _cfgs(arch)
        plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 4, "decode"),
                             None)
        jm = build_model(jcfg)
        with use_plan(plan):
            params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
        _REFS[arch] = dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm,
                           params=params,
                           np_params=jax.tree_util.tree_map(np.asarray,
                                                            params))
    return _REFS[arch]


def _port(r, kv_quant="off", page_size=0):
    return tserve.load_model(r["tcfg"].name, smoke=True, seed=0,
                             device="cpu", cfg=r["tcfg"],
                             params=r["np_params"], kv_quant=kv_quant,
                             page_size=page_size)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------
def _moe_params(cfg, seed, ties=False):
    """router (D, E) and experts as numpy fp32; with ``ties`` the router's
    columns come in equal pairs, so every token's probabilities tie."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    router = rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d)
    if ties:
        router[:, 1::2] = router[:, 0::2]
    return {"router": router,
            "wi_gate": rng.standard_normal((e, d, f)).astype(np.float32)
            / np.sqrt(d),
            "wi_up": rng.standard_normal((e, d, f)).astype(np.float32)
            / np.sqrt(d),
            "wo": rng.standard_normal((e, f, d)).astype(np.float32)
            / np.sqrt(f)}


def _jax_routing(cfg, p, x):
    """The reference's routing of one dispatch group (its moe_ffn's steps
    off a mesh): idx, pos, keep."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.num_experts, cfg.experts_per_token
    logits = jdense(x.reshape(T, D), p["router"], "td,de->te").astype(
        jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    oh = jax.nn.one_hot(idx.reshape(T * K), E, dtype=jnp.int32)
    pos = ((jnp.cumsum(oh, axis=0) - oh) * oh).sum(-1).reshape(T, K)
    return idx, pos, pos < jmoe._capacity(cfg, T)


def _ffn_case(arch, dtype, cf, shape, seed=0, ties=False):
    jcfg, tcfg = _cfgs(arch, compute_dtype=dtype)
    if cf is not None:
        jcfg, tcfg = (c.replace(capacity_factor=cf) for c in (jcfg, tcfg))
    p = _moe_params(tcfg, seed, ties)
    x = np.random.default_rng(seed + 1).standard_normal(
        shape + (tcfg.d_model,)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    return jcfg, tcfg, jp, tp, jx, tx


def _check_routing(jcfg, tcfg, jp, tp, jx, tx):
    idx, pos, keep = _jax_routing(jcfg, jp, jx)
    _, _, tidx, tpos, tkeep = tmoe.route(tcfg, tp["router"],
                                         tx.reshape(-1, tx.shape[-1]))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    return np.asarray(keep)


# (capacity factor, (B, S)): the default 1.25 at a decode step (4 slots) and
# at a prefill, and 8 (nothing dropped)
FFN_CASES = [(None, (4, 1)), (None, (2, 16)), (8.0, (2, 16))]


@pytest.mark.parametrize("arch", ARCHS)
def test_default_capacity_drops_choices(arch):
    """The default-capacity cases of test_moe_ffn_matches_reference drop
    choices (mixtral at the decode step, kimi at the prefill), so the
    drops are compared there."""
    dropped = 0
    for cf, shape in FFN_CASES:
        if cf is None:
            jcfg, tcfg, jp, tp, jx, tx = _ffn_case(arch, "float32", cf, shape)
            dropped += int((~_check_routing(jcfg, tcfg, jp, tp, jx,
                                            tx)).sum())
    assert dropped > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,shape", FFN_CASES,
                         ids=["decode", "prefill", "cf8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, cf, shape, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _ffn_case(arch, dtype, cf, shape)
    keep = _check_routing(jcfg, tcfg, jp, tp, jx, tx)
    if cf == 8.0:
        assert keep.all()
    want = jmoe.moe_ffn(jcfg, jp, jx)
    got = tmoe.moe_ffn(tcfg, tp, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want.astype(jnp.float32), FFN_ATOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_dense_oracle(arch):
    """At capacity factor 8 nothing is dropped: the dispatch equals every
    token through every expert (the reference's tests/test_core.py check),
    and the port's oracle equals the reference's, also when capacity
    drops."""
    jcfg, tcfg, jp, tp, jx, tx = _ffn_case(arch, "float32", 8.0, (2, 16))
    _close(tmoe.moe_ffn(tcfg, tp, tx), tmoe.moe_ffn_ref(tcfg, tp, tx), 1e-5)
    for respect in (True, False):
        _close(tmoe.moe_ffn_ref(tcfg, tp, tx, respect),
               jmoe.moe_ffn_ref(jcfg, jp, jx, respect), 1e-5)
    jcfg, tcfg, jp, tp, jx, tx = _ffn_case(arch, "float32", None, (2, 16))
    _close(tmoe.moe_ffn_ref(tcfg, tp, tx), jmoe.moe_ffn_ref(jcfg, jp, jx),
           1e-5)


@pytest.mark.parametrize("shape", [(4, 1), (2, 16)], ids=["decode", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_ties_take_the_lower_expert(arch, shape):
    """Equal router columns make every token's probabilities tie in pairs:
    top-k takes the lower expert first, as jax.lax.top_k does, and the
    positions, drops and outputs follow the reference's."""
    jcfg, tcfg, jp, tp, jx, tx = _ffn_case(arch, "float32", None, shape,
                                           ties=True)
    _check_routing(jcfg, tcfg, jp, tp, jx, tx)
    probs, _, idx, _, _ = tmoe.route(tcfg, tp["router"],
                                     tx.reshape(-1, tx.shape[-1]))
    top = torch.gather(probs, 1, idx)
    assert (top[:, 0] == top[:, 1]).all() and (idx[:, 0] < idx[:, 1]).all()
    _close(tmoe.moe_ffn(tcfg, tp, tx), jmoe.moe_ffn(jcfg, jp, jx), 1e-5)


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((24, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = rng.integers(0, 8, (24, 2)).astype(np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), 8)
    got = tmoe.load_balance_loss(torch.from_numpy(probs),
                                 torch.from_numpy(idx), 8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_logits_match(arch):
    """forward, prefill (last and every position) and decode steps (one
    token, a verify block, the first layer only) within 1e-4; the caches
    equal."""
    r = _ref(arch)
    jm, params, plan, tm = r["jm"], r["params"], r["plan"], _port(r)
    V = tm.cfg.vocab_size
    toks = _tokens(0, (3, 11), V)
    with use_plan(plan):
        want = jm.forward(params, jnp.asarray(toks))
    _close(tm(torch.from_numpy(toks)), want)
    for full in (False, True):
        with use_plan(plan):
            jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                                max_len=24, full_logits=full)
        tl, tc = tm.prefill(torch.from_numpy(toks), max_len=24,
                            full_logits=full)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
    for S, layers in ((1, None), (4, None), (1, 1)):
        feed = _tokens(S, (3, S), V)
        with use_plan(plan):
            jl, jc = jm.decode_step(params, jc, jnp.asarray(feed),
                                    layers=layers)
        tl, tc = tm.decode_step(tc, torch.from_numpy(feed), layers=layers)
        _close(tl, jl)
        _close(tc["v"], jc["v"])
        np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                      np.asarray(jc["pos_ids"]))


# a 70-token prompt: the reference's init draws the stacked experts at
# 1 / sqrt(num_experts) (its fan-in axis 1 of the (L, E, D, F) leaf), so the
# residual stream is large and the fp32 sums over 70 positions leave up to
# ~2.4e-4 on logits of ~4.4 (the dense model: 2.6e-5 at this length); the
# card-vs-CPU limit
RING_ATOL = 1e-3


def test_mixtral_sliding_window_ring_wraps():
    """mixtral's smoke window (64) with a prompt past it: the cache keeps
    the window and decode writes wrap the ring; greedy tokens equal, logits
    within RING_ATOL."""
    r = _ref("mixtral-8x7b")
    jm, params, plan, tm = r["jm"], r["params"], r["plan"], _port(r)
    assert tm.cache_len(90) == jm.cache_len(90) == 64
    toks = _tokens(5, (2, 70), tm.cfg.vocab_size)
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                            max_len=80)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=80)
    for _ in range(8):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        with use_plan(plan):
            jl, jc = jm.decode_step(params, jc, jt)
        tl, tc = tm.decode_step(tc, tt)
        _close(tl, jl, RING_ATOL)
    np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                  np.asarray(jc["pos_ids"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _jax_serve_tokens(r, *, batch, prompt_len, gen, chunk, seed):
    """The reference's fused serving programs on serve()'s synthetic
    batch."""
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


@pytest.mark.parametrize("kv_quant,pages", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_matches_reference_and_loop(arch, kv_quant, pages,
                                              monkeypatch):
    """serve()'s whole batch (rows share expert capacity), fused and
    per-token loop, against the reference's serving programs (batch 2 x
    prompt 16 + 12 in chunks of 4, as tests/test_serve_fast.py serves
    mixtral)."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    r = _ref(arch)
    kw = dict(batch=2, prompt_len=16, gen=12, chunk=4, seed=1, device="cpu",
              cfg=r["tcfg"], params=r["np_params"], kv_quant=kv_quant,
              page_size=pages)
    fused = tserve.serve(engine="fused", **kw)
    loop = tserve.serve(engine="loop", **kw)
    want = _jax_serve_tokens(r, batch=2, prompt_len=16, gen=12, chunk=4,
                             seed=1)
    np.testing.assert_array_equal(fused["tokens"], want)
    np.testing.assert_array_equal(loop["tokens"], fused["tokens"])


def test_spec_config_moe():
    """mixtral's sliding window turns speculation off (with a warning);
    kimi speculates."""
    mixtral = tserve.load_model("mixtral-8x7b", smoke=True, seed=0,
                                device="cpu")
    with pytest.warns(UserWarning, match="sliding"):
        assert spec_config(mixtral, "ngram", 3) == ("off", 0)
    kimi = tserve.load_model("kimi-k2-1t-a32b", smoke=True, seed=0,
                             device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert spec_config(kimi, "ngram", 3) == ("ngram", 3)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_kimi_spec_chunk_matches_reference(mode):
    """Three spec chunks (k 3) on kimi smoke: every output equal to the
    reference's spec step (a verify block's k + 1 tokens a row take expert
    capacity, so the drafts must be the reference's too)."""
    r = _ref("kimi-k2-1t-a32b")
    jm, params, plan, tm = r["jm"], r["params"], r["plan"], _port(r)
    K, chunk, gen = 3, 4, 16
    rng = np.random.default_rng(0)
    toks = np.stack([np.tile(rng.integers(1, 256, 4), 4) if i < 2
                     else rng.integers(1, 256, 16)
                     for i in range(4)]).astype(np.int32)
    max_len = 16 + gen + K
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                            max_len=max_len)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    h = np.zeros((4, 16 + gen + chunk * (K + 1)), np.int32)
    h[:, :16] = toks
    hl = np.full((4,), 16, np.int32)
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
        jc, jtok, key, jh, jhl = jo[0], jo[1], jo[2], jo[6], jo[7]
        ttok = to[1]


def _queue(vocab, prompt_len, budgets, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, vocab, int(rng.integers(3, prompt_len + 1)))
             .astype(np.int32), n) for i, n in enumerate(budgets)]


@pytest.mark.parametrize("kv_quant,pages", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_matches_reference(arch, kv_quant, pages, monkeypatch):
    """A mixed queue through 3 slots (slot reuse, partial budgets, free
    slots and bucket pads decoding beside live ones, all sharing expert
    capacity): completions equal the reference engine's; every page
    back."""
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    r = _ref(arch)
    kw = dict(slots=3, prompt_len=8, max_new=10, chunk=4)
    queue = _queue(r["jcfg"].vocab_size, 8, [3, 10, 5, 2, 7, 9])
    jeng = JServeEngine(r["jm"], r["params"], r["plan"], **kw)
    jc = {c.uid: c for c in jeng.run([JRequest(u, t, n)
                                      for u, t, n in queue])}
    teng = tserve.make_queue_engine(
        slots=3, prompt_len=8, gen=10, chunk=4, device="cpu", cfg=r["tcfg"],
        params=r["np_params"], kv_quant=kv_quant, page_size=pages)
    tc = {c.uid: c for c in teng.run([Request(u, t, n)
                                      for u, t, n in queue])}
    assert sorted(tc) == sorted(jc) == list(range(len(queue)))
    for uid in jc:
        assert tc[uid].finish_reason == jc[uid].finish_reason == "length"
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens,
                                      err_msg=f"request {uid}")
    if pages:
        assert teng._alloc.used == 0
