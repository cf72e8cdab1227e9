"""What a CUDA graph of the port's fused decode chunk needs, checked on the
CPU at smoke size for ``pimref-100m`` in its six KV layouts and for
``recurrentgemma-2b``: a decode step and a chunk keep every cache tensor
(the same object at the same address, ``pos`` advanced in place); a chunk
reads nothing back to the host; the EOS id may be a device scalar (against
the JAX reference's fused step, which takes it as a traced scalar); the
sampler draws as ``torch.multinomial`` does, and a NaN row does not raise.
The graph itself runs on the card: ``tests/test_torch_graph_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch.steps import make_generate_step as jmake  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import launch_counters  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (cache_tensors, clone_cache,  # noqa: E402
                                      decode_chunk, make_generate_step,
                                      sample_tokens)

KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")
PS = 4
# (arch, kv_quant, page_size): pimref's six layouts and Griffin's one
CASES = [("pimref-100m", "off", 0), ("pimref-100m", "int8", 0),
         ("pimref-100m", "int4", 0), ("pimref-100m", "auto", 0),
         ("pimref-100m", "off", PS), ("pimref-100m", "int8", PS),
         ("recurrentgemma-2b", "off", 0)]
IDS = [f"{a.split('-')[0]}-{q}-{p}" for a, q, p in CASES]
# the host reads a capture cannot hold
SYNCS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist",
         "numpy", "cpu")


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _model(arch, kv_quant="off", page_size=0):
    cfg = tconfigs.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    return tserve.load_model(arch, smoke=True, seed=0, device="cpu", cfg=cfg,
                             kv_quant=kv_quant, page_size=page_size)


def _prefill(model, B=2, S=9, max_len=40, seed=3):
    """Griffin's smoke window is 32, so max_len 40 wraps its ring."""
    toks = np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = model.prefill(torch.from_numpy(toks), max_len=max_len)
    return cache, torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def _addresses(cache):
    return [(t, t.data_ptr()) for t in cache_tensors(cache)]


def _same_tensors(cache, before):
    now = list(cache_tensors(cache))
    assert len(now) == len(before)
    for t, (t0, ptr) in zip(now, before):
        assert t is t0 and t.data_ptr() == ptr


@pytest.mark.parametrize("arch,kv_quant,pages", CASES, ids=IDS)
def test_decode_keeps_every_cache_tensor(arch, kv_quant, pages):
    """After a one-token step, a verify block of 3 and a fused chunk of 4,
    every cache tensor is the same object at the same address and ``pos``
    advanced by the tokens fed."""
    model = _model(arch, kv_quant, pages)
    cache, tok = _prefill(model, S=20 if pages else 9)
    before = _addresses(cache)
    pos = cache["pos"].clone()
    _, out = model.decode_step(cache, tok)
    assert out is cache
    _same_tensors(cache, before)
    assert torch.equal(cache["pos"], pos + 1)
    if arch == "pimref-100m":           # Griffin decodes one token a step
        model.decode_step(cache, tok.repeat(1, 3))
        _same_tensors(cache, before)
        assert torch.equal(cache["pos"], pos + 4)
    step = make_generate_step(model, chunk=4)
    out = step(cache, tok, None, -1)
    assert out[0] is cache
    _same_tensors(cache, before)
    assert torch.equal(cache["pos"], pos + (8 if arch == "pimref-100m" else 5))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
@pytest.mark.parametrize("arch,kv_quant,pages", CASES, ids=IDS)
def test_chunk_reads_nothing_back(monkeypatch, arch, kv_quant, pages,
                                  temperature, top_k):
    """One chunk (greedy, and sampled top-k) with every host read of a
    tensor patched to raise: what a CUDA graph capture refuses on the
    card, found on the CPU. The plain kernel versions the CPU runs need
    no stand-in."""
    model = _model(arch, kv_quant, pages)
    cache, tok = _prefill(model)
    eos = torch.tensor(7, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read of a tensor in the decode chunk")

    for name in SYNCS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = decode_chunk(model, cache, tok, gen, eos, chunk=3,
                       temperature=temperature, top_k=top_k)
    monkeypatch.undo()
    assert out[3].shape == (2, 3) and out[0].shape == (2, 1)


def test_sync_guard_catches_a_host_read(monkeypatch):
    """The guard above is live: ``int`` of a tensor raises under it."""
    t = torch.ones(())

    def refuse(self, *args, **kwargs):
        raise AssertionError("host read")

    monkeypatch.setattr(torch.Tensor, "__int__", refuse)
    with pytest.raises(AssertionError, match="host read"):
        int(t)


@pytest.mark.parametrize("arch,kv_quant,pages", CASES, ids=IDS)
def test_eos_device_scalar_equals_int(arch, kv_quant, pages):
    """A 0-d int32 EOS id gives the tokens, flags and counts of the int,
    with EOS hit mid-chunk."""
    model = _model(arch, kv_quant, pages)
    cache, tok = _prefill(model)
    step = make_generate_step(model, chunk=6)
    free = step(clone_cache(cache), tok.clone(), None, -1)[5]
    eos = int(free[1, 3])
    want = step(clone_cache(cache), tok.clone(), None, eos)
    got = step(cache, tok, None, torch.tensor(eos, dtype=torch.int32))
    for i in (1, 3, 4, 5, 6):
        assert torch.equal(got[i], want[i]), i
    assert bool(got[3][1])
    assert torch.equal(cache["pos"], want[0]["pos"])


@pytest.fixture(scope="module", params=["pimref-100m", "recurrentgemma-2b"])
def ref(request):
    """A mesh-less fp32 smoke reference and the port model with its
    weights."""
    arch = request.param
    jcfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    tcfg = tconfigs.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 40, 2, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tm = tserve.load_model(arch, smoke=True, seed=0, device="cpu", cfg=tcfg,
                           params=jax.tree_util.tree_map(np.asarray, params))
    return dict(jm=jm, params=params, plan=plan, tm=tm)


def test_chunk_with_eos_scalar_matches_jax(ref):
    """Two fused chunks through a window wrap (Griffin) with the EOS id a
    device scalar, against the reference's jitted fused step with a traced
    one: tokens, done, n_valid and failed identical."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], ref["tm"]
    toks = np.random.default_rng(5).integers(0, 256, (2, 28)).astype(np.int32)
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=40)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=40)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    jgen = jax.jit(jmake(jm, plan, chunk=6))
    free = np.asarray(jgen(params, jax.tree_util.tree_map(jnp.copy, jc), jtok,
                           jax.random.PRNGKey(0), jnp.int32(-1))[5])
    eos = int(free[0, 4])
    step = make_generate_step(tm, chunk=6)
    teos = torch.tensor(eos, dtype=torch.int32)
    for _ in range(2):
        jout = jgen(params, jc, jtok, jax.random.PRNGKey(0), jnp.int32(eos))
        tout = step(tc, ttok, None, teos)
        for i in (1, 3, 4, 5, 6):    # tok, done, n_valid, toks, failed
            np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
        jc, jtok, tc, ttok = jout[0], jout[1], tout[0], tout[1]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert bool(tout[3][0])


@pytest.mark.parametrize("top_k", [0, 5])
def test_sampler_draws_as_multinomial(top_k):
    """The exponential race draws what ``torch.multinomial`` draws from
    the same generator state, and only from the top k."""
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, 1, 300)).astype(np.float32)) * 3
    for seed in range(8):
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        got = sample_tokens(logits, g1, temperature=0.7, top_k=top_k)
        lf = (logits / 0.7).reshape(6, 300)
        if top_k:
            kth = torch.topk(lf, top_k, dim=-1).values[:, -1:]
            lf = torch.where(lf < kth, torch.full_like(lf, -1e30), lf)
        want = torch.multinomial(torch.softmax(lf, -1), 1, generator=g2)
        assert torch.equal(got.reshape(-1), want[:, 0].int())
        if top_k:
            top = torch.topk(logits, top_k, dim=-1).indices
            assert bool((top == got[..., None]).any(-1).all())


def test_sampler_survives_non_finite_logits():
    """A slot of NaN logits draws some index instead of raising (the chunk
    then re-feeds its last token); the other slot draws as before."""
    logits = torch.zeros((2, 50))
    logits[1] = float("nan")
    out = sample_tokens(logits, torch.Generator().manual_seed(0), 1.0, 0)
    assert out.shape == (2,) and 0 <= int(out[0]) < 50


def test_prepare_leaves_cache_tok_and_generator(monkeypatch):
    """On the CPU ``prepare`` is the warm-up alone: one eager chunk on a
    copy; the cache, ``tok`` and the caller's generator are untouched, and
    no capture is counted."""
    model = _model("pimref-100m", "int8", PS)
    cache, tok = _prefill(model)
    want = [t.clone() for t in cache_tensors(cache)]
    tok0 = tok.clone()
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    step = make_generate_step(model, chunk=3, temperature=1.0, top_k=4)
    step.prepare(cache, tok, gen)
    assert all(torch.equal(a, b) for a, b in zip(cache_tensors(cache), want))
    assert torch.equal(tok, tok0) and torch.equal(gen.get_state(), state)
    assert step.captures == 0 and step.capture_seconds == 0.0


def test_engine_eos_set_between_chunks():
    """Setting ``eos_id`` on a running engine takes effect at its next
    chunk, through the engine's device scalar; the CPU engine counts no
    capture."""
    model = _model("pimref-100m")
    eng = tserve.make_queue_engine(model=model, slots=2, prompt_len=8, gen=12,
                                   chunk=3, device="cpu")
    probe = tserve.make_queue_engine(model=model, slots=2, prompt_len=8,
                                     gen=12, chunk=3, device="cpu")
    req = dict(uid=0, tokens=np.arange(1, 7, dtype=np.int32),
               max_new_tokens=12)
    stream = probe.run([tserve.Request(**req)])[0].tokens
    eng.submit(tserve.Request(**req))
    eng.step()                           # the first chunk: no EOS armed
    eng.eos_id = int(stream[4])
    eng.run()
    got = eng.completions[0]
    assert got.finish_reason == "eos"
    assert list(got.tokens) == list(stream[:list(stream).index(
        stream[4], 3) + 1])
    assert eng.stats["graph_captures"] == 0
    assert eng.stats["decode_steps"] == 3 * eng.stats["decode_dispatches"]


def test_launch_counters_cover_every_kernel_module():
    from repro_torch.kernels.flash_attention import LAUNCHES as attn
    from repro_torch.kernels.narrow_value import LAUNCHES as nv
    from repro_torch.kernels.quant_matmul import LAUNCHES as qmm
    from repro_torch.kernels.rglru import LAUNCHES as rglru
    got = launch_counters()
    assert len(got) == 4
    assert all(any(c is d for c in got) for d in (attn, nv, qmm, rglru))
