"""The port's serving stack (repro_torch.launch) against the JAX serving
programs and engine with the same weights, in fp32 on the CPU: batch-mode
serve(), the fused decode loop, the continuous-batching engine (EOS and
error completions included), sampling; and the port's import and device
guards."""
import os
import subprocess
import sys

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
from repro_torch.launch.steps import (make_generate_step,  # noqa: E402
                                      sample_tokens)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def ref():
    """Mesh-less fp32 smoke reference and its weights as numpy arrays."""
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 4, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params))


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


@pytest.mark.parametrize("gen,chunk", [(12, 4), (10, 8)])
def test_serve_matches_jax_and_loop(ref, gen, chunk):
    kw = dict(batch=3, prompt_len=9, gen=gen, chunk=chunk, seed=1,
              device="cpu", cfg=ref["tcfg"], params=ref["np_params"])
    fused = tserve.serve(engine="fused", **kw)
    loop = tserve.serve(engine="loop", **kw)
    want = _jax_serve_tokens(ref, batch=3, prompt_len=9, gen=gen, chunk=chunk,
                             seed=1)
    np.testing.assert_array_equal(fused["tokens"], want)
    np.testing.assert_array_equal(loop["tokens"], fused["tokens"])
    assert fused["dispatches"] == -(-gen // chunk) and loop["dispatches"] == gen
    assert fused["prefills"] == 1
    assert fused["decode_steps"] == chunk * (1 + -(-gen // chunk))
    assert loop["decode_steps"] == gen + 1


def _requests(cls, vocab, prompt_len):
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=rng.integers(1, vocab,
                                           rng.integers(3, prompt_len + 1)),
                max_new_tokens=n)
            for i, n in enumerate([3, 10, 5, 2, 7])]


def test_engine_drain_matches_jax_engine(ref):
    """The mixed-queue drain of tests/test_serve_fast.py through both
    engines: identical completions, slot reuse, EOS on device, and typed
    error completions for an over-long and an empty prompt."""
    prompt_len, max_new, chunk, slots = 8, 10, 4, 2
    V = ref["jcfg"].vocab_size
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], slots=slots,
                        prompt_len=prompt_len, max_new=max_new, chunk=chunk)
    teng = tserve.make_queue_engine(slots=slots, prompt_len=prompt_len,
                                    gen=max_new, chunk=chunk, device="cpu",
                                    cfg=ref["tcfg"], params=ref["np_params"])
    jc = {c.uid: c for c in jeng.run(_requests(JRequest, V, prompt_len))}
    tc = {c.uid: c for c in teng.run(_requests(Request, V, prompt_len))}
    assert sorted(tc) == sorted(jc) == list(range(5))
    for uid in jc:
        assert tc[uid].finish_reason == jc[uid].finish_reason == "length"
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens)
    assert teng.stats["prefills"] == 5 > slots
    assert teng.stats["decode_dispatches"] < teng.stats["tokens_out"]

    # EOS: the fifth token of request 1's stream stops it, on both engines
    probe = [int(t) for t in jc[1].tokens] + [-1]
    eos = probe[4]
    prompt = _requests(Request, V, prompt_len)[1].tokens
    bad = [(97, np.arange(1, prompt_len + 3)), (98, np.zeros(0, np.int64))]
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        eng.eos_id = eos
        eng.submit(cls(uid=99, tokens=prompt, max_new_tokens=max_new))
        for uid, toks in bad:
            eng.submit(cls(uid=uid, tokens=toks, max_new_tokens=4))
        eng.run()
    jd = {c.uid: c for c in jeng.completions}
    td = {c.uid: c for c in teng.completions}
    assert td[99].finish_reason == jd[99].finish_reason == "eos"
    np.testing.assert_array_equal(td[99].tokens, jd[99].tokens)
    assert list(td[99].tokens) == probe[:probe.index(eos) + 1]
    for uid, reason in ((97, "prompt_too_long"), (98, "bad_request")):
        assert td[uid].finish_reason == jd[uid].finish_reason == "error"
        assert td[uid].reason == jd[uid].reason == reason
    assert len(teng.completions) == len(jeng.completions) == 8


def test_generate_step_matches_jax(ref):
    """One fused chunk with EOS armed: tokens, done, n_valid, failed."""
    from repro.launch.steps import make_generate_step as jmake
    jm, params, plan = ref["jm"], ref["params"], ref["plan"]
    tm = tserve.load_model("pimref-100m", smoke=True, seed=0, device="cpu",
                           cfg=ref["tcfg"], params=ref["np_params"])
    toks = np.random.default_rng(3).integers(0, 256, (3, 6)).astype(np.int32)
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=20)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=20)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    jgen = jax.jit(jmake(jm, plan, chunk=8))
    free = jgen(params, jax.tree_util.tree_map(jnp.copy, jc), jtok,
                jax.random.PRNGKey(0), jnp.int32(-1))[5]
    eos = int(np.asarray(free)[1, 3])
    jout = jgen(params, jc, jtok, jax.random.PRNGKey(0), jnp.int32(eos))
    tout = make_generate_step(tm, chunk=8)(tc, ttok, None, eos)
    for i in (1, 3, 4, 5, 6):        # tok, done, n_valid, toks, failed
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    assert bool(tout[3][1])


def test_generate_step_quarantines_non_finite_slot(ref):
    """A slot whose logits go non-finite is failed; its count stops with the
    last token sampled from finite logits and its re-feed freezes, while
    the other slots decode on."""
    tm = tserve.load_model("pimref-100m", smoke=True, seed=0, device="cpu",
                           cfg=ref["tcfg"], params=ref["np_params"])
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 5)).astype(np.int32))
    _, clean = tm.prefill(toks, max_len=16)
    _, cache = tm.prefill(toks, max_len=16)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    gen = make_generate_step(tm, chunk=6)
    want = gen(clean, tok, None, -1)
    calls = {"n": 0}
    real = tm.decode_step

    def poisoned(cache, tokens, layers=None):
        logits, cache = real(cache, tokens, layers)
        calls["n"] += 1
        if calls["n"] == 3:
            logits[1] = float("nan")
        return logits, cache

    tm.decode_step = poisoned
    _, _, _, done, n_valid, out, failed = gen(cache, tok, None, -1)
    assert failed.tolist() == [False, True] and not done.any()
    assert n_valid.tolist() == [6, 3]
    assert torch.equal(out[0], want[5][0])
    assert torch.equal(out[1, :3], want[5][1, :3])
    assert (out[1, 3:] == out[1, 2]).all()


def test_engine_rejects_out_of_range_ids_and_extras(ref):
    """Ids outside the vocabulary and extras for a family that takes none
    end in bad_request completions; the engine drains on."""
    eng = tserve.make_queue_engine(slots=2, prompt_len=8, gen=3, chunk=2,
                                   device="cpu", cfg=ref["tcfg"],
                                   params=ref["np_params"])
    V = ref["tcfg"].vocab_size
    comps = {c.uid: c for c in eng.run([
        Request(uid=0, tokens=np.asarray([1, V]), max_new_tokens=3),
        Request(uid=1, tokens=np.asarray([-1, 2]), max_new_tokens=3),
        Request(uid=2, tokens=np.asarray([3, 4]), max_new_tokens=3,
                extras={"patch_embeds": np.zeros((1, 2, 64), np.float32)}),
        Request(uid=3, tokens=np.asarray([5, 6]), max_new_tokens=3)])}
    assert [comps[u].reason for u in range(3)] == ["bad_request"] * 3
    assert comps[3].finish_reason == "length" and len(comps[3].tokens) == 3


def test_sample_tokens_modes():
    logits = torch.tensor([[0.1, 3.0, -1.0, 0.5], [2.0, 0.0, 1.9, -2.0]])
    assert sample_tokens(logits).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    top1 = sample_tokens(logits, gen, temperature=1.0, top_k=1)
    assert top1.tolist() == [1, 0] and top1.dtype == torch.int32
    for seed in range(20):
        s = sample_tokens(logits, torch.Generator().manual_seed(seed),
                          temperature=5.0, top_k=2)
        assert int(s[0]) in (1, 3) and int(s[1]) in (0, 2)
    tied = torch.tensor([[1.0, 5.0, 5.0, 0.0]])
    assert sample_tokens(tied).tolist() == [1]          # first maximum


def test_synth_requests_match_reference():
    from repro.launch.serve import synth_requests as jsynth
    want = jsynth("pimref-100m", requests=6, prompt_len=16, gen=8, seed=3)
    got = tserve.synth_requests("pimref-100m", requests=6, prompt_len=16,
                                gen=8, seed=3)
    for a, b in zip(got, want):
        assert (a.uid, a.max_new_tokens) == (b.uid, b.max_new_tokens)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_serve_queue_on_cpu():
    eng = tserve.serve_queue(requests=5, slots=2, prompt_len=12, gen=6,
                             chunk=3, device="cpu")
    assert sorted(c.uid for c in eng.completions) == list(range(5))
    assert {c.finish_reason for c in eng.completions} == {"length"}


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.make_queue_engine()


def test_port_imports_no_jax_and_no_reference():
    """Every repro_torch module (the Griffin model, the RG-LRU kernel, the
    narrow-value and quantized-matmul kernels, the Proteus host layer and
    the training stack: train loop, optimizers, data, checkpoints, fault
    tolerance and chaos, the attention kernel under autograd, the fleet and
    its dispatcher, the MoE layer, the encoder-decoder and xLSTM models,
    every architecture's config, smoke model and weightless training
    model, the RG-LRU recurrence under autograd, the MIMDRAM planner, DaPPA,
    DAMOV and the kernels' step accounting, the GPipe pipeline, the
    production mesh and the dry-run, among them) and chip_smoke.py's
    imports load without jax or the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "new = ('repro_torch.models.recurrent_lm', 'repro_torch.models.rglru',\n"
        "       'repro_torch.kernels.rglru.kernel', 'repro_torch.kernels.rglru.ops',\n"
        "       'repro_torch.kernels.rglru.ref',\n"
        "       'repro_torch.configs.recurrentgemma_2b',\n"
        "       'repro_torch.kernels.narrow_value.kernel',\n"
        "       'repro_torch.kernels.narrow_value.ops',\n"
        "       'repro_torch.kernels.narrow_value.ref',\n"
        "       'repro_torch.kernels.quant_matmul.kernel',\n"
        "       'repro_torch.kernels.quant_matmul.ops',\n"
        "       'repro_torch.kernels.quant_matmul.ref',\n"
        "       'repro_torch.core.proteus', 'repro_torch.launch.train',\n"
        "       'repro_torch.optim.optimizers', 'repro_torch.data.pipeline',\n"
        "       'repro_torch.checkpoint.manager', 'repro_torch.tree',\n"
        "       'repro_torch.distributed.chaos',\n"
        "       'repro_torch.distributed.fault_tolerance',\n"
        "       'repro_torch.kernels.flash_attention.autograd',\n"
        "       'repro_torch.launch.fleet', 'repro_torch.distributed.dispatcher',\n"
        "       'repro_torch.models.moe', 'repro_torch.launch.specs',\n"
        "       'repro_torch.configs.mixtral_8x7b',\n"
        "       'repro_torch.configs.pixtral_12b',\n"
        "       'repro_torch.configs.kimi_k2_1t',\n"
        "       'repro_torch.configs.internlm2_1_8b',\n"
        "       'repro_torch.configs.stablelm_1_6b',\n"
        "       'repro_torch.configs.stablelm_3b',\n"
        "       'repro_torch.configs.deepseek_coder_33b',\n"
        "       'repro_torch.models.encdec', 'repro_torch.models.xlstm',\n"
        "       'repro_torch.configs.xlstm_125m',\n"
        "       'repro_torch.configs.seamless_m4t_large',\n"
        "       'repro_torch.kernels.rglru.autograd', 'repro_torch.models.model',\n"
        "       'repro_torch.models.bridge', 'repro_torch.launch.steps',\n"
        "       'repro_torch.core.mimdram', 'repro_torch.core.dappa',\n"
        "       'repro_torch.core.damov', 'repro_torch.kernels.accounting',\n"
        "       'repro_torch.distributed.pipeline', 'repro_torch.launch.mesh',\n"
        "       'repro_torch.launch.dryrun')\n"
        "from repro_torch.configs import ALL_IDS, get_config\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.models.model import training_model\n"
        "for a in ALL_IDS:\n"
        "    build_model(get_config(a, smoke=True), 'cpu')\n"
        "    training_model(get_config(a, smoke=True))\n"
        "from repro_torch.kernels.flash_attention import (attention_ref_bh,\n"
        "    flash_attention_bh)\n"
        "assert all(n in sys.modules for n in new), new\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
