"""The port's dense TransformerLM (repro_torch.models) against the JAX
reference with the same weights (bridged as numpy arrays), in fp32 on the
CPU: configs, parameter specs, init, the bridge, prefill, decode."""
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
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import (TransformerLM, count_params,  # noqa: E402
                                load_jax_params, param_specs)
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.models import init_params as tinit_params  # noqa: E402

ATOL = 1e-4
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    """The contiguous fp-cache reference path: no paging, no KV quant, no
    speculation."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _cfgs(**kw):
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32", **kw)
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32", **kw)
    return jcfg, tcfg


def _pair(seed=0, max_len=32, batch=2, **kw):
    """(JAX model, JAX params, plan, port model) with the same weights."""
    jcfg, tcfg = _cfgs(**kw)
    plan = plan_sharding(jcfg, ShapeConfig("serve", max_len, batch, "decode"),
                         None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(seed))
    tm = TransformerLM(tcfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, plan, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs, specs, init, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke):
    j = get_config("pimref-100m", smoke=smoke)
    t = tconfigs.get_config("pimref-100m", smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfigs.param_count(t) == param_count(j)
    # the analytic count leaves out the final norm's scale
    assert count_params(t) == param_count(j) + t.d_model
    shape = dict(name="s", seq_len=8, global_batch=2, mode="decode")
    assert dataclasses.asdict(tconfigs.ShapeConfig(**shape)) == \
        dataclasses.asdict(ShapeConfig(**shape))


def test_registry_knows_only_ported_archs():
    assert tconfigs.ALL_IDS == ("pimref-100m",)
    with pytest.raises(KeyError, match="not yet ported"):
        tconfigs.get_config("mixtral-8x7b")


def test_param_specs_match_reference():
    jcfg, tcfg = _cfgs()
    jspecs = build_model(jcfg).param_specs()
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: hasattr(x, "logical_axes"))[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("blocks."):
            for i in range(s.shape[0]):
                flat[name.replace("blocks.", f"blocks.{i}.", 1)] = (
                    s.shape[1:], s.init)
        else:
            flat[name] = (s.shape, s.init)
    mine = {n: (s.shape, s.init) for n, s in param_specs(tcfg).items()}
    assert mine == flat


def test_init_params_scale_and_seed():
    _, tcfg = _cfgs()
    a = tinit_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = tinit_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert torch.equal(a["blocks.0.ln1"], torch.ones(tcfg.d_model))
    # normal / sqrt(fan_in): w_o's fan-in is its heads axis, others axis 0
    big = tinit_params(tcfg.replace(d_model=256, d_ff=512),
                       torch.Generator().manual_seed(0), "cpu")
    assert abs(big["blocks.0.mlp.wo"].std().item() - 512 ** -0.5) < 2e-3
    assert abs(big["blocks.0.attn.w_o"].std().item() - 4 ** -0.5) < 2e-2
    m = TransformerLM(tcfg, device="cpu")
    m.load_state_dict(a)             # every key present, every shape right


def test_bridge_rejects_bad_trees(pair):
    jm, params, _, tm = pair
    npp = jax.tree_util.tree_map(np.asarray, params)
    missing = {k: v for k, v in npp.items() if k != "head"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(tm, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(tm, {**npp, "bias": np.zeros(3, np.float32)})
    bad = {**npp, "final_norm": np.zeros(5, np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        load_jax_params(tm, bad)
    load_jax_params(tm, npp)         # the good tree still loads


def test_build_model_and_device_guards():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="later slice"):
        tbuild_model(tcfg.replace(family="moe"), device="cpu")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            TransformerLM(tcfg)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------
def test_forward_matches(pair):
    jm, params, plan, tm = pair
    toks = _tokens(0, (2, 11), tm.cfg.vocab_size)
    with use_plan(plan):
        want = jm.forward(params, jnp.asarray(toks))
    _close(tm(torch.from_numpy(toks)), want)


@pytest.mark.parametrize("full_logits", [False, True])
def test_prefill_logits_and_cache_match(pair, full_logits):
    jm, params, plan, tm = pair
    toks = _tokens(1, (2, 13), tm.cfg.vocab_size)
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=24,
                            full_logits=full_logits)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=24,
                        full_logits=full_logits)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    for name in ("pos_ids", "pos"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def _greedy(jm, params, plan, tm, toks, max_len, steps):
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                            max_len=max_len)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len)
    jout, tout = [], []
    for _ in range(steps):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jout.append(np.asarray(jt))
        tout.append(tt.numpy())
        with use_plan(plan):
            jl, jc = jm.decode_step(params, jc, jt)
        tl, tc = tm.decode_step(tc, tt)
        _close(tl, jl)
    return np.concatenate(jout, 1), np.concatenate(tout, 1), jc, tc


def test_greedy_decode_tokens_identical(pair):
    jm, params, plan, tm = pair
    toks = _tokens(2, (2, 9), tm.cfg.vocab_size)
    jt, tt, jc, tc = _greedy(jm, params, plan, tm, toks, 16, 6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["k"], jc["k"])


def test_sliding_window_ring_wraps():
    """Sliding window: the cache is capped at the window and decode writes
    wrap around the ring."""
    jm, params, plan, tm = _pair(seed=1, attention_kind="sliding",
                                 sliding_window=8)
    assert tm.cache_len(20) == jm.cache_len(20) == 8
    toks = _tokens(3, (2, 6), tm.cfg.vocab_size)
    jt, tt, jc, tc = _greedy(jm, params, plan, tm, toks, 20, 6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                  np.asarray(jc["pos_ids"]))


@pytest.mark.parametrize("S,layers", [(4, None), (1, 1), (3, 1)])
def test_decode_block_and_layer_prefix(pair, S, layers):
    """S > 1 verify blocks and the first-N-layers pass."""
    jm, params, plan, tm = pair
    toks = _tokens(4, (2, 7), tm.cfg.vocab_size)
    feed = _tokens(5, (2, S), tm.cfg.vocab_size)
    with use_plan(plan):
        _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=16)
        jl, jc = jm.decode_step(params, jc, jnp.asarray(feed), layers=layers)
    _, tc = tm.prefill(torch.from_numpy(toks), max_len=16)
    tl, tc = tm.decode_step(tc, torch.from_numpy(feed), layers=layers)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                  np.asarray(jc["pos_ids"]))


def test_init_cache_matches(pair):
    jm, _, _, tm = pair
    jc, tc = jm.init_cache(3, 10), tm.init_cache(3, 10)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
