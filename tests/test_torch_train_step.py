"""The port's training step on the CPU against the mesh-less JAX reference:
the flash-attention kernel under autograd (its plain path: the kernel's
plain version forward, the plain recompute backward) against ``jax.vjp`` of
the reference's jnp and Pallas (interpret mode) routes, ``gradcheck`` in
float64, the differentiable loss and its gradients, one and three guarded
AdamW steps with one and two microbatches, and the non-finite guard."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.configs.base import RunConfig  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.data import make_batch_fn  # noqa: E402
from repro.distributed.chaos import nan_grad_hook  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import nan_grad_hook as tnan_grad_hook  # noqa: E402
from repro_torch.kernels.flash_attention.autograd import (  # noqa: E402
    flash_attention_train)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import TransformerLM, reference_tree  # noqa: E402
from repro_torch.models.bridge import flatten_params  # noqa: E402
from repro_torch.optim import make_optimizer as tmake_optimizer  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

# attention gradients in fp32: the same tiles and sums as the reference's
# jnp backward, so the two differ by summation order in the einsums
ATTN_TOL = 2e-5
# the model in fp32 at smoke width: the loss within 1e-5 relative;
# gradients within 1e-4 of a tensor's largest value: the gradients of the
# blocks and the embedding are ill-conditioned in fp32, and each side lies
# 3e-5 to 6e-5 (of the largest value) from a float64 run of the port
LOSS_RTOL = 1e-5
TREE_RTOL = 1e-4

ATTN_CASES = {
    # B, S, Hq, Hkv, D, causal, window, softcap, chunk_q, chunk_kv
    "causal": (2, 24, 2, 2, 16, True, 0, 0.0, 8, 8),
    "gqa_ragged": (1, 21, 4, 2, 16, True, 0, 0.0, 8, 16),
    "window_gqa": (2, 19, 4, 2, 8, True, 6, 0.0, 8, 8),
    "softcap": (1, 17, 2, 2, 16, True, 0, 5.0, 8, 8),
    "full": (1, 16, 2, 2, 8, False, 0, 0.0, 8, 8),
}


def _attn_inputs(case, seed=0, dtype=np.float32):
    B, S, Hq, Hkv, D = ATTN_CASES[case][:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D))]


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_grads_match_reference(case, impl, monkeypatch):
    # the reference's Pallas route in interpret mode
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    _, _, _, _, _, causal, window, cap, cq, ck = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(case)

    def ref(q_, k_, v_):
        return chunked_attention(q_, k_, v_, causal=causal, window=window,
                                 q_offset=0, chunk_q=cq, chunk_kv=ck,
                                 attn_softcap=cap, impl=impl)

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_train(tq, tk, tv, causal=causal, window=window,
                                softcap=cap, chunk_q=cq, chunk_kv=ck)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATTN_TOL, rtol=0)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATTN_TOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["gqa_ragged", "window_gqa", "softcap"])
def test_attention_gradcheck_float64(case):
    _, _, _, _, _, causal, window, cap, cq, ck = ATTN_CASES[case]
    q, k, v, _ = _attn_inputs(case, seed=1, dtype=np.float64)
    args = tuple(torch.from_numpy(x[:1, :11, :, :4].copy()).requires_grad_(True)
                 for x in (q, k, v))

    def fn(q_, k_, v_):
        return flash_attention_train(q_, k_, v_, causal=causal,
                                     window=window, softcap=cap,
                                     chunk_q=min(cq, 4), chunk_kv=min(ck, 8))
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


def test_serving_prefill_builds_no_graph():
    """Without gradients the prefill route is unchanged: no autograd node."""
    q, k, v, _ = _attn_inputs("causal")
    from repro_torch.models.layers import chunked_attention as tca
    out = tca(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# the model's loss and the train step
# ---------------------------------------------------------------------------
SEQ, BATCH = 32, 4


@pytest.fixture(scope="module")
def ref():
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    shape = ShapeConfig("custom", SEQ, BATCH, "train")
    plan = plan_sharding(jcfg, shape, None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    batch_fn = make_batch_fn(jcfg, shape, seed=0)
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=np_params, batch_fn=batch_fn,
                tm=TransformerLM(tcfg, device="cpu"))


def _tparams(np_params):
    """The reference's weights as the port's tree, through the bridge: the
    flat names the module uses, restacked (the inverse of
    ``flatten_params``)."""
    flat = flatten_params(np_params)
    tree = reference_tree({k: torch.from_numpy(v.copy())
                           for k, v in flat.items()})
    assert [tuple(a.shape) for a in leaves(tree)] == \
        [a.shape for a in jax.tree_util.tree_leaves(np_params)]
    return tree


def _tree_close(tree, jtree, rtol=TREE_RTOL, what=""):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = leaves(tree)
    assert len(tl) == len(jl)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree), tl):
        a = np.asarray(a)
        if a.dtype == np.int32:
            assert int(b) == int(a)
            continue
        np.testing.assert_allclose(
            b.detach().numpy(), a, rtol=0,
            atol=rtol * max(np.abs(a).max(), 1e-30),
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _params_close(tree, jtree, n_steps, lr):
    """Updated weights: every element within TREE_RTOL of the leaf's largest
    |value| plus ``n_steps * lr`` (the most AdamW can move an element whose
    gradient is below the two sides' fp32 noise: its first steps divide by
    |g|), and at most 1 in 1000 elements past TREE_RTOL alone."""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            leaves(tree)):
        a = np.asarray(a)
        d = np.abs(b.detach().numpy() - a)
        tight = TREE_RTOL * np.abs(a).max()
        name = jax.tree_util.keystr(path)
        assert d.max() <= tight + n_steps * lr, (name, d.max())
        assert (d > tight).mean() <= 1e-3, (name, (d > tight).sum())


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(ref, masked):
    b = ref["batch_fn"](0)
    if masked:
        b["loss_mask"] = (np.random.default_rng(5).random(b["tokens"].shape)
                          < 0.7).astype(np.float32)
    with use_plan(ref["plan"]):
        jl, jg = jax.jit(lambda p, bb: jsteps._loss_and_grads(
            ref["jm"], p, bb, 1))(ref["params"], b)
    tl, tg = tsteps._loss_and_grads(ref["tm"], _tparams(ref["np_params"]),
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()}, 1)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _tree_close(tg, jg, what="grad ")


def _steps(ref, n, nm, guard=True):
    """``n`` steps of both sides at the default learning rate. An AdamW
    update moves an element by up to about lr and its first steps divide by
    |g|, so an element whose gradient is near zero (where the gradients'
    fp32 noise is a large part of it) can move differently on the two
    sides, by up to lr: within TREE_RTOL of the weights' largest |value|."""
    jrun = RunConfig(total_steps=n, warmup_steps=1, microbatches=nm)
    trun = tconfigs.RunConfig(total_steps=n, warmup_steps=1, microbatches=nm)
    jopt = make_optimizer("adamw", jrun)
    topt = tmake_optimizer("adamw", trun)
    jstep = jax.jit(jsteps.make_train_step(ref["jm"], jopt, ref["plan"], jrun,
                                           guard=guard))
    tstep = tsteps.make_train_step(ref["tm"], topt, trun, guard=guard)
    with use_plan(ref["plan"]):
        jp = ref["params"]
        js = jopt.init(jp)
    tp = _tparams(ref["np_params"])
    ts = topt.init(tp)
    out = []
    for step in range(n):
        b = ref["batch_fn"](step)
        jp, js, jm = jstep(jp, js, b)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        out.append((jm, tm))
    return jp, js, tp, ts, out


@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("n", [1, 3])
def test_train_steps_match_reference(ref, n, nm):
    jp, js, tp, ts, metrics = _steps(ref, n, nm)
    for jm, tm in metrics:
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TREE_RTOL)
        assert not bool(tm["skipped"]) and not bool(jm["skipped"])
    _params_close(tp, jp, n, tconfigs.RunConfig().learning_rate)
    # the moments sum gradients taken at weights that already differ by
    # the steps before: TREE_RTOL a step
    _tree_close(ts, js, rtol=n * TREE_RTOL, what="opt ")


def test_auto_microbatches_matches_reference(ref):
    for seq, batch in ((32, 4), (4096, 256), (4096, 4), (2048, 64)):
        for cfg_name in (False, True):
            jcfg = get_config("pimref-100m", smoke=cfg_name)
            tcfg = tconfigs.get_config("pimref-100m", smoke=cfg_name)
            shape = ShapeConfig("t", seq, batch, "train")
            want = jsteps.auto_microbatches(
                jcfg, shape, plan_sharding(jcfg, shape, None))
            got = tsteps.auto_microbatches(
                tcfg, tconfigs.ShapeConfig("t", seq, batch, "train"))
            assert got == want, (seq, batch, cfg_name)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------
def _bitwise(a, b):
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(leaves(a), leaves(b)))


def test_guard_clean_step_bitwise_and_nan_step_skipped(ref):
    trun = tconfigs.RunConfig(total_steps=4, warmup_steps=1,
                              learning_rate=1e-2, microbatches=1)
    opt = tmake_optimizer("adamw", trun)
    tm = ref["tm"]
    p0 = _tparams(ref["np_params"])
    s0 = opt.init(p0)
    b = {k: torch.from_numpy(v) for k, v in ref["batch_fn"](0).items()}
    plain = tsteps.make_train_step(tm, opt, trun, guard=False)
    guarded = tsteps.make_train_step(tm, opt, trun, guard=True)
    hooked = tsteps.make_train_step(tm, opt, trun, guard=True,
                                    grad_hook=tnan_grad_hook)
    # the step updates its inputs in place: each call gets copies of
    # (p0, s0)
    def copies():
        return tree_map(torch.clone, p0), tree_map(torch.clone, s0)

    pu, su, _ = plain(*copies(), b)
    pg, sg, mg = guarded(*copies(), b)
    ph, sh, mh = hooked(*copies(), b, torch.tensor(0, dtype=torch.int32))
    assert not bool(mg["skipped"]) and not bool(mh["skipped"])
    assert _bitwise(pu, pg) and _bitwise(su, sg)
    assert _bitwise(pu, ph) and _bitwise(su, sh)
    assert not _bitwise(pu, p0)
    # armed: every output leaf is the input leaf, bit for bit
    pn, sn, mn = hooked(*copies(), b, torch.tensor(1, dtype=torch.int32))
    assert bool(mn["skipped"]) and not np.isfinite(mn["grad_norm"].item())
    assert _bitwise(pn, p0) and _bitwise(sn, s0)
    # the same as the reference's armed step
    jrun = RunConfig(total_steps=4, warmup_steps=1, learning_rate=1e-2,
                     microbatches=1)
    jopt = make_optimizer("adamw", jrun)
    jstep = jax.jit(jsteps.make_train_step(ref["jm"], jopt, ref["plan"], jrun,
                                           guard=True,
                                           grad_hook=nan_grad_hook))
    with use_plan(ref["plan"]):
        js0 = jopt.init(ref["params"])
    _, _, jm = jstep(ref["params"], js0, ref["batch_fn"](0), jnp.int32(1))
    assert bool(jm["skipped"])
    np.testing.assert_allclose(mn["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_RTOL)
