"""Training of every non-dense family on the CPU against the mesh-less JAX
reference, at smoke size in fp32: the hybrid ``recurrentgemma-2b``, the
ssm ``xlstm-125m``, the audio ``seamless-m4t-large-v2``, the moe
``mixtral-8x7b`` and the vlm ``pixtral-12b``.

For each family: the parameter tree (leaf keys, shapes, dtypes; Griffin's
``tail`` and the xLSTM's ``blocks`` lists), ``loss`` and its gradients,
three guarded steps of ``make_train_step`` with one and two microbatches
(the family's extras split along the batch axis), ``train()`` from the
reference's init against the reference's ``train(use_mesh=False)``
(losses and checkpoints), and the step's in-place update (a leaf in
pieces bitwise a whole leaf; the guard keeps every element). Also: the attention train branch in the modes these
families run (D 256 windowed MQA, D 128 GQA, non-causal with S = T and
S != T), checkpoints read across the packages and bitwise resume for the
list trees, the CLI, the VLM loss's patch prefix, Adafactor over stacked
4-D expert leaves, and the unsliced ``loss_mask`` hazard on both sides.

Tolerances: the loss within 1e-6 relative; gradients within ``GRAD_REL``
of a leaf's largest |value|, by family. fp32 gradients of these smoke
models are ill-conditioned: rescaling every weight by one ulp (1 + 2^-23)
moves the port's own gradients by up to 5.3e-3 of a leaf's largest value
(seamless), 1.0e-3 (mixtral), 7.4e-4 (Griffin), and the two packages'
fp32 gradients lie 1e-3 to 4e-3 (seamless), 1.3e-3 to 1.8e-3 (Griffin)
and 5e-5 to 7.5e-4 (mixtral) from a float64 run of the port, each side
about as far as the other (port against reference: 1.6e-3, 2.0e-3,
3.4e-4). So each family's limit is its measured fp32 noise: the dense
family's 1e-4 (``tests/test_torch_train_step.py``) where that holds (xLSTM 5.2e-5, pixtral 9.1e-5),
else at most ten times the one-ulp rescale's change, which the gradient
test measures and checks beside it.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager, load_checkpoint  # noqa: E402
from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.configs.base import RunConfig  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.data import make_batch_fn  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import make_batch_fn as tmake_batch_fn  # noqa: E402
from repro_torch.kernels.flash_attention.autograd import (  # noqa: E402
    flash_attention_train)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import reference_tree  # noqa: E402
from repro_torch.models.bridge import flatten_params  # noqa: E402
from repro_torch.models.model import model_class, training_model  # noqa: E402
from repro_torch.optim import make_optimizer as tmake_optimizer  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402

FAMILIES = {"hybrid": "recurrentgemma-2b", "ssm": "xlstm-125m",
            "audio": "seamless-m4t-large-v2", "moe": "mixtral-8x7b",
            "vlm": "pixtral-12b"}
LISTED = ("hybrid", "ssm")
LOSS_RTOL = 1e-6
GRAD_REL = {"hybrid": 3e-3, "ssm": 1e-4, "audio": 5e-3, "moe": 1e-3,
            "vlm": 1e-4}
# weights and moments after steps: each step's update moves an element by
# up to lr where its gradient is below the two sides' fp32 noise (AdamW's
# first steps divide by |g|), so weights get n x lr on top, and at most
# 1e-3 of the elements past the tight limit (the dense family's rule)
BATCH, SEQ = 2, 64
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
         "REPRO_ATTN_IMPL", "REPRO_CHAOS")


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _cfgs(arch, **kw):
    jcfg = get_config(arch, smoke=True).replace(compute_dtype="float32", **kw)
    tcfg = tconfigs.get_config(arch, smoke=True).replace(
        compute_dtype="float32", **kw)
    return jcfg, tcfg


def _reference(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    shape = ShapeConfig("custom", SEQ, BATCH, "train")
    plan = plan_sharding(jcfg, shape, None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm,
                params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params),
                batch_fn=make_batch_fn(jcfg, shape, seed=0),
                tm=training_model(tcfg))


_REFS = {}


@pytest.fixture(params=sorted(FAMILIES))
def ref(request):
    """The mesh-less fp32 smoke reference of one family, its init and
    stream, and the port's weightless training model."""
    family = request.param
    if family not in _REFS:
        _REFS[family] = _reference(FAMILIES[family])
    return dict(_REFS[family], family=family)


def _tparams(r):
    """The reference's init as the port's tree, through the bridge: the
    module's flat names, restacked, lists for the family's list keys."""
    flat = flatten_params(r["np_params"])
    return reference_tree({k: torch.from_numpy(v.copy())
                           for k, v in flat.items()},
                          model_class(r["tcfg"]).LISTS)


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tree_close(tree, jtree, rel, what=""):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = leaves(tree)
    assert len(tl) == len(jl)
    for (path, a), b in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype == np.int32:
            assert int(b) == int(a)
            continue
        np.testing.assert_allclose(
            b.detach().numpy(), a, rtol=0,
            atol=rel * max(np.abs(a).max(), 1e-30),
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _params_close(tree, jtree, rel, n_steps, lr):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            leaves(tree)):
        a = np.asarray(a)
        d = np.abs(b.detach().numpy() - a)
        tight = rel * np.abs(a).max()
        name = jax.tree_util.keystr(path)
        assert d.max() <= tight + n_steps * lr, (name, d.max())
        assert (d > tight).mean() <= 1e-3, (name, (d > tight).sum())


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------
def test_param_tree_matches_reference(ref):
    """The port's init tree (``initial_params``) has the reference's leaf
    keys, in its order, with its shapes and dtypes; the bridge's tree of
    the reference's init is the reference's tree leaf for leaf."""
    want = [(jax.tree_util.keystr(p), tuple(np.shape(a)),
             np.asarray(a).dtype)
            for p, a in jax.tree_util.tree_leaves_with_path(
                ref["np_params"])]
    got = [(p, tuple(t.shape), t.numpy().dtype) for p, t in
           leaves_with_path(ttrain.initial_params(ref["tcfg"], 0, "cpu"))]
    assert got == want
    bridged = _tparams(ref)
    assert [p for p, _ in leaves_with_path(bridged)] == [w[0] for w in want]
    for t, a in zip(leaves(bridged),
                    jax.tree_util.tree_leaves(ref["np_params"])):
        assert t.numpy().tobytes() == np.asarray(a).tobytes()
    if ref["family"] in LISTED:
        key = model_class(ref["tcfg"]).LISTS[0]
        assert isinstance(bridged[key], list)
        assert isinstance(ref["np_params"][key], list)


def test_training_model_holds_no_weights(ref):
    tm = ref["tm"]
    assert all(p.device.type == "meta" for p in tm.parameters())
    b = _tbatch(ref["batch_fn"](0))
    loss = tm.loss(_tparams(ref), b)
    assert loss.device.type == "cpu" and torch.isfinite(loss)


# ---------------------------------------------------------------------------
# loss and gradients, steps
# ---------------------------------------------------------------------------
def _ulp_sensitivity(r, b, grads) -> float:
    """The largest change, relative to a leaf's largest |value|, that
    rescaling every weight by one ulp (1 + 2^-23) makes in the port's
    gradients: the scale of the gradients' fp32 conditioning."""
    _, moved = tsteps._loss_and_grads(r["tm"], tree_map(
        lambda t: t * (1 + 2.0 ** -23), _tparams(r)), _tbatch(b), 1)
    return max((a - c).abs().max().item() / a.abs().max().item()
               for a, c in zip(leaves(grads), leaves(moved)))


def test_loss_and_grads_match_reference(ref):
    b = ref["batch_fn"](0)
    with use_plan(ref["plan"]):
        jl, jg = jax.jit(lambda p, bb: jsteps._loss_and_grads(
            ref["jm"], p, bb, 1))(ref["params"], b)
    tl, tg = tsteps._loss_and_grads(ref["tm"], _tparams(ref), _tbatch(b), 1)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    rel = GRAD_REL[ref["family"]]
    _tree_close(tg, jg, rel, what="grad ")
    if rel > 1e-4:
        # the limit is the fp32 noise, not slack: a one-ulp rescale of
        # the weights moves the gradients by at least a tenth of it
        sens = _ulp_sensitivity(ref, b, tg)
        assert rel <= 10 * sens, (ref["family"], rel, sens)


def _moments_close(tree, jtree, rel, step):
    """The optimizer state after one step: ``nu`` holds g^2, so an
    element's error is up to twice g's; all within 2 x ``rel`` of the
    leaf's largest value but at most 1e-3 of the elements, within 4 x
    ``rel`` all of them."""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            leaves(tree)):
        a = np.asarray(a)
        name = f"step {step} opt {jax.tree_util.keystr(path)}"
        if a.dtype == np.int32:
            assert int(b) == int(a), name
            continue
        d = np.abs(b.numpy() - a)
        tight = 2 * rel * np.abs(a).max()
        assert d.max() <= 2 * tight, (name, d.max(), tight)
        assert (d > tight).mean() <= 1e-3, (name, (d > tight).sum())


def _from_reference(tree):
    """A reference tree (params or optimizer state) as the port's tensors,
    dicts and lists kept."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _check_steps(r, n, nm, optimizer="adamw", rel=None):
    """``n`` guarded steps of the port's step and the reference's
    jitted step, each from the reference's state after the steps before
    (so fp32 noise does not compound: these smoke models' losses rise and
    their gradient norms grow step by step, and AdamW moves every element
    by up to lr, so free-running trajectories part by far more than one
    step's noise); the batch, extras too, split into ``nm`` microbatches.
    Each step: the loss, the gradient norm, the new weights (plus lr where
    a gradient is below the fp32 noise) and the optimizer state."""
    rel = rel or GRAD_REL[r["family"]]
    jrun = RunConfig(total_steps=n, warmup_steps=1, microbatches=nm)
    trun = tconfigs.RunConfig(total_steps=n, warmup_steps=1, microbatches=nm)
    jopt = make_optimizer(optimizer, jrun)
    topt = tmake_optimizer(optimizer, trun)
    jstep = jax.jit(jsteps.make_train_step(r["jm"], jopt, r["plan"], jrun,
                                           guard=True))
    tstep = tsteps.make_train_step(r["tm"], topt, trun, guard=True)
    with use_plan(r["plan"]):
        jp = r["params"]
        js = jopt.init(jp)
    for step in range(n):
        b = r["batch_fn"](step)
        tp, ts, tm = tstep(_from_reference(jp), _from_reference(js),
                           _tbatch(b))
        jp, js, jm = jstep(jp, js, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=rel)
        assert not bool(tm["skipped"]) and not bool(jm["skipped"])
        # an element whose gradient's sign is below the noise moves by +lr
        # on one side and -lr on the other (AdamW's first steps divide by
        # |g|)
        _params_close(tp, jp, rel, 2, trun.learning_rate)
        _moments_close(ts, js, rel, step)


@pytest.mark.parametrize("nm", [1, 2])
def test_train_steps_match_reference(ref, nm):
    """Three guarded AdamW steps of the port's step against the
    reference's jitted step."""
    _check_steps(ref, 3, nm)


def test_adafactor_over_stacked_experts():
    """Adafactor's factored moments over the MoE's (L, E, D, F) expert
    leaves, three steps against the reference's."""
    r = dict(_reference(FAMILIES["moe"], optimizer="adafactor"),
             family="moe")
    assert np.asarray(r["np_params"]["blocks"]["moe"]["wi_gate"]).ndim == 4
    _check_steps(r, 3, 1, "adafactor")


def _bitwise(a, b):
    return all(x.dtype == y.dtype and x.numpy().tobytes() == y.numpy()
               .tobytes() for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_step_updates_in_place(optimizer, monkeypatch):
    """The step writes the update into the tree and the state it is given
    and returns them: a clean step with every leaf split into pieces of
    1000 elements equals one over whole leaves bit for bit, and an armed
    step (NaN gradients) leaves every element as it was."""
    from repro_torch.distributed import nan_grad_hook
    from repro_torch.optim import optimizers
    r = _reference(FAMILIES["moe"])
    run = tconfigs.RunConfig(total_steps=4, warmup_steps=1,
                             learning_rate=1e-2, microbatches=1)
    opt = tmake_optimizer(optimizer, run)
    step = tsteps.make_train_step(r["tm"], opt, run, guard=True,
                                  grad_hook=nan_grad_hook)
    p0 = _tparams(r)
    s0 = opt.init(p0)
    b = _tbatch(r["batch_fn"](0))

    def one_step(piece, armed):
        monkeypatch.setattr(optimizers, "PIECE", piece)
        p, s = tree_map(torch.clone, p0), tree_map(torch.clone, s0)
        out_p, out_s, m = step(p, s, b, torch.tensor(armed,
                                                     dtype=torch.int32))
        assert out_p is p and out_s is s
        assert bool(m["skipped"]) == bool(armed)
        return p, s

    for armed in (0, 1, 0):
        pp, sp = one_step(1000, armed)
        pw, sw = one_step(1 << 40, armed)
        assert _bitwise(pp, pw) and _bitwise(sp, sw)
        assert _bitwise(pp, p0) == bool(armed)
        if armed:
            assert _bitwise(sp, s0)
        p0, s0 = pp, sp


# ---------------------------------------------------------------------------
# the attention train branch in the families' modes
# ---------------------------------------------------------------------------
ATTN_MODES = {
    # B, S, T, Hq, Hkv, D, causal, window, chunk_q, chunk_kv
    "griffin_d256_mqa_window": (1, 40, 40, 10, 1, 256, True, 16, 16, 16),
    "mixtral_d128_gqa": (1, 24, 24, 32, 8, 128, True, 0, 8, 16),
    "encoder_noncausal": (2, 24, 24, 4, 4, 32, False, 0, 8, 8),
    "cross_noncausal_ragged": (2, 20, 29, 4, 4, 32, False, 0, 8, 8),
}


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("mode", sorted(ATTN_MODES))
def test_attention_train_modes_match_reference(mode, impl, monkeypatch):
    """``flash_attention_train`` (the kernel's plain version forward, the
    plain recompute backward) against ``jax.vjp`` of the reference's
    ``chunked_attention``; the cross-attention's T (29) is not a multiple
    of its kv chunk, so its padded kv rows are masked by ``kv_len``."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    B, S, T, Hq, Hkv, D, causal, window, cq, ck = ATTN_MODES[mode]
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D),
                    (B, S, Hq, D)))

    def jref(q_, k_, v_):
        return chunked_attention(q_, k_, v_, causal=causal, window=window,
                                 q_offset=0, chunk_q=cq, chunk_kv=ck,
                                 impl=impl)

    jout, vjp = jax.vjp(jref, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_train(tq, tk, tv, causal=causal, window=window,
                                chunk_q=cq, chunk_kv=ck)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=0, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the VLM loss, the batch, the loss mask
# ---------------------------------------------------------------------------
def test_vlm_loss_drops_the_patch_prefix():
    """The VLM loss runs the patches through the model and scores only the
    text positions: equal to the reference's loss, and different from the
    loss of the same tokens without the patches."""
    r = _reference(FAMILIES["vlm"])
    b = r["batch_fn"](0)
    assert b["patch_embeds"].shape == (BATCH, 8, r["jcfg"].d_model)
    with use_plan(r["plan"]):
        want = float(r["jm"].loss(r["params"], b))
        no_patch = float(r["jm"].loss(r["params"], {
            k: v for k, v in b.items() if k != "patch_embeds"}))
    got = r["tm"].loss(_tparams(r), _tbatch(b)).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert abs(want - no_patch) > 1e-3 * abs(want)


def test_stream_extras_bitwise_reference():
    """``patch_embeds`` and ``src_embeds`` of the port's stream are the
    reference's, byte for byte."""
    for family in ("vlm", "audio"):
        jcfg, tcfg = _cfgs(FAMILIES[family])
        jb = make_batch_fn(jcfg, ShapeConfig("c", SEQ, BATCH, "train"), 5)
        tb = tmake_batch_fn(tcfg, tconfigs.ShapeConfig("c", SEQ, BATCH,
                                                       "train"), 5)
        for step in (0, 3):
            a, b = jb(step), tb(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes(), (family, k)


@pytest.mark.parametrize("family", ["hybrid", "ssm", "audio"])
def test_unsliced_loss_mask_as_reference(family):
    """Griffin, the xLSTM and the encoder-decoder pass ``loss_mask``
    unsliced, as the reference does: a (B, S - 1) mask weights the
    next-token losses on both sides alike, a (B, S) mask fails to
    broadcast on both (ROADMAP §C)."""
    r = _REFS.get(family) or _reference(FAMILIES[family])
    b = r["batch_fn"](0)
    S = b["tokens"].shape[1]
    mask = (np.random.default_rng(2).random((BATCH, S - 1)) < 0.7).astype(
        np.float32)
    with use_plan(r["plan"]):
        want = float(r["jm"].loss(r["params"], dict(b, loss_mask=mask)))
    got = r["tm"].loss(_tparams(r), _tbatch(dict(b, loss_mask=mask)))
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    full = np.ones((BATCH, S), np.float32)
    with pytest.raises((TypeError, ValueError)):
        with use_plan(r["plan"]):
            r["jm"].loss(r["params"], dict(b, loss_mask=full))
    with pytest.raises(RuntimeError):
        r["tm"].loss(_tparams(r), _tbatch(dict(b, loss_mask=full)))


# ---------------------------------------------------------------------------
# train(), checkpoints, resume, the CLI
# ---------------------------------------------------------------------------
STEPS = 4


def _patch_configs(monkeypatch, arch):
    jcfg, tcfg = _cfgs(arch)
    monkeypatch.setattr(jtrain, "get_config", lambda a, smoke=True: jcfg)
    monkeypatch.setattr(ttrain, "get_config", lambda a, smoke=True: tcfg)
    return jcfg, tcfg


def _common(**kw):
    return dict(smoke=True, batch=BATCH, seq=SEQ, log_every=100, **kw)


def test_train_matches_reference(ref, tmp_path, monkeypatch):
    """``train()`` from the reference's init: the reference's losses and
    loop state, and checkpoints with the reference's files (leaf keys)."""
    arch = ref["arch"]
    _patch_configs(monkeypatch, arch)
    jrun = RunConfig(total_steps=STEPS, microbatches=1, checkpoint_every=2)
    trun = tconfigs.RunConfig(total_steps=STEPS, microbatches=1,
                              checkpoint_every=2)
    want = jtrain.train(arch, steps=STEPS, run=jrun, use_mesh=False,
                        checkpoint_dir=str(tmp_path / "j"), **_common())
    got = ttrain.train(arch, steps=STEPS, run=trun, device="cpu",
                       params=ref["np_params"],
                       checkpoint_dir=str(tmp_path / "t"), **_common())
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=10 * LOSS_RTOL)
    for k in ("first_step", "resumed_at", "preempted", "skipped_steps",
              "rollbacks", "anomalies", "ckpt_failures"):
        assert got[k] == want[k], k
    jm = CheckpointManager(str(tmp_path / "j"))
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    assert tm.all_steps() == jm.all_steps() == [2, 4]
    for s in (2, 4):
        a, b = jm.load_extra(s), tm.load_extra(s)
        a["loop"].pop("loss_ewma"), b["loop"].pop("loss_ewma")
        np.testing.assert_allclose(b.pop("loss"), a.pop("loss"),
                                   rtol=10 * LOSS_RTOL)
        assert a == b
        name = f"step_{s:08d}"
        assert sorted(os.listdir(tmp_path / "j" / name)) == \
            sorted(os.listdir(tmp_path / "t" / name))
    # the caller's tree is copied, not trained in place
    assert _bitwise(_tparams(ref), ttrain.initial_params(
        ref["tcfg"], 0, "cpu", ref["np_params"]))


@pytest.mark.parametrize("family", LISTED)
def test_list_trees_cross_read_and_resume(family, tmp_path, monkeypatch):
    """Griffin's and the xLSTM's checkpoints (trees with lists) restore in
    the other package bit for bit; the port resumes the reference's run;
    an interrupted supervised run of the port equals its uninterrupted
    run byte for byte."""
    arch = FAMILIES[family]
    jcfg, tcfg = _patch_configs(monkeypatch, arch)
    jrun = RunConfig(total_steps=STEPS, microbatches=1, checkpoint_every=2)
    trun = tconfigs.RunConfig(total_steps=STEPS, microbatches=1,
                              checkpoint_every=2)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jtrain.train(arch, steps=2, run=jrun, use_mesh=False,
                 checkpoint_dir=jdir, **_common())
    r = _REFS.get(family) or _reference(arch)
    jp = r["np_params"]
    jtemplate = {"params": jp, "opt": make_optimizer("adamw", jrun).init(jp)}
    want = load_checkpoint(os.path.join(jdir, "step_00000002"), jtemplate)
    tp = ttrain.initial_params(tcfg, 0, "cpu")
    ttemplate = {"params": tp, "opt": tmake_optimizer("adamw", trun).init(tp)}
    step, got = tckpt.CheckpointManager(jdir).restore(ttemplate)
    assert step == 2
    wl = jax.tree_util.tree_leaves(want)
    assert len(leaves(got)) == len(wl)
    for a, b in zip(leaves(got), wl):
        assert a.dtype == np.asarray(b).dtype
        assert a.tobytes() == np.asarray(b).tobytes()
    tckpt.CheckpointManager(tdir).save(
        5, tree_map(torch.from_numpy, got), extra={"loop": {"step": 5}},
        block=True)
    back = load_checkpoint(os.path.join(tdir, "step_00000005"), jtemplate)
    for a, b in zip(jax.tree_util.tree_leaves(back), wl):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    got = ttrain.train(arch, steps=STEPS, run=trun, device="cpu",
                       checkpoint_dir=jdir, resume=True, **_common())
    ref_run = jtrain.train(arch, steps=STEPS, run=jrun, use_mesh=False,
                           **_common())
    assert got["resumed_at"] == 2
    np.testing.assert_allclose(got["losses"], ref_run["losses"][2:],
                               rtol=10 * LOSS_RTOL)
    from repro_torch.distributed import TrainChaosConfig
    chaos = TrainChaosConfig(seed=5, nan=1, crash_steps=[3], preempt=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = ttrain.verify_resume_identity(
            arch, steps=STEPS + 1, work_dir=str(tmp_path / "v"), chaos=chaos,
            max_restarts=3, device="cpu", run=trun, **_common())
    assert res["identical"], {k: res[k] for k in res if k not in ("out",
                                                                  "ref")}
    assert res["restarts"] >= 1 and res["skipped_steps"] == 1


def test_cli_trains_xlstm_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch xlstm-125m --smoke
    --device cpu``, the reference's docstring example with the port's
    device flag."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xlstm-125m", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "32"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "train xlstm-125m on cpu" in out.stdout
    assert "final loss:" in out.stdout
