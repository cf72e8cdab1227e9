"""The port's xLSTM model (``XLSTMLM``, xlstm-125m at smoke size: 4 layers,
layer 3 an sLSTM block) against the mesh-less JAX reference with the same
weights, in fp32 on the CPU: parameter specs and the list bridge both
ways, the mLSTM and sLSTM layers, the model's forward / prefill /
decode_step logits and recurrent states (S = 512 runs two mLSTM chunks),
the fused decode chunk's tokens, and the refusal of the serving entry
points beside the reference's ``TypeError``.

Tolerances are relative to a tensor's largest |value|: the states are
sums of exponentially weighted outer products (the matrix memory C and
normaliser n of an mLSTM head grow with the tokens, ``exp(i - m)``
weighted), so an fp32 difference of summation order shows at ~1e-6 of
their scale, not of each element; REL = 1e-4 holds them."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.steps import make_generate_step as jmake  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.launch.steps import cache_tensors  # noqa: E402
from repro_torch.launch.steps import make_generate_step  # noqa: E402
from repro_torch.models import (XLSTMLM, count_params,  # noqa: E402
                                param_specs, reference_tree)
from repro_torch.models import xlstm as tx  # noqa: E402

ARCH = "xlstm-125m"
REL = 1e-4                    # of a tensor's largest |value|


@pytest.fixture(scope="module")
def ref():
    jcfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    tcfg = tconfigs.get_config(ARCH, smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 4, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm = tserve.load_model(ARCH, smoke=True, seed=0, device="cpu", cfg=tcfg,
                           params=np_params)
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=np_params, tm=tm)


def _rel(t, j, rel=REL, what=""):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().cpu().float().numpy(), j,
                               atol=rel * max(float(np.abs(j).max()), 1e-30),
                               rtol=0, err_msg=what)


def _states(tc, jc):
    """Every block's state, port against reference, within REL."""
    assert len(tc["blocks"]) == len(jc["blocks"])
    for i, (t, j) in enumerate(zip(tc["blocks"], jc["blocks"])):
        assert sorted(t) == sorted(j), i
        for k in j:
            _rel(t[k], j[k], what=f"block {i} {k}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# specs, the list bridge
# ---------------------------------------------------------------------------
def test_xlstm_specs_and_list_bridge(ref):
    """The port's flat specs are the reference's list of unlike blocks,
    ``blocks.<i>.*`` (shapes, init kinds; layer 3 of 4 is sLSTM); the
    reference's weights load and ``reference_tree(lists=("blocks",))``
    gives its tree back, a list."""
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            ref["jm"].param_specs(),
            is_leaf=lambda x: hasattr(x, "logical_axes"))[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                        for p in path)
        flat[name] = (s.shape, s.init)
    mine = param_specs(ref["tcfg"])
    assert {n: (s.shape, s.init) for n, s in mine.items()} == flat
    assert "blocks.3.slstm.r_z" in mine and "blocks.2.mlstm.w_q" in mine
    tm = ref["tm"]
    assert isinstance(tm, XLSTMLM)
    tree = reference_tree(dict(tm.named_parameters()), lists=("blocks",))
    assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == 4
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = jax.tree_util.tree_flatten_with_path(ref["np_params"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_, j) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(p))
    assert count_params(tconfigs.get_config(ARCH)) == 74_106_696
    with pytest.raises(ValueError, match="no KV cache"):
        tm.with_kv_layout("int8")


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _layer_params(r, i, kind):
    p = r["np_params"]["blocks"][i][kind]
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


@pytest.mark.parametrize("S,chunk", [(24, 8), (16, 16), (12, 256)])
def test_mlstm_chunked_matches_reference_and_steps(ref, S, chunk):
    """mlstm_chunked from a nonzero state against the reference's (out and
    C / n / m within REL), and against mlstm_step over the same tokens one
    at a time (the port's two forms of one recurrence)."""
    jp, tp = _layer_params(ref, 0, "mlstm")
    cfg, jcfg = ref["tcfg"], ref["jcfg"]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 5, cfg.d_model)).astype(np.float32)
    # a state from 5 earlier tokens
    jy0, jst = jx.mlstm_chunked(jcfg, jp, jnp.asarray(x[:, :5]), None, 5)
    ty0, tst = tx.mlstm_chunked(cfg, tp, torch.from_numpy(x[:, :5]), None, 5)
    _rel(ty0, jy0)
    jy, jst2 = jx.mlstm_chunked(jcfg, jp, jnp.asarray(x[:, 5:]), jst, chunk)
    ty, tst2 = tx.mlstm_chunked(cfg, tp, torch.from_numpy(x[:, 5:]), tst,
                                chunk)
    _rel(ty, jy)
    for k in ("C", "n", "m"):
        _rel(tst2[k], jst2[k], what=k)
    st, ys = tst, []
    for t in range(S):
        y, st = tx.mlstm_step(cfg, tp, torch.from_numpy(x[:, 5 + t:6 + t]),
                              st)
        ys.append(y)
    _rel(torch.cat(ys, 1), ty.numpy())
    for k in ("C", "n", "m"):
        _rel(st[k], tst2[k].numpy(), what=f"steps {k}")


def test_mlstm_chunk_must_divide_the_sequence(ref):
    """The reference asserts S % min(chunk, S) == 0; the port raises a
    ValueError for the same shapes."""
    jp, tp = _layer_params(ref, 0, "mlstm")
    x = np.zeros((1, 300, ref["tcfg"].d_model), np.float32)
    with pytest.raises(AssertionError):
        jx.mlstm_chunked(ref["jcfg"], jp, jnp.asarray(x), None, 256)
    with pytest.raises(ValueError, match="multiple"):
        tx.mlstm_chunked(ref["tcfg"], tp, torch.from_numpy(x), None, 256)
    with pytest.raises(ValueError, match="multiple"):
        ref["tm"].prefill(torch.zeros((1, 300), dtype=torch.int32))


def test_slstm_scan_matches_reference(ref):
    """slstm_scan over 20 steps from a nonzero state, with nonzero
    recurrent weights (the init's are zeros): out and c / n / m / h within
    REL."""
    jp, tp = _layer_params(ref, 3, "slstm")
    rng = np.random.default_rng(5)
    for k in ("r_z", "r_i", "r_f", "r_o"):
        r = (0.3 * rng.standard_normal(jp[k].shape)).astype(np.float32)
        jp[k], tp[k] = jnp.asarray(r), torch.from_numpy(r)
    cfg, jcfg = ref["tcfg"], ref["jcfg"]
    x = rng.standard_normal((3, 27, cfg.d_model)).astype(np.float32)
    jy0, jst = jx.slstm_scan(jcfg, jp, jnp.asarray(x[:, :7]))
    ty0, tst = tx.slstm_scan(cfg, tp, torch.from_numpy(x[:, :7]))
    _rel(ty0, jy0)
    jy, jst = jx.slstm_scan(jcfg, jp, jnp.asarray(x[:, 7:]), jst)
    ty, tst = tx.slstm_scan(cfg, tp, torch.from_numpy(x[:, 7:]), tst)
    _rel(ty, jy)
    for k in ("c", "n", "m", "h"):
        _rel(tst[k], jst[k], what=k)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [16, 512])
def test_xlstm_model_matches_reference(ref, S):
    """forward and prefill logits, the states after the prefill, and four
    decode steps' logits and states (written in place), within REL;
    S = 512 runs the mLSTM in two chunks of 256."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], ref["tm"]
    toks = _tokens(tm.cfg, S, (2, S))
    with use_plan(plan):
        jf = jm.forward(params, jnp.asarray(toks))
        jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    _rel(tm(torch.from_numpy(toks)), jf)
    tlg, tc = tm.prefill(torch.from_numpy(toks), max_len=S + 8)
    assert tlg.shape == (2, 1, tm.cfg.vocab_size)
    _rel(tlg, jlg)
    _states(tc, jc)
    ptrs = [t.data_ptr() for t in cache_tensors(tc)]
    decode = jax.jit(jm.decode_step)
    for i in range(4):
        f = _tokens(tm.cfg, 100 + i, (2, 1))
        jlg, jc = decode(params, jc, jnp.asarray(f))
        tlg, tc = tm.decode_step(tc, torch.from_numpy(f))
        _rel(tlg, jlg)
    _states(tc, jc)
    assert ptrs == [t.data_ptr() for t in cache_tensors(tc)]


def test_xlstm_fused_chunk_matches_reference(ref):
    """Three fused chunks of 4 after a prefill: tok, done, n_valid, toks and
    failed equal the reference's jitted ``make_generate_step`` (EOS set to
    a token of the first chunk), states within REL; the per-token
    ``decode_step`` loop gives the same tokens."""
    jm, params, plan, tm = ref["jm"], ref["params"], ref["plan"], ref["tm"]
    toks = _tokens(tm.cfg, 9, (3, 16))
    with use_plan(plan):
        jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tlg, tc = tm.prefill(torch.from_numpy(toks))
    jtok = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tlg[:, -1:], dim=-1).to(torch.int32)
    loop_c = {"blocks": [{k: v.clone() for k, v in st.items()}
                         for st in tc["blocks"]], "pos": tc["pos"].clone()}
    loop_tok, loop_out = ttok.clone(), []
    for _ in range(12):
        loop_out.append(loop_tok[:, 0].clone())
        lg, loop_c = tm.decode_step(loop_c, loop_tok)
        loop_tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    jgen = jax.jit(jmake(jm, plan, chunk=4))
    step = make_generate_step(tm, chunk=4)
    key = jax.random.PRNGKey(0)
    eos, outs = -1, []
    for c in range(3):
        jo = jgen(params, jc, jtok, key, jnp.int32(eos))
        to = step(tc, ttok, None, eos)
        for i, (t, j) in enumerate(zip((to[1],) + to[3:], (jo[1],) + jo[3:])):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                          err_msg=f"chunk {c} output {i}")
        outs.append(to[5].numpy())
        if c == 0:
            eos = int(np.asarray(jo[5])[1, 3])
        jc, jtok, key, ttok = jo[0], jo[1], jo[2], to[1]
    _states(tc, jc)
    # the loop ran without EOS: compare the first chunk, before it applies
    np.testing.assert_array_equal(outs[0], torch.stack(loop_out[:4], 1))


# ---------------------------------------------------------------------------
# serving entry points: refused, as the reference cannot build them
# ---------------------------------------------------------------------------
def test_xlstm_serving_refused_as_reference_fails(ref, monkeypatch):
    """The reference's serve() and ServeEngine raise TypeError (its serving
    programs pass full_logits to XLSTMLM.prefill, which takes none); the
    port's serve(), make_queue_engine, ServeEngine and serve CLI refuse the
    family with a ValueError before any model work."""
    with pytest.raises(TypeError, match="full_logits"):
        jserve.serve(ARCH, smoke=True, batch=1, prompt_len=8, gen=2,
                     chunk=2, warmup=False)
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], slots=1,
                        prompt_len=8, max_new=2, chunk=2)
    with pytest.raises(TypeError, match="full_logits"):
        jeng.run([JRequest(0, np.arange(1, 5, dtype=np.int32), 2)])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke",
                                      "--device", "cpu"])
    for call in (
            tserve.main,
            lambda: tserve.serve(ARCH, batch=1, prompt_len=8, gen=2,
                                 device="cpu"),
            lambda: tserve.serve(model=ref["tm"], batch=1, prompt_len=8,
                                 gen=2),
            lambda: tserve.make_queue_engine(ARCH, device="cpu"),
            lambda: ServeEngine(ref["tm"], slots=1, prompt_len=8, max_new=2)):
        with pytest.raises(ValueError, match="cannot build serving"):
            call()
