"""The port's DAMOV characterization (``repro_torch.core.damov``) against
the reference's (``repro.core.damov``) on the CPU.

``analyze_step`` counts an eager step under a ``TorchDispatchMode``; the
reference's ``analyze_hlo`` reads the compiled HLO of the same program.
Held here:

- the analyzer tests' own programs (``tests/test_core.py``), written in
  torch: the single matmul within 1% of the reference's FLOPs, the 7-step
  tanh loop within the reference test's band (0.95-1.2 x ``2 7 64^3``);
- the pure-Python functions on the same inputs (``make_roofline`` given the
  reference's figures; DAMOV's class codes equal, the labels name the
  card's units);
- a pimref-100m smoke forward, prefill, decode step and train step (AdamW;
  d_model 256, so its heads are 64 wide, a head_dim the kernels take):
  dot FLOPs within 2% of the reference's (its ``analyze_hlo`` with the
  elementwise ops switched off, the program jitted with a mesh-less plan).
  Attention: the reference on the CPU runs its jnp flash path, whose dots
  cover every (q, kv) pair of the padded tiles (here one tile each way, so
  every pair of the shapes); the port's prefill and decode kernels report
  ``4 D`` FLOPs for every pair of the shapes, and its train path's plain
  backward runs the same dots as the reference's ``_flash_vjp_bwd``. Total
  FLOPs within ``TOTAL_RTOL``: the reference also counts the jnp
  attention's elementwise ops on every score (exp, masks, selects) that
  the port's kernel keeps on chip, and XLA's decompositions of softmax and
  silu, which the eager step runs as single aten ops (a decode step's
  total is recorded: there the per-score ops are half the reference's
  count). Bytes are recorded
  beside the reference's, not held to them: an eager step reads and writes
  every op's operands, fused XLA only its fusions' (printed with ``-s``);
- equal counts on ``cpu`` and ``meta``, and one kernel report per kernel
  call; a kernel entry given ``meta`` tensors outside a counter raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import damov as jd  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import module as jmod  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import damov  # noqa: E402
from repro_torch.kernels import accounting  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.narrow_value import ops as nv  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as qmm  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.models import param_specs, reference_tree  # noqa: E402
from repro_torch.models.model import model_class, training_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

DOT_RTOL = 0.02
TOTAL_RTOL = 0.10
# the reference's TPU v5e figures, passed to the port's make_roofline
REF_HW = damov.Hardware("reference", jd.PEAK_FLOPS_BF16, jd.PEAK_FLOPS_BF16,
                        jd.HBM_BW, jd.ICI_LINK_BW)
B, S, MAX_LEN = 2, 32, 48
# pimref-100m's smoke config with heads of 64, a head_dim the kernels (and
# so their meta stand-ins) take
WIDE_HEADS = dict(d_model=256)


def _ref_stats(fn, *abstract):
    """(analyze_hlo, its dot FLOPs alone) of ``fn`` jitted on abstract
    inputs."""
    txt = jax.jit(fn).lower(*abstract).compile().as_text()
    full = jd.analyze_hlo(txt)
    saved = jd._ELEMWISE_FLOP_OPS
    jd._ELEMWISE_FLOP_OPS = set()
    try:
        dots = jd.analyze_hlo(txt)
    finally:
        jd._ELEMWISE_FLOP_OPS = saved
    return full, dots.flops


def _code(clazz: str) -> str:
    return clazz[clazz.index("("):]


# ---------------------------------------------------------------------------
# the analyzer's own programs
# ---------------------------------------------------------------------------
def test_dot_flops_single_matmul():
    a = jax.ShapeDtypeStruct((128, 64), jnp.float32)
    b = jax.ShapeDtypeStruct((64, 32), jnp.float32)
    ref, _ = _ref_stats(lambda x, y: x @ y, a, b)
    st = damov.analyze_step(lambda x, y: x @ y, torch.ones(128, 64),
                            torch.ones(64, 32))
    assert st.flops == pytest.approx(ref.flops, rel=0.01)
    assert st.flops == 2 * 128 * 64 * 32 and st.n_dots == ref.n_dots == 1


def test_tanh_loop_flops():
    def f(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()

    def g(x, w):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x.sum()

    ref, _ = _ref_stats(f, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                        jax.ShapeDtypeStruct((7, 64, 64), jnp.float32))
    st = damov.analyze_step(g, torch.ones(64, 64), torch.ones(7, 64, 64))
    expect = 2 * 7 * 64 ** 3
    assert 0.95 * expect < st.flops < 1.2 * expect
    assert st.flops == pytest.approx(ref.flops, rel=0.01)
    assert st.n_dots == 7 and st.trip_counts == []


# ---------------------------------------------------------------------------
# the pure-Python half
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_classify(mode):
    for terms in ((1.0, 0.1, 0.1), (0.1, 1.0, 0.1), (0.1, 0.1, 1.0),
                  (0.5, 0.5, 0.1), (0.0, 0.0, 0.0)):
        dom, clazz = damov.classify(*terms, mode)
        jdom, jclazz = jd.classify(*terms, mode)
        assert dom == jdom and _code(clazz) == _code(jclazz)


def _stats_pairs():
    """The same counts as the reference's HloStats and the port's
    StepStats: compute-, memory- and collective-dominated."""
    for flops, nbytes, wire in ((1e15, 1e9, 0.0), (1e12, 1e12, 0.0),
                                (1e12, 1e9, 1e12)):
        kw = dict(flops=flops, bytes=nbytes, coll_operand_bytes=wire / 2,
                  coll_wire_bytes=wire, by_kind={"all-reduce": wire / 2})
        yield jd.HloStats(**kw), damov.StepStats(**kw)


def test_make_roofline_and_reports():
    rows, jrows = [], []
    for i, (js, ts) in enumerate(_stats_pairs()):
        for mode in ("train", "decode"):
            for useful in (0.2, 0.9):
                mf = useful * js.flops * 4
                j = jd.make_roofline("a", f"s{i}", mode, "2x2", 4, js, mf,
                                     notes="n")
                t = damov.make_roofline("a", f"s{i}", mode, "2x2", 4, ts, mf,
                                        notes="n", hw=REF_HW)
                jdict, tdict = j.to_json(), t.to_json()
                assert _code(tdict.pop("bottleneck_class")) == _code(
                    jdict.pop("bottleneck_class"))
                assert tdict == jdict
                assert damov.what_would_help(t) == jd.what_would_help(j)
                jrows.append(j)
                rows.append(damov.Roofline(**{**jdict, "bottleneck_class":
                                              j.bottleneck_class}))
    assert damov.render_table(rows) == jd.render_table(jrows)


def test_model_flops_for():
    for name, shape in tconfigs.SHAPES_BY_NAME.items():
        for n in (100, 163_597_056):
            assert damov.model_flops_for(None, shape, n) == \
                jd.model_flops_for(None, shape, n)


def test_hardware_and_collective_formulas():
    """The H100 figures (the card's data sheet) and the reference's
    collective formulas: ring all-reduce 2 (g - 1) / g of the operand."""
    hw = damov.H100_SXM
    assert (hw.peak_flops_bf16, hw.peak_flops_fp32, hw.hbm_bytes_per_s,
            hw.link_bytes_per_s) == (989e12, 67e12, 3.35e12, 450e9)
    assert damov.collective_bytes("all-reduce", 8.0, 8) == (8.0, 14.0)
    assert damov.collective_bytes("all-gather", 8.0, 4) == (2.0, 6.0)
    assert damov.collective_bytes("reduce-scatter", 2.0, 4) == (8.0, 6.0)
    assert damov.collective_bytes("all-to-all", 8.0, 4) == (8.0, 6.0)
    assert damov.collective_bytes("collective-permute", 8.0, 4) == (8.0, 8.0)
    assert damov.collective_bytes("all-reduce", 8.0, 1) == (8.0, 0.0)


# ---------------------------------------------------------------------------
# pimref-100m smoke steps against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_model():
    cfg = get_config("pimref-100m", smoke=True).replace(**WIDE_HEADS)
    jm = build_model(cfg)
    return cfg, jm, jmod.abstract_params(jm.param_specs())


def _tcfg():
    return tconfigs.get_config("pimref-100m", smoke=True).replace(
        **WIDE_HEADS)


def _tokens(dev, shape=(B, S)):
    return torch.zeros(shape, dtype=torch.int32, device=dev)


def _port_steps(dev):
    """Counts of the port's forward, prefill, decode step and train step on
    ``dev`` (zero weights on the CPU, none on meta)."""
    cfg = _tcfg()
    m = tbuild_model(cfg, dev)
    out = {"forward": damov.analyze_step(m.forward, _tokens(dev))}
    (_, cache), out["prefill"] = damov.count_step(m.prefill, _tokens(dev),
                                                  MAX_LEN)
    out["decode"] = damov.analyze_step(m.decode_step, cache,
                                       _tokens(dev, (B, 1)))
    params = reference_tree(
        {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
         for n, s in param_specs(cfg).items()}, model_class(cfg).LISTS)
    opt = make_optimizer(cfg.optimizer, tconfigs.RunConfig())
    state = opt.init(params)
    batch = {"tokens": _tokens(dev), "labels": _tokens(dev)}
    step = make_train_step(training_model(cfg), opt, tconfigs.RunConfig())
    out["train"] = damov.analyze_step(step, params, state, batch)
    return out


@pytest.fixture(scope="module")
def port_meta():
    return _port_steps("meta")


@pytest.fixture(scope="module")
def ref_steps(ref_model):
    cfg, jm, ap = ref_model
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    plan = plan_sharding(cfg, ShapeConfig("s", MAX_LEN, B, "train"), None)

    def planned(fn):
        def run(*a):
            with use_plan(plan):
                return fn(*a)
        return run

    out = {"forward": _ref_stats(planned(jm.forward), ap, toks),
           "prefill": _ref_stats(planned(
               lambda p, t: jm.prefill(p, {"tokens": t}, MAX_LEN)), ap, toks)}
    cache = jax.eval_shape(planned(
        lambda p, t: jm.prefill(p, {"tokens": t}, MAX_LEN)[1]), ap, toks)
    out["decode"] = _ref_stats(planned(jm.decode_step), ap, cache,
                               jax.ShapeDtypeStruct((B, 1), jnp.int32))
    run = RunConfig()
    opt = jmake_optimizer(cfg.optimizer, run)
    state = jax.eval_shape(opt.init, ap)
    out["train"] = _ref_stats(jmake_train_step(jm, opt, plan, run), ap,
                              state, {"tokens": toks, "labels": toks})
    return out


@pytest.mark.parametrize("step", ["forward", "prefill", "decode", "train"])
def test_pimref_step_matches_reference(step, port_meta, ref_steps):
    st = port_meta[step]
    ref, ref_dots = ref_steps[step]
    dots = st.dot_flops + st.kernel_flops.get("flash_attention_fwd", 0.0) \
        + sum(v for k, v in st.kernel_flops.items() if "decode" in k)
    print(f"{step}: dot FLOPs port {dots:.0f} ref {ref_dots:.0f}; FLOPs "
          f"port {st.flops:.0f} ref {ref.flops:.0f}; bytes port "
          f"{st.bytes:.0f} ref {ref.bytes:.0f}")
    assert dots == pytest.approx(ref_dots, rel=DOT_RTOL)
    if step != "decode":
        # a decode step's elementwise work is mostly the reference's
        # per-score ops over the whole cache (about half its FLOPs at this
        # size), which the port's decode kernel keeps on chip: recorded
        assert st.flops == pytest.approx(ref.flops, rel=TOTAL_RTOL)
    assert st.bytes > 0 and ref.bytes > 0
    want = {"forward": {"flash_attention_fwd": 2},
            "prefill": {"flash_attention_fwd": 2},
            "decode": {"flash_decode_fwd": 2},
            "train": {"flash_attention_fwd": 4}}[step]
    assert st.kernels == want


def test_cpu_and_meta_count_alike(port_meta):
    cpu = _port_steps("cpu")
    for step, st in port_meta.items():
        assert dataclasses.asdict(cpu[step]) == dataclasses.asdict(st), step


# ---------------------------------------------------------------------------
# the kernel entries' reports
# ---------------------------------------------------------------------------
def _kernel_calls(dev):
    """One call of every kernel entry on ``dev``: (name, thunk)."""
    f32 = dict(dtype=torch.float32, device=dev)
    q = torch.zeros((1, 2, 2, 4, 64), **f32)
    k = torch.zeros((1, 2, 8, 64), **f32)
    qp = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    kp = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    codes = torch.zeros((1, 2, 8, 64), dtype=torch.int8, device=dev)
    scale = torch.ones((1, 2, 8), **f32)
    pool = torch.zeros((3, 8, 2, 64), **f32)        # pages of 8
    pcodes = torch.zeros((3, 8, 2, 64), dtype=torch.int8, device=dev)
    pscale = torch.ones((3, 8, 2), **f32)
    table = torch.ones((1, 2), dtype=torch.int32, device=dev)
    kp16 = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    a = torch.zeros((1, 8, 4), **f32)
    x = torch.zeros((128, 128), **f32)
    c = torch.zeros((128, 128), dtype=torch.int8, device=dev)
    s = torch.ones((1, 128), **f32)
    iv = torch.zeros(256, dtype=torch.int32, device=dev)
    i8 = torch.zeros(512, dtype=torch.int8, device=dev)
    return [
        ("flash_attention_fwd", lambda: fa.flash_attention_fwd(q, k, k, qp,
                                                               kp)),
        ("flash_decode_fwd", lambda: fa.flash_decode_fwd(q, k, k, qp, kp)),
        ("flash_decode_quant_fwd", lambda: fa.flash_decode_quant_fwd(
            q, codes, scale, codes, scale, qp, kp)),
        ("flash_decode_paged_fwd", lambda: fa.flash_decode_paged_fwd(
            q, pool, pool, table, qp, kp16)),
        ("flash_decode_paged_quant_fwd",
         lambda: fa.flash_decode_paged_quant_fwd(
             q, pcodes, pscale, pcodes, pscale, table, qp, kp16)),
        ("flash_attention_fwd", lambda: fa.flash_attention_bh(
            q[0, :, 0], k[0], k[0])),
        ("rglru_scan", lambda: rglru.rglru_scan(a, a)),
        ("quant_matmul", lambda: qmm.quant_matmul(x, c, s)),
        ("required_bits", lambda: nv.required_bits(iv)),
        ("pack_int4", lambda: nv.pack_int4(i8)),
        ("unpack_int4", lambda: nv.unpack_int4(i8)),
    ]


def test_one_report_per_kernel_call():
    """Every entry reports once a call on the CPU and on meta, with the
    same work; the plain versions' ops are not counted; on meta the
    outputs have the card's shapes and dtypes."""
    for (name, cpu_call), (_, meta_call) in zip(_kernel_calls("cpu"),
                                                _kernel_calls("meta")):
        cpu = damov.analyze_step(cpu_call)
        meta = damov.analyze_step(meta_call)
        assert cpu.kernels == meta.kernels == {name: 1}, name
        assert dataclasses.asdict(cpu) == dataclasses.asdict(meta), name
        # nothing but the report (the bh adapter's own positions and views
        # aside)
        assert set(cpu.ops) <= {"arange", "repeat", "unsqueeze", "select",
                                "slice"}, (name, cpu.ops)
        assert not cpu.ops or cpu.ops.get("repeat") == 2, (name, cpu.ops)
        outs = [o for o in (cpu_call(),) for o in (
            o if isinstance(o, tuple) else (o,))]
        with accounting.counting(damov._StepCounter()):
            mouts = meta_call()
        mouts = mouts if isinstance(mouts, tuple) else (mouts,)
        assert [(o.shape, o.dtype) for o in outs] == \
            [(o.shape, o.dtype) for o in mouts], name
    st = damov.analyze_step(_kernel_calls("cpu")[0][1])
    # B 1 x Hkv 2 x G 2 x S 4 x T 8 pairs, 4 D FLOPs each
    assert st.kernel_flops == {"flash_attention_fwd": 4 * 2 * 2 * 4 * 8 * 64}


def test_meta_outside_a_counter_raises():
    for name, call in _kernel_calls("meta"):
        with pytest.raises((ValueError, TypeError)):
            call()
