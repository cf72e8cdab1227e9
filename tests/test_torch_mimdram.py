"""The port's MIMDRAM planner (``repro_torch.core.mimdram``) against the
reference's (``repro.core.mimdram``) on the CPU.

The reference plans on ``jax.sharding.AbstractMesh`` (no devices needed);
the port plans on ``DeviceMesh`` es built under torch's fake process group
of 512 ranks, in a subprocess (``torch_dist_worker.py plans``) so that the
group is gone when the test ends. Compared, for every arch x the four
shape cells x the meshes none, (8,) data, (4, 2) data x model, (16, 16)
data x model and (2, 16, 16) pod x data x model: ``rules``, ``notes``,
``segment_utilization``, ``segments``, ``vf_report`` and the spec of every
parameter leaf (the port's per-layer spec equals the reference's stacked
leaf's after its leading ``None``), exactly. Both sides plan serving with
the reference's 8e9-byte budget. ``reduce_hierarchical`` runs on 8 gloo
ranks as (2, 2, 2): int32 bit for bit against one flat all_reduce, fp32
within the summation order's rounding."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from repro.configs import SHAPES, get_config  # noqa: E402
from repro.core import mimdram as jmim  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import module as jmod  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import mimdram  # noqa: E402
from repro_torch.models import param_pspecs, param_specs  # noqa: E402

STACKED = ("blocks", "groups", "enc_blocks", "dec_blocks")
# a sum of 8 fp32 values in another order: within a few ulps of the largest
# partial sum
FP32_SUM_RTOL = 8 * 2 ** -23


@pytest.fixture(scope="module")
def port_plans(tmp_path_factory):
    path = tmp_path_factory.mktemp("plans") / "plans.json"
    return worker.run_plans(str(path))


def _norm(x):
    """Tuples (and PartitionSpecs) as lists, as JSON holds them."""
    return json.loads(json.dumps(x, default=tuple))


def _reference_leaf_specs(cfg, plan):
    """The reference's param_pspecs, by the port's flat parameter names."""
    pspecs = jmod.param_pspecs(build_model(cfg).param_specs(), plan)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        spec = list(_norm(tuple(spec)))
        if keys[0] in STACKED and isinstance(path[1],
                                             jax.tree_util.DictKey):
            assert spec[0] is None, (keys, spec)  # the layer axis
            n = (cfg.num_layers // 3 if keys[0] == "groups" else
                 cfg.num_encoder_layers if keys[0] == "enc_blocks" else
                 cfg.num_layers)
            for i in range(n):
                flat[".".join(map(str, [keys[0], i] + keys[1:]))] = spec[1:]
        else:
            flat[".".join(map(str, keys))] = spec
    return flat


@pytest.mark.parametrize("arch", tconfigs.ALL_IDS)
def test_plans_match_reference(arch, port_plans):
    cfg = get_config(arch)
    n_cells = 0
    for shape in SHAPES:
        for m in worker.PLAN_MESHES:
            mesh = None if m is None else AbstractMesh(m[0], m[1])
            name = "none" if m is None else "x".join(map(str, m[0]))
            plan = jmim.plan_sharding(cfg, shape, mesh)
            got = port_plans[f"{arch}|{shape.name}|{name}"]
            where = f"{arch} {shape.name} {name}"
            assert got["rules"] == _norm(plan.rules), where
            assert got["notes"] == _norm(plan.notes), where
            assert got["segment_utilization"] == plan.segment_utilization, \
                where
            assert got["segments"] == _norm(plan.segments), where
            assert got["vf"] == _norm(jmim.vf_report(cfg, shape)), where
            assert got["specs"] == _reference_leaf_specs(cfg, plan), where
            n_cells += 1
    assert n_cells == 20


def test_placements_and_default_budget(port_plans):
    """DTensor placements on (2, 16, 16) pod x data x model, one per mesh
    dim (a dim over pod and data is Shard twice, in mesh order); the port's
    default serving budget (half an H100's 80 GB) keeps pixtral-12b's
    weights off the data axes where the reference's 8e9 does not."""
    assert port_plans["placements"] == {
        # mixtral train_4k: embed FSDP over (pod, data), heads on model
        "w_q": ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"],
        # 8 experts do not divide 16: d_ff takes the model axis
        "experts": ["Shard(dim=1)", "Shard(dim=1)", "Shard(dim=2)"],
        "tokens": ["Shard(dim=0)", "Shard(dim=0)", "Replicate()"]}
    jplan = jmim.plan_sharding(get_config("pixtral-12b"), SHAPES[2],
                               AbstractMesh((8,), ("data",)))
    assert any("FSDP fallback" in n for n in jplan.notes)
    assert not any("FSDP fallback" in n
                   for n in port_plans["default_budget"])
    assert mimdram.SERVING_PARAM_BUDGET == 40e9


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-coder-33b",
                                  "mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_planner_no_mesh_is_unsharded(arch):
    plan = mimdram.plan_sharding(tconfigs.get_config(arch),
                                 tconfigs.SHAPES_BY_NAME["train_4k"], None)
    assert not any(plan.rules.values())
    assert plan.segment_utilization == 1.0
    specs = param_pspecs(param_specs(tconfigs.get_config(arch)), plan)
    assert all(all(p is None for p in s) for s in specs.values())


def test_plan_spec_dedups_and_embed_extra():
    """A mesh axis is used once; the first ``embed`` dim takes the
    ``_embed_extra`` axes pass 1 left unused; ``dims`` drops axes that do
    not divide, right to left: the reference's three rules."""
    for P_, mesh in ((jmim.Plan, None), (mimdram.Plan, None)):
        plan = P_(rules={"a": ("data",), "b": ("data",)}, mesh=mesh)
        s = tuple(plan.spec("a", "b"))
        assert s[0] == "data" and s[1] is None
    rules = {"embed": ("data",), "mlp": ("model",), "_embed_extra": ("model",
                                                                     "x")}
    for logical in (("embed", "mlp"), ("mlp", "embed"), ("heads", "embed")):
        want = tuple(jmim.Plan(rules=rules, mesh=None).spec(*logical))
        assert mimdram.Plan(rules=rules, mesh=None).spec(*logical) == want


def test_vf_report_and_shapes_copied():
    for shape in SHAPES:
        mine = tconfigs.SHAPES_BY_NAME[shape.name]
        assert (mine.seq_len, mine.global_batch, mine.mode) == (
            shape.seq_len, shape.global_batch, shape.mode)
        for arch in tconfigs.ALL_IDS:
            assert mimdram.vf_report(tconfigs.get_config(arch), mine) == \
                jmim.vf_report(get_config(arch), shape)
    assert mimdram.PARAM_AXES == jmim.PARAM_AXES
    assert mimdram.ACT_AXES == jmim.ACT_AXES


def test_constrain_without_a_plan_or_mesh():
    x = torch.ones(2, 3)
    assert mimdram.constrain(x, "act_batch", "act_embed") is x
    plan = mimdram.plan_sharding(tconfigs.get_config("pimref-100m"),
                                 tconfigs.SHAPES[0], None)
    with mimdram.use_plan(plan) as p:
        assert mimdram.current_plan() is p
        assert mimdram.constrain(x, "act_batch", "act_embed") is x
    assert mimdram.current_plan() is None
    with pytest.raises(ValueError, match="needs a mesh"):
        mimdram.reduce_hierarchical(x, ("data",))


def test_reduce_hierarchical_gloo(tmp_path):
    """8 gloo ranks as (2, 2, 2) pod x data x model: the pod-local-first
    sum equals one flat all_reduce, int32 bit for bit, fp32 within the
    order's rounding; the data x model sum alone is the sum over each pod;
    ``constrain`` turns a replicated DTensor into the plan's batch split."""
    outs = worker.run_ranks("reduce", 8, tmp_path)
    ints = np.stack([o["int_in"] for o in outs]).astype(np.int64)
    floats = np.stack([o["float_in"] for o in outs]).astype(np.float64)
    limit = FP32_SUM_RTOL * np.abs(floats).sum(0)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["int_h"], o["int_flat"])
        np.testing.assert_array_equal(o["int_h"], ints.sum(0))
        assert (np.abs(o["float_h"] - o["float_flat"]) <= limit).all()
        assert (np.abs(o["float_h"] - floats.sum(0)) <= limit).all()
        pod = o["coords"][0]
        pod_sum = floats[[i for i, q in enumerate(outs)
                          if q["coords"][0] == pod]].sum(0)
        assert (np.abs(o["float_dm"] - pod_sum) <= limit).all()
        # batch 8 over (pod, data): 2 rows a (pod, data) pair
        i = 2 * o["coords"][0] + o["coords"][1]
        full = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        np.testing.assert_array_equal(o["constrained"], full[2 * i:2 * i + 2])
        assert list(o["placements"]) == ["Shard(dim=0)", "Shard(dim=0)",
                                         "Replicate()"]
