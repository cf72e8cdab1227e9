"""The port's dry-run (``repro_torch.launch.dryrun``), its cell assembly
(``repro_torch.launch.steps.cell_artifacts``), its input and cache specs
(``repro_torch.launch.specs``), the models' ``cache_logical_axes`` and the
production mesh against the reference's on the CPU.

The port's side that needs a ``DeviceMesh`` runs in a subprocess under
torch's fake process group (``torch_dist_worker.py dryrun``: 256 ranks for
(16, 16), 512 for (2, 16, 16), 1 for one device). Compared, exactly:

* the argument bytes of the smoke serving cells (internlm2-1.8b,
  mixtral-8x7b, recurrentgemma-2b; prefill and decode, batch 8 x 64) on a
  one-device mesh against the reference's
  ``compiled.memory_analysis().argument_size_in_bytes``;
* the per-device argument bytes of every argument of every arch x shape
  cell on (16, 16) and (2, 16, 16), from the port's placements, against
  the reference's ``PartitionSpec`` s and mesh sizes (each dim over the
  product of its axes' sizes, rounded up; nothing compiled), with the
  reference's serving budget on both sides;
* the microbatches ``cell_artifacts`` picks, and whether it picks the
  Proteus step;
* ``skip_reason`` of every cell; ``cache_logical_axes`` and the decode
  cell's ``cache_pspecs`` leaf for leaf in every KV layout;
* ``describe`` and ``n_chips`` of the production meshes.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from repro.compat import make_mesh  # noqa: E402
from repro.configs import RunConfig, SHAPES, ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.mimdram import plan_sharding as tplan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module")
def port_dry(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    return worker.run_plans(str(path), mode="dryrun")


def _norm(x):
    return json.loads(json.dumps(x, default=tuple))


def _serving(cfg, shape):
    return cfg.replace(param_dtype="bfloat16") if shape.mode != "train" \
        else cfg


def _reference_bytes(cfg, shape, mesh):
    """Per-device bytes of each argument of the reference's cell, from its
    PartitionSpecs and the mesh's sizes; its microbatches and step."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    plan = plan_sharding(cfg, shape, mesh)
    _, step, args, shardings, _, run, _ = jsteps.cell_artifacts(
        cfg, shape, plan, RunConfig(microbatches=0, proteus_enabled=True))
    out = []
    for a, sh in zip(args, shardings):
        leaves = jax.tree_util.tree_leaves(a)
        specs = jax.tree_util.tree_leaves(
            sh, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(specs)
        total = 0
        for leaf, s in zip(leaves, specs):
            dims = list(leaf.shape)
            for i, ax in enumerate(s.spec):
                if ax is not None:
                    ax = ax if isinstance(ax, tuple) else (ax,)
                    n = math.prod(sizes[x] for x in ax)
                    dims[i] = -(-dims[i] // n)
            total += math.prod(dims) * leaf.dtype.itemsize
        out.append(total)
    return out, run.microbatches, step.__qualname__.split(".")[0]


@pytest.mark.parametrize("arch", tconfigs.ALL_IDS)
def test_argument_bytes_match_reference(arch, port_dry):
    for mname, (shp, names) in worker.DRYRUN_MESHES.items():
        mesh = AbstractMesh(shp, names)
        for shape in SHAPES:
            want = _reference_bytes(_serving(get_config(arch), shape), shape,
                                    mesh)
            got = port_dry[f"args|{arch}|{shape.name}|{mname}"]
            assert got[0] == want[0], (mname, shape.name, got, want)
            if shape.mode == "train":
                assert got[1:] == list(want[1:]), (mname, got, want)


@pytest.mark.parametrize("arch", worker.ONE_DEVICE_ARCHS)
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_one_device_argument_bytes_match_compiled(arch, mode, port_dry):
    cfg = get_config(arch, smoke=True)
    seq, batch = worker.ONE_DEVICE_SHAPE
    shape = ShapeConfig("t", seq_len=seq, global_batch=batch, mode=mode)
    mesh = make_mesh((1,), ("data",))
    plan = plan_sharding(cfg, shape, mesh)
    _, step, args, shardings, donate, _, out_sh = jsteps.cell_artifacts(
        cfg, shape, plan, RunConfig(microbatches=1))
    compiled = jax.jit(step, in_shardings=shardings, out_shardings=out_sh,
                       donate_argnums=donate or None).lower(*args).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    assert sum(port_dry[f"one|{arch}|{mode}"]) == want


@pytest.mark.parametrize("arch", tconfigs.ALL_IDS)
def test_skip_reason_matches(arch):
    for shape in SHAPES:
        want = jdry.skip_reason(get_config(arch), shape)
        got = dryrun.skip_reason(tconfigs.get_config(arch),
                                 tconfigs.SHAPES_BY_NAME[shape.name])
        assert got == want, (arch, shape.name)


def _layouts(cfg):
    return (worker.CACHE_LAYOUTS if cfg.family in ("dense", "moe", "vlm",
                                                    "audio")
            else (("off", 0),))


def _reference_model(arch, q, ps, monkeypatch):
    monkeypatch.setenv("REPRO_KV_QUANT", q)
    monkeypatch.setenv("REPRO_KV_PAGES", str(ps))
    return jbuild(get_config(arch).replace(param_dtype="bfloat16"))


@pytest.mark.parametrize("arch", tconfigs.ALL_IDS)
def test_cache_axes_and_specs_match_reference(arch, port_dry, monkeypatch):
    cfg = tconfigs.get_config(arch).replace(param_dtype="bfloat16")
    for q, ps in _layouts(cfg):
        jm = _reference_model(arch, q, ps, monkeypatch)
        want = jax.tree_util.tree_leaves(
            jm.cache_logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
        tm = build_model(cfg, "meta", kv_quant=q, page_size=ps)
        got = tspecs.cache_leaves(tm.cache_logical_axes())
        assert got == want, (q, ps)
        # the leaves' shapes line up with the axes
        shapes = tspecs.cache_leaves(tspecs.cache_specs(tm, SHAPES[2]))
        jshapes = jax.tree_util.tree_leaves(jspecs.cache_specs(jm,
                                                               SHAPES[2]))
        assert [tuple(t.shape) for t in shapes] == \
            [tuple(s.shape) for s in jshapes]
        assert [len(a) for a in got] == [t.dim() for t in shapes]
        for mname, (shp, names) in worker.DRYRUN_MESHES.items():
            plan = plan_sharding(jm.cfg, SHAPES[2], AbstractMesh(shp, names))
            ref = jax.tree_util.tree_leaves(
                jspecs.cache_pspecs(jm, plan, SHAPES[2]),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert port_dry[f"cache|{arch}|{q}|{ps}|{mname}"] == \
                [_norm(tuple(s)) for s in ref], (q, ps, mname)


def _batch_sizes(cache, axis):
    """The size of every cache leaf along its ``cache_batch_axes`` entry (a
    paged leaf's table's, a QKVCache's codes' and scales')."""
    from repro_torch.models.layers import PagedKVCache, QKVCache
    if isinstance(cache, dict):
        assert cache.keys() == axis.keys()
        return [n for k in cache for n in _batch_sizes(cache[k], axis[k])]
    if isinstance(cache, list):
        assert len(cache) == len(axis)
        return [n for c, a in zip(cache, axis) for n in _batch_sizes(c, a)]
    if isinstance(cache, PagedKVCache):
        return [cache.table.shape[axis]]
    if isinstance(cache, QKVCache):
        return [cache.codes.shape[axis], cache.scale.shape[axis]]
    return [cache.shape[axis]]


@pytest.mark.parametrize("arch", tconfigs.ALL_IDS)
def test_cache_batch_axes_are_the_batch_dims(arch):
    """``cache_batch_axes``, worked out from ``cache_logical_axes``, points
    at the batch dim of every leaf of ``init_cache`` in every KV layout."""
    cfg = tconfigs.get_config(arch, smoke=True)
    for q, ps in _layouts(cfg):
        tm = build_model(cfg, "meta", kv_quant=q, page_size=ps)
        cache = tspecs.cache_specs(tm, ShapeConfig("d", 64, 3, "decode"))
        sizes = _batch_sizes(cache, tm.cache_batch_axes())
        assert set(sizes) == {3}, (q, ps, sizes)


@pytest.mark.parametrize("name,multi", [("16x16", False), ("2x16x16", True)])
def test_production_mesh_describe_and_n_chips(port_dry, name, multi):
    shape, names = worker.DRYRUN_MESHES[name]
    want = AbstractMesh(shape, names)
    assert port_dry[f"mesh|{name}"] == [jmesh.describe(want),
                                        jmesh.n_chips(want)]
    assert port_dry["mesh|local"] == [jmesh.describe(AbstractMesh(
        (8, 1), ("data", "model"))), 8]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_specs_against_reference(mode):
    """input_specs (with the decode template) and batch_pspecs on the
    reference's meshes, for a VLM, an encoder-decoder and a dense arch."""
    for arch in ("pixtral-12b", "seamless-m4t-large-v2", "pimref-100m"):
        shape = dict(name="s", seq_len=64, global_batch=16, mode=mode)
        want = jspecs.input_specs(get_config(arch), ShapeConfig(**shape))
        got = tspecs.input_specs(tconfigs.get_config(arch),
                                 tconfigs.ShapeConfig(**shape))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


def test_optimizer_state_specs_match_init():
    """Each optimizer's ``state_specs`` has ``init``'s structure, shapes and
    dtypes, and its moments carry their parameters' logical axes."""
    from repro_torch.configs import RunConfig as TRun
    from repro_torch.models.module import ParamSpec
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaves_with_path, tree_map
    for arch in ("pimref-100m", "recurrentgemma-2b", "xlstm-125m"):
        cfg = tconfigs.get_config(arch, smoke=True)
        specs = tspecs.param_spec_tree(cfg)
        params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                device="meta"), specs,
                          is_leaf=lambda x: isinstance(x, ParamSpec))
        for name in ("adamw", "adafactor", "sgd"):
            opt = make_optimizer(name, TRun())
            state = leaves_with_path(opt.init(params))
            ranks = []
            sspecs = leaves_with_path(tree_map(
                lambda s: ranks.append(len(s.logical_axes) - len(s.shape))
                or torch.empty(s.shape, dtype=s.dtype, device="meta"),
                opt.state_specs(specs),
                is_leaf=lambda x: isinstance(x, ParamSpec)))
            assert [(p, tuple(t.shape), t.dtype) for p, t in state] == \
                [(p, tuple(t.shape), t.dtype) for p, t in sspecs], \
                (arch, name)
            assert ranks and not any(ranks)


# the archs whose head dims (stablelm-3b 80, kimi-k2 112) the kernels took
# last; run_cell holds them on meta at the card's head dims
HEAD_DIM_ARCHS = ("stablelm-3b", "kimi-k2-1t-a32b")
HEAD_DIM_SHAPES = ("prefill_32k", "decode_32k", "train_4k", "long_500k")


@pytest.fixture(scope="module")
def head_dim_cells(tmp_path_factory):
    """run_cell's rows for HEAD_DIM_ARCHS x HEAD_DIM_SHAPES on both
    production meshes, through the dry-run's CLI in parallel processes (on
    meta kimi-k2's train cells take minutes each: 16 and 8 microbatches of
    61 layers, the plain attention backward's tiles counted op by op); by
    (arch, shape, multi_pod), with each process's output."""
    out = tmp_path_factory.mktemp("dryrun_head_dims")
    kimi = HEAD_DIM_ARCHS[1]
    jobs = ([(kimi, "train_4k", m) for m in ("single", "multi")]
            + [(kimi, s, "both") for s in HEAD_DIM_SHAPES if s != "train_4k"]
            + [(HEAD_DIM_ARCHS[0], None, "both")])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mesh in jobs:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--mesh", mesh, "--out", str(out)]
        procs.append(subprocess.Popen(
            argv + (["--shape", shape] if shape else []), env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=1200)[0] for p in procs]
    rows = {}
    for name in os.listdir(out):
        with open(out / name) as f:
            row = json.load(f)
        rows[(row["arch"], row["shape"], row["multi_pod"])] = row
    return rows, "\n".join(log[-1500:] for log in logs)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", HEAD_DIM_SHAPES)
@pytest.mark.parametrize("arch", HEAD_DIM_ARCHS)
def test_head_dim_cells_run(arch, shape, multi, head_dim_cells):
    """stablelm-3b's and kimi-k2's cells come out OK on both meshes (the
    kernel entries take D 80 and 112 on meta), with argument bytes equal
    to the reference's PartitionSpec arithmetic and the attention kernel
    counted once a layer (a train step: forward and remat recompute, each
    microbatch); long_500k stays SKIP with the reference's reason."""
    rows, logs = head_dim_cells
    row = rows[(arch, shape, multi)]
    ref_shape = {s.name: s for s in SHAPES}[shape]
    cfg = get_config(arch)
    if shape == "long_500k":
        assert row["status"] == "SKIP"
        assert row["reason"] == jdry.skip_reason(cfg, ref_shape)
        return
    assert row["status"] == "OK", (row.get("error"), logs)
    mname = "2x16x16" if multi else "16x16"
    mesh = AbstractMesh(*worker.DRYRUN_MESHES[mname])
    want, microbatches, _ = _reference_bytes(_serving(cfg, ref_shape),
                                             ref_shape, mesh)
    assert row["memory"]["argument_bytes"] == sum(want)
    kernel, per_layer = {"prefill": ("flash_attention_fwd", 1),
                         "decode": ("flash_decode_fwd", 1),
                         "train": ("flash_attention_fwd",
                                   2 * microbatches)}[ref_shape.mode]
    assert row["step_cost"]["kernels"] == {kernel: per_layer *
                                           cfg.num_layers}


def test_predict_cell_one_device():
    """Without a mesh a cell's argument bytes are its arguments' bytes; the
    one-device step is counted on meta (temporaries, FLOPs, kernels)."""
    from repro_torch.configs import RunConfig as TRun
    from repro_torch.kernels.accounting import nbytes
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    cfg = tconfigs.get_config("pimref-100m", smoke=True).replace(head_dim=64)
    for mode in ("train", "prefill", "decode"):
        shape = tconfigs.ShapeConfig("t", 64, 4, mode)
        plan = tplan(cfg, shape)
        got = dryrun.predict_cell(cfg, shape, plan, TRun(microbatches=1))
        _, _, args, pl, _, _, _ = steps.cell_artifacts(cfg, shape, plan,
                                                       TRun(microbatches=1))
        flat = [t for t, _ in dryrun._pairs(args, pl)]
        assert got["memory"]["argument_bytes"] == nbytes(*flat)
        assert got["memory"]["temp_bytes"] > 0
        assert got["split"] == 1 and not got["proteus_step"]
        kern = {"train": ("flash_attention_fwd", 2),
                "prefill": ("flash_attention_fwd", 1),
                "decode": ("flash_decode_fwd", 1)}[mode]
        assert got["stats"].kernels == {kern[0]: kern[1] * cfg.num_layers}


def test_run_cell_skip_row(tmp_path):
    row = dryrun.run_cell("pimref-100m", "long_500k", False,
                          tconfigs.RunConfig(), {}, "", str(tmp_path))
    assert row["status"] == "SKIP" and "full-attention" in row["reason"]
    assert os.listdir(tmp_path) == ["pimref-100m_long_500k_data16xmodel16.json"]


def test_cli_runs_a_cell_without_jax(tmp_path):
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'pimref-100m', '--shape', "
            f"'decode_32k', '--mesh', 'single', '--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "1 OK, 0 SKIP, 0 FAIL" in res.stdout
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        row = json.load(f)
    assert row["status"] == "OK" and row["mesh"] == "data=16xmodel=16"
    assert row["memory"]["argument_bytes"] > 0
    assert row["damov"]["bottleneck_class"]
