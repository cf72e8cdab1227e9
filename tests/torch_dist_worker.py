"""Multi-process workers of the port's paper-layer tests (torch only: no
jax, no ``repro``), and the launcher that runs them with time limits.

    python torch_dist_worker.py plans OUT.json
        every arch x shape x mesh planned by ``repro_torch.core.mimdram`` on
        ``DeviceMesh`` es under torch's fake process group of 512 ranks
        (one process; the group is destroyed before it exits)
    python torch_dist_worker.py dryrun OUT.json
        the dry-run's per-device argument bytes of every arch x shape on the
        two production meshes and of the smoke serving cells on one device,
        and the decode cache's specs in every KV layout (fake groups of 256,
        512 and 1 ranks, one after the other)
    python torch_dist_worker.py <mode> RANK WORLD STORE OUT_DIR [INPUTS]
        one gloo rank of ``mode`` (``reduce``, ``dappa``, ``proteus``,
        ``proteus_train``, ``proteus_one``, ``pipeline``), rendezvous
        through the ``FileStore`` at STORE; reads its inputs from the npz
        INPUTS when the mode takes any (the reference's, from
        ``torch_dist_reference.py``); writes OUT_DIR/rank<RANK>.npz

Every rank's process group is created with a timeout, so a hung
rendezvous or collective fails in seconds.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys

import numpy as np

# the reference's cells and the layout of its npz trees
from torch_dist_reference import (PSUM_BLOCK, TRAIN_BLOCK, TRAIN_RUN,
                                  TRAIN_SHAPE, flat_tree, nested)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

PG_TIMEOUT_S = 30
# the meshes the planner is held to the reference on: (shape, names)
PLAN_MESHES = (None, ((8,), ("data",)), ((4, 2), ("data", "model")),
               ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))
# the reference's serving budget (half a 16 GB TPU chip), passed so that the
# port's plans can be held to the reference's
REFERENCE_SERVING_BUDGET = 8e9
# the reduce mode's mesh: pod x data x model over 8 ranks
REDUCE_MESH = ((2, 2, 2), ("pod", "data", "model"))
REDUCE_N = 1000


def run_ranks(mode: str, world: int, tmp_path, timeout: float = 120.0,
              inputs: str = ""):
    """Run ``mode`` on ``world`` gloo ranks, each in its own process (with
    the npz ``inputs``, if given); returns the ranks' outputs (dicts of
    arrays) in rank order. A rank that fails or outlives ``timeout`` fails
    the call (every rank is killed)."""
    store = os.path.join(str(tmp_path), f"store_{mode}")
    out = os.path.join(str(tmp_path), f"out_{mode}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         store, out] + ([inputs] if inputs else []), env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{mode}: a rank outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, (f"{mode}: ranks {bad} failed; rank {bad[0]}'s log:\n"
                     f"{logs[bad[0]][-3000:]}" if bad else "")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


def run_plans(out_json: str, timeout: float = 300.0,
              mode: str = "plans") -> dict:
    """The ``plans`` (or ``dryrun``) mode in a subprocess; returns its
    JSON."""
    subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                    out_json], check=True, timeout=timeout,
                   env=dict(os.environ, OMP_NUM_THREADS="1"))
    with open(out_json) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------
def _jsonable(x):
    if isinstance(x, tuple):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


def plans(out_json: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ALL_IDS, SHAPES, get_config
    from repro_torch.core.mimdram import plan_sharding, vf_report
    from repro_torch.models import param_pspecs, param_specs

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        meshes = {"none": None}
        for m in PLAN_MESHES[1:]:
            meshes["x".join(map(str, m[0]))] = init_device_mesh(
                "cpu", m[0], mesh_dim_names=m[1])
        out = {}
        for arch in ALL_IDS:
            cfg = get_config(arch)
            specs = param_specs(cfg)
            for shape in SHAPES:
                for mname, mesh in meshes.items():
                    plan = plan_sharding(
                        cfg, shape, mesh,
                        serving_param_budget=REFERENCE_SERVING_BUDGET)
                    out[f"{arch}|{shape.name}|{mname}"] = _jsonable(dict(
                        rules=plan.rules, notes=plan.notes,
                        segment_utilization=plan.segment_utilization,
                        segments=plan.segments, vf=vf_report(cfg, shape),
                        specs=param_pspecs(specs, plan)))
        # placements of a few specs on the 3-D mesh
        mesh = meshes["2x16x16"]
        plan = plan_sharding(get_config("mixtral-8x7b"), SHAPES[0], mesh)
        out["placements"] = {
            name: [repr(p) for p in plan.placements(*axes, dims=dims)]
            for name, (axes, dims) in {
                "w_q": (("embed", "heads", "head_dim"), (4096, 32, 128)),
                "experts": (("expert", "embed", "mlp"), (8, 4096, 14336)),
                "tokens": (("act_batch", "act_seq"), (256, 4096))}.items()}
        # the port's own serving budget (half an H100's 80 GB): pixtral-12b's
        # bf16 weights (~24.8 GB) fit it, not the reference's 8e9
        out["default_budget"] = _jsonable(plan_sharding(
            get_config("pixtral-12b"), SHAPES[2], meshes["8"]).notes)
    finally:
        dist.destroy_process_group()
    with open(out_json, "w") as f:
        json.dump(out, f)


# the dry-run's cells held to the reference: every arch x shape on the two
# production meshes (arithmetic), and the smoke configs' serving cells on
# one device (against the reference's compiled argument bytes)
DRYRUN_MESHES = {"16x16": ((16, 16), ("data", "model")),
                 "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ONE_DEVICE_ARCHS = ("internlm2-1.8b", "mixtral-8x7b", "recurrentgemma-2b")
ONE_DEVICE_SHAPE = (64, 8)                # seq, batch
# KV layouts (kv_quant, page_size) of the cache specs
CACHE_LAYOUTS = (("off", 0), ("int8", 0), ("int4", 0), ("auto", 0),
                 ("off", 16), ("int8", 16))


def dryrun_cells(world_shape, names, cells, budget=None) -> dict:
    """Per cell of ``cells`` ((cfg, shape) by key) on a mesh of
    ``world_shape`` under a fake process group of its ranks: the
    per-device argument bytes (one entry an argument of the step), the
    microbatches ``cell_artifacts`` picks, and its step's name with Proteus
    asked for."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.mimdram import plan_sharding
    from repro_torch.configs import RunConfig
    from repro_torch.launch import dryrun, steps
    out = {}
    with dryrun.fake_world(int(np.prod(world_shape))):
        mesh = init_device_mesh("cpu", world_shape, mesh_dim_names=names)
        for key, (cfg, shape) in cells.items():
            kw = {} if budget is None else {"serving_param_budget": budget}
            plan = plan_sharding(cfg, shape, mesh, **kw)
            _, step, args, pl, _, run, _ = steps.cell_artifacts(
                cfg, shape, plan, RunConfig(microbatches=0,
                                            proteus_enabled=True))
            out[key] = [[dryrun.device_bytes(a, p, mesh)
                         for a, p in zip(args, pl)], run.microbatches,
                        step.__qualname__.split(".")[0]]
    return out


def dryrun(out_json: str) -> None:
    """The dry-run's argument bytes (production meshes with the reference's
    serving budget; one device) and cache specs in every KV layout."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ALL_IDS, SHAPES, ShapeConfig, get_config
    from repro_torch.core.mimdram import plan_sharding
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    out = {}
    cells = {}
    for arch in ALL_IDS:
        for shape in SHAPES:
            cfg = get_config(arch)
            if shape.mode != "train":
                cfg = cfg.replace(param_dtype="bfloat16")
            cells[f"{arch}|{shape.name}"] = (cfg, shape)
    for mname, (shp, names) in DRYRUN_MESHES.items():
        got = dryrun_cells(shp, names, cells, REFERENCE_SERVING_BUDGET)
        out.update({f"args|{k}|{mname}": v for k, v in got.items()})
        # the cache specs of the decode cell in every KV layout
        with dr.fake_world(int(np.prod(shp))):
            from repro_torch.launch import mesh as mesh_lib
            prod = mesh_lib.make_production_mesh(len(shp) == 3, "cpu")
            out[f"mesh|{mname}"] = [mesh_lib.describe(prod),
                                    mesh_lib.n_chips(prod)]
            mesh = init_device_mesh("cpu", shp, mesh_dim_names=names)
            for arch in ALL_IDS:
                cfg = get_config(arch).replace(param_dtype="bfloat16")
                layouts = (CACHE_LAYOUTS if cfg.family in
                           ("dense", "moe", "vlm", "audio") else
                           (("off", 0),))
                plan = plan_sharding(cfg, SHAPES[2], mesh,
                                     serving_param_budget=REFERENCE_SERVING_BUDGET)
                for q, ps in layouts:
                    m = build_model(cfg, "meta", kv_quant=q, page_size=ps)
                    out[f"cache|{arch}|{q}|{ps}|{mname}"] = _jsonable(
                        specs.cache_leaves(specs.cache_pspecs(m, plan,
                                                              SHAPES[2])))
    seq, batch = ONE_DEVICE_SHAPE
    one = {f"{arch}|{mode}": (get_config(arch, smoke=True),
                              ShapeConfig("t", seq, batch, mode))
           for arch in ONE_DEVICE_ARCHS for mode in ("prefill", "decode")}
    out.update({f"one|{k}": v[0] for k, v in dryrun_cells(
        (1,), ("data",), one).items()})
    with dr.fake_world(8):
        from repro_torch.launch import mesh as mesh_lib
        local = mesh_lib.make_local_mesh(("data", "model"), "cpu")
        out["mesh|local"] = [mesh_lib.describe(local),
                             mesh_lib.n_chips(local)]
    with open(out_json, "w") as f:
        json.dump(out, f)


def _init(rank: int, world: int, store_path: str):
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def reduce(rank: int, world: int) -> dict:
    """reduce_hierarchical over (pod, data, model) against one flat
    all_reduce, int32 and fp32; constrain() of a replicated DTensor."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.mimdram import (constrain, plan_sharding,
                                          reduce_hierarchical, use_plan)
    mesh = init_device_mesh("cpu", REDUCE_MESH[0],
                            mesh_dim_names=REDUCE_MESH[1])
    rng = np.random.default_rng(rank)
    xi = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, REDUCE_N,
                                       dtype=np.int32))
    xf = torch.from_numpy(rng.standard_normal(REDUCE_N).astype(np.float32))
    out = {"int_in": xi.numpy().copy(), "float_in": xf.numpy().copy()}
    axes = REDUCE_MESH[1]
    out["int_h"] = reduce_hierarchical(xi.clone(), axes, mesh).numpy()
    out["float_h"] = reduce_hierarchical(xf.clone(), axes, mesh).numpy()
    flat_i, flat_f = xi.clone(), xf.clone()
    dist.all_reduce(flat_i)
    dist.all_reduce(flat_f)
    out["int_flat"], out["float_flat"] = flat_i.numpy(), flat_f.numpy()
    # the data and model axes alone (no pod hop)
    out["float_dm"] = reduce_hierarchical(xf.clone(), ("data", "model"),
                                          mesh).numpy()
    # constrain: a replicated (B, S) token tensor to the plan's batch split
    cfg = get_config("pimref-100m", smoke=True)
    plan = plan_sharding(cfg, ShapeConfig("t", 16, 8, "train"), mesh)
    full = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    dt = distribute_tensor(full, mesh, [Replicate()] * 3)
    with use_plan(plan):
        got = constrain(dt, "act_batch", "act_seq")
    out["constrained"] = got.to_local().numpy()
    out["placements"] = np.array([repr(p) for p in got.placements])
    out["coords"] = np.array(mesh.get_coordinate())
    return out


def dappa_mode(rank: int, world: int) -> dict:
    """``tests/distributed_worker.py``'s dappa_distributed pipelines on a
    (world,) data mesh, each rank its contiguous shard."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import damov, dappa
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}
    for label, kw in (("local", {}), ("mesh", dict(mesh=mesh))):
        x = dappa.input_stream("x")
        y = dappa.input_stream("y")
        dot = x.zip(y).map(lambda t: t[..., 0] * t[..., 1]).reduce("sum")
        mov = x.window(4, lambda w: w.amax(-1))
        fm = x.filter(lambda v: v > 0).reduce("mean")
        f = dappa.compile_pipeline({"d": dot, "m": mov, "f": fm}, **kw)
        xs = torch.linspace(-3, 3, 64)
        ys = torch.linspace(1, 2, 64)
        if label == "mesh":
            n = 64 // world
            xs, ys = xs[rank * n:(rank + 1) * n], ys[rank * n:(rank + 1) * n]
        res, st = damov.count_step(f, x=xs, y=ys)
        out.update({f"{label}_{k}": v.numpy() for k, v in res.items()})
    # the mesh run's collectives as the step counter reads them
    out["coll"] = np.array([st.n_collectives, st.coll_operand_bytes,
                            st.coll_wire_bytes])
    kinds = sorted(st.by_kind)
    out["kind_names"] = np.array(kinds)
    out["kind_bytes"] = np.array([st.by_kind[k] for k in kinds])
    return out


PIPE_STAGES = 2


def proteus_mode(rank: int, world: int, inputs: dict) -> dict:
    """proteus_psum at 8 and 4 bits over a (world,) pod mesh, each rank its
    row of the reference's inputs; the exact sum by one all_reduce."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import proteus
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    out = {}
    for name in ("g", "odd"):
        x = torch.from_numpy(inputs[f"{name}_in"][rank])
        # the exact sum in rank order, as the reference's psum adds
        rows = torch.empty((world,) + tuple(x.shape), dtype=x.dtype)
        dist.all_gather(list(rows), x, group=mesh.get_group("pod"))
        exact = rows[0].clone()
        for r in range(1, world):
            exact += rows[r]
        out[f"{name}_exact"] = exact.numpy()
        for bits in (8, 4):
            out[f"{name}_q{bits}"] = proteus.proteus_psum(
                x, "pod", bits=bits, block=PSUM_BLOCK, mesh=mesh).numpy()
        # the same from the active plan's mesh
        from repro_torch.core.mimdram import Plan, use_plan
        with use_plan(Plan(rules={}, mesh=mesh)):
            out[f"{name}_q8_plan"] = proteus.proteus_psum(
                x, "pod", bits=8, block=PSUM_BLOCK).numpy()
        out[f"{name}_tree"] = proteus.maybe_compress_grads(
            {"a": x}, True, "pod", bits=8, block=PSUM_BLOCK, n_pods=world,
            mesh=mesh)["a"].numpy()
    return out


def _smoke_train(world_mesh, **run_kw):
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.core.mimdram import plan_sharding
    cfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    shape = ShapeConfig("t", seq_len=TRAIN_SHAPE[1],
                        global_batch=TRAIN_SHAPE[0], mode="train")
    run = RunConfig(**dict(dict(total_steps=10, microbatches=1,
                                proteus_enabled=True, proteus_grad_bits=8,
                                proteus_block=TRAIN_BLOCK), **run_kw))
    return cfg, shape, run, plan_sharding(cfg, shape, world_mesh)


def proteus_train_mode(rank: int, world: int, inputs: dict) -> dict:
    """One Proteus step of the fp32 smoke pimref (SGD, the reference's
    ``TRAIN_RUN``) on a (2, 2, 2) pod x data x model mesh from the
    reference's parameters and batch: the new parameters, SGD's momentum
    (the reduced gradient) and the loss."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.steps import make_train_step_proteus
    from repro_torch.models.model import training_model
    from repro_torch.optim import make_optimizer
    mesh = init_device_mesh("cpu", REDUCE_MESH[0],
                            mesh_dim_names=REDUCE_MESH[1])
    cfg, _, run, plan = _smoke_train(mesh, **TRAIN_RUN)
    params = _to_torch(nested(inputs, "param"))
    batch = {k: torch.from_numpy(v)
             for k, v in nested(inputs, "batch").items()}
    opt = make_optimizer("sgd", run)
    step = make_train_step_proteus(training_model(cfg), opt, plan, run)
    params, state, m = step(params, opt.init(params), batch)
    out = flat_tree(params, "new")
    out.update(flat_tree(state["mu"], "mu"))
    out["loss"] = m["loss"].numpy()
    out["rules_batch"] = np.array(plan.rules["act_batch"])
    return out


def _to_torch(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def proteus_one_mode(rank: int, world: int, inputs: dict) -> dict:
    """On one rank (a (1,) pod mesh): three AdamW steps of the Proteus step
    and of the plain step whose gradients pass through quantize and
    dequantize, from the port's init; the losses, parameters and states
    of both."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.proteus import quantize_hook
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.steps import (make_train_step,
                                          make_train_step_proteus)
    from repro_torch.launch.train import initial_params
    from repro_torch.models.model import training_model
    from repro_torch.optim import make_optimizer
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    cfg, shape, run, plan = _smoke_train(mesh)
    model = training_model(cfg)
    hook = quantize_hook(run)

    bf = make_batch_fn(cfg, shape)
    out = {}
    for name, make in (("proteus", lambda o: make_train_step_proteus(
            model, o, plan, run)), ("hooked", lambda o: make_train_step(
                model, o, run, grad_hook=hook))):
        opt = make_optimizer("adamw", run)
        params = initial_params(cfg, 0, "cpu")
        state = opt.init(params)
        step = make(opt)
        for i in range(3):
            batch = {k: torch.from_numpy(v) for k, v in bf(i).items()}
            params, state, m = step(params, state, batch)
            out[f"{name}_loss{i}"] = m["loss"].numpy()
        out.update(flat_tree(params, f"{name}_params"))
        out.update(flat_tree(state["mu"], f"{name}_mu"))
        out.update(flat_tree(state["nu"], f"{name}_nu"))
        out[f"{name}_step"] = state["step"].numpy()
    return out


def pipeline_mode(rank: int, world: int, inputs: dict) -> dict:
    """pipelined_forward over the (2, 2, 2) mesh's two pod stages, and the
    sequential stack microbatch by microbatch."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import pipelined_forward
    mesh = init_device_mesh("cpu", REDUCE_MESH[0],
                            mesh_dim_names=REDUCE_MESH[1])
    w, x = (torch.from_numpy(inputs[k]) for k in ("w", "x"))

    def block(wl, h):
        return torch.tanh(h @ wl)

    out = pipelined_forward(block, w, x, mesh=mesh, n_stages=PIPE_STAGES,
                            n_layers=w.shape[0])
    seq = []
    for mb in x:
        for wl in w:
            mb = block(wl, mb)
        seq.append(mb)
    refused = ""
    try:
        pipelined_forward(block, w[:3], x, mesh=mesh, n_stages=PIPE_STAGES,
                          n_layers=3)
    except ValueError as e:
        refused = str(e)
    return {"out": out.numpy(), "seq": torch.stack(seq).numpy(),
            "refused": np.array(refused)}


MODES = {"reduce": reduce, "dappa": dappa_mode}
INPUT_MODES = {"proteus": proteus_mode, "proteus_train": proteus_train_mode,
               "proteus_one": proteus_one_mode, "pipeline": pipeline_mode}


def main(argv) -> int:
    mode = argv[1]
    if mode in ("plans", "dryrun"):
        (plans if mode == "plans" else dryrun)(argv[2])
        return 0
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out_dir = int(argv[2]), int(argv[3]), argv[4], \
        argv[5]
    inputs = dict(np.load(argv[6])) if len(argv) > 6 else {}
    _init(rank, world, store)
    try:
        if mode in INPUT_MODES:
            res = INPUT_MODES[mode](rank, world, inputs)
        else:
            res = MODES[mode](rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
