"""Multi-process workers of the port's paper-layer tests (torch only: no
jax, no ``repro``), and the launcher that runs them with time limits.

    python torch_dist_worker.py plans OUT.json
        every arch x shape x mesh planned by ``repro_torch.core.mimdram`` on
        ``DeviceMesh`` es under torch's fake process group of 512 ranks
        (one process; the group is destroyed before it exits)
    python torch_dist_worker.py <mode> RANK WORLD STORE OUT_DIR
        one gloo rank of ``mode`` (``reduce``, ``dappa``), rendezvous
        through the ``FileStore`` at STORE; writes OUT_DIR/rank<RANK>.npz

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


def run_ranks(mode: str, world: int, tmp_path, timeout: float = 120.0):
    """Run ``mode`` on ``world`` gloo ranks, each in its own process;
    returns the ranks' outputs (dicts of arrays) in rank order. A rank
    that fails or outlives ``timeout`` fails the call (every rank is
    killed)."""
    store = os.path.join(str(tmp_path), f"store_{mode}")
    out = os.path.join(str(tmp_path), f"out_{mode}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         store, out], env=env, stdout=subprocess.PIPE,
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


def run_plans(out_json: str, timeout: float = 300.0) -> dict:
    """The ``plans`` mode in a subprocess; returns its JSON."""
    subprocess.run([sys.executable, os.path.abspath(__file__), "plans",
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


MODES = {"reduce": reduce, "dappa": dappa_mode}


def main(argv) -> int:
    mode = argv[1]
    if mode == "plans":
        plans(argv[2])
        return 0
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out_dir = int(argv[2]), int(argv[3]), argv[4], \
        argv[5]
    _init(rank, world, store)
    try:
        res = MODES[mode](rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
