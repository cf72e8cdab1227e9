"""Multi-pod dry-run: every (arch x shape x mesh) cell planned, assembled
and sized without a card (counterpart: ``repro/launch/dryrun.py``).

For each cell:
  * the MIMDRAM planner resolves the data mapping on the production mesh,
    a ``DeviceMesh`` of 256 or 512 ranks under torch's fake process group
    (one process; the counterpart of the reference's 512 placeholder XLA
    devices);
  * ``steps.cell_artifacts`` gives the step, its arguments as ``meta``
    tensors and their DTensor placements;
  * the memory and cost of one device are computed (there is no compiler
    to ask, so this is what stands in for XLA's analyses):

    - argument bytes a device: exact, from the shard shapes the placements
      give (parameters, optimizer state and batch; the cache for decode);
    - temporaries: a model. The step of one device's batch (the global
      batch over the plan's ``act_batch`` axes) runs once on ``meta``
      under a dispatch mode that tracks the storages it makes (each from
      its first op to its release); their peak is split evenly over the
      ranks that share that batch (the model and sequence axes), as the
      activations would be. Output bytes (the new tensors the step
      returns) the same way;
    - cost (XLA's ``cost_analysis``): ``damov.analyze_step`` of that run
      (FLOPs, bytes, the kernels' own work reports), split the same way;
      collectives: only a Proteus step's pod hop is modelled (its int8 ring
      over the pods and the fp32 max of the block maxima, for the gradient
      shard of a device); the port has no GSPMD, so a plain step's
      gradient reductions are not counted;
    - the roofline is ``damov.make_roofline`` with the H100's figures
      (``damov.H100_SXM``), and the fit check is against one H100's 80 GB.

  A Proteus cell's one-device step is the plain step with its gradients
  passed through ``proteus.quantize`` and ``dequantize`` (on one pod the
  Proteus step equals it bit for bit; the ring needs real ranks).

Usage:
  python -m repro_torch.launch.dryrun --arch pimref-100m --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k \\
      --mesh multi --proteus --tag proteus_int8

Rows are written as JSON under ``--out`` (default ``build/dryrun``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ALL_IDS, SHAPES_BY_NAME, RunConfig, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig

# one NVIDIA H100 SXM's 80 GB, taken as GiB as the reference takes its 16
HBM_PER_CARD = 80 * 1024 ** 3
DEFAULT_OUT = os.path.join("build", "dryrun")


def active_param_count_from_specs(model, cfg: ModelConfig) -> int:
    """Parameters a token uses: all of them, less the experts it is not
    routed to."""
    from repro_torch.models import count_params
    total = count_params(cfg)
    if cfg.num_experts and cfg.experts_per_token:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        inactive = cfg.num_layers * (cfg.num_experts - cfg.experts_per_token) \
            * per_expert
        return total - inactive
    return total


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("full-attention arch: 524k dense KV cache at batch 1 is "
                "architecturally meaningless (assignment rule); runs only for "
                "SSM/hybrid/sliding-window archs")
    return None


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------
def shard_numel(shape, placements, sizes) -> int:
    """Elements of the largest shard of a tensor of ``shape`` laid out by
    ``placements`` over mesh dims of ``sizes`` (None: replicated)."""
    from torch.distributed.tensor import Shard
    dims = list(shape)
    for p, n in zip(placements or (), sizes):
        if isinstance(p, Shard):
            dims[p.dim] = -(-dims[p.dim] // n)
    return math.prod(dims)


def _pairs(tree, placements):
    """(tensor, placements) pairs of matching trees (dicts, lists, tuples,
    the KV cache's dataclasses)."""
    if isinstance(tree, torch.Tensor):
        yield tree, placements
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], placements[k])
    elif isinstance(tree, (list, tuple)):
        for t, p in zip(tree, placements):
            yield from _pairs(t, p)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _pairs(getattr(tree, f.name),
                              getattr(placements, f.name))


def device_bytes(tree, placements, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``placements``."""
    from repro_torch.core.mimdram import mesh_shape
    sizes = tuple(mesh_shape(mesh).values())
    return sum(shard_numel(t.shape, p, sizes) * t.element_size()
               for t, p in _pairs(tree, placements))


# ---------------------------------------------------------------------------
# one device's step, counted on meta
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(n: int):
    """Torch's fake process group of ``n`` ranks (this process is rank 0)
    for the block, unless a default group of ``n`` ranks is up already."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is up; the mesh needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _LivePeak(TorchDispatchMode):
    """The peak of the bytes of the storages made in its block and still
    alive (each storage counted once, from its first op to its release;
    those of ``known`` tensors are not counted)."""

    def __init__(self, known):
        super().__init__()
        from repro_torch.core.damov import _tensors
        self._tensors = _tensors
        self.seen = {t.untyped_storage()._cdata for t in _tensors(known)}
        self.live = 0
        self.peak = 0

    def _free(self, key, n):
        self.live -= n
        self.seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in self._tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            self.seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def measure_step(step, args):
    """(StepStats, peak bytes of the storages made while ``step(*args)``
    runs, bytes of the new tensors it returns) of one run on ``meta``."""
    from repro_torch.core import damov
    with _LivePeak(args) as tracker:
        out, stats = damov.count_step(step, *args)
    known = {t.untyped_storage()._cdata for t in damov._tensors(args)}
    new = {}
    for t in damov._tensors(out):
        st = t.untyped_storage()
        if st._cdata not in known:
            new[st._cdata] = st.nbytes()
    return stats, int(tracker.peak), int(sum(new.values()))


def _proteus_cell(shape, plan, run) -> bool:
    """Whether ``cell_artifacts`` picks the Proteus step."""
    from repro_torch.core.mimdram import mesh_shape
    return (shape.mode == "train" and run.proteus_enabled
            and "pod" in mesh_shape(plan.mesh))


def _local_problem(cfg, shape, plan, run):
    """One device's step: ``(step, args, split)`` with ``split`` the ranks
    that share its batch; a Proteus cell's is the plain step with the
    quantize hook (one pod's)."""
    from repro_torch.core import proteus
    from repro_torch.core.mimdram import _axis_size, plan_sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    dw = _axis_size(plan.mesh, plan.rules.get("act_batch"))
    chips = mesh_lib.n_chips(plan.mesh) if plan.mesh is not None else 1
    local = shape.replace(global_batch=-(-shape.global_batch // dw))
    hook = (proteus.quantize_hook(run) if _proteus_cell(shape, plan, run)
            else None)
    _, step, args, _, _, _, _ = steps_lib.cell_artifacts(
        cfg, local, plan_sharding(cfg, local), run, grad_hook=hook)
    return step, args, max(chips // dw, 1)


def _proteus_ring(stats, params, placements, plan, run) -> None:
    """Add a Proteus step's pod hop to ``stats`` (a model): a device's
    gradient shard as int8 codes around the pods' ring, and the fp32
    all-reduce of its block maxima."""
    from repro_torch.core import damov
    from repro_torch.core.mimdram import mesh_shape
    sizes = mesh_shape(plan.mesh)
    g = sizes["pod"]
    shards = [shard_numel(t.shape, p, tuple(sizes.values()))
              for t, p in _pairs(params, placements)]
    codes = float(sum(shards))
    maxima = 4.0 * sum(-(-n // run.proteus_block) for n in shards)
    for kind, res in (("collective-permute", codes), ("all-reduce", maxima)):
        operand, wire = damov.collective_bytes(kind, res, g)
        if kind == "collective-permute":
            wire *= g - 1                       # n - 1 hops of the ring
        stats.coll_operand_bytes += operand
        stats.coll_wire_bytes += wire
        stats.by_kind[kind] = stats.by_kind.get(kind, 0.0) + operand
        stats.n_collectives += len(shards) * (g - 1 if kind ==
                                              "collective-permute" else 1)


def predict_cell(cfg: ModelConfig, shape: ShapeConfig, plan,
                 run: RunConfig) -> Dict[str, Any]:
    """The memory and cost of one device for a cell under ``plan`` (see
    the module's docstring for what is counted and what is modelled)."""
    from repro_torch.launch import steps as steps_lib
    t0 = time.time()
    model, _, args, placements, _, eff_run, _ = steps_lib.cell_artifacts(
        cfg, shape, plan, run)
    arg_b = sum(device_bytes(a, p, plan.mesh)
                for a, p in zip(args, placements))
    step, local_args, split = _local_problem(cfg, shape, plan, eff_run)
    stats, temp, out_b = measure_step(step, local_args)
    for f in ("flops", "bytes", "dot_flops"):
        setattr(stats, f, getattr(stats, f) / split)
    proteus = _proteus_cell(shape, plan, eff_run)
    if proteus:
        _proteus_ring(stats, args[0], placements[0], plan, eff_run)
    temp, out_b = temp // split, out_b // split
    peak, steady = arg_b + temp, arg_b + out_b
    return dict(
        model=model, run=eff_run, stats=stats, split=split, seconds=time.time() - t0,
        memory={"argument_bytes": int(arg_b), "temp_bytes": int(temp),
                "output_bytes": int(out_b), "peak_bytes": int(peak),
                "fits_80GB": bool(peak <= HBM_PER_CARD),
                "peak_GB": round(peak / 2 ** 30, 2),
                "steady_GB": round(steady / 2 ** 30, 2),
                "steady_fits_80GB": bool(steady <= HBM_PER_CARD)},
        cost={"flops": stats.flops, "bytes_accessed": stats.bytes,
              "kernels": dict(stats.kernels)},
        proteus_step=proteus)


def run_cell(arch: str, shape_name: str, multi_pod: bool, run: RunConfig,
             overrides: Dict[str, Any], tag: str, out_dir: str = DEFAULT_OUT,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell on its production mesh (under a fake process group of the
    mesh's ranks when none is up): a row with status ``OK`` (memory, cost,
    roofline, plan), ``SKIP`` (with the reason) or ``FAIL`` (the error),
    also written under ``out_dir``."""
    from repro_torch.core import damov
    from repro_torch.core.mimdram import plan_sharding
    from repro_torch.launch import mesh as mesh_lib
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if shape.mode in ("prefill", "decode"):
        # serving holds bf16 weights
        cfg = cfg.replace(param_dtype="bfloat16")
    if overrides:
        cfg = cfg.replace(**overrides)
    chips = 512 if multi_pod else 256
    mdesc = ("pod=2xdata=16xmodel=16" if multi_pod else "data=16xmodel=16")
    row: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mdesc, "tag": tag,
        "multi_pod": multi_pod, "chips": chips, "status": "pending",
    }
    reason = skip_reason(cfg, shape)
    if reason:
        row.update(status="SKIP", reason=reason)
        _save(row, out_dir)
        return row
    try:
        with fake_world(chips):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device="cpu")
            plan = plan_sharding(cfg, shape, mesh)
            got = predict_cell(cfg, shape, plan, run)
        n_active = active_param_count_from_specs(got["model"], cfg)
        mf = damov.model_flops_for(cfg, shape, n_active)
        roof = damov.make_roofline(arch, shape_name, shape.mode, mdesc, chips,
                                   got["stats"], mf,
                                   notes="; ".join(plan.notes))
        from repro_torch.models import count_params
        row.update(
            status="OK", seconds=round(got["seconds"], 1),
            microbatches=got["run"].microbatches, split=got["split"],
            proteus_step=got["proteus_step"], memory=got["memory"],
            step_cost=got["cost"], damov=dataclasses.asdict(roof),
            plan={"notes": list(plan.notes),
                  "segment_utilization": plan.segment_utilization,
                  "segments": plan.segments,
                  "rules": {k: list(v) if v else None
                            for k, v in plan.rules.items()}},
            params_total=count_params(cfg), params_active=n_active)
        if verbose:
            print(f"[{arch} x {shape_name} x {mdesc}"
                  f"{' #' + tag if tag else ''}] OK "
                  f"peak={row['memory']['peak_GB']}GB "
                  f"dominant={roof.dominant} class={roof.bottleneck_class} "
                  f"rf={roof.roofline_fraction:.3f} ({row['seconds']}s)")
            print(f"  terms: compute={roof.compute_s:.3e}s "
                  f"memory={roof.memory_s:.3e}s coll={roof.collective_s:.3e}s "
                  f"MF/HF={roof.useful_ratio:.3f}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        row.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{arch} x {shape_name} x {mdesc}] FAIL: {e}")
    _save(row, out_dir)
    return row


def _save(row: Dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = ("_" + row["tag"]) if row.get("tag") else ""
    name = f"{row['arch']}_{row['shape']}_{row['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name.replace("=", "")), "w") as f:
        json.dump(row, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ALL_IDS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES_BY_NAME) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--proteus", action="store_true",
                    help="quantized cross-pod gradient reduction (multi-pod)")
    ap.add_argument("--proteus-bits", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides k=v (e.g. attn_block_skip=1)")
    args = ap.parse_args(argv)

    run = RunConfig(proteus_enabled=args.proteus,
                    proteus_grad_bits=args.proteus_bits,
                    microbatches=args.microbatches)
    overrides: Dict[str, Any] = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        cur = getattr(ModelConfig, k, None)
        overrides[k] = type(cur)(eval(v)) if cur is not None else eval(v)

    archs = list(ALL_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(arch, shape, mp, run, overrides,
                                        args.tag, args.out))
    ok = sum(r["status"] == "OK" for r in results)
    sk = sum(r["status"] == "SKIP" for r in results)
    fa = sum(r["status"] == "FAIL" for r in results)
    print(f"\ndry-run: {ok} OK, {sk} SKIP, {fa} FAIL / {len(results)} cells")
    if fa:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
