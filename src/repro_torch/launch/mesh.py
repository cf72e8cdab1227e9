"""The production meshes (counterpart: ``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no process
group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group, which the caller has initialised (a real one on the
cards, or torch's fake group for the dry-run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from typing import Tuple


def make_production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): 256 or 512 ranks of the default group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(axes: Tuple[str, ...] = ("data",), device: str = "cuda"):
    """A mesh over every rank of the default group: the first axis takes
    them all, the others are 1 wide."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (dist.get_world_size(),) + (1,) * (len(axes) - 1)
    return init_device_mesh(device, shape, mesh_dim_names=tuple(axes))


def describe(mesh) -> str:
    """``"data=16xmodel=16"``: each axis with its size, in mesh order."""
    from repro_torch.core.mimdram import mesh_shape
    return "x".join(f"{k}={v}" for k, v in mesh_shape(mesh).items())


def n_chips(mesh) -> int:
    from repro_torch.core.mimdram import mesh_shape
    return math.prod(mesh_shape(mesh).values())
