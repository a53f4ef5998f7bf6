"""Model meshes over ranks (port of `repro.launch.mesh`).

Functions, never module-level meshes, so importing this module touches
no process group.  Each builds a `DeviceMesh` over the first ranks of
the default process group (`sharding.ranks.init_ranks` joins it), with
the reference's axis names.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def mesh_over(members, shape, axes, device: str = "cuda"):
    """A `DeviceMesh` of `shape` over the ranks `members` (as many as the
    shape holds), its axes named `axes`; every rank of the world calls
    it, members or not."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(list(members), dtype=torch.int64).reshape(shape)
    return DeviceMesh(torch.device(device).type, grid,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — start {n} "
            "ranks (`sharding.ranks.spawn_ranks`, or one process per rank "
            "with `init_ranks`)")
    return mesh_over(range(n), shape, axes, device)


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"),
                   device: str = "cuda"):
    """Small mesh for tests (8 ranks by default)."""
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {have}")
    return mesh_over(range(n), shape, axes, device)
