"""Elastic re-meshing: resume a job on another set of ranks (port of
`repro.runtime.elastic`).

A state written under mesh A goes on under mesh B by re-deriving each
leaf's sharding from its *logical axes*, which do not depend on the
mesh, and re-placing the leaf: the recovery path when ranks are lost
(shrink) or added (grow).  A mesh is a `DeviceMesh` over ranks of the
process group (`sharding.ranks`); a leaf that is a DTensor is gathered
to full over its old mesh first (`ranks.gather_dtensor`, bitwise), so
every rank of the old mesh calls `reshard`.  A rank outside the new mesh
gets DTensors with empty blocks.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch.distributed as dist

from ..checkpoint.checkpointer import tree_flatten
from ..launch.mesh import mesh_over
from ..sharding import axes as ax
from ..sharding import ranks


def make_mesh_from(members: Sequence[int], shape, axis_names,
                   device: str = "cuda"):
    """A `DeviceMesh` of `shape` over the first prod(shape) ranks of
    `members` (every rank of the world calls it)."""
    n = math.prod(shape)
    if len(members) < n:
        raise ValueError(f"need {n} devices, have {len(members)}")
    return mesh_over(list(members)[:n], shape, axis_names, device)


def survivors_mesh(failed: Sequence[int], shape, axis_names,
                   device: str = "cuda"):
    """A (smaller) mesh over the ranks of the world that are not in
    `failed`."""
    alive = [r for r in range(dist.get_world_size()) if r not in set(failed)]
    return make_mesh_from(alive, shape, axis_names, device)


def reshard(tree: Any, axes_tree: Any, mesh, rules: ax.Rules):
    """Every leaf (a full tensor or a DTensor) as a DTensor placed on
    `mesh` by its logical axes under `rules`
    (`tree_shardings_matched`)."""
    flat, treedef = tree_flatten(tree)
    full = [ranks.gather_dtensor(x) for x in flat]
    shardings = ax.tree_shardings_matched(
        axes_tree, treedef.unflatten(full), mesh, rules)
    flat_s, _ = tree_flatten(shardings)
    return treedef.unflatten([s.place(x) for x, s in zip(full, flat_s)])
