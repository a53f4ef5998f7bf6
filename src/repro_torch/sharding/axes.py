"""Sweep meshes: where the sharded engines put each slab of a grid.

The counterpart of the sweep-mesh half of `repro.sharding.axes`.  A
sweep's grid is embarrassingly parallel (one lifecycle per configuration
or trial, nothing shared between them), so a mesh is only a placement:
a ``(dc, dt)`` grid of devices named (`CONFIG_AXIS`, `TRIAL_AXIS`).
`core.sweep.sharded_sweep` and `core.mc_sweep.sharded_mc_sweep` cut
their batch into slabs with it and run each slab on its device:

* a flat (configuration·trial) batch is product-sharded over both axes
  in device order (`batch_slabs`, `repro`'s `batch_spec`), so every
  ``(dc, dt)`` with the same device count gives the same slabs;
* a ``[B, T]`` grid is block-sharded, configurations over `CONFIG_AXIS`
  and trials over `TRIAL_AXIS` (`grid_blocks`, `repro`'s `grid_spec`).

A device list may name one device more than once, which puts several
slabs on it (``["cpu"] * 4`` on the CPU, ``["cuda:0"] * 2`` on one
card).  The model-mesh rule sets of `repro.sharding.axes` are not here
yet (ROADMAP queue 1, item 11b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

AxisVal = Union[None, str, Tuple[str, ...]]

# Mesh-axis names of a sweep's (configuration × trial) grid, `repro`'s.
CONFIG_AXIS = "config"
TRIAL_AXIS = "trial"

# Logical axes of the sweep engines onto mesh axes, `repro`'s table:
# "batch" is a flat (config·trial) axis product-sharded over both.
SWEEP_RULES: Dict[str, AxisVal] = {
    "config": CONFIG_AXIS,
    "trial": TRIAL_AXIS,
    "batch": (CONFIG_AXIS, TRIAL_AXIS),
}


@dataclass(frozen=True)
class SweepMesh:
    """A grid of devices with one name per axis.  `devices` is an object
    array of `torch.device`s of the mesh's shape, filled in the order of
    the device list."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]


def local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """`devices` as `torch.device`s, each checked by `resolve_device`;
    None means every visible card, ``cuda:0 … cuda:{n−1}`` (it raises
    without one, as every entry point asked for the card does)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("an empty device list")
    return devs


def _mesh(devs: List[torch.device], shape, names) -> SweepMesh:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return SweepMesh(grid.reshape(shape), tuple(names))


def config_mesh(devices: Optional[Sequence] = None) -> SweepMesh:
    """1-D mesh over `devices` (default: every visible card) with the
    single axis `CONFIG_AXIS`."""
    devs = local_devices(devices)
    return _mesh(devs, (len(devs),), (CONFIG_AXIS,))


def sweep_mesh(devices: Optional[Sequence] = None,
               shape: Optional[Tuple[int, int]] = None) -> SweepMesh:
    """2-D (`CONFIG_AXIS` × `TRIAL_AXIS`) mesh over `devices` (default:
    every visible card).  `shape=(dc, dt)` must multiply out to the
    device count; the default ``(D, 1)`` puts every device on the
    configuration axis."""
    devs = local_devices(devices)
    D = len(devs)
    if shape is None:
        shape = (D, 1)
    dc, dt = int(shape[0]), int(shape[1])
    if dc < 1 or dt < 1 or dc * dt != D:
        raise ValueError(
            f"mesh shape {shape} needs {max(dc, 1) * max(dt, 1)} devices, "
            f"got {D}")
    return _mesh(devs, (dc, dt), (CONFIG_AXIS, TRIAL_AXIS))


def batch_slabs(mesh: SweepMesh, lo: int,
                hi: int) -> List[Tuple[torch.device, int, int]]:
    """A flat batch ``[lo, hi)`` product-sharded over every mesh axis:
    D contiguous slabs of ``ceil((hi − lo) / D)`` entries (D devices),
    the k-th on the k-th device of the list, as (device, start, stop);
    a short batch leaves its last slabs empty (start ≥ stop)."""
    devs = list(mesh.devices.flat)
    width = -(-(hi - lo) // len(devs))
    return [(d, lo + k * width, min(lo + (k + 1) * width, hi))
            for k, d in enumerate(devs)]


def grid_blocks(mesh: SweepMesh, B: int, T: int) -> List[
        Tuple[torch.device, Tuple[int, int], Tuple[int, int]]]:
    """A ``[B, T]`` grid block-sharded over a (config, trial) mesh: the
    device at mesh position (i, j) takes configurations block i and
    trials block j, blocks of ``ceil(B / dc)`` and ``ceil(T / dt)``, as
    (device, (b0, b1), (t0, t1)) in the order of the device list; a
    short grid leaves blocks empty (b0 ≥ b1 or t0 ≥ t1)."""
    dc, dt = mesh.devices.shape
    bc, tc = -(-B // dc), -(-T // dt)
    return [(mesh.devices[i, j], (i * bc, min((i + 1) * bc, B)),
             (j * tc, min((j + 1) * tc, T)))
            for i in range(dc) for j in range(dt)]
